"""Decode-index sidecar and the indexed decompress (counterpart of
deflate_compression_tpu/decode/index.py).

The index records, per coding block, its bit offset, output byte offset and
type, plus sub-block entries (bit offset, output offset, block) that become
the device decoder's lanes (decode/device_inflate.py). Sources:

  * free from the encoder's per-shard stats, via `index_from_shards`;
  * one host pass over any raw DEFLATE stream (`build_index`): the native
    C++ pass of the repository's native runtime where it builds, else the
    Python loop below, which is the oracle.

Sidecar format (.dcx), byte-identical to the JAX package's: magic 'DCXI',
u32 version, u32 n_blocks, u64 out_len, then per block u64 bit_base,
u64 out_start, u8 btype; version 2 appends u32 n_subs then per sub
u64 bit, u64 out, u32 block.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from .. import native_bridge
from ..core.bits import BitReader
from ..core.checksum import adler32_combine, adler32_torch
from ..device import pick_device
from ..format import constants as C
from ..utils.errors import DeflateError
from .inflate import _FIXED_D_LUT, _FIXED_LL_LUT, _read_dynamic_tables

_MAGIC = b"DCXI"
_VERSION = 2
SUB_SIZE = 1024

# the per-shard encoder stats that index_from_shards consumes
INDEX_STAT_FIELDS = ("block_bit_base", "block_out_start", "btype",
                     "n_blocks", "sub_bit", "sub_out", "sub_blk",
                     "sub_overflow")

@dataclasses.dataclass
class DecodeIndex:
    bit_base: np.ndarray      # i64[n] bit offset of each block header
    out_start: np.ndarray     # i64[n] output byte offset of each block
    btype: np.ndarray         # u8[n]
    out_len: int              # total decompressed bytes
    sub_bit: np.ndarray | None = None    # i64[m] first-token bit offsets
    sub_out: np.ndarray | None = None    # i64[m] output offsets
    sub_blk: np.ndarray | None = None    # i32[m] owning block ids

    @property
    def n_blocks(self) -> int:
        return len(self.bit_base)

    @property
    def n_subs(self) -> int:
        return 0 if self.sub_bit is None else len(self.sub_bit)

    def to_bytes(self) -> bytes:
        head = _MAGIC + struct.pack("<IIQ", _VERSION, self.n_blocks,
                                    self.out_len)
        body = b"".join(
            struct.pack("<QQB", int(b), int(o), int(t))
            for b, o, t in zip(self.bit_base, self.out_start, self.btype))
        subs = struct.pack("<I", self.n_subs)
        if self.n_subs:
            subs += b"".join(
                struct.pack("<QQI", int(b), int(o), int(k))
                for b, o, k in zip(self.sub_bit, self.sub_out, self.sub_blk))
        return head + body + subs

    @classmethod
    def from_bytes(cls, data: bytes) -> "DecodeIndex":
        if data[:4] != _MAGIC:
            raise DeflateError("E_HDR", "bad index magic")
        ver, n, out_len = struct.unpack("<IIQ", data[4:20])
        if ver not in (1, 2):
            raise DeflateError("E_HDR", f"unsupported index version {ver}")
        blocks = np.frombuffer(data, np.dtype([("b", "<u8"), ("o", "<u8"),
                                               ("t", "u1")]), n, 20)
        bb = blocks["b"].astype(np.int64)
        os_ = blocks["o"].astype(np.int64)
        bt = blocks["t"].copy()
        sb = so = sk = None
        off = 20 + 17 * n
        if ver >= 2:
            (m,) = struct.unpack("<I", data[off:off + 4])
            subs = np.frombuffer(data, np.dtype([("b", "<u8"), ("o", "<u8"),
                                                 ("k", "<u4")]), m, off + 4)
            sb = subs["b"].astype(np.int64)
            so = subs["o"].astype(np.int64)
            sk = subs["k"].astype(np.int32)
            _check_sub_order(so)
        return cls(bb, os_, bt, out_len, sb, so, sk)

    def block_for_offset(self, byte_off: int) -> int:
        """Random access: which block contains output byte `byte_off`."""
        return int(np.searchsorted(self.out_start, byte_off, "right") - 1)


def _check_sub_order(sub_out) -> None:
    """Raise E_INDEX where the sub-entries' output offsets decrease. The
    device decoder ends each lane where the next entry starts, so entries
    out of output order would give lanes that overlap, and the kernel's
    16-byte token stores would then race."""
    if sub_out is not None and (np.diff(sub_out) < 0).any():
        raise DeflateError("E_INDEX", "sub-entries out of output order")


def native_available() -> bool:
    """Whether build_index can take the repository's native C++ pass."""
    return native_bridge.available()


def build_index(stream: bytes, bit_pos: int = 0, sub_size: int = SUB_SIZE,
                prefer_native: bool = True) -> DecodeIndex:
    """One host pass over a raw DEFLATE stream: block boundaries and a
    sub-entry every `sub_size` output bytes, found by decoding symbols but
    only counting output bytes."""
    if prefer_native and native_available():
        bb, bo, bt, sb, so, sk, out_len = native_bridge.build_index_native(
            bytes(stream), bit_pos, sub_size)
        return DecodeIndex(bb, bo, bt.astype(np.uint8), out_len, sb, so, sk)
    r = BitReader(stream, bit_pos)
    bit_base, out_start, btypes = [], [], []
    sub_bit, sub_out, sub_blk = [], [], []
    out = 0
    while True:
        blk_i = len(bit_base)
        bit_base.append(r.pos)
        out_start.append(out)
        bfinal = r.read(1)
        btype = r.read(2)
        btypes.append(btype)
        if btype == C.BTYPE_STORED:
            r.align_byte()
            ln = r.read(16)
            nlen = r.read(16)
            if ln != (~nlen & 0xFFFF):
                raise DeflateError("E_STORED", "LEN != ~NLEN")
            r.skip(8 * ln)
            out += ln
        elif btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            if btype == C.BTYPE_FIXED:
                (ll_sym, ll_len), (d_sym, d_len) = _FIXED_LL_LUT, _FIXED_D_LUT
            else:
                (ll_sym, ll_len), (d_sym, d_len) = _read_dynamic_tables(r)
            next_mark = out          # a block's start always gets an entry
            while True:
                if out >= next_mark:
                    sub_bit.append(r.pos)
                    sub_out.append(out)
                    sub_blk.append(blk_i)
                    next_mark = (out // sub_size + 1) * sub_size
                idx = r.peek(15)
                l = ll_len[idx]
                if l == 0:
                    raise DeflateError("E_BADCODE", "invalid code")
                r.skip(int(l))
                s = int(ll_sym[idx])
                if s < 256:
                    out += 1
                elif s == 256:
                    break
                else:
                    li = s - 257
                    out += int(C.LENGTH_BASE[li]) + r.read(int(C.LENGTH_EXTRA[li]))
                    didx = r.peek(15)
                    dl = d_len[didx]
                    if dl == 0:
                        raise DeflateError("E_BADCODE", "invalid dist code")
                    r.skip(int(dl))
                    r.skip(int(C.DIST_EXTRA[int(d_sym[didx])]))
        else:
            raise DeflateError("E_BTYPE", "reserved BTYPE=3")
        if bfinal:
            break
    return DecodeIndex(np.array(bit_base, np.int64),
                       np.array(out_start, np.int64),
                       np.array(btypes, np.uint8), out,
                       np.array(sub_bit, np.int64),
                       np.array(sub_out, np.int64),
                       np.array(sub_blk, np.int32))


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def index_from_shards(shard_results, shard_comp_bits, shard_out_lens,
                      sub_spacing: int = SUB_SIZE) -> DecodeIndex:
    """Assemble a stream-level index from per-shard encoder stats (the
    port's encode_shard dicts of tensors, or numpy stats from an
    index_sink). The encoder's dense sub-entries are thinned to about one
    per `sub_spacing` output bytes; each block's first entry is kept."""
    bit_base, out_start, btypes = [], [], []
    sub_bit, sub_out, sub_blk = [], [], []
    bit_off = out_off = blk_off = 0
    for si, (r, nbits, out_len) in enumerate(zip(shard_results,
                                                 shard_comp_bits,
                                                 shard_out_lens)):
        nbits, out_len = int(nbits), int(out_len)
        if "sub_overflow" in r and bool(_np(r["sub_overflow"])):
            raise DeflateError(
                "E_INDEX", f"shard {si}: sub-entry capacity overflow — "
                "index would be silently incomplete")
        n = int(_np(r["n_blocks"]))
        bit_base += list(_np(r["block_bit_base"])[:n] + bit_off)
        out_start += list(_np(r["block_out_start"])[:n] + out_off)
        btypes += list(_np(r["btype"])[:n])
        if "sub_bit" in r:
            sb, so, sk = (_np(r[k]) for k in ("sub_bit", "sub_out",
                                               "sub_blk"))
            live = (sk >= 0) & (so < out_len)
            sb, so, sk = sb[live], so[live], sk[live]
            if sub_spacing > 1 and len(so):
                first = np.concatenate([[True], sk[1:] != sk[:-1]])
                keep = first | (so // sub_spacing
                                != np.concatenate([[-1], so[:-1]])
                                // sub_spacing)
                sb, so, sk = sb[keep], so[keep], sk[keep]
            sub_bit += list(sb + bit_off)
            sub_out += list(so + out_off)
            sub_blk += list(sk + blk_off)
        bit_off += -(-nbits // 8) * 8             # shards are byte-aligned
        out_off += out_len
        blk_off += n
    subs = (np.array(sub_bit, np.int64), np.array(sub_out, np.int64),
            np.array(sub_blk, np.int32)) if sub_bit else (None, None, None)
    return DecodeIndex(np.array(bit_base, np.int64),
                       np.array(out_start, np.int64),
                       np.array(btypes, np.uint8), out_off, *subs)


def decompress_indexed(stream: bytes, index: DecodeIndex,
                       shard_out: int = 1 << 20,
                       expected_adler: int | None = None,
                       max_dist: int = C.WINDOW_SIZE, device=None) -> bytes:
    """Decode a raw DEFLATE stream with the device decoder, in groups of
    whole blocks of about `shard_out` output bytes. The previous group's
    last 32 KB rides along as window context, so distances may cross
    group boundaries.

    `expected_adler` (the zlib footer) is checked over the decoded bytes,
    each group's Adler-32 taken on the device and combined on the host;
    `max_dist` bounds distances to the container's declared window. Raises
    DeflateError when a group decodes not ok or the checksum differs. Runs
    on `device` (the CUDA card unless "cpu" is asked for)."""
    from .device_inflate import decode_blocks

    dev = pick_device(device)
    _check_sub_order(index.sub_out)
    W = C.WINDOW_SIZE
    n = index.n_blocks
    have_subs = index.n_subs > 0
    out_parts = []
    prev_tail = torch.zeros(W, dtype=torch.uint8, device=dev)
    plen = 0
    adler = 1
    i = 0
    while i < n:
        j = i
        start = int(index.out_start[i])
        while j < n and (int(index.out_start[j]) - start) < shard_out:
            j += 1
        end_out = int(index.out_start[j]) if j < n else index.out_len
        span = end_out - start
        nb = j - i

        # the decoder reads bits relative to the group's first word
        first_byte = int(index.bit_base[i]) // 8 // 4 * 4
        rest = bytearray(stream[first_byte:])
        rest += b"\x00" * 3
        comp_words = np.frombuffer(rest, np.int32, len(rest) // 4)
        bb = index.bit_base[i:j] - first_byte * 8
        os_ = index.out_start[i:j] - start + plen
        bt = index.btype[i:j].astype(np.int64)
        if have_subs:
            si = int(np.searchsorted(index.sub_blk, i, "left"))
            sj = int(np.searchsorted(index.sub_blk, j, "left"))
            ns = sj - si
            sb = index.sub_bit[si:sj] - first_byte * 8
            so = index.sub_out[si:sj] - start + plen
            sk = index.sub_blk[si:sj].astype(np.int64) - i
        else:
            ns = nb
            sb = np.full(nb, -1, np.int64)
            so = os_
            sk = np.where((bt == C.BTYPE_FIXED) | (bt == C.BTYPE_DYNAMIC),
                          np.arange(nb), -1)
        S = max(plen + span, 1)
        res = decode_blocks(
            torch.from_numpy(comp_words).to(dev), bb, os_, bt,
            nb, sb, so, sk, ns, plen + span, S, prefix=prev_tail,
            prefix_len=plen, max_dist=max_dist)
        if not bool(res["ok"]):
            raise DeflateError("E_BADCODE", "indexed decode failed")
        full = res["out"][:plen + span]
        new = full[plen:]
        if expected_adler is not None:
            adler = adler32_combine(adler, int(adler32_torch(new, span)),
                                    span)
        out_parts.append(new.cpu().numpy().tobytes())
        tail = full[max(0, plen + span - W):]
        prev_tail = torch.zeros(W, dtype=torch.uint8, device=dev)
        prev_tail[:tail.shape[0]] = tail
        plen = tail.shape[0]
        i = j
    if expected_adler is not None and adler != (expected_adler & 0xFFFFFFFF):
        raise DeflateError("E_ADLER",
                           f"adler mismatch {expected_adler:#x} != {adler:#x}")
    return b"".join(out_parts)
