"""Phase C's bytes, from the tokens to the resolved output: CUDA kernel
wrapper and its plain version.

Counterpart of the JAX decoder's phase C (decode/tpu_inflate.py:600-841),
which the JAX package left to XLA: it has no Pallas kernel. Per output
position: the literal or prefix value; the live-block coverage and the
covering block's stored flag; the stored blocks' byte copies, later blocks
winning; the covering token and its distance; the source pointer with
same-distance runs collapsed to one step; the pointer-doubling rounds that
resolve every position to a byte; and the bytes at or past `valid_out` set
to 0. The kernels (`csrc/copy_sources.cu`: the blocks ranked by start, one
pass over the tokens, and the rounds in one persistent kernel that stops
when no pointer is left) are built at first use by `ops/cuda_build.py` and
called through ctypes on PyTorch's current stream; the call waits for
nothing on the device.

`resolve_bytes` launches its kernels for CUDA tensors and raises if it
cannot; it takes the plain version `resolve_bytes_ref` only for tensors
that lie on the CPU. `resolve_bytes.launches` counts the calls that
launched.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "copy_sources.cu"
WSTO = 1 << 16                                # a stored block's byte cap
TILE = 2048                                   # positions per CTA (kTile)
MAX_OUT = (1 << 31) - 1 - TILE                # int32 positions in the kernels


def max_rounds(out_size: int) -> int:
    """The bound on pointer-doubling rounds: every source lies before its
    position, so a chain halves each round."""
    return int(np.ceil(np.log2(max(int(out_size), 2)))) + 2


@functools.cache
def _bind():
    """The launch function and the scratch-size query, bound once, and the
    raw current-stream lookup."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = cuda_build.load(SOURCE, {
        "copy_sources_scratch_bytes": [i64, i64, ctypes.POINTER(i64)],
        "copy_sources_launch": [
            vp, i64, vp, i64, vp, vp, vp, vp, vp, i64, vp, i64, vp, i64, vp,
            i64, i64, vp, vp, vp, ctypes.c_int, vp]})
    return (lib.copy_sources_launch, lib.copy_sources_scratch_bytes,
            cuda_build.raw_stream())


def resolve_bytes_ref(w, tok, blk_bit, blk_out, blk_end, blive, is_sto,
                      out_size: int, prefix=None, prefix_len=None,
                      valid_out=None, stats: dict | None = None):
    """Plain version of the kernels. Arguments and results as for
    `resolve_bytes`; `stats`, if given, receives the rounds run and the
    tagged positions each round gathered (it waits for the device each
    round)."""
    dev = tok.device
    S = int(out_size)
    NB = blk_bit.shape[0]
    j = torch.arange(S, device=dev)
    t = tok[:S].long()
    t_valid = ((t >> 25) & 1) == 1
    t_match = ((t >> 26) & 1) == 1

    if prefix is not None:
        plen = torch.as_tensor(prefix_len, device=dev).to(torch.int64)
        pref = torch.zeros(S, dtype=torch.int64, device=dev)
        pw = min(prefix.shape[0], S)
        pref[:pw] = prefix[:pw].to(dev).long()
        lit_val = torch.where(j < plen, pref, 0)
    else:
        plen = torch.zeros((), dtype=torch.int64, device=dev)
        lit_val = torch.zeros(S, dtype=torch.int64, device=dev)
    lit_val = torch.where(t_valid & ~t_match, t & 0x1FF, lit_val)

    # live-block coverage and the covering block's stored flag: a packed
    # word scattered at each block start and forward-filled by cummax
    blanes = torch.arange(NB, device=dev)
    ok_start = blive & (blk_out >= 0) & (blk_out < S)
    start = torch.where(ok_start, blk_out, S)
    cend = torch.zeros(S + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, start, torch.where(blive, blk_end, 0), "amax")[:S]
    pos_live = j < torch.cummax(cend, 0).values
    markv = ((blanes + 1) << 1) | is_sto.long()
    pc = torch.zeros(S + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, start, torch.where(blive, markv, 0), "amax")[:S]
    pc = torch.cummax(pc, 0).values
    pos_sto = ((pc & 1) == 1) & (j >= plen) & ((pc >> 1) > 0)

    # stored payloads: one contiguous slice copy per live stored block, in
    # block order (later blocks win, as in the JAX fori_loop)
    sto = torch.nonzero(is_sto).squeeze(1)
    if sto.numel():
        CW = w.shape[0]
        shifts = torch.arange(0, 32, 8, device=dev)
        cbytes = torch.cat([((w.unsqueeze(1) >> shifts) & 0xFF).reshape(-1),
                            w.new_zeros(WSTO)])
        lv = torch.cat([lit_val, lit_val.new_zeros(WSTO)])
        src = (((blk_bit[sto] + 3 + 7) >> 3) + 4).clamp(0, 4 * CW)
        dst = blk_out[sto].clamp(0, S)
        n = (blk_end[sto] - blk_out[sto]).clamp(0, WSTO)
        for s0, d0, k in zip(src.tolist(), dst.tolist(), n.tolist()):
            lv[d0:d0 + k] = cbytes[s0:s0 + k]
        lit_val = lv[:S]

    # covering token per position; same-distance runs collapse to one step
    s_j = torch.cummax(torch.where(t_valid, j, -1), 0).values
    t_cov = t[s_j.clamp(min=0)]
    d_j = torch.where((s_j >= 0) & (((t_cov >> 26) & 1) == 1),
                      (t_cov >> 9) & 0xFFFF, 0)
    mpos = (d_j > 0) & ~pos_sto & (j >= plen) & pos_live
    rd = torch.where(mpos, d_j, 0)
    prev_rd = torch.cat([rd.new_full((1,), -1), rd[:-1]])
    r = torch.cummax(torch.where(rd != prev_rd, j, -1), 0).values
    base = r - rd
    g = base + torch.where(mpos, (j - base) % rd.clamp(min=1), 0)
    bad_dist = (mpos & (g < 0)).any()

    # tagged-value pointer doubling: v is a resolved byte or TAG | source
    tag_bit = max(24, int(S - 1).bit_length())
    TAG = 1 << tag_bit
    v = torch.where(mpos & (g >= 0), TAG | g.clamp(0, max(S - 1, 0)), lit_val)
    tag = (v & TAG) != 0
    rounds = []
    for _ in range(max_rounds(S)):
        if not bool(tag.any()):
            break
        if stats is not None:
            rounds.append(int(tag.sum()))
        v = torch.where(tag, v[(v & (TAG - 1)).clamp(max=max(S - 1, 0))], v)
        tag = (v & TAG) != 0
    if stats is not None:
        stats["tagged"] = rounds
        stats["stored_bytes"] = int(n.sum()) if sto.numel() else 0
    out = (v & 0xFF).to(torch.uint8)
    if valid_out is not None:
        out = torch.where(j < torch.as_tensor(valid_out, device=dev), out, 0)
    return out, bad_dist, tag.any()


def _check(w, tok, blk_bit, blk_out, blk_end, blive, is_sto, S) -> None:
    dev = tok.device
    if tok.dtype != torch.int32 or tok.dim() != 1 or tok.shape[0] < S:
        raise TypeError(f"tok must be 1-D int32 of at least {S} tokens")
    if w.dtype != torch.int64 or w.dim() != 1 or w.device != dev:
        raise TypeError(f"w must be 1-D int64 (u32 values) on {dev}")
    NB = blk_bit.shape[0]
    for name, t, dt in (("blk_bit", blk_bit, torch.int64),
                        ("blk_out", blk_out, torch.int64),
                        ("blk_end", blk_end, torch.int64),
                        ("blive", blive, torch.bool),
                        ("is_sto", is_sto, torch.bool)):
        if t.dtype != dt or t.shape != (NB,) or t.device != dev:
            raise ValueError(f"{name} must be {dt}[{NB}] on {dev}")


def _scalar(x, dev, name):
    """(device pointer, 0) for one int64 on dev, else (None, int(x))."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1 or x.device != dev or x.dtype != torch.int64:
            raise ValueError(f"{name} must be an int or one int64 on {dev}")
        return x.data_ptr(), 0
    return None, int(x)


def resolve_bytes(w, tok, blk_bit, blk_out, blk_end, blive, is_sto,
                  out_size: int, prefix=None, prefix_len=None,
                  valid_out=None, stats: dict | None = None):
    """The decoded byte of every output position.

    w: i64[CW] stream words (u32 values). tok: i32[>= out_size] packed
    tokens (ops/decode_symbols.py: bit 25 valid, bit 26 match, bits 9-24
    distance, low 9 bits literal). Per block slot (NB): blk_bit, blk_out,
    blk_end (int64: header bit, output start and end), blive and is_sto
    (bool). prefix (u8) occupies output [0, prefix_len), prefix_len an int
    or one int64 on tok's device. valid_out (an int or one int64 on tok's
    device, default out_size): the bytes at or past it are 0. Returns
    (v u8[out_size], bad_dist, unconverged): a match reached before the
    output start, and pointers left after the round bound (both 0-dim
    bool). A CUDA tensor goes through the kernels (or this raises); a CPU
    tensor through `resolve_bytes_ref`. `stats`, if given, receives the
    gather rounds the kernels ran (`rounds`; it waits for the device) or
    the plain version's stats."""
    S = int(out_size)
    _check(w, tok, blk_bit, blk_out, blk_end, blive, is_sto, S)
    dev = tok.device
    if dev.type == "cpu":
        return resolve_bytes_ref(w, tok, blk_bit, blk_out, blk_end, blive,
                                 is_sto, S, prefix, prefix_len, valid_out,
                                 stats)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if S > MAX_OUT:
        raise ValueError(f"out_size {S} is past the kernels' int32 positions")
    NB = blk_bit.shape[0]
    vo_ptr, vo_val = _scalar(S if valid_out is None else valid_out, dev,
                             "valid_out")
    if prefix is None:
        pre_ptr, pre_n, pl_ptr, pl_val = None, 0, None, 0
    else:
        prefix = prefix.to(dev).contiguous()
        if prefix.dtype != torch.uint8 or prefix.dim() != 1:
            raise TypeError("prefix must be 1-D uint8")
        pre_ptr, pre_n = prefix.data_ptr(), min(prefix.shape[0], S)
        pl_ptr, pl_val = _scalar(prefix_len, dev, "prefix_len")
    launch, scratch_bytes, stream = _bind()
    n = ctypes.c_int64()
    rc = scratch_bytes(S, NB, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"copy_sources scratch size failed: cudaError {rc}")
    # the scratch's first ints: bad_dist, unconverged, ..., rounds run (9)
    scratch = torch.empty(max(n.value, 64), dtype=torch.uint8, device=dev)
    head = scratch[:64].view(torch.int32)
    out = torch.empty(S, dtype=torch.uint8, device=dev)
    if S == 0:
        head.zero_()
        if stats is not None:
            stats["rounds"] = 0
        return out, head[0] != 0, head[1] != 0
    v = torch.empty(S, dtype=torch.int32, device=dev)
    w, tok, blk_bit, blk_out, blk_end, blive, is_sto = (
        x.contiguous() for x in (w, tok, blk_bit, blk_out, blk_end, blive,
                                 is_sto))
    rc = launch(w.data_ptr(), w.shape[0], tok.data_ptr(), S,
                blk_bit.data_ptr(), blk_out.data_ptr(), blk_end.data_ptr(),
                blive.data_ptr(), is_sto.data_ptr(), NB, pre_ptr, pre_n,
                pl_ptr, pl_val, vo_ptr, vo_val, max_rounds(S), v.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), dev.index,
                stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"copy_sources launch failed: cudaError {rc}")
    resolve_bytes.launches += 1
    if stats is not None:
        stats["rounds"] = int(head[9])
    return out, head[0] != 0, head[1] != 0


resolve_bytes.launches = 0
