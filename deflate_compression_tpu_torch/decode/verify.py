"""Stream verifier (counterpart of deflate_compression_tpu/decode/verify.py,
copied with its reports, checks and error codes).

`replay_stream` walks a raw DEFLATE stream token by token and replays each
token against a 32 KB ring (not the whole output, so a token whose
distance passes the real window is caught even where a whole-buffer
inflater would accept it). `verify_stream` adds the container parse, a
cross-check against the port's own inflater (decode/inflate.py) and
CPython's zlib, and the container checksum. Both run on the host; the
codec's self-check replays each shard with `replay_stream` right after the
card encodes it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.bits import BitReader
from ..format import constants as C
from ..utils.errors import DeflateError

_RING = C.WINDOW_SIZE            # 32 KB ring


@dataclasses.dataclass
class BlockReport:
    btype: int
    bits: int
    out_bytes: int
    n_tokens: int
    n_lits: int
    n_matches: int
    max_dist: int


def replay_stream(body: bytes, bit_pos: int = 0,
                  stop_at_bits: int | None = None):
    """Walk a raw DEFLATE stream token by token, replaying each against a
    32 KB ring buffer. Returns (output bytes, end_bit_pos,
    [BlockReport...]). Raises DeflateError on any malformed structure or a
    token not resolvable from the ring.

    `stop_at_bits` bounds the walk to a substream: the block loop ends
    (without requiring BFINAL) once the cursor reaches it, as the codec's
    self-check needs for a shard that ends with a BFINAL=0 sync flush.

    Truncation is an error, never a hang: BitReader.peek zero-pads past the
    end, and an all-zeros prefix can decode as a literal forever, so the
    symbol loop raises E_TRUNC once the cursor passes the last real bit."""
    from .inflate import _FIXED_D_LUT, _FIXED_LL_LUT, _read_dynamic_tables

    r = BitReader(body, bit_pos)
    limit = 8 * len(body) if stop_at_bits is None else min(
        stop_at_bits, 8 * len(body))
    ring = bytearray(_RING)
    wpos = 0                     # ring write cursor
    total = 0                    # bytes emitted so far
    out = bytearray()
    reports = []

    def put(b: int):
        nonlocal wpos, total
        ring[wpos] = b
        wpos = (wpos + 1) % _RING
        total += 1
        out.append(b)

    while True:
        if stop_at_bits is not None and r.pos >= stop_at_bits:
            break                      # substream replay: clean end, no BFINAL
        start = r.pos
        bfinal = r.read(1)
        btype = r.read(2)
        if btype == 3:
            raise DeflateError("E_BTYPE", "reserved BTYPE=3")
        n_tok = n_lit = n_match = 0
        out0 = total
        maxd = 0
        if btype == C.BTYPE_STORED:
            r.align_byte()
            ln = r.read(16)
            nlen = r.read(16)
            if ln != (~nlen & 0xFFFF):
                raise DeflateError("E_STORED", "LEN != ~NLEN")
            for b in r.read_bytes(ln):
                put(b)
            n_tok = n_lit = ln
        else:
            if btype == C.BTYPE_FIXED:
                (ll_sym, ll_len), (d_sym, d_len) = _FIXED_LL_LUT, _FIXED_D_LUT
            else:
                (ll_sym, ll_len), (d_sym, d_len) = _read_dynamic_tables(r)
            while True:
                if r.pos >= limit:
                    raise DeflateError(
                        "E_TRUNC", f"stream truncated mid-block at bit {r.pos}")
                idx = r.peek(15)
                cl = ll_len[idx]
                if cl == 0:
                    raise DeflateError("E_BADCODE", "invalid code")
                r.skip(int(cl))
                s = int(ll_sym[idx])
                if s < 256:
                    put(s)
                    n_tok += 1
                    n_lit += 1
                elif s == 256:
                    break
                else:
                    if s > 285:
                        raise DeflateError("E_SYM", f"bad length symbol {s}")
                    li = s - 257
                    length = int(C.LENGTH_BASE[li]) + r.read(
                        int(C.LENGTH_EXTRA[li]))
                    didx = r.peek(15)
                    dl = d_len[didx]
                    if dl == 0:
                        raise DeflateError("E_BADCODE", "invalid dist code")
                    r.skip(int(dl))
                    ds = int(d_sym[didx])
                    if ds > 29:
                        raise DeflateError("E_SYM", f"bad dist symbol {ds}")
                    dist = int(C.DIST_BASE[ds]) + r.read(int(C.DIST_EXTRA[ds]))
                    if dist > total:
                        raise DeflateError(
                            "E_DIST", f"token (len={length}, dist={dist}) "
                            f"reaches before output start at byte {total}")
                    if dist > _RING:
                        raise DeflateError(
                            "E_DIST", f"token dist {dist} exceeds the 32 KB "
                            "ring window")
                    # ring replay, byte at a time (overlapping copies fall
                    # out naturally)
                    for _ in range(length):
                        put(ring[(wpos - dist) % _RING])
                    n_tok += 1
                    n_match += 1
                    maxd = max(maxd, dist)
        reports.append(BlockReport(btype, r.pos - start, total - out0,
                                   n_tok, n_lit, n_match, maxd))
        if bfinal:
            break
    return bytes(out), r.pos, reports


def verify_stream(data: bytes, original: bytes | None = None):
    """Full verification of a compressed file: container parse, ring
    replay, own-inflater cross-check, CPython zlib cross-check, container
    checksum, optional comparison with the original.

    Returns (reports, checks) where checks is a list of (name, ok, detail).
    """
    import zlib as _zlib

    from ..core import checksum as ck
    from .inflate import inflate_raw

    checks = []
    body = data
    bit_pos = 0
    want_adler = want_crc = want_isize = None
    max_dist = C.WINDOW_SIZE
    if data[:2] == C.GZIP_MAGIC:
        from ..format.containers import gzip_parse_header
        bit_pos = 8 * gzip_parse_header(data)
        want_crc = int.from_bytes(data[-8:-4], "little")
        want_isize = int.from_bytes(data[-4:], "little")
    elif len(data) >= 2 and (data[0] & 0x0F) == 8 and \
            ((data[0] << 8) | data[1]) % 31 == 0:
        bit_pos = 16
        max_dist = 1 << ((data[0] >> 4) + 8)
        want_adler = int.from_bytes(data[-4:], "big")

    out, end_bits, reports = replay_stream(body, bit_pos)

    # declared-window bound (zlib containers can declare < 32 KB)
    over = max((rep.max_dist for rep in reports), default=0)
    checks.append(("window", over <= max_dist,
                   f"max dist {over} <= declared window {max_dist}"))

    # own inflater (native C++ where it builds, else the Python oracle)
    try:
        own, _ = inflate_raw(body, bit_pos, max_dist=max_dist)
        checks.append(("own-inflater", own == out,
                       f"{len(own)} bytes, match={own == out}"))
    except DeflateError as e:
        checks.append(("own-inflater", False, str(e)))

    # CPython zlib oracle
    try:
        raw_body = body[bit_pos // 8:] if bit_pos % 8 == 0 else None
        if raw_body is not None:
            z = _zlib.decompress(raw_body, wbits=-15)
            checks.append(("zlib-oracle", z == out,
                           f"{len(z)} bytes, match={z == out}"))
    except _zlib.error as e:
        checks.append(("zlib-oracle", False, str(e)))

    if want_adler is not None:
        got = ck.adler32_np(np.frombuffer(out, np.uint8))
        checks.append(("adler32", got == want_adler,
                       f"{got:#010x} vs {want_adler:#010x}"))
    if want_crc is not None:
        got = ck.crc32_np(out)
        ok = got == want_crc and (len(out) & 0xFFFFFFFF) == want_isize
        checks.append(("crc32/isize", ok, f"{got:#010x} vs {want_crc:#010x}"))

    if original is not None:
        checks.append(("original", out == original,
                       f"{len(out)} vs {len(original)} bytes"))
    return reports, checks
