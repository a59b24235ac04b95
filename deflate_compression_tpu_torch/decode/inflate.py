"""Host zlib/DEFLATE inflater (counterpart of
deflate_compression_tpu/decode/inflate.py, copied with its names, outputs
and error codes).

  * zlib header parse CMF/FLG/FCHECK/FDICT, the CINFO window bounding every
    match distance, and the Adler-32 check;
  * the block loop BFINAL/BTYPE; stored blocks with the LEN/NLEN check;
    fixed tables; dynamic headers with the RLE 16/17/18 runs carried across
    the litlen/dist boundary;
  * the symbol loop with LZ back-copies of overlapping-copy semantics.

Symbols decode through flat canonical LUTs (core/huffman.decode_lut_np):
peek 15 bits, one lookup. `inflate_raw` and `zlib_decompress` take the
repository's native C++ inflater where it builds (native_bridge); the
Python path is the independent oracle. Both run on the host: the card's
decoder is decode/device_inflate.py, behind a decode index.
"""
from __future__ import annotations

import numpy as np

from ..core import checksum
from ..core.bits import BitReader
from ..core.huffman import decode_lut_np
from ..format import constants as C
from ..utils.errors import DeflateError

_FIXED_LL_LUT = decode_lut_np(C.FIXED_LITLEN_LENGTHS, 15)
_FIXED_D_LUT = decode_lut_np(C.FIXED_DIST_LENGTHS, 15)


def _read_symbol(r: BitReader, sym_lut: np.ndarray, len_lut: np.ndarray) -> int:
    idx = r.peek(15)
    l = len_lut[idx]
    if l == 0:
        raise DeflateError("E_BADCODE", "invalid Huffman code in stream")
    r.skip(int(l))
    return int(sym_lut[idx])


def _read_dynamic_tables(r: BitReader):
    """Parse a BTYPE=2 header into (litlen LUT, dist LUT), including RLE
    runs that carry across the litlen/dist boundary."""
    hlit = r.read(5) + 257
    hdist = r.read(5) + 1
    hclen = r.read(4) + 4
    if hlit > 286 or hdist > 30:
        raise DeflateError("E_HDR", f"bad HLIT/HDIST {hlit}/{hdist}")
    clen_lens = np.zeros(19, dtype=np.int64)
    for j in range(hclen):
        clen_lens[C.CLEN_ORDER[j]] = r.read(3)
    try:
        cl_sym, cl_len = decode_lut_np(clen_lens, 7)
    except ValueError as e:
        raise DeflateError("E_TREE", str(e))

    total = hlit + hdist
    lens = np.zeros(total, dtype=np.int64)
    i = 0
    prev = -1
    while i < total:
        idx = r.peek(7)
        l = cl_len[idx]
        if l == 0:
            raise DeflateError("E_BADCODE", "invalid code-length code")
        r.skip(int(l))
        s = int(cl_sym[idx])
        if s < 16:
            lens[i] = s
            prev = s
            i += 1
        elif s == 16:
            if prev < 0:
                raise DeflateError("E_TREE", "repeat with no previous length")
            rep = 3 + r.read(2)
            if i + rep > total:
                raise DeflateError("E_TREE", "repeat overruns code lengths")
            lens[i:i + rep] = prev
            i += rep
        elif s == 17:
            rep = 3 + r.read(3)
            if i + rep > total:
                raise DeflateError("E_TREE", "zero-run overruns code lengths")
            i += rep
            prev = 0
        else:  # 18
            rep = 11 + r.read(7)
            if i + rep > total:
                raise DeflateError("E_TREE", "zero-run overruns code lengths")
            i += rep
            prev = 0
    ll_lens = lens[:hlit]
    d_lens = lens[hlit:]
    if ll_lens[256] == 0:
        raise DeflateError("E_TREE", "no end-of-block code")
    try:
        ll_lut = decode_lut_np(np.pad(ll_lens, (0, 286 - hlit)), 15)
        d_lut = decode_lut_np(np.pad(d_lens, (0, 30 - hdist)), 15)
    except ValueError as e:
        raise DeflateError("E_TREE", str(e))
    return ll_lut, d_lut


def inflate_raw(data: bytes, bit_pos: int = 0,
                max_output: int | None = None,
                prefer_native: bool = True,
                max_dist: int = C.WINDOW_SIZE) -> tuple[bytes, int]:
    """Inflate a raw DEFLATE stream. Returns (decompressed, end_bit_pos).

    `max_dist` bounds match distances to the declared sliding window.
    Takes the native C++ inflater where it builds (and no `max_output` is
    asked for); the Python path below is the independent oracle."""
    if prefer_native and max_output is None:
        from .. import native_bridge
        if native_bridge.available():
            return native_bridge.inflate_raw_native(bytes(data), bit_pos,
                                                    max_dist)
    return _inflate_raw_py(data, bit_pos, max_output, max_dist)


def _inflate_raw_py(data: bytes, bit_pos: int = 0,
                    max_output: int | None = None,
                    max_dist: int = C.WINDOW_SIZE) -> tuple[bytes, int]:
    """Pure-Python inflater (the oracle path)."""
    r = BitReader(data, bit_pos)
    out = bytearray()
    length_base = C.LENGTH_BASE
    length_extra = C.LENGTH_EXTRA
    dist_base = C.DIST_BASE
    dist_extra = C.DIST_EXTRA

    while True:
        bfinal = r.read(1)
        btype = r.read(2)
        if btype == 3:
            raise DeflateError("E_BTYPE", "reserved BTYPE=3")
        if btype == C.BTYPE_STORED:
            r.align_byte()
            ln = r.read(16)
            nlen = r.read(16)
            if ln != (~nlen & 0xFFFF):
                raise DeflateError("E_STORED", "LEN != ~NLEN")
            out += r.read_bytes(ln)
        else:
            if btype == C.BTYPE_FIXED:
                ll_lut, d_lut = _FIXED_LL_LUT, _FIXED_D_LUT
            else:
                ll_lut, d_lut = _read_dynamic_tables(r)
            ll_sym, ll_len = ll_lut
            d_sym, d_len = d_lut
            limit = 8 * len(data)
            while True:
                # truncation guard: peek() zero-pads past the end, and an
                # all-zeros prefix can decode as a literal forever
                if r.pos >= limit:
                    raise DeflateError(
                        "E_TRUNC", f"stream truncated mid-block at bit {r.pos}")
                s = _read_symbol(r, ll_sym, ll_len)
                if s < 256:
                    out.append(s)
                elif s == 256:
                    break
                else:
                    if s > 285:
                        raise DeflateError("E_SYM", f"bad length symbol {s}")
                    li = s - 257
                    length = int(length_base[li]) + r.read(int(length_extra[li]))
                    ds = _read_symbol(r, d_sym, d_len)
                    if ds > 29:
                        raise DeflateError("E_SYM", f"bad distance symbol {ds}")
                    dval = int(dist_base[ds]) + r.read(int(dist_extra[ds]))
                    if dval > len(out):
                        raise DeflateError("E_DIST",
                                           "distance beyond output start")
                    if dval > max_dist:
                        raise DeflateError("E_DIST",
                                           "distance beyond declared window")
                    # overlapping copy, byte-at-a-time semantics
                    start = len(out) - dval
                    if dval >= length:
                        out += out[start:start + length]
                    else:
                        for k in range(length):
                            out.append(out[start + k])
                if max_output is not None and len(out) > max_output:
                    raise DeflateError("E_SIZE", "output exceeds limit")
        if bfinal:
            break
    return bytes(out), r.pos


def zlib_decompress(data: bytes, verify_adler: bool = True) -> bytes:
    """Inflate a zlib (RFC 1950) container on the host: the header's CINFO
    window bounds every distance, and the Adler-32 footer is checked."""
    if len(data) < 6:
        raise DeflateError("E_HDR", "zlib stream too short")
    from .. import native_bridge
    if native_bridge.available():
        return native_bridge.zlib_decompress_native(bytes(data), verify_adler)
    cmf, flg = data[0], data[1]
    if (cmf & 0x0F) != C.ZLIB_CM_DEFLATE:
        raise DeflateError("E_HDR", f"unsupported CM {cmf & 0xF}")
    if ((cmf << 8) | flg) % 31 != 0:
        raise DeflateError("E_HDR", "FCHECK failed")
    if flg & 0x20:
        raise DeflateError("E_FDICT", "FDICT not supported")
    cinfo = cmf >> 4
    if cinfo > 7:
        raise DeflateError("E_HDR", f"bad CINFO {cinfo}")

    # the declared window bounds every match distance
    out, end_bits = inflate_raw(data, 16, max_dist=1 << (cinfo + 8))
    adler_off = (end_bits + 7) // 8
    if verify_adler:
        if adler_off + 4 > len(data):
            raise DeflateError("E_ADLER", "missing adler32 footer")
        want = int.from_bytes(data[adler_off:adler_off + 4], "big")
        got = checksum.adler32_np(np.frombuffer(out, dtype=np.uint8))
        if want != got:
            raise DeflateError("E_ADLER", f"adler mismatch {want:#x}!={got:#x}")
    return out
