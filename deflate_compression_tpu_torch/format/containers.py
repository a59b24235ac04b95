"""Stream containers: zlib (RFC 1950) and gzip (RFC 1952) (counterpart of
deflate_compression_tpu/format/containers.py, whose checksum import pulls
JAX in; copied here with the same bytes and error codes)."""
from __future__ import annotations

import numpy as np

from ..core import checksum
from ..utils.errors import DeflateError
from . import constants as C


def zlib_header(window_size: int = C.WINDOW_SIZE, level_hint: int = 2) -> bytes:
    """CMF/FLG pair with a valid FCHECK."""
    cinfo = max(0, int(np.log2(window_size)) - 8)
    cmf = (cinfo << 4) | C.ZLIB_CM_DEFLATE
    flg = (level_hint & 3) << 6
    rem = ((cmf << 8) | flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg])


def zlib_footer(adler: int) -> bytes:
    return (int(adler) & 0xFFFFFFFF).to_bytes(4, "big")


def zlib_wrap(deflate_stream: bytes, adler: int) -> bytes:
    return zlib_header() + deflate_stream + zlib_footer(adler)


def gzip_header() -> bytes:
    """Minimal gzip member header: magic, CM=8, no flags, zero mtime,
    XFL=0, OS=255."""
    return C.GZIP_MAGIC + bytes([8, 0, 0, 0, 0, 0, 0, 255])


def gzip_footer(crc: int, isize: int) -> bytes:
    return (int(crc) & 0xFFFFFFFF).to_bytes(4, "little") + \
        (isize & 0xFFFFFFFF).to_bytes(4, "little")


def gzip_wrap(deflate_stream: bytes, crc: int, isize: int) -> bytes:
    return gzip_header() + deflate_stream + gzip_footer(crc, isize)


def container_header(container: str) -> bytes:
    if container == "zlib":
        return zlib_header()
    if container == "gzip":
        return gzip_header()
    if container == "raw":
        return b""
    raise ValueError(f"unknown container {container!r}")


def gzip_parse_header(data: bytes) -> int:
    """Return the offset where the DEFLATE stream begins."""
    if len(data) < 10 or data[:2] != C.GZIP_MAGIC:
        raise DeflateError("E_HDR", "not a gzip stream")
    if data[2] != 8:
        raise DeflateError("E_HDR", f"unsupported gzip CM {data[2]}")
    flg = data[3]
    off = 10
    if flg & 0x04:  # FEXTRA
        if off + 2 > len(data):
            raise DeflateError("E_TRUNC", "truncated FEXTRA")
        xlen = int.from_bytes(data[off:off + 2], "little")
        off += 2 + xlen
    if flg & 0x08:  # FNAME
        off = data.index(b"\0", off) + 1
    if flg & 0x10:  # FCOMMENT
        off = data.index(b"\0", off) + 1
    if flg & 0x02:  # FHCRC
        off += 2
    if off > len(data):
        raise DeflateError("E_TRUNC", "truncated gzip header")
    return off


def gzip_decompress(data: bytes) -> bytes:
    """Inflate a gzip member on the host (the native inflater where it
    builds), checking its CRC-32 and ISIZE."""
    from ..decode.inflate import inflate_raw
    off = gzip_parse_header(data)
    out, end_bits = inflate_raw(data, 8 * off)
    foot = (end_bits + 7) // 8
    if foot + 8 > len(data):
        raise DeflateError("E_TRUNC", "missing gzip footer")
    want_crc = int.from_bytes(data[foot:foot + 4], "little")
    want_isize = int.from_bytes(data[foot + 4:foot + 8], "little")
    got_crc = checksum.crc32_np(out)
    if got_crc != want_crc:
        raise DeflateError("E_ADLER", f"gzip crc mismatch {want_crc:#x}!={got_crc:#x}")
    if want_isize != (len(out) & 0xFFFFFFFF):
        raise DeflateError("E_SIZE", "gzip ISIZE mismatch")
    return out
