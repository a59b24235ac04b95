"""zlib container, RFC 1950 (counterpart of
deflate_compression_tpu/format/containers.py, whose checksum import pulls
JAX in; the zlib half is copied here)."""
from __future__ import annotations

import numpy as np

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


def container_header(container: str) -> bytes:
    if container == "zlib":
        return zlib_header()
    if container == "raw":
        return b""
    raise ValueError(f"unknown container {container!r}")
