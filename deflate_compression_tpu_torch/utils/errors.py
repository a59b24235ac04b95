"""Namespaced errors of the port: a numeric code in a domain (bits 24 and
up) beside a symbolic name, the same codes and message form as
deflate_compression_tpu/utils/errors.py.
"""
from __future__ import annotations

DOMAIN_GLOBAL = 0x0000000
DOMAIN_DEFLATE = 0x1000000
DOMAIN_PNG = 0x2000000


class CodecError(Exception):
    """Base error; carries a namespaced numeric code."""

    domain = DOMAIN_GLOBAL
    _names: dict[str, int] = {}

    def __init__(self, name: str, message: str = ""):
        self.name = name
        self.code = self.domain | self._names.get(name, 0xFFFF)
        super().__init__(f"{name} ({self.code:#09x}): {message}")


class DeflateError(CodecError):
    domain = DOMAIN_DEFLATE
    _names = {n: i for i, n in enumerate([
        "E_HDR", "E_FDICT", "E_BTYPE", "E_STORED", "E_TREE", "E_BADCODE",
        "E_SYM", "E_DIST", "E_SIZE", "E_ADLER", "E_TRUNC", "E_INDEX",
        "E_SELFCHECK",
    ])}


class PngError(CodecError):
    domain = DOMAIN_PNG
    _names = {n: i for i, n in enumerate([
        "E_SIG", "E_CHLEN", "E_CHNAME", "E_CRC", "E_ORDER", "E_MULT",
        "E_IHDR", "E_PLTE", "E_IDAT", "E_DEPTH", "E_FILTER", "E_INTERLACE",
        "E_TEXT", "E_EOF",
    ])}
