"""The plain reference that decides `correct` in the gzip cells.

CPython's zlib (the format's reference implementation, independent of the
port) inflates a gzip member and checks its CRC-32 and ISIZE; decoded
bytes are compared with the objects in numpy (`reference.bytes_wrong`).
It imports nothing of the port.

Every number is a count of faults, compared exactly (limit 0).
"""
from __future__ import annotations

import zlib

from .reference import bytes_wrong  # noqa: F401  (the gzip cells' too)


def member_valid(member: bytes, obj: bytes) -> bool:
    """Whether a gzip member decodes to `obj` with its footer's CRC-32 and
    ISIZE matching: the verdict a verified decode must give."""
    d = zlib.decompressobj(31)
    try:
        out = d.decompress(member) + d.flush()
    except zlib.error:
        return False
    return d.eof and not d.unused_data and out == obj


def footer_altered(member: bytes, field: str) -> bytes:
    """`member` with one bit of its footer's CRC-32 ("crc32") or ISIZE
    ("isize") flipped."""
    at = {"crc32": -8, "isize": -4}[field]
    b = bytearray(member)
    b[at] ^= 0x01
    return bytes(b)
