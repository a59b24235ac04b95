"""The plain reference that decides `correct`.

It works from the objects the benchmark made and judges what the port
produced: a zlib stream is inflated piece by piece by CPython's zlib (the
format's reference implementation, independent of the port), decoded
bytes are compared with the objects in numpy, and Adler-32 is zlib's. It
imports nothing of the port.

Every number is a count of faults, compared exactly (limit 0).
"""
from __future__ import annotations

import zlib

import numpy as np

SYNC = b"\x00\x00\xff\xff"       # an empty stored block's LEN and NLEN


def bytes_wrong(got, want: bytes) -> int:
    """Bytes of `want` that `got` does not reproduce: the positions that
    differ plus the length difference."""
    g = np.frombuffer(got, np.uint8) if not isinstance(got, np.ndarray) \
        else got.reshape(-1)
    w = np.frombuffer(want, np.uint8)
    n = min(g.size, w.size)
    return int(np.count_nonzero(g[:n] != w[:n])) + abs(g.size - w.size)


def adler32(data) -> int:
    return zlib.adler32(data) & 0xFFFFFFFF


def shard_adlers(obj: bytes, shard: int) -> list[int]:
    """The Adler-32 of each `shard`-byte piece of `obj`."""
    mv = memoryview(obj)
    return [adler32(mv[s:s + shard]) for s in range(0, len(obj), shard)]


def _sync_ends(body: bytes) -> np.ndarray:
    """Offsets just past each occurrence of an empty stored block's
    LEN/NLEN in `body`: where a byte-aligned piece may end."""
    b = np.frombuffer(body, np.uint8)
    if b.size < 4:
        return np.zeros(0, np.int64)
    hit = (b[:-3] == 0) & (b[1:-2] == 0) & (b[2:-1] == 255) & (b[3:] == 255)
    return np.flatnonzero(hit) + 4


def _pieces(body: bytes, n: int, shard: int):
    """Inflate `body` as independent pieces, one a shard: each piece starts
    a fresh inflater with no window and ends at the first empty stored
    block after which it has written exactly its shard. Returns the
    pieces' output and the number of shards that ended no such piece."""
    nsh = max(1, -(-n // shard))
    ends = _sync_ends(body)
    out, start, ci = [], 0, 0
    for k in range(nsh - 1):
        d = zlib.decompressobj(-15)
        got, size, prev, found = [], 0, start, False
        while ci < ends.size:
            c = int(ends[ci])
            ci += 1
            try:
                chunk = d.decompress(body[prev:c])
            except zlib.error:
                break
            got.append(chunk)
            size += len(chunk)
            prev = c
            if size >= shard:
                found = size == shard
                break
        if not found:
            return None, nsh - 1 - k
        out.append(b"".join(got))
        start = prev
    d = zlib.decompressobj(-15)
    try:
        last = d.decompress(body[start:]) + d.flush()
    except zlib.error:
        return None, 0
    if not d.eof or d.unused_data:
        return None, 0
    out.append(last)
    return b"".join(out), 0


def check_zlib(blob: bytes, obj: bytes, shard: int) -> dict:
    """A zlib stream against the object it encodes, under the
    configuration's guarantees: `bytes_wrong` (bytes the stream does not
    reproduce), `shards_not_independent` (shard boundaries where the
    stream does not split into a byte-aligned piece that inflates with no
    earlier window) and `container_wrong` (a bad header, a wrong Adler-32
    in the footer)."""
    bad_container = 0
    if len(blob) < 6:
        return {"bytes_wrong": len(obj), "shards_not_independent": 0,
                "container_wrong": 2}
    cmf, flg = blob[0], blob[1]
    if (cmf & 0x0F) != 8 or (cmf >> 4) > 7 or (cmf << 8 | flg) % 31 \
            or flg & 0x20:
        bad_container += 1
    if int.from_bytes(blob[-4:], "big") != adler32(obj):
        bad_container += 1
    body = blob[2:-4]
    out, not_indep = _pieces(body, len(obj), shard)
    if out is None:                   # judge the bytes as one stream
        d = zlib.decompressobj(-15)
        try:
            out = d.decompress(body) + d.flush()
        except zlib.error:
            out = b""
    return {"bytes_wrong": bytes_wrong(out, obj),
            "shards_not_independent": not_indep,
            "container_wrong": bad_container}


def stream_valid(stream: bytes, adler: int, obj: bytes) -> bool:
    """Whether a raw DEFLATE stream and its zlib footer's Adler-32 decode
    to `obj`: the verdict a verified decode must give."""
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(stream) + d.flush()
    except zlib.error:
        return False
    return d.eof and out == obj and adler == adler32(obj)
