"""The benchmark's objects, made from a seed in vectorised numpy.

A pass is the objects of a list that the traffic mix names
(`data/silesia.json`: the sizes of the Silesia corpus's twelve files),
each filled with one synthetic kind of data chosen to match its
namesake. The kinds are a frozen copy of the port's
corpus generator (text, C++, random, a tiled pattern, RGB triples, zero
runs, and the mix of them all); the text and C++ bytes come from the
snapshots in `data/` (zlib-compressed), so nothing outside this folder
moves the inputs. Sizes never change with the seed; the content does:
the text kinds are the snapshot's lines in orders drawn from the seed,
the others are drawn from it.
"""
from __future__ import annotations

import json
import zlib
from functools import cache
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
DATA = HERE / "data"
SILESIA = "data/silesia.json"
PERIOD = 1 << 20         # bytes of fresh line orders before a text repeats
KINDS = ("text", "cpp", "random", "periodic", "zeros", "rgb", "mixed")


def objects(listed: str = SILESIA) -> list[dict]:
    """The pass's objects in their fixed order: name, size, kind, why;
    `listed` is the list's path under this folder."""
    return json.loads((HERE / listed).read_text())["objects"]


@cache
def snapshot(kind: str) -> bytes:
    """The frozen text (`text`) or C++ (`cpp`) bytes."""
    return zlib.decompress((DATA / f"{kind}.zz").read_bytes())


def _line_table(src: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`src` as u8 and the start and length of each of its lines."""
    a = np.frombuffer(src, np.uint8)
    ends = np.flatnonzero(a == 10) + 1
    starts = np.concatenate([[0], ends])
    ends = np.concatenate([ends, [a.size]])
    keep = ends > starts
    return a, starts[keep], (ends - starts)[keep]


def _gather_lines(a, starts, lens, order) -> np.ndarray:
    """The bytes of the lines `order` (indices into starts/lens), in turn."""
    lens = lens[order]
    first = np.repeat(starts[order] - np.cumsum(lens) + lens, lens)
    return a[first + np.arange(lens.sum())]


def _shuffled_lines(src: bytes, rng: np.random.Generator) -> np.ndarray:
    """`src`'s lines in an order drawn from `rng`, as u8."""
    a, starts, lens = _line_table(src)
    return _gather_lines(a, starts, lens, rng.permutation(starts.size))


def _lines_to(src: bytes, n: int, rng: np.random.Generator) -> np.ndarray:
    """u8[n]: `src`'s lines in a fresh order drawn from `rng` for every
    repeat of the snapshot over a period of at least 1 MiB, tiled to n.
    The C++ snapshot is 19 KB, inside DEFLATE's 32 KiB window: one order
    tiled would let every shard be coded as one run of copies."""
    a, starts, lens = _line_table(src)
    reps = min(-(-PERIOD // int(lens.sum())), -(-n // int(lens.sum())))
    order = np.argsort(rng.random((reps, starts.size)), axis=1).reshape(-1)
    return np.resize(_gather_lines(a, starts, lens, order), n)


def _mixed(n: int, rng: np.random.Generator) -> np.ndarray:
    """The corpus mix: text, 64 KB random, C++, a tiled 64-byte pattern,
    RGB triples and a zero run, repeated to n bytes; the text and the C++
    in a line order drawn from `rng`."""
    text = _shuffled_lines(snapshot("text"), rng)
    cpp = _shuffled_lines(snapshot("cpp"), rng)
    parts, size = [], 0
    while size < n:
        rgb = rng.integers(0, 256, (64, 3), dtype=np.uint8)
        pieces = [
            text,
            rng.integers(0, 256, 65536, dtype=np.uint8),
            cpp,
            np.tile(rng.integers(0, 256, 64, dtype=np.uint8), 1024),
            rgb[rng.integers(0, 64, 40000)].reshape(-1),
            np.zeros(int(rng.integers(20000, 120000)), np.uint8),
        ]
        parts += pieces
        size += sum(p.size for p in pieces)
    return np.concatenate(parts)[:n]


def sample(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """u8[n] of one kind, drawn from `rng`."""
    if kind in ("text", "cpp"):
        return _lines_to(snapshot(kind), n, rng)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "periodic":
        return np.resize(rng.integers(0, 256, 64, dtype=np.uint8), n)
    if kind == "zeros":
        # long zero runs broken by 64-byte random bursts
        out = np.zeros(n + 64, np.uint8)
        at = rng.integers(0, n, max(n // 8192, 1))
        out[at[:, None] + np.arange(64)] = rng.integers(
            0, 256, (at.size, 64), dtype=np.uint8)
        return out[:n]
    if kind == "rgb":
        palette = rng.integers(0, 256, (64, 3), dtype=np.uint8)
        return palette[rng.integers(0, 64, n // 3 + 1)].reshape(-1)[:n]
    if kind == "mixed":
        return _mixed(n, rng)
    raise ValueError(f"unknown kind {kind!r}")


def make(seed: int, scale: int = 1, listed: str = SILESIA) -> list[bytes]:
    """The pass's objects for `seed`, in the fixed order. Each object has
    its own stream of random numbers, from (seed, its index). `scale`
    divides every size (tests run at a small size)."""
    out = []
    for i, o in enumerate(objects(listed)):
        rng = np.random.default_rng([int(seed) & (2**63 - 1), i])
        out.append(sample(o["kind"], max(1, o["size"] // scale), rng)
                   .tobytes())
    return out
