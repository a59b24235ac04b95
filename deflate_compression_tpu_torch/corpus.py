"""Seeded test and smoke corpora made from bytes in the repository.

Nothing is downloaded: text comes from SURVEY.md and the JAX package's
Python sources (frozen, so the corpus does not move with the port's code),
C++ from native/deflate_native.cpp, and the binary kinds from a numpy
generator seeded by the caller (the same shape of mix as the JAX package's
bench.py corpus).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .format import constants as C
from .ops.find_matches import HASH_MUL

ROOT = Path(__file__).resolve().parent.parent


def repo_text() -> bytes:
    """SURVEY.md followed by the JAX package's .py sources, in path order."""
    out = [(ROOT / "SURVEY.md").read_bytes()]
    pkg = ROOT / "deflate_compression_tpu"
    out += [p.read_bytes() for p in sorted(pkg.rglob("*.py"))]
    return b"".join(out)


def _fill(src: bytes, n: int) -> np.ndarray:
    reps = n // max(len(src), 1) + 1
    return np.frombuffer(src * reps, dtype=np.uint8)[:n].copy()


def sample(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """u8[n] of one kind of data."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        return _fill(repo_text(), n)
    if kind == "cpp":
        return _fill((ROOT / "native" / "deflate_native.cpp").read_bytes(), n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "periodic":
        return np.resize(rng.integers(0, 256, 64, dtype=np.uint8), n)
    if kind == "zeros":
        # long zero runs broken by short random bursts
        out = np.zeros(n, dtype=np.uint8)
        for start in rng.integers(0, n, max(n // 8192, 1)):
            burst = rng.integers(0, 256, 64, dtype=np.uint8)
            out[start:start + 64] = burst[:n - start]
        return out
    if kind == "rgb":
        palette = rng.integers(0, 256, (64, 3), dtype=np.uint8)
        px = palette[rng.integers(0, 64, n // 3 + 1)].reshape(-1)
        return px[:n].copy()
    if kind == "mixed":
        return np.frombuffer(build_corpus(n, seed), dtype=np.uint8).copy()
    raise ValueError(f"unknown corpus kind {kind!r}")


def build_corpus(total: int, seed: int = 1234) -> bytes:
    """Mixed corpus: text, 64 KB random blocks, C++ source, a tiled
    64-byte pattern, RGB triples and long zero runs, repeated to `total`
    bytes."""
    text = repo_text()
    cpp = (ROOT / "native" / "deflate_native.cpp").read_bytes()
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < total:
        rgb = rng.integers(0, 256, (64, 3), dtype=np.uint8)
        pieces = [
            text,
            rng.integers(0, 256, 65536, dtype=np.uint8).tobytes(),
            cpp,
            np.tile(rng.integers(0, 256, 64, dtype=np.uint8), 1024).tobytes(),
            rgb[rng.integers(0, 64, 40000)].tobytes(),
            bytes(int(rng.integers(20000, 120000))),
        ]
        parts += pieces
        size += sum(len(p) for p in pieces)
    return b"".join(parts)[:total]


# ------------------------------------------- edge cases of the LZ77 stage

def hash_collision() -> tuple:
    """Two different trigrams (as bytes) with one 16-bit hash."""
    tri = np.arange(1 << 20, dtype=np.uint64)
    h = ((tri * HASH_MUL) & 0xFFFFFFFF) >> 16
    order = np.argsort(h, kind="stable")
    j = int(np.flatnonzero(h[order][1:] == h[order][:-1])[0])
    return tuple(int(t).to_bytes(3, "little") for t in order[j:j + 2])


def hash3_np(data: np.ndarray) -> np.ndarray:
    """find_matches' hash of the three bytes at each position (0 past the
    end), in numpy."""
    d = np.concatenate([data, np.zeros(2, np.uint8)]).astype(np.uint64)
    tri = d[:-2] | d[1:-1] << 8 | d[2:] << 16
    return ((tri * HASH_MUL) & 0xFFFFFFFF) >> 16


def _place(n: int, seed: int, parts: dict) -> np.ndarray:
    """n random bytes with each bytes object of `parts` at its offset."""
    out = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    for at, b in parts.items():
        out[at:at + len(b)] = np.frombuffer(b, np.uint8)
    return out


def lz_case(name: str) -> tuple:
    """(data u8[S], valid_len, lazy, num_candidates) of one edge case of
    the LZ77 stage:
    tail_tie      the zero padding past S decides the preselect winner in
                  the shard's last 11 bytes (the farther candidate is
                  followed by zeros, the nearer by nonzero bytes);
    collision_kN  a different trigram of the same hash sits between a
                  position and its true match, using up one of K = N;
    dist_32768    one match exactly 32768 back (allowed), one 32769 back
                  (out of the window);
    clamp_dist    matches cut below 3 bytes by the tile boundary and by
                  valid_len, which keep their dist;
    chain         a 100-byte period over 40 KB: every match chains to 258
                  through all three extension rounds;
    short_valid   valid_len well under S; greedy  lazy=False;
    k1, k255      the bounds of K; s40000  S not a multiple of 32768;
    s1, s2        S under 3;
    long_chains   one trigram every 16 bytes over 64 KB, the bytes after
                  it differing inside 11: every chain there runs the full
                  K (the walk's busiest lanes);
    link_two_tiles  one hash in three consecutive 32 KB tiles: two
                  occurrences in the first (the nearer after the farther),
                  one 32768 after the nearer (a 35-byte match at that
                  distance), one 32769 after that (no link, no match);
    parse_subtile  across every 4 KB edge (the walk's tiles and lz_parse's
                  sub-tiles), lazy on: a 600-byte segment from 200
                  before each even edge, repeated, so a match chained to
                  258 bytes crosses the edge (a 30-byte constant run
                  inside it, 100 past the edge); a 250-byte constant run
                  across each odd edge;
    s36865        S a multiple of neither 4096 nor 32768."""
    rng = np.random.default_rng(len(name))
    W = C.WINDOW_SIZE
    if name == "tail_tie":
        S = 4096
        x = bytes(rng.integers(1, 256, 5, dtype=np.uint8))
        tail = bytes(rng.integers(1, 256, 11, dtype=np.uint8))
        return _place(S, 1, {1000: x + bytes(40), 2000: x + tail,
                             S - 5: x}), S, True, 32
    if name.startswith("collision"):
        t1, t2 = hash_collision()
        body = bytes(rng.integers(0, 256, 20, dtype=np.uint8))
        for seed in range(100):
            d = _place(4096, seed, {1000: t1 + body, 2000: t2 + body[::-1],
                                    3000: t1 + body})
            h = hash3_np(d)
            if (np.flatnonzero(h == h[1000]) == [1000, 2000, 3000]).all():
                return d, 4096, True, int(name[len("collision_k"):])
        raise AssertionError("no filler without a third same-hash position")
    if name == "dist_32768":
        a = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
        b = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
        return _place(70_000, 2, {100: a, 100 + W: a, 200: b,
                                  200 + W + 1: b}), 70_000, True, 32
    if name == "clamp_dist":
        r = bytes(rng.integers(0, 256, 60, dtype=np.uint8))
        S, vl = 2 * W, 2 * W - 1000
        return _place(S, 3, {100: r, W - 10: r, 5000: r, vl - 2: r}), vl, \
            True, 32
    if name == "chain":
        period = np.resize(rng.integers(0, 256, 100, dtype=np.uint8), 40_000)
        return period, 40_000, True, 32
    if name == "short_valid":
        return sample("mixed", 1 << 16, seed=4), 12_345, True, 32
    if name == "greedy":
        return sample("text", 1 << 16, seed=4), 1 << 16, False, 32
    if name in ("k1", "k255"):
        return (sample("mixed", 1 << 16, seed=6), (1 << 16) - 77, True,
                int(name[1:]))
    if name == "s40000":
        return sample("mixed", 40_000, seed=7), 40_000, True, 32
    if name in ("s1", "s2"):
        n = int(name[1:])
        return np.frombuffer(b"aa"[:n], np.uint8).copy(), n, True, 32
    if name == "long_chains":
        S = 1 << 16
        out = np.random.default_rng(9).integers(0, 256, S, dtype=np.uint8)
        out.reshape(-1, 16)[:, :3] = [7, 11, 13]
        return out, S, True, 32
    if name == "link_two_tiles":
        S = 100_000
        tri = bytes(rng.integers(0, 256, 3, dtype=np.uint8))
        near, far = (tri + bytes(rng.integers(0, 256, 40, dtype=np.uint8))
                     for _ in range(2))
        at = [30_000, 31_000, 31_000 + W, 31_000 + 2 * W + 1]
        for seed in range(100):
            d = _place(S, seed, {at[0]: far, at[1]: near, at[2]: near,
                                 at[3]: near})
            h = hash3_np(d)
            if np.array_equal(np.flatnonzero(h == h[at[0]]), at):
                return d, S, True, 32
        raise AssertionError("no filler without a fifth same-hash position")
    if name == "parse_subtile":
        S, edge = 1 << 16, 4096
        seg = rng.integers(0, 256, 600, dtype=np.uint8)
        seg[300:330] = 0x55
        out = np.random.default_rng(10).integers(0, 256, S, dtype=np.uint8)
        for e in range(edge, S, edge):
            if e // edge % 2:
                out[e - 100:e + 150] = 0xAA
            else:
                out[e - 200:e + 400] = seg
        return out, S, True, 32
    if name == "s36865":
        return sample("mixed", 36_865, seed=8), 36_865, True, 32
    raise ValueError(name)


LZ_CASES = ["tail_tie", "collision_k1", "collision_k2", "dist_32768",
            "clamp_dist", "chain", "short_valid", "greedy", "k1", "k255",
            "s40000", "s1", "s2", "long_chains", "link_two_tiles",
            "parse_subtile", "s36865"]
