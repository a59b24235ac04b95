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


# --------------------------------------- cases of the encoder's block stage

def tile_histograms(M: int, seed: int, stored_every: int = 0) -> tuple:
    """(ll int64[M, 286], d int64[M, 30]): tiles drawn from three kinds of
    source (text-like, match-heavy, near-uniform), in runs, so that merging
    and splitting both pay; with stored_every = s, every run of s tiles
    starting at a multiple of 2 s is incompressible (32,768 uniform
    literals, no match), so the DP prices those tiles stored."""
    rng = np.random.default_rng(seed)
    kinds = []
    while len(kinds) < M:
        kinds += [int(rng.integers(0, 3))] * int(rng.integers(1, 5))
    ll = np.zeros((M, C.NUM_LITLEN), np.int64)
    d = np.zeros((M, C.NUM_DIST), np.int64)
    base = [rng.dirichlet(np.full(C.NUM_LITLEN, a)) for a in (0.05, 0.3, 50)]
    dbase = [rng.dirichlet(np.full(C.NUM_DIST, 0.5)) for _ in range(3)]
    for m, k in enumerate(kinds[:M]):
        if stored_every and m // stored_every % 2 == 0:
            ll[m, :256] = rng.multinomial(32768, np.full(256, 1 / 256))
            continue
        ntok = int(rng.integers(4000, 30000))
        ll[m] = rng.multinomial(ntok, base[k])
        d[m] = rng.multinomial(int(ll[m, 257:].sum()), dbase[k])
        ll[m, 256] = 0
    return ll, d


def block_plan_case(name: str) -> tuple:
    """(ll int64[M, 286], d int64[M, 30], n_micro_valid, tile_bytes
    int64[M]) of one case of the block-split DP, as encode_shard hands
    them over (tiles past the valid bytes are empty):
    mM            M tiles, all valid (32: a 1 MB shard, 128: 4 MB);
    mM_short      the valid bytes end inside tile n_valid - 1;
    m32_stored    every tile incompressible: each its own stored block;
    m128_mixed    runs of 3 incompressible tiles between text-like runs;
    m2, m17       the sizes of the older parity cases."""
    M, n_valid, stored_every = {
        "m32": (32, 32, 0), "m128": (128, 128, 0), "m32_short": (32, 21, 0),
        "m128_short": (128, 77, 0), "m32_stored": (32, 32, 1),
        "m128_mixed": (128, 128, 3), "m2": (2, 1, 0),
        "m17": (17, 17, 0)}[name]
    seed = sum(map(ord, name))
    ll, d = tile_histograms(M, seed, stored_every)
    tile_bytes = np.full(M, C.WINDOW_SIZE, np.int64)
    tile_bytes[n_valid - 1] = 20000
    tile_bytes[n_valid:] = 0
    ll[n_valid:] = 0
    d[n_valid:] = 0
    return ll, d, n_valid, tile_bytes


BLOCK_PLAN_CASES = ["m32", "m128", "m32_short", "m128_short", "m32_stored",
                    "m128_mixed", "m2", "m17"]


def huffman_case(name: str) -> tuple:
    """(freqs int64[B, n], max_bits) of one case of the code construction,
    its first rows the edge cases, the rest like the encoder's:
    litlen_11  B = 64, n = 286, 11 bits: no symbol, one (two places),
               two (adjacent and far apart), all tied, all 286 used with
               geometric weights (the limit binds), a skewed and a sparse
               row, then block-like litlen rows and zero-padded 30-symbol
               distance rows (the encoder's batched build);
    clen_7     B = 32, n = 19, 7 bits: the same edge rows, all 19 used and
               geometric (the limit binds), then RLE-like counts."""
    rng = np.random.default_rng(sum(map(ord, name)))
    B, n, max_bits = {"litlen_11": (64, 286, 11), "clen_7": (32, 19, 7)}[name]
    s = np.arange(n)
    edge = [np.zeros(n), np.eye(1, n, n // 2)[0] * 77, np.eye(1, n, 0)[0],
            np.eye(1, n, 3)[0] * 5 + np.eye(1, n, 4)[0] * 5,
            np.eye(1, n, 0)[0] * 5 + np.eye(1, n, n - 1)[0],
            np.full(n, 9), np.floor(2.0 ** 21 * 0.75 ** s) + 1,
            np.floor(1e6 * 0.6 ** s), rng.integers(0, 3, n)
            * rng.integers(0, 50, n)]
    rows = [np.asarray(r, np.int64) for r in edge]
    while len(rows) < B:
        if n == C.NUM_CLEN:
            r = rng.multinomial(int(rng.integers(20, 320)),
                                rng.dirichlet(np.full(n, 0.4)))
        elif len(rows) % 2:
            r = np.zeros(n, np.int64)
            r[:C.NUM_DIST] = rng.multinomial(int(rng.integers(1, 60000)),
                                             rng.dirichlet(np.full(30, 0.5)))
        else:
            r = rng.multinomial(int(rng.integers(1, 8 * 32768)),
                                rng.dirichlet(np.full(n, 0.2)))
            r[256] = 1
        rows.append(r.astype(np.int64))
    return np.stack(rows), max_bits


HUFFMAN_CASES = ["litlen_11", "clen_7"]


def huffman_rows(n: int, max_bits: int) -> np.ndarray:
    """int64 rows of n frequencies for a max_bits limit: random, sparse,
    Zipf, negative, all tied, one and two used symbols, and rows with
    frequencies at and above INF = 2^28 (the one used symbol first in
    order or not, and mixed with small ones); at most 2^max_bits used."""
    inf = 1 << 28
    rng = np.random.default_rng(n + max_bits)
    one, two, tied = (np.zeros(n, np.int64) for _ in range(3))
    one[n // 2] = 11
    two[0], two[-1] = 3, 3
    tied[:] = 7
    big = []
    for at, v in ((0, inf), (n - 1, inf), (0, inf + 5)):
        r = np.zeros(n, np.int64)
        r[at] = v
        big.append(r)
    mixed = rng.integers(0, 1000, n)
    mixed[rng.integers(0, n, 3)] = [inf, inf + 1, 1 << 40]
    rows = np.stack([rng.integers(0, 1000, n), rng.integers(0, 3, n)
                     * rng.integers(0, 50, n), rng.zipf(1.3, n) % 100000,
                     rng.integers(-5, 5, n), one, two, tied, *big,
                     mixed]).astype(np.int64)
    rows[:, 1 << max_bits:] = 0
    return rows


def layout_case(name: str) -> tuple:
    """(rest int64[NB], stored bool[NB]) of one case of the block layout:
    NB blocks (32, 128, 1, or 5,000 to cross the kernel's 2,048-block
    chunks), about half of them stored; a stored block's rest is its 3
    header bits, 32 of LEN/NLEN and its bytes, a Huffman block's any
    count."""
    NB = {"nb32": 32, "nb128": 128, "nb1": 1, "nb5000": 5000}[name]
    rng = np.random.default_rng(NB)
    stored = rng.random(NB) < 0.5
    huff = rng.integers(10, 300_000, NB)
    rest = np.where(stored, 35 + 8 * rng.integers(0, 32769, NB), huff)
    return rest.astype(np.int64), stored


LAYOUT_CASES = ["nb32", "nb128", "nb1", "nb5000"]


def pack_case(name: str) -> tuple:
    """The arguments of ops/pack_words.py::pack_words for one synthetic
    shard, as numpy arrays (the stride a 0-d one) and then final and
    num_words (the shard's out_words):
    nbN           N tiles, tokens of random lengths (literals, matches of
                  3 to 258 bytes at distances up to 32768) that cross tile
                  edges, random block splits, every type (stored blocks one
                  tile), random code lengths of 1-15 bits and, in dynamic
                  blocks, header widths (some of 33-40 bits; values with
                  bits past their widths), the valid bytes ending inside
                  the last tile, not final; the stride as encode_shard
                  sizes it from the Huffman tokens;
    nbN_final     the same, final, every tile valid;
    nbN_stride5   the stride 5, so blocks' first tokens that are not
                  multiples add entries; every other block has no token
                  in its first 4,096 or 8,192 positions, so its first
                  Huffman token lies a unit or two after its start;
    nbN_every     longer matches, the stride 1: every Huffman token an
                  entry, NSUB not reached;
    nbN_overflow  nearly all literals, the stride 1: more entries than
                  NSUB (the overflow flag);
    nbN_stored    every block stored: no Huffman token, no entry."""
    base, _, kind = name.partition("_")
    final = kind == "final"
    NB = int(base[2:])
    S = NB * C.WINDOW_SIZE
    rng = np.random.default_rng(sum(map(ord, name)))
    valid = S if final else S - int(rng.integers(1, C.WINDOW_SIZE))
    data = rng.integers(0, 256, S).astype(np.uint8)
    p_lit = {"every": 0.3, "overflow": 0.97}.get(kind, 0.6)
    lens = np.where(rng.random(S) < p_lit, 1, rng.integers(3, 259, S))
    starts = np.cumsum(lens) - lens
    starts = starts[starts < valid]
    chosen = np.zeros(S, bool)
    chosen[starts] = True
    length = np.zeros(S, np.int64)
    dist = np.zeros(S, np.int64)
    lm = lens[:len(starts)]
    length[starts] = np.where(lm >= 3, lm, 0)
    dist[starts] = np.where(lm >= 3, rng.integers(1, 32769, len(starts)), 0)
    split = rng.random(NB) < 0.5
    split[0] = True
    if kind == "stored":
        split[:] = True
    blk = np.cumsum(split) - 1
    n_blocks = int(blk[-1]) + 1
    last = int(blk[(valid - 1) // C.WINDOW_SIZE])        # last emitted
    start = np.full(NB, NB - 1, np.int64)
    start[:n_blocks] = np.flatnonzero(split)
    tiles = np.diff(np.append(start[:n_blocks], NB))
    btype = rng.integers(0, 3, NB)
    btype[:n_blocks] = np.where(tiles[:n_blocks] > 1,
                                np.maximum(btype[:n_blocks], 1),
                                btype[:n_blocks])
    if kind == "stored":
        btype[:] = 0
    emitted = np.arange(NB) <= last
    huff = emitted & (btype != 0)
    if kind == "stride5":
        for b in range(0, n_blocks, 2):
            q = start[b] * C.WINDOW_SIZE
            n = 4096 * (1 + b % 4 // 2)
            chosen[q:q + n] = False
            length[q:q + n] = 0
            dist[q:q + n] = 0
    stored = emitted & (btype == 0)
    blen = np.clip(valid - start * C.WINDOW_SIZE, 0, C.WINDOW_SIZE)
    blen = np.where(np.arange(NB) < n_blocks, blen, 0)
    lens_ll = rng.integers(1, 16, (NB, C.NUM_LITLEN + 1))
    lens_d = rng.integers(1, 16, (NB, C.NUM_DIST + 1))
    ll_tab = (rng.integers(0, 1 << 15, lens_ll.shape) & ((1 << lens_ll) - 1)
              | lens_ll << 16)
    d_tab = (rng.integers(0, 1 << 15, lens_d.shape) & ((1 << lens_d) - 1)
             | lens_d << 16)
    ll_tab[:, -1] = 0
    d_tab[:, -1] = 0
    hdr_lo = rng.integers(0, 1 << 32, (NB, 340))
    hdr_nbs = rng.integers(0, 15, (NB, 340)) * (rng.random((NB, 340)) < 0.7)
    hdr_nbs[:, 0] = 3
    hdr_nbs[:, 1::97] = rng.integers(33, 41, (NB, len(range(1, 340, 97))))
    hdr_nbs[btype != 2, 1:337] = 0             # a tree only if dynamic
    hdr_nbs[:, 337] = 0
    hdr_nbs[:, 338] = np.where(stored, 32, 0)
    hdr_nbs[:, 339] = np.where(huff, ll_tab[:, 256] >> 16, 0)
    hdr_nbs[~emitted] = 0
    n_tok_h = int((chosen & np.repeat(huff[blk], C.WINDOW_SIZE)).sum())
    nsub = S // 64
    stride = {"stride5": 5, "every": 1, "overflow": 1}.get(
        kind, max((n_tok_h + nsub - NB - 1) // (nsub - NB), 1))
    return (data, chosen, length, dist, blk.astype(np.int64), start, huff,
            stored, blen.astype(np.int64), ll_tab.astype(np.int64),
            d_tab.astype(np.int64), hdr_lo.astype(np.int64),
            hdr_nbs.astype(np.int64), np.array(stride, np.int64), final,
            (NB * (42 + 9 * C.WINDOW_SIZE) + 96) // 32)


PACK_CASES = ["nb1", "nb1_final", "nb32", "nb32_final", "nb128",
              "nb128_final", "nb32_stride5", "nb32_every", "nb32_overflow",
              "nb32_stored"]


def block_stage_inputs(x, valid_len: int, final: bool = True,
                       **options) -> dict:
    """The arguments encode_shard(x, valid_len, final, **options) hands
    each op of its block stage and back end, by row name ("block_plan",
    "huffman_codes 11-bit", "huffman_codes 7-bit", "pack_words"), each as
    (op, plain version, args, kwargs). The encode runs once with
    format.deflate's three names wrapped by recorders, restored after it."""
    from .format import deflate
    from .ops import block_plan as BP
    from .ops import huffman_codes as HC
    from .ops import pack_words as PW
    plain = {"block_plan": BP.block_plan_ref,
             "huffman_codes": HC.huffman_codes_ref,
             "pack_words": PW.pack_words_ref}
    saved = {n: getattr(deflate, n) for n in plain}
    got = {}

    def recorder(name, fn):
        def call(*a, **k):
            row = name if name != "huffman_codes" else f"{name} {a[1]}-bit"
            got.setdefault(row, (fn, plain[name], a, k))
            return fn(*a, **k)
        return call
    try:
        for n, fn in saved.items():
            setattr(deflate, n, recorder(n, fn))
        deflate.encode_shard(x, valid_len, final, **options)
    finally:
        for n, fn in saved.items():
            setattr(deflate, n, fn)
    return got


def layout_inputs(pack_args) -> tuple:
    """(rest int64[NB], stored bool[NB]) of the layout inside pack_words
    on its arguments `pack_args` (as block_stage_inputs records them): each
    block's header bits, token bits and stored bytes' bits, and its stored
    flag. The token bits come from the plain version, on the arguments'
    device."""
    import torch

    from .ops import pack_words as PW
    T_b = PW.pack_words_ref(*pack_args).token_bits
    stored, blen, hdr_nbs = pack_args[7], pack_args[8], pack_args[12]
    rest = hdr_nbs.sum(1) + T_b + torch.where(stored, 8 * blen, 0)
    return rest.contiguous(), stored.contiguous()
