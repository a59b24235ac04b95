"""Port parity: the encoder's block stage (ops/block_plan.py,
ops/huffman_codes.py, ops/block_layout.py) against the JAX package on the
CPU, at the main path's sizes (32 and 128 tiles, 2 x 32 litlen and
distance alphabets of 286, 32 code-length alphabets of 19), and a 32-tile
encode_shard of interleaved stored and dynamic tiles.

The split, the code lengths, codes and reversed codes, the layout and every
encoded word are integers: exact equality. The segment costs are float32
sums of a few hundred log terms, compared at rtol 1e-5.

Where a kernel's algorithm differs from its plain version (the DP's
integer segment counts, float64 sums and bit-pattern argmin; the code
construction's rank sort, per-level binary searches and top-down counts),
a numpy model of the kernel's algorithm is held against the plain
version; the kernels themselves are held against the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 15)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.core import bits as jb
from deflate_compression_tpu.core import cost as jc
from deflate_compression_tpu.core import huffman as jh
from deflate_compression_tpu.format import deflate as jd
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.format import constants as C
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.ops import block_layout as BL
from deflate_compression_tpu_torch.ops import block_plan as BP
from deflate_compression_tpu_torch.ops import huffman_codes as HC

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

F32 = np.float32
INF_W = 1 << 28


# ------------------------------------------------------------ block plan

def _jax_plan_args(ll, d, n_valid, tile_bytes):
    return (jnp.asarray(ll, jnp.int32), jnp.asarray(d, jnp.int32),
            jnp.int32(n_valid), jnp.asarray(tile_bytes, jnp.int32))


def _jax_block_plan_eager(ll, d, n_valid, tile_bytes):
    """core/cost.py::block_plan called op by op, outside any jit."""
    a, b, n, t = _jax_plan_args(ll, d, n_valid, tile_bytes)
    return jc.block_plan(a, b, n, max_merge=8, tile_bytes=t)


def _jax_block_plan_jit(ll, d, n_valid, tile_bytes):
    """core/cost.py::block_plan as the JAX encoder runs it: inside one
    jax.jit, max_merge static, the counts, n_valid and tile_bytes traced
    (format/deflate.py::encode_shard_jit)."""
    fn = jax.jit(lambda a, b, n, t: jc.block_plan(a, b, n, max_merge=8,
                                                  tile_bytes=t))
    return fn(*_jax_plan_args(ll, d, n_valid, tile_bytes))


@pytest.mark.parametrize("name", corpus.BLOCK_PLAN_CASES)
def test_block_plan_matches_jax(name):
    """The split and n_blocks equal the JAX package's block_plan run as its
    encoder runs it, under jax.jit."""
    ll, d, n_valid, tile_bytes = corpus.block_plan_case(name)
    w_split, w_nb = _jax_block_plan_jit(ll, d, n_valid, tile_bytes)
    stats = {}
    g_split, g_nb = BP.block_plan(torch.from_numpy(ll), torch.from_numpy(d),
                                  n_valid, torch.from_numpy(tile_bytes), 8,
                                  stats=stats)
    np.testing.assert_array_equal(g_split.numpy(), np.asarray(w_split))
    assert int(g_nb) == int(w_nb)
    assert stats["cost"].shape == (ll.shape[0], 8)
    if name == "m32_stored":
        assert g_split.all()


def _lane_sum(terms: np.ndarray, lanes: np.ndarray) -> float:
    """The kernel's float64 sum: each lane adds its terms in symbol order,
    then the lanes' sums meet in a butterfly (lane 0's result)."""
    v = np.zeros(32)
    for x, lane in zip(terms, lanes):
        v[lane] += float(x)
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def plan_model(ll, d, n_valid, tile_bytes, mm):
    """numpy model of csrc/block_plan.cu: for each end tile j the running
    integer counts of tiles j-1, j-2, ... and after each tile k the cost
    of tiles [j-k, j): float32 terms, float64 sums rounded once; the DP
    chain with opt[j-MM..j-1] in a ring indexed j mod MM (MM = 8 or 32,
    the columns k > mm +inf, opt below 0 the plain version's 3.4e38),
    MM float32 candidates and their minimum taken newest last; then each
    step's
    candidates again from opt: the first k that reaches opt[j] as the back
    link and the margin to the runner-up; the backtrack counting its
    steps. Returns (split, n_blocks, cost, gap)."""
    M = ll.shape[0]
    syms = np.concatenate([ll, d], 1).astype(np.int64)
    lanes = np.arange(316) % 32
    extra_bits = np.concatenate([np.zeros(257, np.int64), C.LENGTH_EXTRA,
                                 C.DIST_EXTRA]).astype(np.int64)
    cost = np.zeros((M, mm), F32)
    for j in range(1, M + 1):
        f = np.zeros(316, np.int64)
        for k in range(1, mm + 1):
            if j - k >= 0:
                f += syms[j - k]
            nll = F32(f[:286].sum()) + F32(1)
            nd = max(F32(f[286:].sum()), F32(1))
            lg = np.where(np.arange(316) < 286, np.log2(nll), np.log2(nd))
            x = f.astype(F32)
            term = x * (lg.astype(F32) - np.log2(np.maximum(x, F32(1e-9))))
            on = f > 0
            h_ll = _lane_sum(term[:286][on[:286]], lanes[:286][on[:286]])
            h_d = _lane_sum(term[286:][on[286:]], lanes[286:][on[286:]])
            c = F32(h_ll) + F32(h_d)
            c = c + F32((f * extra_bits).sum())
            c = c + F32(62.0)
            c = c + F32(5.5) * F32(on.sum())
            c = c + np.log2(nll)
            if k == 1:
                c = min(c, F32(42.0) + F32(8.0) * F32(tile_bytes[j - 1]))
            cost[j - 1, k - 1] = c
    MM = 8 if mm <= 8 else 32
    row = np.full((M, MM), np.inf, F32)
    row[:, :mm] = cost
    ring = np.full(MM, F32(3.4e38))
    ring[0] = 0
    opt = np.zeros(M + 1, F32)
    for j in range(1, M + 1):
        c = np.array([ring[(j - k) % MM] + row[j - 1, k - 1]
                      for k in range(1, MM + 1)], F32)
        far = c[2:].min()               # k >= 3: opt[j-3] and older
        ring[j % MM] = opt[j] = min(c[0], min(c[1], far))
    back, gap = np.zeros(M, np.int64), np.inf
    for j in range(1, M + 1):
        best = second = F32(np.inf)
        for k in range(1, min(mm, j) + 1):
            cand = F32(opt[j - k] + cost[j - 1, k - 1])
            if cand < best:
                second, best, back[j - 1] = best, cand, k
            elif cand < second:
                second = cand
        assert best.view(np.uint32) == opt[j].view(np.uint32)
        if 2 <= j <= n_valid:
            gap = min(gap, float(second - best))
    split = np.zeros(M, bool)
    split[0] = True
    jcur, blocks = n_valid, 0
    while jcur > 0:
        jcur = max(jcur - back[jcur - 1], 0)
        split[jcur] = True
        blocks += 1
    return split, blocks, cost, gap


@pytest.mark.parametrize("name,mm", [(n, 8) for n in corpus.BLOCK_PLAN_CASES]
                         + [("m32", 1), ("m32", 3), ("m17", 32)])
def test_block_plan_kernel_model_matches_plain(name, mm):
    ll, d, n_valid, tile_bytes = corpus.block_plan_case(name)
    split, blocks, cost, gap = plan_model(ll, d, n_valid, tile_bytes, mm)
    stats = {}
    w_split, w_nb = BP.block_plan_ref(
        torch.from_numpy(ll), torch.from_numpy(d), n_valid,
        torch.from_numpy(tile_bytes), mm, stats=stats)
    np.testing.assert_array_equal(split, w_split.numpy())
    assert blocks == int(w_nb)
    np.testing.assert_allclose(cost, stats["cost"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(gap, float(stats["gap"]), rtol=0, atol=1.0)


def plan_float64(ll, d, n_valid, tile_bytes, mm=8):
    """The block plan with the cost model evaluated in float64 from the
    integer counts, each segment's terms summed by math.fsum (within a
    few float64 ulps of the exact value, far below a float32 ulp of the
    costs). Returns (split, cand): cand[j - 1] holds step j's candidates
    (inf where j - k < 0)."""
    M = ll.shape[0]
    syms = np.concatenate([ll, d], 1).astype(np.int64)
    extra = np.concatenate([np.zeros(257, np.int64), C.LENGTH_EXTRA,
                            C.DIST_EXTRA]).astype(np.int64)

    def cost(i, j):
        f = syms[i:j].sum(0)
        n_ll, n_d = int(f[:286].sum()) + 1, max(int(f[286:].sum()), 1)
        terms = [float(x) * (math.log2(n_ll if s < 286 else n_d)
                             - math.log2(x)) for s, x in enumerate(f) if x]
        c = math.fsum(terms + [float((f * extra).sum()), 62.0,
                               5.5 * int((f > 0).sum()), math.log2(n_ll)])
        return min(c, 42.0 + 8.0 * float(tile_bytes[j - 1])) if j - i == 1 \
            else c
    opt, back, cand = [0.0], [], []
    for j in range(1, M + 1):
        c = [opt[j - k] + cost(max(j - k, 0), j) if j - k >= 0 else math.inf
             for k in range(1, mm + 1)]
        back.append(int(np.argmin(c)) + 1)
        opt.append(min(c))
        cand.append(c)
    split = np.zeros(M, bool)
    split[0] = True
    jcur = n_valid
    while jcur > 0:
        jcur = max(jcur - back[jcur - 1], 0)
        split[jcur] = True
    return split, np.asarray(cand)


@pytest.mark.parametrize("name", corpus.BLOCK_PLAN_CASES)
def test_block_plan_matches_float64_model(name):
    """The port's float32 plan splits where the cost model evaluated in
    float64 does, on every case (m32_short's near-tie included)."""
    ll, d, n_valid, tile_bytes = corpus.block_plan_case(name)
    split, _ = BP.block_plan_ref(torch.from_numpy(ll), torch.from_numpy(d),
                                 n_valid, torch.from_numpy(tile_bytes), 8)
    np.testing.assert_array_equal(
        split.numpy(), plan_float64(ll, d, n_valid, tile_bytes)[0])


class _ArgminSpy:
    """Stands for jax.numpy inside the JAX package's core/cost.py: records
    the candidates of each DP step its argmin sees."""

    def __init__(self):
        self.rows = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmin(self, x):
        jax.debug.callback(lambda v: self.rows.append(np.asarray(v)), x)
        return jnp.argmin(x)


def test_block_plan_near_tie_witness(monkeypatch):
    """m32_short's DP step 13, a sub-ulp tie: its two best candidates (k =
    6 tiles and k = 7) in float64, in the port's float32 and in the JAX
    package's float32 called eagerly and under jax.jit (as its encoder
    runs it). float64 puts k = 6 ahead by less than two float32 ulps of
    the costs (0.125 each at 2^20); the port picks k = 6, and so does the
    jitted JAX function, whose two candidates tie exactly (argmin's first
    minimum): starts [0, 7, ...]. The eager JAX function picks k = 7:
    starts [0, 6, ...]. The reference's own split at this tie depends on
    how XLA compiles its float32 sums. Run with -s to print them."""
    ll, d, n_valid, tile_bytes = corpus.block_plan_case("m32_short")
    want, cand64 = plan_float64(ll, d, n_valid, tile_bytes)
    stats = {}
    split, _ = BP.block_plan_ref(torch.from_numpy(ll), torch.from_numpy(d),
                                 n_valid, torch.from_numpy(tile_bytes), 8,
                                 stats=stats)
    cost = stats["cost"].numpy()
    starts = np.flatnonzero(split.numpy())
    opt = [F32(0)]                      # the plain DP's float32 opt[j]
    for j in range(1, 14):
        opt.append(min(opt[j - k] + cost[j - 1, k - 1]
                       for k in range(1, min(j, 8) + 1)))
    port = {k: opt[13 - k] + cost[12, k - 1] for k in (6, 7)}
    jax_c, jax_starts = {}, {}
    for how, run in (("eager", _jax_block_plan_eager),
                     ("jit", _jax_block_plan_jit)):
        spy = _ArgminSpy()
        monkeypatch.setattr(jc, "jnp", spy)
        jsplit, _ = run(ll, d, n_valid, tile_bytes)
        jax_starts[how] = np.flatnonzero(np.asarray(jsplit)).tolist()
        assert len(spy.rows) == ll.shape[0]     # one row per DP step
        jax_c[how] = spy.rows[12]
    monkeypatch.undo()
    f64 = {k: cand64[12, k - 1] for k in (6, 7)}
    print(f"step 13 candidates k=6 / k=7: float64 {float(f64[6])!r} / "
          f"{float(f64[7])!r} (margin {float(f64[7] - f64[6])!r}); port "
          f"float32 {float(port[6])!r} / {float(port[7])!r}; JAX float32 "
          f"eager {float(jax_c['eager'][5])!r} / "
          f"{float(jax_c['eager'][6])!r}, jit {float(jax_c['jit'][5])!r} / "
          f"{float(jax_c['jit'][6])!r}")
    print(f"block starts: float64 {np.flatnonzero(want).tolist()}, port "
          f"{starts.tolist()}, JAX eager {jax_starts['eager']}, JAX jit "
          f"{jax_starts['jit']}")
    assert 0 < f64[7] - f64[6] < 0.25
    np.testing.assert_array_equal(split.numpy(), want)
    assert 7 in starts and int(np.argmin(cand64[12])) + 1 == 6
    assert port[6] < port[7]                    # the port picks k = 6
    assert jax_c["eager"][6] < jax_c["eager"][5]    # eager JAX picks k = 7
    assert jax_starts["eager"][:2] == [0, 6]
    assert jax_c["jit"][5] <= jax_c["jit"][6]       # jitted JAX picks k = 6
    assert jax_starts["jit"][:2] == [0, 7]
    assert jax_starts["jit"] == starts.tolist()


def test_block_plan_wrapper_checks():
    ll, d, n_valid, tile_bytes = (torch.from_numpy(x) if isinstance(
        x, np.ndarray) else x for x in corpus.block_plan_case("m32"))
    with pytest.raises(TypeError):
        BP.block_plan(ll.float(), d, n_valid, tile_bytes)
    with pytest.raises(TypeError):
        BP.block_plan(ll, d.int(), n_valid, tile_bytes)
    with pytest.raises(TypeError):          # int64 only, as encode_shard
        BP.block_plan(ll.int(), d.int(), n_valid, tile_bytes.int())
    with pytest.raises(ValueError):
        BP.block_plan(ll[:, :285], d, n_valid, tile_bytes)
    with pytest.raises(ValueError):
        BP.block_plan(ll.t().contiguous().t(), d, n_valid, tile_bytes)
    with pytest.raises(ValueError):
        BP.block_plan(ll, d, 33, tile_bytes)
    with pytest.raises(ValueError):
        BP.block_plan(ll, d, n_valid, tile_bytes, max_merge=33)
    with pytest.raises(ValueError):
        BP.block_plan(ll.to("meta"), d.to("meta"), n_valid,
                      tile_bytes.to("meta"))


# -------------------------------------------------------- Huffman codes

@functools.lru_cache(maxsize=None)
def _jax_codes(max_bits):
    def one(f):
        lengths = jh.huffman_code_lengths(f, max_bits)
        codes = jh.canonical_codes(lengths, max_bits)
        return lengths, codes, jb.reverse_bits(codes, lengths, max_bits)
    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("name", corpus.HUFFMAN_CASES)
def test_huffman_codes_match_jax(name):
    freqs, max_bits = corpus.huffman_case(name)
    want = _jax_codes(max_bits)(jnp.asarray(freqs, jnp.int32))
    got = HC.huffman_codes(torch.from_numpy(freqs), max_bits)
    for g, w, what in zip(got, want, got._fields):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int64), err_msg=what)
    lengths = got.lengths.numpy()
    assert lengths.max() == max_bits        # the limit binds somewhere
    assert list((lengths > 0).sum(1)[:5]) == [0, 1, 1, 2, 2]
    assert (lengths[6] > 0).all()           # every symbol used


def _count(arr, length, key, top, at_most=False):
    """The kernel's branchless binary search: #{i < length : arr[i] < key}
    (<= with at_most) by steps top, top / 2, ..., 1 (length < 2 top)."""
    pos, step = 0, top
    while step:
        p = pos + step
        if p <= length and (arr[p - 1] <= key if at_most
                            else arr[p - 1] < key):
            pos = p
        step //= 2
    return pos


def _top(length):
    return 1 << (length.bit_length() - 1) if length else 0


def codes_model(freqs: np.ndarray, max_bits: int):
    """numpy model of csrc/huffman_codes.cu for one row: the used symbols
    below INF as unique keys f << 16 | symbol, each placed at the count of
    the keys below it; per level the packages below INF (a prefix), each
    leaf placed at j + #(packages < it) and each package at q + #(leaves
    <= it), over the finite prefix only, each leaf's position kept; the
    top-down counts as the leaves placed before m; the lengths back in
    symbol order (the
    one used symbol at or above INF by the first-in-order rule); ranks
    among equal lengths per warp of 32 symbols plus the counts of the
    warps before; next_code from the counts; reversed codes."""
    n = freqs.shape[0]
    f = freqs.astype(np.int64)
    active = f > 0
    fin = active & (f < INF_W)
    k, kf = int(active.sum()), int(fin.sum())
    keys = [int(f[s]) << 16 | s for s in range(n) if fin[s]]
    srt = [0] * kf
    for x in keys:
        srt[sum(y < x for y in keys)] = x
    lv = [x >> 16 for x in srt]
    order = [x & 0xFFFF for x in srt]
    cur, at_level = lv, {}
    for lvl in range(1, max_bits):
        pk = []
        for q in range(len(cur) // 2):
            if cur[2 * q] + cur[2 * q + 1] < INF_W:
                pk.append(cur[2 * q] + cur[2 * q + 1])
        total = kf + len(pk)
        nxt, at_level[lvl] = [None] * total, []
        for j, x in enumerate(lv):
            at = j + _count(pk, len(pk), x, _top(len(pk)))
            nxt[at] = x
            at_level[lvl].append(at)
        for q, x in enumerate(pk):
            nxt[q + _count(lv, kf, x, _top(kf), at_most=True)] = x
        assert None not in nxt and nxt == sorted(nxt)
        cur = nxt
    m, nleaf = max(2 * k - 2, 0), [0] * max_bits
    for lvl in range(max_bits - 1, -1, -1):
        idx = min(m, 2 * n)
        at = range(kf) if lvl == 0 else at_level[lvl]
        nleaf[lvl] = sum(a < idx for a in at)
        m = 2 * (m - nleaf[lvl])
    lengths = np.zeros(n, np.int64)
    for j in range(kf):
        lengths[order[j]] = (j == 0) if k == 1 else sum(j < x for x in nleaf)
    if k == 1 and kf == 0:
        s = int(np.flatnonzero(active)[0])
        if n == 1 or (s == 0 and f[s] == INF_W):
            lengths[s] = 1
    cnt = np.zeros(16, np.int64)
    rank = np.zeros(n, np.int64)
    for r0 in range(0, n, 32):
        lens = [int(lengths[s]) if s < n else 0 for s in range(r0, r0 + 32)]
        for lane, ln in enumerate(lens):
            if r0 + lane < n:
                rank[r0 + lane] = cnt[ln] + lens[:lane].count(ln)
        for ln in set(lens):
            cnt[ln] += lens.count(ln)
    nxt_code = [sum(int(cnt[i]) << (b - i) for i in range(1, b))
                for b in range(16)]
    codes, rev = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for t in np.flatnonzero(lengths):
        ln = int(lengths[t])
        codes[t] = nxt_code[ln] + rank[t]
        rev[t] = int(format(int(codes[t]), f"0{ln}b")[::-1], 2)
    return lengths, codes, rev


@pytest.mark.parametrize("name", corpus.HUFFMAN_CASES)
def test_huffman_codes_kernel_model_matches_plain(name):
    freqs, max_bits = corpus.huffman_case(name)
    want = HC.huffman_codes_ref(torch.from_numpy(freqs), max_bits)
    for b in range(freqs.shape[0]):
        for g, w, what in zip(codes_model(freqs[b], max_bits), want,
                              want._fields):
            np.testing.assert_array_equal(g, w[b].numpy(),
                                          err_msg=f"row {b} {what}")


@pytest.mark.parametrize("n,max_bits", [(1, 1), (2, 1), (30, 15), (512, 15),
                                        (300, 9), (19, 7), (30, 7),
                                        (286, 11), (512, 1), (2, 15)])
def test_huffman_codes_kernel_model_other_alphabets(n, max_bits):
    rows = corpus.huffman_rows(n, max_bits)
    want = HC.huffman_codes_ref(torch.from_numpy(rows), max_bits)
    for b in range(rows.shape[0]):
        for g, w in zip(codes_model(rows[b], max_bits), want):
            np.testing.assert_array_equal(g, w[b].numpy())


def test_huffman_codes_wrapper_checks():
    f = torch.ones((2, 19), dtype=torch.int64)
    with pytest.raises(TypeError):
        HC.huffman_codes(f.float(), 7)
    with pytest.raises(TypeError):          # int64 only, as encode_shard
        HC.huffman_codes(f.int(), 7)
    with pytest.raises(ValueError):
        HC.huffman_codes(torch.ones((2, 513), dtype=torch.int64), 15)
    with pytest.raises(ValueError):
        HC.huffman_codes(f, 16)
    with pytest.raises(ValueError):
        HC.huffman_codes(torch.ones((19, 2), dtype=torch.int64).t(), 7)
    with pytest.raises(ValueError):
        HC.huffman_codes(f.to("meta"), 7)


# ---------------------------------------------------------- block layout

def layout_model(rest: np.ndarray, stored: np.ndarray):
    """The serial layout in plain Python integers."""
    p, base, pad = 0, [], []
    for r, s in zip(rest.tolist(), stored.tolist()):
        pd = (8 - (p + 3) % 8) % 8 if s else 0
        base.append(p)
        pad.append(pd)
        p += r + pd
    return np.asarray(base), np.asarray(pad), p


@pytest.mark.parametrize("name", corpus.LAYOUT_CASES)
def test_block_layout_matches_serial_model(name):
    rest, stored = corpus.layout_case(name)
    assert name == "nb1" or (stored.any() and not stored.all())
    base, pad, p_end = BL.block_layout(torch.from_numpy(rest),
                                       torch.from_numpy(stored))
    w_base, w_pad, w_end = layout_model(rest, stored)
    np.testing.assert_array_equal(base.numpy(), w_base)
    np.testing.assert_array_equal(pad.numpy(), w_pad)
    assert int(p_end) == w_end
    assert ((base.numpy() + 3 + pad.numpy())[stored] % 8 == 0).all()


def test_block_layout_wrapper_checks():
    rest = torch.zeros(4, dtype=torch.int64)
    stored = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        BL.block_layout(rest.int(), stored)
    with pytest.raises(ValueError):
        BL.block_layout(rest[:3], stored)
    with pytest.raises(ValueError):
        BL.block_layout(rest[:0], stored[:0])
    with pytest.raises(ValueError):
        BL.block_layout(rest.to("meta"), stored.to("meta"))


# ------------------------------------------------- the shard, 32 tiles

ENCODE_KEYS = ("total_bits", "btype", "block_bits", "block_bytes",
               "tree_bits", "n_tokens", "n_matches", "block_bit_base",
               "block_out_start", "n_blocks", "sub_bit", "sub_out",
               "sub_blk", "sub_overflow")


def interleaved_shard() -> np.ndarray:
    """32 tiles: random (stored) tiles between text and C++ tiles, single
    and in runs of two."""
    kinds = ["text", "random", "cpp", "text", "random", "random", "cpp",
             "text"] * 4
    return np.concatenate([corpus.sample(k, 32768, seed=t)
                           for t, k in enumerate(kinds)])


@pytest.mark.parametrize("valid_len,final", [(1 << 20, True),
                                             ((1 << 20) - 5000, False)])
def test_encode_shard_32_tiles_interleaved_matches_jax(valid_len, final):
    data = interleaved_shard()
    want = jd.encode_shard_jit(jnp.asarray(data), jnp.int32(valid_len),
                               jnp.asarray(final))
    got = td.encode_shard(torch.from_numpy(data), valid_len, final)
    nw = (int(want["total_bits"]) + 31) // 32
    np.testing.assert_array_equal(
        got["words"][:nw].numpy(),
        np.asarray(want["words"][:nw]).astype(np.int64))
    for k in ENCODE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    bt = got["btype"].numpy()
    assert (bt == 0).sum() >= 8 and (bt == 2).sum() >= 8
