"""Port parity: the indexed device decoder (decode/device_inflate.py and its
phase-B kernel's plain version, ops/decode_symbols.py) against the JAX
decoder (decode/tpu_inflate.py) on the CPU.

The same stream words and index, made from seeded in-repo inputs, go
through both. Tolerance: exact. `ok` and `bad_lanes` are always identical;
the output bytes are identical wherever the decode is ok (on a stream
flagged bad, neither decoder defines its bytes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.core.huffman import decode_lut_np
from deflate_compression_tpu.decode import tpu_inflate as TI
from deflate_compression_tpu.format import constants as C
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.core.huffman import canonical_codes_np
from deflate_compression_tpu_torch.decode import device_inflate as DI
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.ops import decode_symbols as DS
from deflate_compression_tpu_torch.ops import lut_gather as LG

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

S = 1 << 16
IDX = ("block_bit_base", "block_out_start", "btype", "n_blocks", "sub_bit",
       "sub_out", "sub_blk")


def _encode(kind, size, valid_len, final=True, seed=1, **kw):
    data = corpus.sample(kind, size, seed=seed)
    r = td.encode_shard(torch.from_numpy(data), valid_len, final, **kw)
    return data, {k: v.numpy() for k, v in r.items()}


def _i32(x):
    return jnp.asarray(np.asarray(x).astype(np.int32))


def _jax_words(words):
    return jnp.asarray(np.asarray(words).astype(np.uint32))


def _blocks_args(r, words=None):
    """(words, blk_bit, blk_out, btype, n_blocks, sub_bit, sub_out, sub_blk,
    n_subs) as numpy from an encoder result."""
    w = r["words"] if words is None else words
    return (w, r["block_bit_base"], r["block_out_start"], r["btype"],
            int(r["n_blocks"]), r["sub_bit"], r["sub_out"], r["sub_blk"],
            len(r["sub_bit"]))


def _jax_blocks(args, valid, size, **kw):
    w, bb, bo, bt, nb, sb, so, sk, ns = args
    res = TI.decode_blocks(_jax_words(w), _i32(bb), _i32(bo), _i32(bt),
                           jnp.int32(nb), _i32(sb), _i32(so), _i32(sk),
                           jnp.int32(ns), jnp.int32(valid), size, **kw)
    return {k: np.asarray(v) for k, v in res.items()}


def _port_blocks(args, valid, size, **kw):
    w, *rest = args
    res = DI.decode_blocks(torch.from_numpy(np.asarray(w).astype(np.int64)),
                           *rest, valid, size, **kw)
    return {k: v.numpy() for k, v in res.items()}


def _same(got, want, valid):
    assert bool(got["ok"]) == bool(want["ok"])
    np.testing.assert_array_equal(got["bad_lanes"], want["bad_lanes"])
    if bool(want["ok"]):
        np.testing.assert_array_equal(got["out"][:valid], want["out"][:valid])


# ------------------------------------------------------------- clean cases

@pytest.mark.parametrize("kind,valid_len,force_btype", [
    ("text", S, None), ("mixed", S - 5000, None), ("random", S, None),
    ("periodic", S, None), ("zeros", S - 1, None), ("rgb", S, None),
    ("mixed", S - 777, C.BTYPE_FIXED)])
def test_decode_blocks_matches_jax(kind, valid_len, force_btype):
    data, r = _encode(kind, S, valid_len, force_btype=force_btype)
    args = _blocks_args(r)
    got = _port_blocks(args, valid_len, S)
    _same(got, _jax_blocks(args, valid_len, S), valid_len)
    assert bool(got["ok"])
    assert got["out"][:valid_len].tobytes() == data[:valid_len].tobytes()
    if force_btype is not None:
        bt = r["btype"]
        assert set(bt[bt >= 0].tolist()) == {force_btype}


def test_decode_blocks_256k_full_rounds_match_compact_and_nocmp():
    """At S = 2^18 the JAX decoder finishes pointer doubling with its
    compact tail; the port's full rounds must give the same bytes as both
    that and the JAX full-round loop (_ablate="nocmp")."""
    SB = 1 << 18
    data, r = _encode("text", SB, SB)
    args = _blocks_args(r)
    got = _port_blocks(args, SB, SB)
    assert bool(got["ok"]) and got["out"].tobytes() == data.tobytes()
    _same(got, _jax_blocks(args, SB, SB), SB)
    _same(got, _jax_blocks(args, SB, SB, _ablate="nocmp"), SB)


def test_decode_blocks_batch_matches_jax_ragged():
    kinds = [("text", S), ("random", S), ("mixed", S - 3000),
             ("rgb", S - 7777)]
    res = [_encode(k, S, v, final=(i == len(kinds) - 1), seed=i)
           for i, (k, v) in enumerate(kinds)]
    stack = {k: np.stack([r[k] for _, r in res]) for k in ("words", *IDX)}
    valid = np.array([v for _, v in kinds])
    got = DI.decode_blocks_batch(
        torch.from_numpy(stack["words"]), *(stack[k] for k in IDX), valid, S)
    want = TI.decode_blocks_batch(
        _jax_words(stack["words"]), *(_i32(stack[k]) for k in IDX),
        _i32(valid), S)
    assert bool(got["ok"]) and bool(want["ok"])
    np.testing.assert_array_equal(got["bad_lanes"].numpy(),
                                  np.asarray(want["bad_lanes"]))
    out = got["out"].numpy()
    np.testing.assert_array_equal(out, np.asarray(want["out"]))
    for (data, _), v, row in zip(res, valid, out):
        assert row[:v].tobytes() == data[:v].tobytes()


def _shard_indexed(words, bb, bo, bt, nb, valid, size):
    got = DI.decode_shard_indexed(
        torch.from_numpy(np.asarray(words).astype(np.int64)), bb, bo, bt, nb,
        valid, size)
    want = TI.decode_shard_indexed(_jax_words(words), _i32(bb), _i32(bo),
                                   _i32(bt), jnp.int32(nb),
                                   jnp.int32(valid), size)
    got = {k: v.numpy() for k, v in got.items()}
    _same(got, {k: np.asarray(v) for k, v in want.items()}, valid)
    return got


def test_decode_shard_indexed_matches_jax():
    """One lane per block (no sub-entries)."""
    valid = 3000
    data, r = _encode("text", 32768, valid)
    got = _shard_indexed(r["words"], r["block_bit_base"],
                         r["block_out_start"], r["btype"], r["n_blocks"],
                         valid, 32768)
    assert bool(got["ok"])
    assert got["out"][:valid].tobytes() == data[:valid].tobytes()


# ------------------------------------------------------------ 15-bit codes

class _BitWriter:
    """LSB-first bit writer (codes arrive pre-reversed)."""

    def __init__(self):
        self.bits = 0
        self.n = 0

    def put(self, value, nbits):
        self.bits |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits

    def bytes(self):
        return self.bits.to_bytes((self.n + 7) // 8, "little")


def _rev(code, n):
    r = 0
    for _ in range(n):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def _deep_15bit_stream(n_lit):
    """A valid dynamic block whose literals 0 and 1 have 15-bit codes: n_lit
    literal zeros then EOB (the JAX tests' round-5 regression fixture)."""
    ll = np.zeros(288, np.int64)
    for k in range(14):
        ll[256 + k] = k + 1          # EOB gets the 1-bit code
    ll[0] = ll[1] = 15
    llc = canonical_codes_np(ll, 15)
    clen_lens = np.zeros(19, np.int64)
    clen_lens[0] = 1
    for v in list(range(1, 16)) + [18]:
        clen_lens[v] = 5
    clc = canonical_codes_np(clen_lens, 7)
    w = _BitWriter()
    w.put(1, 1)                      # BFINAL
    w.put(2, 2)                      # dynamic
    w.put(286 - 257, 5)              # HLIT
    w.put(0, 5)                      # HDIST
    hclen_syms = [int(clen_lens[C.CLEN_ORDER[j]]) for j in range(19)]
    last = max(j for j in range(19) if hclen_syms[j] > 0)
    w.put(last + 1 - 4, 4)
    for j in range(last + 1):
        w.put(hclen_syms[j], 3)

    def put_clen(sym, extra=0, ebits=0):
        w.put(_rev(int(clc[sym]), int(clen_lens[sym])), int(clen_lens[sym]))
        if ebits:
            w.put(extra, ebits)
    put_clen(15)
    put_clen(15)
    put_clen(18, 138 - 11, 7)
    put_clen(18, 116 - 11, 7)
    for k in range(14):
        put_clen(k + 1)
    put_clen(18, 16 - 11, 7)
    put_clen(1)                      # the single dist length
    for _ in range(n_lit):
        w.put(_rev(int(llc[0]), 15), 15)
    w.put(_rev(int(llc[256]), 1), 1)
    body = w.bytes()
    return np.frombuffer(body + b"\x00" * ((-len(body)) % 4), np.uint32)


def test_deep_15bit_literal_stream_single_lane_matches_jax():
    """One lane over 2000 15-bit literals: every symbol takes the long-code
    walk, and the lane needs more tokens than a small step bound allows."""
    n = 2000
    got = _shard_indexed(_deep_15bit_stream(n), [0], [0], [2], 1, n, 2048)
    assert bool(got["ok"])
    assert got["out"][:n].tobytes() == bytes(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_long_code_tables_match_host_lut(seed):
    """Phase A's tables resolve every 15-bit peek like the host flat LUT,
    through the 11-bit LUT or the long-code walk."""
    rng = np.random.default_rng(seed)
    lens = {0: 1, 1: 1}
    syms, nxt = [0, 1], 2
    for _ in range(400):               # random complete tree, deep codes
        if nxt >= 286:
            break
        s = syms[rng.integers(0, len(syms))]
        if lens[s] >= 15:
            continue
        lens[s] += 1
        lens[nxt] = lens[s]
        syms.append(nxt)
        nxt += 1
    ll = np.zeros(DS.N_LL, np.int64)
    for s, l in lens.items():
        ll[s] = l
    sym_lut, len_lut = decode_lut_np(ll[:286], 15)
    lut, cnt, order, over = DI._tables(torch.from_numpy(ll)[None], DS.LL_PAY,
                                       DS.LL_SHIFT)
    assert not bool(over[0])
    assert ll.max() > DS.LUT_BITS
    peeks = torch.from_numpy(rng.integers(0, 1 << 15, 4000))
    e = DS._lookup(lut, cnt, order, torch.as_tensor(DS.LL_PAY),
                   torch.zeros_like(peeks), peeks, DS.LL_SHIFT).numpy()
    p = peeks.numpy()
    valid = (len_lut[p] > 0) & (sym_lut[p] < 286)
    np.testing.assert_array_equal((e >> 14)[valid] & 0xF, len_lut[p][valid])
    np.testing.assert_array_equal(e[valid] & 0x3FFF,
                                  DS.LL_PAY[sym_lut[p][valid]])
    assert (e[len_lut[p] == 0] == 0).all()


# --------------------------------------------------------------- mutations

def test_word_mutations_match_jax():
    """Seeded bit flips in the token words (test_fuzz.py's manner): the same
    ok and bad_lanes as JAX, and no silent identity."""
    data, r = _encode("text", S, S - 4000)
    valid = S - 4000
    nw = int(r["total_bits"]) // 32 - 1
    rng = np.random.default_rng(11)
    flagged = 0
    for _ in range(8):
        w = r["words"].copy()
        for _ in range(rng.integers(1, 4)):
            w[rng.integers(0, nw)] ^= 1 << int(rng.integers(0, 32))
        args = _blocks_args(r, w)
        got = _port_blocks(args, valid, S)
        _same(got, _jax_blocks(args, valid, S), valid)
        if bool(got["ok"]):
            assert got["out"][:valid].tobytes() != data[:valid].tobytes()
        else:
            flagged += 1
    assert flagged >= 3


def test_index_mutations_match_jax():
    """Wrong block and lane offsets, and a reserved BTYPE."""
    valid = S - 2000
    data, r = _encode("mixed", S, valid, seed=3)
    rng = np.random.default_rng(12)
    nb = int(r["n_blocks"])
    live = np.flatnonzero(r["sub_blk"] >= 0)
    cases = []
    for _ in range(3):
        m = dict(r)
        m["sub_bit"] = r["sub_bit"].copy()
        m["sub_bit"][rng.choice(live)] += int(rng.integers(1, 40))
        cases.append(m)
    for _ in range(2):
        m = dict(r)
        m["block_bit_base"] = r["block_bit_base"].copy()
        m["block_bit_base"][rng.integers(0, nb)] += int(rng.integers(1, 2000))
        m["sub_bit"] = np.where(r["sub_out"] == r["block_out_start"][0], -1,
                                r["sub_bit"])
        cases.append(m)
    m = dict(r)
    m["btype"] = r["btype"].copy()
    m["btype"][0] = 3
    cases.append(m)
    m = dict(r)
    m["sub_out"] = r["sub_out"].copy()
    m["sub_out"][live[len(live) // 2]] -= 5
    cases.append(m)
    n_bad = 0
    for m in cases:
        args = _blocks_args(m)
        got = _port_blocks(args, valid, S)
        _same(got, _jax_blocks(args, valid, S), valid)
        n_bad += not bool(got["ok"])
        assert (not bool(got["ok"])
                or got["out"][:valid].tobytes() != data[:valid].tobytes())
    assert n_bad >= len(cases) - 2


def test_garbage_words_terminate_like_jax():
    rng = np.random.default_rng(13)
    words = rng.integers(0, 2**32, 512, dtype=np.uint32)
    got = _shard_indexed(words, [0, 100, 1000, 4000],
                         [0, 4096, 8192, 12288], [2, 2, 1, 2], 4, 1 << 14,
                         1 << 14)
    assert not bool(got["ok"])


# ---------------------------------------------------- the kernel's wrapper

def test_decode_symbols_cpu_takes_plain_version():
    """On CPU tensors the wrapper is its plain version and launches
    nothing; malformed arguments raise."""
    _, r = _encode("text", S, S)
    p = DI.plan(torch.from_numpy(r["words"]), *_blocks_args(r)[1:], S)
    args = DI.phase_b_args(p, S, C.WINDOW_SIZE)
    before = DS.decode_symbols.launches
    got = DS.decode_symbols(*args)
    want = DS.decode_symbols_ref(*args)
    assert DS.decode_symbols.launches == before
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert bool(got.done[p.ln.llive].all()) and not bool(got.bad.any())
    with pytest.raises(TypeError):
        DS.decode_symbols(p.w, *args[1:])        # int64 words
    with pytest.raises(ValueError):
        DS.decode_symbols(args[0], p.ln.bp.int(), *args[2:])


def test_lut_gather_cpu_is_plain_take():
    rng = np.random.default_rng(0)
    tbl = torch.from_numpy(rng.integers(0, 1000, 2048).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 2048, 4096).astype(np.int32))
    before = LG.lut_gather.launches
    assert torch.equal(LG.lut_gather(tbl, idx), tbl[idx.long()])
    assert LG.lut_gather.launches == before
    with pytest.raises(ValueError):
        LG.lut_gather(tbl[:1000], idx)


def _old_cta_plan(lblk, visit, NB, threads=128):
    """The plan of the first kernel (128 lanes per CTA, per-block counts by
    bincount), as it was: the reference of the lane-to-block assignment."""
    NL = lblk.shape[0]
    key = torch.where(visit, lblk.long(), NB)
    order = torch.argsort(key, stable=True).to(torch.int32)
    cnt = torch.bincount(key, minlength=NB + 1)[:NB]
    ncta = (cnt + threads - 1) // threads
    cta_end = torch.cumsum(ncta, 0)
    G = NL // threads + NB + 1
    c = torch.arange(G)
    cb = torch.searchsorted(cta_end, c, right=True)
    cbc = cb.clamp(max=NB - 1)
    seg = torch.cumsum(cnt, 0) - cnt
    k = c - (cta_end - ncta)[cbc]
    first = seg[cbc] + k * threads
    ccnt = (cnt[cbc] - k * threads).clamp(0, threads)
    cta_blk = torch.where(cb < NB, cbc, -1)
    return [(int(b), order[f:f + n].tolist())
            for b, f, n in zip(cta_blk.tolist(), first.tolist(),
                               ccnt.tolist()) if b >= 0]


@pytest.mark.parametrize("NL,NB,seed", [(1, 1, 0), (300, 7, 1),
                                        (5000, 3, 2), (20000, 288, 3),
                                        (3000, 40_000, 4), (2000, 5, 5)])
def test_cta_rounds_assign_lanes_like_the_old_plan(NL, NB, seed):
    """The kernel's schedule decodes the lanes the first kernel's plan
    visited, each once, with its own block's tables; a round stages at
    most TABLE_SETS blocks, and lanes listed block by block (the index's
    order) take one round for every TABLE_SETS blocks in a CTA."""
    rng = np.random.default_rng(seed)
    lblk = torch.from_numpy(rng.integers(-1, NB, NL).astype(np.int32))
    if seed % 2:
        lblk = lblk.sort().values             # the decoder's usual order
    visit = (lblk >= 0) & torch.from_numpy(rng.random(NL) < 0.9)
    old = sorted((i, b) for b, lanes in _old_cta_plan(lblk, visit, NB)
                 for i in lanes)
    ctas = DS.cta_rounds(lblk, visit, NB)
    new = sorted((i, b) for rounds in ctas for rnd in rounds
                 for b, lanes in rnd for i in lanes)
    assert new == old
    assert len(ctas) == -(-NL // DS.THREADS)
    for c, rounds in enumerate(ctas):
        for rnd in rounds:
            assert 1 <= len(rnd) <= DS.TABLE_SETS
            assert all(c * DS.THREADS <= i < (c + 1) * DS.THREADS
                       for _, lanes in rnd for i in lanes)
        n_blocks = len({b for rnd in rounds for b, _ in rnd})
        assert len(rounds) == -(-n_blocks // DS.TABLE_SETS)
