"""Port parity: the plain versions of the LZ77 stage's two kernels,
`find_matches_ref` (ops/find_matches.py, a hash-chain walk) and
`lz_parse_ref` (ops/lz_parse.py, runs, chain extension, clamps, lazy and
the parse), against the JAX package's find_matches and tokenize on the
CPU. The same seeded inputs go through both; lengths, distances and the
chosen flags are integers: exact equality. The edge cases are
`corpus.lz_case`'s, on which tests/test_torch_cuda.py holds the CUDA
kernels against these plain versions on the card; inputs shorter than the JAX
package takes (S >= 32) are held against a direct Python walk of the
rules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.core import lz77 as jl
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.core import lz77 as tl
from deflate_compression_tpu_torch.corpus import LZ_CASES, hash3_np, lz_case
from deflate_compression_tpu_torch.format import constants as C
from deflate_compression_tpu_torch.ops import find_matches as FM
from deflate_compression_tpu_torch.ops import lz_parse as LP

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

S = 1 << 16
WINDOW = C.WINDOW_SIZE
KINDS = ["text", "random", "periodic", "zeros", "rgb", "cpp", "mixed"]


def _equal(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
def test_find_matches_ref_matches_jax_on_kinds(kind):
    data = corpus.sample(kind, S, seed=11)
    wl, wd = jl.find_matches(jnp.asarray(data), 32)
    gl, gd = FM.find_matches_ref(torch.from_numpy(data), 32)
    _equal(gl, wl, "length")
    _equal(gd, wd, "dist")


@pytest.mark.parametrize("kind", KINDS)
def test_lz_parse_ref_alone_matches_jax_on_kinds(kind):
    """lz_parse_ref on the JAX package's own matches equals its tokenize:
    the second kernel's plain version held apart from the first's."""
    data = corpus.sample(kind, S, seed=12)
    vl = S - 4321
    wl, wd = jl.find_matches(jnp.asarray(data), 32)
    want = jl.tokenize(jnp.asarray(data), jnp.int32(vl), num_candidates=32)
    got = LP.lz_parse_ref(torch.from_numpy(data),
                          torch.from_numpy(np.asarray(wl, np.int64)),
                          torch.from_numpy(np.asarray(wd, np.int64)), vl)
    for k in ("chosen", "length", "dist"):
        _equal(got[k], want[k], k)


BIG = 1_081_344                 # 33 tiles: over 2^20, JAX's sorted branch


def test_lz_parse_ref_alone_matches_jax_over_1mb():
    big = corpus.sample("mixed", BIG, seed=5)
    vl = BIG - 4321
    wl, wd = jl.find_matches(jnp.asarray(big), 32)
    want = jl.tokenize(jnp.asarray(big), jnp.int32(vl), num_candidates=32)
    got = LP.lz_parse_ref(torch.from_numpy(big),
                          torch.from_numpy(np.asarray(wl, np.int64)),
                          torch.from_numpy(np.asarray(wd, np.int64)), vl)
    for k in ("chosen", "length", "dist"):
        _equal(got[k], want[k], k)


JAX_CASES = [c for c in LZ_CASES if c not in ("s1", "s2")]     # S >= 32


@pytest.mark.parametrize("name", JAX_CASES)
def test_edge_cases_match_jax(name):
    data, vl, lazy, k = lz_case(name)
    wl, wd = jl.find_matches(jnp.asarray(data), k)
    gl, gd = FM.find_matches_ref(torch.from_numpy(data), k)
    _equal(gl, wl, "length")
    _equal(gd, wd, "dist")
    want = jl.tokenize(jnp.asarray(data), jnp.int32(vl), num_candidates=k,
                       lazy=lazy)
    got = tl.tokenize(torch.from_numpy(data), vl, num_candidates=k,
                      lazy=lazy)
    for key in ("chosen", "length", "dist"):
        _equal(got[key], want[key], key)
    assert not got["chosen"][vl:].any()


def _matches(name):
    data, vl, lazy, k = lz_case(name)
    x = torch.from_numpy(data)
    length, dist = FM.find_matches_ref(x, k)
    return data, length.numpy(), dist.numpy(), tl.tokenize(x, vl, k, lazy)


def test_edge_case_tail_tie_is_decided_by_the_padding():
    """At S - 5 the farther candidate (followed by zeros, equal to the
    padding) scores 11 bytes and beats the nearer (5): its distance wins,
    and the length is cut to the 5 bytes left."""
    data, length, dist, _ = _matches("tail_tie")
    S = data.shape[0]
    assert (length[S - 5], dist[S - 5]) == (5, S - 5 - 1000)


@pytest.mark.parametrize("k,want", [(1, (0, 0)), (2, (23, 2000))])
def test_edge_case_collision_uses_up_a_candidate(k, want):
    """A different trigram of the same hash between 3000 and its match at
    1000: with K = 1 it is the only candidate (no match), with K = 2 the
    match is found."""
    data, length, dist, _ = _matches(f"collision_k{k}")
    h = hash3_np(data)
    assert h[1000] == h[2000] and bytes(data[1000:1003]) != bytes(
        data[2000:2003])
    assert (length[3000], dist[3000]) == want


def test_edge_case_window_edge():
    _, length, dist, _ = _matches("dist_32768")
    assert (length[100 + WINDOW], dist[100 + WINDOW]) == (35, WINDOW)
    assert length[200 + WINDOW + 1] == 0


def test_edge_case_clamps_keep_dist():
    """Matches cut below 3 bytes at the tile boundary and at valid_len
    keep their distance; the one cut to 10 bytes keeps its length."""
    data, vl, _, _ = lz_case("clamp_dist")
    _, _, _, tok = _matches("clamp_dist")
    ln, ds = tok["length"].numpy(), tok["dist"].numpy()
    assert ln[WINDOW - 10] == 10
    for i in (WINDOW - 2, WINDOW - 1, vl - 2, vl - 1):
        assert ln[i] == 0 and ds[i] > 0
    assert not tok["chosen"][vl:].any()


def test_edge_case_chain_reaches_258():
    _, _, _, tok = _matches("chain")
    ln = tok["length"].numpy()
    assert ln.max() == 258 and (ln[tok["chosen"].numpy()] == 258).sum() > 100


def _walk_rules(data: np.ndarray, k: int):
    """find_matches by the rules, one position at a time: the K nearest
    earlier positions of the same hash (none over 32768 back), 11-byte
    preselect, nearest on ties, 35-byte rescore."""
    S = data.shape[0]
    h = hash3_np(data)
    b = np.concatenate([data, np.zeros(40, np.uint8)])

    def equal_run(i, j, cap):
        n = 0
        while n < cap and b[i + n] == b[j + n]:
            n += 1
        return n
    length = np.zeros(S, np.int64)
    dist = np.zeros(S, np.int64)
    seen = {}
    for i in range(S):
        earlier = seen.setdefault(int(h[i]), [])
        cands = [j for j in earlier[::-1][:k] if i - j <= WINDOW]
        earlier.append(i)
        if not cands:
            continue
        nbs = [equal_run(i, j, 11) for j in cands]
        j = cands[nbs.index(max(nbs))]
        n = min(equal_run(i, j, 35), 258, S - i)
        if n >= 3:
            length[i], dist[i] = n, i - j
    return length, dist


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 31, 33])
@pytest.mark.parametrize("k", [1, 32])
def test_short_inputs_by_the_rules(n, k):
    """Shards shorter than the JAX package takes: find_matches_ref equals a
    direct walk of the rules, and tokenize's starts tile [0, n)."""
    data = np.frombuffer((b"aab" * 20)[:n], np.uint8).copy()
    gl, gd = FM.find_matches_ref(torch.from_numpy(data), k)
    wl, wd = _walk_rules(data, k)
    _equal(gl, wl, "length")
    _equal(gd, wd, "dist")
    tok = tl.tokenize(torch.from_numpy(data), n, num_candidates=k)
    ln = tok["length"].numpy()
    starts = np.flatnonzero(tok["chosen"].numpy())
    step = np.where(ln[starts] >= 3, ln[starts], 1)
    assert starts[0] == 0 and starts[-1] + step[-1] == n
    assert (starts[1:] == (starts + step)[:-1]).all()


@pytest.mark.parametrize("kind", ["text", "rgb", "mixed"])
def test_find_matches_ref_matches_the_rules(kind):
    """A few thousand positions of real data against the direct walk."""
    data = corpus.sample(kind, 3000, seed=13)
    gl, gd = FM.find_matches_ref(torch.from_numpy(data), 8)
    wl, wd = _walk_rules(data, 8)
    _equal(gl, wl, "length")
    _equal(gd, wd, "dist")


def _nearest_earlier(h: np.ndarray) -> np.ndarray:
    """back[i] by a direct scan: i minus the last earlier position of hash
    h[i], 0 where there is none or it lies over 32768 back."""
    last, back = {}, np.zeros(h.shape[0], np.int64)
    for i, x in enumerate(h.tolist()):
        j = last.get(x)
        if j is not None and i - j <= WINDOW:
            back[i] = i - j
        last[x] = i
    return back


@pytest.mark.parametrize("name", ["link_two_tiles", "long_chains",
                                  "dist_32768", "collision_k2", "s36865"])
def test_back_links_match_a_direct_scan(name):
    """The 16-bit links the kernels stage (`_back_links`) equal the nearest
    earlier same-hash position within the window, found by a scan."""
    data = lz_case(name)[0]
    got = FM._back_links(FM._hash3(torch.from_numpy(data)))
    _equal(got, _nearest_earlier(hash3_np(data)))
    assert int(got.max()) <= WINDOW


@pytest.mark.parametrize("kind", ["mixed", "zeros"])
def test_packed_hand_off_equals_the_int64_pair(kind):
    """find_matches_packed is pack(find_matches), unpack inverts it (dist
    32768 included), and lz_parse_packed equals lz_parse."""
    data = torch.from_numpy(corpus.sample(kind, 1 << 16, seed=14))
    length, dist = FM.find_matches(data, 32)
    packed = FM.find_matches_packed(data, 32)
    assert packed.dtype == torch.int32
    _equal(packed, FM.pack(length, dist).numpy())
    for g, w in zip(FM.unpack(packed), (length, dist)):
        _equal(g, w.numpy())
    edge = FM.pack(torch.tensor([258, 35]), torch.tensor([32768, 1]))
    assert [t.tolist() for t in FM.unpack(edge)] == [[258, 35], [32768, 1]]
    got = LP.lz_parse_packed(data, packed, 60_000)
    want = LP.lz_parse(data, length, dist, 60_000)
    for key in ("chosen", "length", "dist"):
        _equal(got[key], want[key].numpy(), key)


def test_edge_case_link_two_tiles():
    """A link of exactly 32768 to the nearer of two same-hash positions in
    the tile before is taken (a 35-byte match); one of 32769 is not."""
    data, length, dist, _ = _matches("link_two_tiles")
    at = [30_000, 31_000, 31_000 + WINDOW, 31_000 + 2 * WINDOW + 1]
    assert np.array_equal(np.flatnonzero(hash3_np(data) == hash3_np(data)[
        at[0]]), at)
    assert (length[at[2]], dist[at[2]]) == (35, WINDOW)
    assert (length[at[3]], dist[at[3]]) == (0, 0)


def test_edge_case_long_chains_run_the_full_k():
    """Every trigram position with 32 predecessors scores all 32 (none
    reaches 11 bytes) and keeps a match among them: 3 bytes or a few more,
    at most 32 * 16 back."""
    data, vl, lazy, k = lz_case("long_chains")
    stats = {}
    length, dist = FM.find_matches_ref(torch.from_numpy(data), k, stats)
    busy = np.arange(16 * k, data.shape[0], 16)
    assert stats["visits"] >= k * busy.shape[0]
    ln, ds = length.numpy()[busy], dist.numpy()[busy]
    assert ((ln >= 3) & (ln < 11)).all() and (ln == 3).mean() > 0.8
    assert ((ds % 16 == 0) & (ds >= 16) & (ds <= 16 * k)).all()


def test_edge_case_parse_subtile_tokens_cross_the_edges():
    """A 258-byte token crosses every even 4 KB edge that has an earlier
    copy (a 32 KB tile edge cuts its token there), and a constant run
    token crosses every odd edge."""
    _, _, _, tok = _matches("parse_subtile")
    ln, ds = tok["length"].numpy(), tok["dist"].numpy()
    starts = np.flatnonzero(tok["chosen"].numpy())
    for e in range(4096, 1 << 16, 4096):
        over = [s for s in starts if s < e < s + ln[s]]
        if e // 4096 % 2:
            assert [ds[s] for s in over] == [1], e
        elif e % WINDOW and e >= 16384:
            assert [(ln[s], ds[s]) for s in over] == [(258, 8192)], e
