"""Port parity: LZ77 (core/lz77.py) against the JAX package at S = 65,536
on the in-repo corpus kinds, and at S = 1,081,344 (33 tiles), where the
JAX package takes its sorted-order branch and the port the same single
path; there also one whole encode_shard. chosen/length/dist, words and
stats are integers: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.core import lz77 as jl
from deflate_compression_tpu.format import deflate as jd
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.core import lz77 as tl
from deflate_compression_tpu_torch.format import deflate as td

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

S = 65536


@pytest.mark.parametrize("kind,valid_len,lazy", [
    ("text", S, True), ("random", S, True), ("periodic", S, True),
    ("zeros", S, True), ("rgb", S, True), ("mixed", S - 12345, True),
    ("text", 40000, False), ("cpp", S, True),
])
def test_tokenize_matches_jax(kind, valid_len, lazy):
    data = corpus.sample(kind, S, seed=3)
    want = jl.tokenize(jnp.asarray(data), jnp.int32(valid_len),
                       num_candidates=32, lazy=lazy)
    got = tl.tokenize(torch.from_numpy(data), valid_len, num_candidates=32,
                      lazy=lazy)
    for k in ("chosen", "length", "dist"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]), err_msg=k)
    assert not got["chosen"][valid_len:].any()


def test_find_matches_matches_jax():
    data = corpus.sample("mixed", S, seed=9)
    wl, wd = jl.find_matches(jnp.asarray(data), 32)
    gl, gd = tl.find_matches(torch.from_numpy(data), 32)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_greedy_parse_matches_jax_flat():
    rng = np.random.default_rng(11)
    tl_len = np.where(rng.random(8192) < 0.3, rng.integers(3, 40, 8192), 1)
    want = np.asarray(jl.greedy_parse_flat(jnp.asarray(tl_len, jnp.int32)))
    got = tl.greedy_parse(torch.from_numpy(tl_len))
    np.testing.assert_array_equal(got.numpy(), want)


BIG = 1_081_344                 # 33 tiles: over 2^20, JAX's sorted branch
ENCODE_KEYS = ("total_bits", "btype", "block_bits", "block_bytes",
               "tree_bits", "n_tokens", "n_matches", "block_bit_base",
               "block_out_start", "n_blocks", "sub_bit", "sub_out",
               "sub_blk", "sub_overflow")


@pytest.fixture(scope="module")
def big():
    return corpus.sample("mixed", BIG, seed=5)


def test_find_matches_over_1mb_matches_jax(big):
    wl, wd = jl.find_matches(jnp.asarray(big), 32)
    gl, gd = tl.find_matches(torch.from_numpy(big), 32)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    # candidates past 2^20 positions win (the JAX fold's 20-bit field
    # could not carry them)
    assert (gl.numpy()[1 << 20:] > 0).any()


def test_tokenize_over_1mb_matches_jax(big):
    vl = BIG - 4321
    want = jl.tokenize(jnp.asarray(big), jnp.int32(vl), num_candidates=32)
    got = tl.tokenize(torch.from_numpy(big), vl, num_candidates=32)
    for k in ("chosen", "length", "dist"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]), err_msg=k)
    assert not got["chosen"][vl:].any()


def test_encode_shard_over_1mb_matches_jax(big):
    vl = BIG - 777
    want = jd.encode_shard_jit(jnp.asarray(big), jnp.int32(vl),
                               jnp.asarray(False))
    got = td.encode_shard(torch.from_numpy(big), vl, False)
    nw = (int(want["total_bits"]) + 31) // 32
    np.testing.assert_array_equal(
        got["words"][:nw].numpy(),
        np.asarray(want["words"][:nw]).astype(np.int64))
    for k in ENCODE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 5, 31, 33])
def test_tokenize_short_inputs(n):
    """Inputs shorter than the candidate and payload shifts tokenize (the
    JAX package's find_matches needs S >= 32); the parse covers them."""
    data = np.frombuffer((b"abcab" * 10)[:n], np.uint8).copy()
    got = tl.tokenize(torch.from_numpy(data), n)
    tok_len = np.where(got["length"].numpy() >= 3, got["length"].numpy(), 1)
    starts = np.flatnonzero(got["chosen"].numpy())
    assert starts[0] == 0
    assert (starts[1:] == (starts + tok_len[starts])[:-1]).all()
    assert starts[-1] + tok_len[starts[-1]] == n


def test_num_candidates_bounds():
    data = torch.from_numpy(corpus.sample("text", 4096, seed=1))
    for k in (0, 256):
        with pytest.raises(ValueError):
            tl.find_matches(data, k)
    lk, dk = tl.find_matches(data, 255)
    wl, wd = jl.find_matches(jnp.asarray(data.numpy()), 255)
    np.testing.assert_array_equal(lk.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(dk.numpy(), np.asarray(wd))
