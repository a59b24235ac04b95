"""Port parity: encode_shard (format/deflate.py) and ZlibCodec.compress
(models/codec.py) against the JAX package on the CPU. Every output is an
integer: exact equality, bit for bit."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.core import lz77 as jlz77
from deflate_compression_tpu.format import constants as C
from deflate_compression_tpu.format import deflate as jd
from deflate_compression_tpu.models import codec as jcodec
from deflate_compression_tpu.utils.config import CodecConfig
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.models import codec as tcodec
from deflate_compression_tpu_torch.utils.config import CodecConfig as TCodecConfig

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

S = 65536
KEYS = ("total_bits", "btype", "block_bits", "block_bytes", "tree_bits",
        "n_tokens", "n_matches", "block_bit_base", "block_out_start",
        "n_blocks", "sub_bit", "sub_out", "sub_blk", "sub_overflow")


@pytest.fixture(scope="module")
def jax_encode():
    """JAX encode_shard_jit outputs as numpy, cached per case. The static
    arguments are passed the way the JAX codec passes them, so the codec
    test reuses the compiled default program."""
    cache = {}

    def run(kind, size, valid_len, final, force_btype=None,
            _test_stride=None):
        key = (kind, size, valid_len, final, force_btype, _test_stride)
        if key not in cache:
            data = corpus.sample(kind, size, seed=size)
            kw = {} if _test_stride is None else {"_test_stride": _test_stride}
            r = jd.encode_shard_jit(jnp.asarray(data), jnp.int32(valid_len),
                                    jnp.asarray(final), num_candidates=32,
                                    lazy=True, force_btype=force_btype, **kw)
            cache[key] = (data, {k: np.asarray(v) for k, v in r.items()})
        return cache[key]
    return run


def _check_case(jax_encode, kind, size, valid_len, final, **kw):
    data, want = jax_encode(kind, size, valid_len, final, **kw)
    got = td.encode_shard(torch.from_numpy(data), valid_len, final, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    nw = (int(want["total_bits"]) + 31) // 32
    np.testing.assert_array_equal(got["words"][:nw],
                                  want["words"][:nw].astype(np.int64),
                                  err_msg="words")
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return data, got


@pytest.mark.parametrize("kind,valid_len,final", [
    ("text", S, True), ("random", S, True), ("periodic", S, True),
    ("zeros", S, True), ("rgb", S, True), ("mixed", S, False),
    ("mixed", S - 5000, True), ("text", 40000, False), ("text", 1, True),
    ("random", 1, False),
])
def test_encode_shard_matches_jax(jax_encode, kind, valid_len, final):
    data, got = _check_case(jax_encode, kind, S, valid_len, final)
    blob = td.shard_bytes({k: torch.as_tensor(v) for k, v in got.items()})
    if final:
        assert zlib.decompress(blob, wbits=-15) == data[:valid_len].tobytes()


@pytest.mark.parametrize("force_btype", [C.BTYPE_STORED, C.BTYPE_FIXED,
                                         C.BTYPE_DYNAMIC])
def test_encode_shard_forced_btype_matches_jax(jax_encode, force_btype):
    _, got = _check_case(jax_encode, "mixed", S, S - 777, True,
                         force_btype=force_btype)
    bt = got["btype"]
    assert set(bt[bt >= 0].tolist()) == {force_btype}


def test_encode_shard_test_stride_overflow_matches_jax(jax_encode):
    _, got = _check_case(jax_encode, "text", S, S, True, _test_stride=1)
    assert bool(got["sub_overflow"])


@pytest.mark.parametrize("kind", ["text", "cpp", "random", "periodic",
                                  "zeros", "rgb", "mixed"])
def test_sub_stride_from_tile_histograms_matches_jax(jax_encode, kind):
    """The decode entries' stride, which encode_shard now sizes from the
    tile histograms (a tile's chosen positions are its litlen counts'
    sum), equals the JAX encoder's: its Huffman tokens counted from its
    own tokens and blocks."""
    data, want = jax_encode(kind, S, S, True)
    tok = jax.jit(jlz77.tokenize, static_argnames=("num_candidates", "lazy"))(
        jnp.asarray(data), jnp.int32(S), num_candidates=32, lazy=True)
    chosen = np.asarray(tok["chosen"])
    nb = int(want["n_blocks"])
    starts = want["block_out_start"][:nb]
    ends = np.append(starts[1:], S)
    n_tok_h = sum(int(chosen[a:b].sum()) for a, b, bt in
                  zip(starts, ends, want["btype"][:nb]) if bt != 0)
    nsub, NB = S // 64, S // 32768
    jax_stride = max((n_tok_h + nsub - NB - 1) // (nsub - NB), 1)
    args = corpus.block_stage_inputs(torch.from_numpy(data), S,
                                     True)["pack_words"][2]
    assert int(args[13]) == jax_stride


def test_encode_shard_17_tiles_matches_jax(jax_encode):
    """17 tiles: block_plan's DP runs past JAX's unrolled branch (M > 16)."""
    _, got = _check_case(jax_encode, "mixed", 17 * 32768, 17 * 32768 - 3000,
                         True)
    assert 1 < int(got["n_blocks"]) < 17


def test_zlib_codec_matches_jax_three_shards():
    cfg = CodecConfig(shard_size=S)
    raw = corpus.build_corpus(2 * S + 20000, seed=5)
    want, wst = jcodec.ZlibCodec(cfg).compress(raw, return_stats=True)
    got, gst = tcodec.ZlibCodec(TCodecConfig(shard_size=S),
                                device="cpu").compress(
        raw, return_stats=True)
    assert got == want
    assert zlib.decompress(got) == raw
    # the raw stream inside the zlib container (2-byte header, 4-byte adler)
    assert td.deflate_compress_bytes(raw, S, device="cpu") == want[2:-4]
    for f in ("n_blocks", "n_tokens", "n_matches", "btype_counts",
              "tree_bits", "block_bits", "block_bytes", "output_bytes"):
        assert getattr(gst, f) == getattr(wst, f), f


def test_empty_input_matches_jax():
    assert tcodec.ZlibCodec(TCodecConfig(shard_size=S),
                            device="cpu").compress(b"") == \
        jcodec.ZlibCodec(CodecConfig(shard_size=S)).compress(b"")
