"""Port parity: the decode index, decompress_indexed and the streaming
encoder's index sink (decode/index.py, models/codec.py) and adler32_torch
(core/checksum.py) against the JAX package on the CPU. Indexes compare as
their .dcx bytes, decoded streams byte for byte, checksums exactly."""
import io
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_compression_tpu.core.checksum import adler32_jax
from deflate_compression_tpu.decode import index as jidx
from deflate_compression_tpu.models import codec as jcodec
from deflate_compression_tpu.utils.config import CodecConfig as JaxConfig
from deflate_compression_tpu.utils.errors import DeflateError as JaxDeflateError
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.core.checksum import (adler32_combine,
                                                         adler32_torch)
from deflate_compression_tpu_torch.decode import index as tidx
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.models import codec as tcodec
from deflate_compression_tpu_torch.utils.config import CodecConfig
from deflate_compression_tpu_torch.utils.errors import DeflateError

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

S = 1 << 16
TEXT = corpus.sample("text", 300_000).tobytes()


def _own_stream(raw, shard=S):
    return td.deflate_compress_bytes(raw, shard, device="cpu")


def _same_index(a, b):
    assert a.to_bytes() == b.to_bytes()


def _skewed(n, seed):
    """Skewed bytes that drive zlib's trees to deep (up to 15-bit) codes."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefgh" * 4 + b"\x00" * 200, np.uint8)
    return rng.choice(alphabet, n).tobytes()


# ------------------------------------------------------------------ index

@pytest.mark.parametrize("source", ["zlib6", "own"])
@pytest.mark.parametrize("native", [True, False])
def test_build_index_matches_jax(source, native):
    raw = TEXT[:120_000] + corpus.sample("random", 30_000, 9).tobytes()
    comp = zlib.compress(raw, 6)[2:-4] if source == "zlib6" \
        else _own_stream(raw)
    got = tidx.build_index(comp, prefer_native=native)
    _same_index(got, jidx.build_index(comp, prefer_native=native))
    assert got.out_len == len(raw)


def test_index_bytes_cross_read():
    comp = zlib.compress(TEXT[:90_000], 9)[2:-4]
    blob = jidx.build_index(comp).to_bytes()
    port = tidx.DecodeIndex.from_bytes(blob)
    assert port.to_bytes() == blob
    back = jidx.DecodeIndex.from_bytes(port.to_bytes())
    for f in ("bit_base", "out_start", "btype", "sub_bit", "sub_out",
              "sub_blk"):
        np.testing.assert_array_equal(getattr(port, f), getattr(back, f))
    assert port.out_len == back.out_len == 90_000
    assert port.block_for_offset(50_000) == back.block_for_offset(50_000)
    v1 = tidx.DecodeIndex(port.bit_base, port.out_start, port.btype,
                          port.out_len)
    assert tidx.DecodeIndex.from_bytes(v1.to_bytes()).sub_bit.size == 0
    with pytest.raises(DeflateError):
        tidx.DecodeIndex.from_bytes(b"XXXX" + blob[4:])


def test_index_with_sub_entries_out_of_output_order_rejected():
    """Sub-entries whose output offsets decrease would give the decoder
    overlapping lanes: reading such an index, or decoding with it, raises
    E_INDEX; the same index in order decodes."""
    comp = zlib.compress(TEXT[:90_000], 9)[2:-4]
    idx = tidx.build_index(comp, sub_size=4096)
    assert idx.n_subs > 3
    so = idx.sub_out.copy()
    so[1], so[2] = so[2], so[1]
    bad = tidx.DecodeIndex(idx.bit_base, idx.out_start, idx.btype,
                           idx.out_len, idx.sub_bit, so, idx.sub_blk)
    with pytest.raises(DeflateError) as e:
        tidx.DecodeIndex.from_bytes(bad.to_bytes())
    assert e.value.name == "E_INDEX"
    with pytest.raises(DeflateError) as e:
        tidx.decompress_indexed(comp, bad, device="cpu")
    assert e.value.name == "E_INDEX"
    assert tidx.decompress_indexed(
        comp, tidx.DecodeIndex.from_bytes(idx.to_bytes()),
        device="cpu") == TEXT[:90_000]


def test_index_from_shards_and_stream_sink_match_jax():
    """The encoder's index, from the port's torch shard dicts and from
    compress_stream's sink, equals JAX's index_from_shards of the same
    stats; the streamed bytes equal ZlibCodec.compress's."""
    cfg = CodecConfig(shard_size=S)
    raw = corpus.build_corpus(2 * S + 12_345, seed=4)
    shards = list(td.encode_shards(raw, S, torch.device("cpu")))
    bits = [int(r["total_bits"]) for r in shards]
    lens = [min(S, len(raw) - i * S) for i in range(len(shards))]
    got = tidx.index_from_shards(shards, bits, lens)
    np_shards = [{k: v.numpy() for k, v in r.items()} for r in shards]
    _same_index(got, jidx.index_from_shards(np_shards, bits, lens))
    sink = []
    blob = b"".join(tcodec.compress_stream(io.BytesIO(raw), cfg,
                                           index_sink=sink, device="cpu"))
    assert blob == tcodec.ZlibCodec(cfg, device="cpu").compress(raw)
    _same_index(tidx.index_from_shards(*zip(*sink)), got)
    assert tidx.decompress_indexed(
        blob[2:-4], got, expected_adler=zlib.adler32(raw),
        device="cpu") == raw


def test_compress_file_writes_stream_and_index(tmp_path):
    cfg = CodecConfig(shard_size=S, container="raw")
    raw = TEXT[:S + 5000]
    src, dst, dcx = (tmp_path / n for n in ("in", "out", "out.dcx"))
    src.write_bytes(raw)
    n = tcodec.compress_file(str(src), str(dst), cfg, index_path=str(dcx),
                             device="cpu")
    body = dst.read_bytes()
    assert n == len(body) and zlib.decompress(body, wbits=-15) == raw
    idx = jidx.DecodeIndex.from_bytes(dcx.read_bytes())
    assert idx.out_len == len(raw) and idx.n_subs > 0
    assert tidx.decompress_indexed(
        body, tidx.DecodeIndex.from_bytes(dcx.read_bytes()),
        device="cpu") == raw
    gz = CodecConfig(shard_size=S, container="gzip")
    assert b"".join(tcodec.compress_stream([raw], gz, device="cpu")) == \
        b"".join(jcodec.compress_stream([raw], JaxConfig(shard_size=S,
                                                         container="gzip")))


# ----------------------------------------------------- decompress_indexed

def test_decompress_indexed_cross_group_window_matches_jax():
    """Groups of about 40000 bytes, smaller than the encoder's shards:
    distances cross group ends through the carried 32 KB window."""
    raw = b"A" * 5000 + TEXT[:70_000]
    raw = raw + raw[:30_000]
    comp = _own_stream(raw, 1 << 17)
    idx = tidx.build_index(comp)
    got = tidx.decompress_indexed(comp, idx, shard_out=40_000, device="cpu")
    assert got == raw
    assert jidx.decompress_indexed(comp, jidx.build_index(comp),
                                   shard_out=40_000) == got


def test_decompress_indexed_foreign_zlib9_matches_jax():
    """A zlib level-9 stream with 15-bit codes, through build_index."""
    raw = _skewed(40_000, 9) + TEXT[:30_000]
    z = zlib.compress(raw, 9)
    body, adler = z[2:-4], int.from_bytes(z[-4:], "big")
    idx = tidx.build_index(body, prefer_native=False)
    got = tidx.decompress_indexed(body, idx, expected_adler=adler,
                                  device="cpu")
    assert got == raw
    assert jidx.decompress_indexed(body, jidx.build_index(body),
                                   expected_adler=adler) == got


def test_decompress_indexed_adler_mismatch_raises_like_jax():
    raw = TEXT[:50_000]
    comp = _own_stream(raw)
    good = zlib.adler32(raw)
    idx = tidx.build_index(comp)
    assert tidx.decompress_indexed(comp, idx, expected_adler=good,
                                   device="cpu") == raw
    with pytest.raises(DeflateError):
        tidx.decompress_indexed(comp, idx, expected_adler=good ^ 0x10000,
                                device="cpu")
    with pytest.raises(JaxDeflateError):
        jidx.decompress_indexed(comp, jidx.build_index(comp),
                                expected_adler=good ^ 0x10000)


def test_verified_path_no_mutation_survives():
    """With the adler check on, a mutated stream raises or decodes exactly."""
    raw = TEXT[:50_000]
    comp = _own_stream(raw)
    idx = tidx.build_index(comp)
    good = zlib.adler32(raw)
    rng = np.random.default_rng(21)
    for _ in range(12):
        m = bytearray(comp)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        try:
            out = tidx.decompress_indexed(bytes(m), idx, expected_adler=good,
                                          device="cpu")
        except DeflateError:
            continue
        assert out == raw


PAT = b"The quick brown fox jumps over the lazy dog 0123456789!"
WDATA = PAT * 20 + bytes(np.random.default_rng(3).integers(
    0, 256, 2000, dtype=np.uint8)) + PAT * 20


def test_window_violation_rejected_like_jax():
    """zlib-9 emits distances over 512 here: a declared 512-byte window
    rejects the stream on both decoders; the honest window decodes it."""
    body = zlib.compress(WDATA, 9)[2:-4]
    idx = tidx.build_index(body)
    with pytest.raises(DeflateError):
        tidx.decompress_indexed(body, idx, max_dist=512, device="cpu")
    with pytest.raises(JaxDeflateError):
        jidx.decompress_indexed(body, jidx.build_index(body), max_dist=512)
    assert tidx.decompress_indexed(body, idx, max_dist=32768,
                                   device="cpu") == WDATA


# ------------------------------------------------------------------ adler

@pytest.mark.parametrize("n,valid", [(1, 1), (5552, 5552), (40_000, 33_333),
                                     (65_536, 65_536), (70_000, 0)])
def test_adler32_torch_matches_jax_and_zlib(n, valid):
    data = corpus.sample("mixed", n, seed=n)
    got = int(adler32_torch(torch.from_numpy(data), valid))
    assert got == int(adler32_jax(jnp.asarray(data), jnp.int32(valid)))
    assert got == zlib.adler32(data[:valid].tobytes())


def test_adler32_combine():
    a, b = TEXT[:1000], TEXT[1000:71_000]
    assert adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b)) == \
        zlib.adler32(a + b)
