"""Port parity: checkpoint/resume of file encodes (parallel/checkpoint.py)
against the JAX package's on the CPU. A job killed after a shard and run
again must give the bytes of an uninterrupted run, and the manifest is the
JAX package's byte for byte, so either package resumes the other's job.

Tolerance: identical bytes (output and manifest). Inputs are made from a
seed by `corpus.build_corpus`."""
import os
import zlib

import pytest
import torch

from deflate_compression_tpu.parallel import checkpoint as jck
from deflate_compression_tpu.utils.config import CodecConfig as JaxConfig
from deflate_compression_tpu.utils.errors import DistError as JaxDistError
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.models.codec import ZlibCodec
from deflate_compression_tpu_torch.parallel import checkpoint as tck
from deflate_compression_tpu_torch.utils.config import CodecConfig
from deflate_compression_tpu_torch.utils.errors import DistError

torch.set_num_threads(1)

S = 32768
CFG = CodecConfig(shard_size=S)
JCFG = JaxConfig(shard_size=S)
RAW = corpus.build_corpus(3 * S + 20_000, seed=11)


class Boom(Exception):
    pass


def bomb_at(shard):
    def cb(s, n):
        if s == shard:
            raise Boom()
    return cb


def port_run(src, dst, cfg=CFG, **kw):
    return tck.compress_file_resumable(str(src), str(dst), cfg,
                                       device="cpu", **kw)


@pytest.fixture
def src(tmp_path):
    p = tmp_path / "input.bin"
    p.write_bytes(RAW)
    return p


@pytest.fixture(scope="module")
def jax_whole(tmp_path_factory):
    """The JAX package's uninterrupted output of RAW."""
    d = tmp_path_factory.mktemp("jax")
    (d / "in").write_bytes(RAW)
    jck.compress_file_resumable(str(d / "in"), str(d / "out"), JCFG)
    return (d / "out").read_bytes()


def test_uninterrupted(src, tmp_path, jax_whole):
    dst = tmp_path / "out.zz"
    info = port_run(src, dst)
    assert info == {"input_bytes": len(RAW), "output_bytes": len(jax_whole),
                    "n_shards": 4, "resumed_at_shard": 0}
    assert dst.read_bytes() == jax_whole
    assert dst.read_bytes() == ZlibCodec(CFG, device="cpu").compress(RAW)
    assert zlib.decompress(dst.read_bytes()) == RAW
    assert not os.path.exists(str(dst) + ".ckpt")


def test_resume_after_crash(src, tmp_path, jax_whole):
    dst = tmp_path / "out.zz"
    with pytest.raises(Boom):
        port_run(src, dst, progress_cb=bomb_at(1))
    assert os.path.exists(str(dst) + ".ckpt")
    info = port_run(src, dst)
    assert info["resumed_at_shard"] == 2          # shards 0, 1 were durable
    assert dst.read_bytes() == jax_whole


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_one_package_resumes_the_others_job(src, tmp_path, jax_whole, first,
                                            second):
    """Crashed after shard 1 by one package, resumed by the other: the
    bytes of one uninterrupted JAX run. Before the resume, both packages'
    manifests of the same crash are equal byte for byte."""
    runs = {"jax": lambda d, **kw: jck.compress_file_resumable(
                str(src), str(d), JCFG, **kw),
            "port": lambda d, **kw: port_run(src, d, **kw)}
    dst = tmp_path / "out.zz"
    with pytest.raises(Boom):
        runs[first](dst, progress_cb=bomb_at(1))
    other = tmp_path / "other.zz"
    with pytest.raises(Boom):
        runs[second](other, progress_cb=bomb_at(1))
    manifest = (tmp_path / "out.zz.ckpt").read_bytes()
    assert manifest == (tmp_path / "other.zz.ckpt").read_bytes()
    assert other.read_bytes() == dst.read_bytes()
    info = runs[second](dst)
    assert info["resumed_at_shard"] == 2
    assert dst.read_bytes() == jax_whole


def test_stale_checkpoint_restarts(src, tmp_path):
    dst = tmp_path / "out.zz"
    with pytest.raises(Boom):
        port_run(src, dst, progress_cb=bomb_at(0))
    src.write_bytes(b"Q" + RAW[1:])      # input changed: checkpoint stale
    info = port_run(src, dst)
    assert info["resumed_at_shard"] == 0
    assert zlib.decompress(dst.read_bytes()) == b"Q" + RAW[1:]


def test_output_shorter_than_checkpoint_raises(src, tmp_path):
    dst = tmp_path / "out.zz"
    with pytest.raises(Boom):
        port_run(src, dst, progress_cb=bomb_at(1))
    os.truncate(dst, 10)
    with pytest.raises(DistError) as e:
        port_run(src, dst)
    assert e.value.name == "E_RESUME"


def test_manifest_roundtrip_and_cross_read(tmp_path):
    cp = tck.CheckpointManager(str(tmp_path / "m.ckpt"))
    assert cp.load() is None
    cp.save({"version": 1, "x": 42})
    assert cp.load()["x"] == 42
    assert jck.CheckpointManager(cp.path).load() == cp.load()
    cp.save({"version": 2, "x": 1})        # another manifest version
    assert cp.load() is None
    cp.clear()
    assert cp.load() is None


def test_empty_input(tmp_path):
    src = tmp_path / "empty.bin"
    src.write_bytes(b"")
    info = port_run(src, tmp_path / "p.zz")
    jck.compress_file_resumable(str(src), str(tmp_path / "j.zz"), JCFG)
    assert info["input_bytes"] == 0 and info["n_shards"] == 1
    assert (tmp_path / "p.zz").read_bytes() == \
        (tmp_path / "j.zz").read_bytes()
    assert zlib.decompress((tmp_path / "p.zz").read_bytes()) == b""


@pytest.mark.parametrize("block_type", ["stored", "fixed"])
def test_block_type_is_ignored_like_jax(src, tmp_path, jax_whole,
                                        block_type):
    """The reference's quirk, kept: no force_btype reaches the encoder, so
    a forced block type still gives the cost-chosen bytes."""
    out = tmp_path / "forced.zz"
    port_run(src, out, CodecConfig(shard_size=S, block_type=block_type))
    assert out.read_bytes() == jax_whole
    j = tmp_path / "jax_forced.zz"
    jck.compress_file_resumable(str(src), str(j),
                                JaxConfig(shard_size=S, block_type=block_type))
    assert j.read_bytes() == jax_whole


def test_raw_container(src, tmp_path):
    cfg = CodecConfig(shard_size=S, container="raw")
    info = port_run(src, tmp_path / "p.raw", cfg)
    body = (tmp_path / "p.raw").read_bytes()
    assert info["output_bytes"] == len(body)
    assert zlib.decompress(body, wbits=-15) == RAW


def test_gzip_refused_like_jax(src, tmp_path):
    with pytest.raises(DistError) as e:
        port_run(src, tmp_path / "x.gz",
                 CodecConfig(shard_size=S, container="gzip"))
    with pytest.raises(JaxDistError) as j:
        jck.compress_file_resumable(str(src), str(tmp_path / "y.gz"),
                                    JaxConfig(shard_size=S, container="gzip"))
    assert (e.value.name, e.value.code, str(e.value)) == \
        (j.value.name, j.value.code, str(j.value))


@pytest.mark.parametrize("kw", [{}, {"shard_size": S}, {"lazy": False},
                                {"container": "raw", "block_type": "fixed"},
                                {"num_candidates": 8, "self_check": True}])
def test_fingerprints_match_jax(src, kw):
    assert tck._config_fingerprint(CodecConfig(**kw)) == \
        jck._config_fingerprint(JaxConfig(**kw))
    assert tck._input_fingerprint(str(src)) == \
        jck._input_fingerprint(str(src))
