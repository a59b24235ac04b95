"""Port parity: the stream verifier and the codec's self-check
(decode/verify.py, models/codec.py) against the JAX package on the CPU.
Reports and checks are integers, booleans and strings: exact equality."""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from deflate_compression_tpu import native_bridge as jnb
from deflate_compression_tpu.decode import verify as jver
from deflate_compression_tpu.utils.errors import DeflateError as JaxDeflateError
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch import native_bridge as tnb
from deflate_compression_tpu_torch.decode import verify as tver
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.models import codec as tcodec
from deflate_compression_tpu_torch.utils.config import CodecConfig
from deflate_compression_tpu_torch.utils.errors import DeflateError

torch.set_num_threads(1)

S = 32768
RAW = corpus.build_corpus(3 * S + 5_000, seed=8)


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    monkeypatch.setattr(jnb, "available", lambda: False)


def _reports(reports):
    return [dataclasses.astuple(r) for r in reports]


def _blobs():
    own = {c: tcodec.make_codec(CodecConfig(shard_size=S, container=c),
                                device="cpu").compress(RAW)
           for c in ("raw", "zlib", "gzip")}
    fixed = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    small = zlib.compressobj(9, zlib.DEFLATED, 10)     # a 1 KB window
    return {**{f"own_{c}": b for c, b in own.items()},
            "zlib9": zlib.compress(RAW, 9),
            "zlib_fixed": fixed.compress(RAW[:20_000]) + fixed.flush(),
            "zlib_wbits10": small.compress(RAW[:30_000]) + small.flush()}


BLOBS = _blobs()


@pytest.mark.parametrize("name", sorted(BLOBS))
def test_verify_stream_matches_jax(name):
    blob = BLOBS[name]
    original = RAW if name.startswith(("own", "zlib9")) else None
    got_r, got_c = tver.verify_stream(blob, original)
    want_r, want_c = jver.verify_stream(blob, original)
    assert _reports(got_r) == _reports(want_r)
    assert got_c == want_c
    assert all(ok for _, ok, _ in got_c), got_c


def test_verify_stream_flags_a_window_violation(monkeypatch):
    pat = b"The quick brown fox jumps over the lazy dog 0123456789!"
    data = pat * 20 + bytes(np.random.default_rng(3).integers(
        0, 256, 2000, dtype=np.uint8)) + pat * 20
    comp = zlib.compress(data, 9)
    cmf = (1 << 4) | 8
    blob = bytes([cmf, (31 - (cmf * 256) % 31) % 31]) + comp[2:]
    native = dict((n, ok) for n, ok, _ in tver.verify_stream(blob)[1])
    assert not native["window"] and not native["own-inflater"]
    monkeypatch.setattr(tnb, "available", lambda: False)   # Python inflater
    got = tver.verify_stream(blob)
    want = jver.verify_stream(blob)
    assert _reports(got[0]) == _reports(want[0]) and got[1] == want[1]
    assert dict((n, ok) for n, ok, _ in got[1]) == native


def test_replay_stream_stop_at_bits_on_a_non_final_shard():
    buf = np.frombuffer(RAW[:S], np.uint8).copy()
    r = td.encode_shard(torch.from_numpy(buf), S, False)
    tb = int(r["total_bits"])
    sb = td.shard_bytes(r)
    out, end, reps = tver.replay_stream(sb, 0, stop_at_bits=tb)
    w_out, w_end, w_reps = jver.replay_stream(sb, 0, stop_at_bits=tb)
    assert (out, end) == (w_out, w_end) and out == RAW[:S]
    assert _reports(reps) == _reports(w_reps)
    assert reps[-1].btype == 0 and reps[-1].out_bytes == 0   # sync flush
    with pytest.raises((DeflateError, EOFError)) as e:     # no BFINAL
        tver.replay_stream(sb, 0)
    with pytest.raises((JaxDeflateError, EOFError)) as j:
        jver.replay_stream(sb, 0)
    assert type(e.value).__name__ == type(j.value).__name__
    assert getattr(e.value, "name", None) == getattr(j.value, "name", None)


@pytest.mark.parametrize("cut", [0.3, 0.7])
def test_replay_stream_truncation_matches_jax(cut):
    blob = BLOBS["own_raw"]
    short = blob[:int(len(blob) * cut)]

    def outcome(fn):
        try:
            fn(short)
        except (DeflateError, JaxDeflateError) as e:
            return "DeflateError", e.name
        except EOFError:
            return "EOFError", None
        return "ok", None
    want = outcome(jver.replay_stream)
    assert want != ("ok", None)
    assert outcome(tver.replay_stream) == want


@pytest.mark.parametrize("container", ["zlib", "gzip"])
def test_self_check_passes(container):
    cfg = CodecConfig(shard_size=S, container=container, self_check=True)
    plain = CodecConfig(shard_size=S, container=container)
    blob = tcodec.make_codec(cfg, device="cpu").compress(RAW)
    assert blob == tcodec.make_codec(plain, device="cpu").compress(RAW)
    streamed = b"".join(tcodec.compress_stream([RAW], cfg, device="cpu"))
    assert streamed == blob


def _corrupt_second(real, calls):
    def corrupt(*a, **kw):
        r = dict(real(*a, **kw))
        if calls["n"] == 1:
            w = r["words"].clone()
            w[10] ^= 0xDEADBEEF
            r["words"] = w
        calls["n"] += 1
        return r
    return corrupt


def test_self_check_catches_corrupt_encoder(monkeypatch):
    """Corrupt the second shard's words: the replay fails at shard 1,
    before any of its bytes are committed."""
    monkeypatch.setattr(td, "encode_shard",
                        _corrupt_second(td.encode_shard, {"n": 0}))
    cfg = CodecConfig(shard_size=S, self_check=True)
    with pytest.raises(DeflateError) as e:
        tcodec.ZlibCodec(cfg, device="cpu").compress(RAW)
    assert e.value.name == "E_SELFCHECK" and "shard 1" in str(e.value)

    monkeypatch.setattr(tcodec, "encode_shard",
                        _corrupt_second(tcodec.encode_shard, {"n": 0}))
    out = []
    with pytest.raises(DeflateError) as e:
        for piece in tcodec.compress_stream([RAW], cfg, device="cpu"):
            out.append(piece)
    assert e.value.name == "E_SELFCHECK" and "shard 1" in str(e.value)
    assert len(out) == 2                    # the header and shard 0 only
