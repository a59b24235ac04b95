"""Port parity: the gzip container, CRC-32 and the whole codec surface
(format/containers.py, core/checksum.py, models/codec.py) against the JAX
package on the CPU. Streams compare byte for byte, checksums and the
stats' CSV exactly. JAX's host inflaters run their Python path."""
import gzip
import zlib

import numpy as np
import pytest
import torch

from deflate_compression_tpu import native_bridge as jnb
from deflate_compression_tpu.core import checksum as jck
from deflate_compression_tpu.format import containers as jcon
from deflate_compression_tpu.models import codec as jcodec
from deflate_compression_tpu.utils.config import CodecConfig as JaxConfig
from deflate_compression_tpu.utils.errors import DeflateError as JaxDeflateError
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch import native_bridge as tnb
from deflate_compression_tpu_torch.core import checksum as tck
from deflate_compression_tpu_torch.format import containers as tcon
from deflate_compression_tpu_torch.models import codec as tcodec
from deflate_compression_tpu_torch.utils.config import CodecConfig
from deflate_compression_tpu_torch.utils.errors import DeflateError

torch.set_num_threads(1)

S = 65536
RAW = corpus.build_corpus(2 * S + 23_456, seed=6)


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    monkeypatch.setattr(jnb, "available", lambda: False)


@pytest.fixture(scope="module")
def gz():
    return tcodec.GzipCodec(CodecConfig(shard_size=S, container="gzip"),
                            device="cpu").compress(RAW)


# ------------------------------------------------------------------ CRC-32

@pytest.mark.parametrize("n", [0, 1, 4095, 4096, (1 << 20) + 7])
def test_crc32_matches_jax_and_zlib(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    got = tck.crc32_np(data)
    assert got == jck.crc32_np(data) == zlib.crc32(data)
    assert tck.crc32_np(data, 0xDEADBEEF) == zlib.crc32(data, 0xDEADBEEF)
    assert tck.crc32_np(np.frombuffer(data, np.uint8)) == got
    if tnb.available():
        assert tnb.crc32_native(data) == got
        assert tnb.adler32_native(data) == zlib.adler32(data)


@pytest.mark.parametrize("n1,n2", [(0, 5), (7, 0), (1000, 4097),
                                   (70_000, 123_457)])
def test_crc32_combine_matches_jax(n1, n2):
    rng = np.random.default_rng(n1 + n2)
    a = rng.integers(0, 256, n1, np.uint8).tobytes()
    b = rng.integers(0, 256, n2, np.uint8).tobytes()
    ca, cb = zlib.crc32(a), zlib.crc32(b)
    got = tck.crc32_combine(ca, cb, n2)
    assert got == jck.crc32_combine(ca, cb, n2) == zlib.crc32(a + b)
    assert tck.crc32_combine_raw(ca, cb, n2) == jck.crc32_combine_raw(
        ca, cb, n2)


# -------------------------------------------------------------------- gzip

def test_gzip_compress_matches_jax(gz):
    want = jcodec.GzipCodec(JaxConfig(shard_size=S,
                                      container="gzip")).compress(RAW)
    assert gz == want
    assert gzip.decompress(gz) == RAW
    assert tcon.gzip_header() == jcon.gzip_header()
    assert tcon.container_header("gzip") == jcon.container_header("gzip")


@pytest.mark.parametrize("container", ["raw", "zlib", "gzip"])
def test_compress_stream_matches_jax(container):
    tcfg = CodecConfig(shard_size=S, container=container)
    jcfg = JaxConfig(shard_size=S, container=container)
    pieces = [RAW[i:i + 40_000] for i in range(0, len(RAW), 40_000)]
    got = b"".join(tcodec.compress_stream(pieces, tcfg, device="cpu"))
    assert got == b"".join(jcodec.compress_stream(pieces, jcfg))
    assert got == tcodec.make_codec(tcfg, device="cpu").compress(RAW)


@pytest.mark.parametrize("container", ["raw", "zlib", "gzip"])
def test_empty_input_matches_jax(container):
    tcfg = CodecConfig(shard_size=S, container=container)
    jcfg = JaxConfig(shard_size=S, container=container)
    got = tcodec.make_codec(tcfg, device="cpu").compress(b"")
    assert got == jcodec.make_codec(jcfg).compress(b"")
    assert b"".join(tcodec.compress_stream([], tcfg, device="cpu")) == \
        b"".join(jcodec.compress_stream([], jcfg))
    assert tcodec.make_codec(tcfg, device="cpu").decompress(got) == b""


@pytest.mark.parametrize("flags", ["FEXTRA", "FNAME", "FCOMMENT", "FHCRC",
                                   "all"])
def test_gzip_parse_header_matches_jax(gz, flags):
    bits = {"FHCRC": 0x02, "FEXTRA": 0x04, "FNAME": 0x08, "FCOMMENT": 0x10}
    flg = sum(bits.values()) if flags == "all" else bits[flags]
    head = bytearray(gz[:10])
    head[3] = flg
    if flg & 0x04:
        head += (6).to_bytes(2, "little") + b"ab\x02\x00cd"
    if flg & 0x08:
        head += b"name.txt\x00"
    if flg & 0x10:
        head += b"a comment\x00"
    if flg & 0x02:
        head += (zlib.crc32(bytes(head)) & 0xFFFF).to_bytes(2, "little")
    blob = bytes(head) + gz[10:]
    off = tcon.gzip_parse_header(blob)
    assert off == jcon.gzip_parse_header(blob) == len(head)
    assert tcon.gzip_decompress(blob) == gzip.decompress(blob) == RAW


def _gzip_error(fn, blob):
    try:
        fn(blob)
    except (DeflateError, JaxDeflateError) as e:
        return e.name
    return None


@pytest.mark.parametrize("case", ["crc", "isize", "magic", "cm", "footer",
                                  "fextra"])
def test_gzip_errors_match_jax(gz, case):
    blob = bytearray(gz)
    if case == "crc":
        blob[-8] ^= 1
    elif case == "isize":
        blob[-1] ^= 1
    elif case == "magic":
        blob[0] ^= 1
    elif case == "cm":
        blob[2] = 7
    elif case == "footer":
        blob = blob[:-5]
    else:
        blob = blob[:3] + b"\x04" + blob[4:10] + b"\x07"
    blob = bytes(blob)
    want = _gzip_error(jcon.gzip_decompress, blob)
    assert want is not None
    assert _gzip_error(tcon.gzip_decompress, blob) == want


# ------------------------------------------------------------------- codecs

@pytest.mark.parametrize("container", ["raw", "zlib", "gzip"])
def test_codec_round_trip(container, monkeypatch):
    codec = tcodec.make_codec(CodecConfig(shard_size=S, container=container),
                              device="cpu")
    blob = codec.compress(RAW)
    assert codec.decompress(blob) == RAW
    monkeypatch.setattr(tnb, "available", lambda: False)   # Python inflater
    assert codec.decompress(blob) == RAW
    oracle = {"raw": lambda b: zlib.decompress(b, wbits=-15),
              "zlib": zlib.decompress, "gzip": gzip.decompress}[container]
    assert oracle(blob) == RAW


def test_zlib_decompress_verify_checksums_off():
    codec = tcodec.ZlibCodec(CodecConfig(shard_size=S,
                                         verify_checksums=False),
                             device="cpu")
    blob = codec.compress(RAW[:5000])
    bad = blob[:-1] + bytes([blob[-1] ^ 1])
    assert codec.decompress(bad) == RAW[:5000]
    with pytest.raises(DeflateError) as e:
        tcodec.ZlibCodec(CodecConfig(shard_size=S),
                         device="cpu").decompress(bad)
    assert e.value.name == "E_ADLER"


@pytest.mark.parametrize("container", ["raw", "zlib", "gzip"])
def test_stats_csv_and_metrics_match_jax(container):
    tc = tcodec.make_codec(CodecConfig(shard_size=S, container=container),
                           device="cpu")
    jc = jcodec.make_codec(JaxConfig(shard_size=S, container=container))
    tb, ts = tc.compress(RAW, return_stats=True)
    jb, js = jc.compress(RAW, return_stats=True)
    assert tb == jb
    assert ts.to_csv() == js.to_csv()
    assert ts.rate_bits_per_byte == js.rate_bits_per_byte
    assert tc.metrics.cost_trace_csv() == jc.metrics.cost_trace_csv()
    strip = {k: (v["count"], v["sum"], v["last"])
             for k, v in tc.metrics.summary().items()}
    assert strip == {k: (v["count"], v["sum"], v["last"])
                     for k, v in jc.metrics.summary().items()}
    assert [k for _, k, _ in tc.metrics.records] == \
        [k for _, k, _ in jc.metrics.records]
