"""The port's spans (utils/logging_util.py: `span`, `spanned`) and the
indexed decode's upload counter, on the CPU, over the encode, the
indexed decode and the device decode.

With no profiler the port enters no `record_function` and its outputs are
the reference's (the JAX codec's blob, the original bytes). Under a CPU
`torch.profiler` every span of the path appears as often as the path's
calls make it, each inside its parent span, and the outputs are the same.
`decompress_indexed.upload_bytes` counts the bytes of the arrays each
group hands to the device."""
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deflate_compression_tpu.models import codec as jcodec
from deflate_compression_tpu.utils.config import CodecConfig as JConfig
from deflate_compression_tpu_torch import corpus
from deflate_compression_tpu_torch.core import checksum as CK
from deflate_compression_tpu_torch.decode import device_inflate as DI
from deflate_compression_tpu_torch.decode import index as IDX
from deflate_compression_tpu_torch.format import deflate as td
from deflate_compression_tpu_torch.models import codec as tcodec
from deflate_compression_tpu_torch.utils.config import CodecConfig
from deflate_compression_tpu_torch.utils.logging_util import SPAN_PREFIX

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

S = 32768
RAW = corpus.build_corpus(2 * S + 5000, seed=9)       # three shards
SHARDS = [RAW[k:k + S] for k in range(0, len(RAW), S)]
BLOCKS = ("block_bit_base", "block_out_start", "btype", "n_blocks",
          "sub_bit", "sub_out", "sub_blk")
STAGES = ("tokenize", "token_fields", "tile_histograms", "block_plan",
          "block_histograms", "tree_rle", "clen_histogram", "bit_costs",
          "code_tables", "header_items", "sub_entries", "pack_words")
DECODE = {"decode.plan": "decode.blocks", "decode.phase_a": "decode.plan",
          "decode.lanes": "decode.plan", "decode.phase_b": "decode.blocks",
          "decode.phase_c": "decode.blocks"}

# span -> (calls, parent span or None) of one call of each path
EXPECT = {
    "encode": {
        "codec.compress": (1, None),
        "codec.upload": (3, "codec.compress"),
        "encode.shard": (3, "codec.compress"),
        **{f"encode.{s}": (3, "encode.shard") for s in STAGES},
        "encode.huffman_codes": (6, "encode.shard"),
        "codec.wait": (3, "codec.compress"),
        "codec.unpack": (4, "codec.compress"),
        "codec.adler32": (1, "codec.compress"),
        "codec.wrap": (1, "codec.compress"),
    },
    "indexed_decode": {
        "index.decompress": (1, None),
        **{f"index.{s}": (3, "index.decompress")
           for s in ("group", "upload", "wait", "adler32", "copy_back",
                     "window")},
        "decode.blocks": (3, "index.decompress"),
        **{k: (3, p) for k, p in DECODE.items()},
        "checksum.adler32": (3, "index.adler32"),
        "index.join": (1, "index.decompress"),
    },
    "device_decode": {
        "decode.batch": (1, None),
        "decode.flat_batch": (1, "decode.batch"),
        "decode.blocks": (1, "decode.batch"),
        **{k: (1, p) for k, p in DECODE.items()},
        "checksum.adler32": (3, None),
    },
}


@pytest.fixture(scope="module")
def streams():
    """The raw stream and its decode index, and each shard's encode."""
    sink = []
    body = b"".join(tcodec.compress_stream(
        [RAW], CodecConfig(shard_size=S, container="raw"), index_sink=sink,
        device="cpu"))
    idx = IDX.index_from_shards([t[0] for t in sink], [t[1] for t in sink],
                                [t[2] for t in sink])
    enc = [td.encode_shard(torch.from_numpy(np.frombuffer(
        part.ljust(S, b"\0"), np.uint8).copy()), len(part),
        k == len(SHARDS) - 1) for k, part in enumerate(SHARDS)]
    return body, idx, enc


def _encode(_):
    return tcodec.ZlibCodec(CodecConfig(shard_size=S),
                            device="cpu").compress(RAW)


def _indexed_decode(st):
    body, idx, _ = st
    return IDX.decompress_indexed(body, idx, shard_out=S,
                                  expected_adler=zlib.adler32(RAW),
                                  device="cpu")


def _device_decode(st):
    enc = st[2]
    stack = {k: torch.stack([r[k] for r in enc]) for k in ("words", *BLOCKS)}
    valid = [len(p) for p in SHARDS]
    r = DI.decode_blocks_batch(stack["words"], *(stack[k] for k in BLOCKS),
                               torch.tensor(valid), S)
    ad = [int(CK.adler32_torch(r["out"][s], v)) for s, v in enumerate(valid)]
    return bool(r["ok"]), r["out"].numpy().tobytes(), ad


PATHS = {"encode": _encode, "indexed_decode": _indexed_decode,
         "device_decode": _device_decode}


def _want(path):
    """The reference's output of each path."""
    if path == "encode":
        return jcodec.ZlibCodec(JConfig(shard_size=S)).compress(RAW)
    if path == "indexed_decode":
        return RAW
    return (True, b"".join(p.ljust(S, b"\0") for p in SHARDS),
            [zlib.adler32(p) for p in SHARDS])


def _spans(prof) -> list:
    """(name, start ns, end ns) of every span the profile recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(SPAN_PREFIX) and \
                str(e.device_type()).endswith("CPU"):
            t0 = e.start_ns()
            out.append((e.name()[len(SPAN_PREFIX):], t0,
                        t0 + e.duration_ns()))
    return out


def _parent(spans, k) -> str | None:
    """The name of the innermost other span that encloses span k."""
    name, t0, t1 = spans[k]
    inside = [(b - a, n) for i, (n, a, b) in enumerate(spans)
              if i != k and a <= t0 and t1 <= b]
    return min(inside)[1] if inside else None


@pytest.mark.parametrize("path", list(PATHS))
def test_no_record_function_without_a_profiler(path, streams, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert PATHS[path](streams) == _want(path)


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_under_the_profiler(path, streams):
    off = PATHS[path](streams)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = PATHS[path](streams)
    assert on == off
    spans = _spans(prof)
    got = {}
    for n, _, _ in spans:
        got[n] = got.get(n, 0) + 1
    expect = EXPECT[path]
    assert got == {n: c for n, (c, _) in expect.items()}
    for k, (name, _, _) in enumerate(spans):
        assert _parent(spans, k) == expect[name][1], name


def test_self_check_span_inside_unpack():
    codec = tcodec.GzipCodec(CodecConfig(shard_size=S, container="gzip",
                                         self_check=True), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blob = codec.compress(RAW)
    assert zlib.decompress(blob, wbits=31) == RAW
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert names.count("codec.self_check") == 3
    assert names.count("codec.crc32") == 1 and "codec.adler32" not in names
    for k, (name, _, _) in enumerate(spans):
        if name == "codec.self_check":
            assert _parent(spans, k) == "codec.unpack"


def test_upload_bytes_count_the_arrays_handed_over(streams, monkeypatch):
    handed = []
    decode_blocks = DI.decode_blocks

    def record(words, bb, os_, bt, nb, sb, so, sk, *a, **k):
        handed.append(words.numel() * words.element_size() + sum(
            8 * len(x) for x in (bb, os_, bt, sb, so, sk)))
        return decode_blocks(words, bb, os_, bt, nb, sb, so, sk, *a, **k)
    monkeypatch.setattr(DI, "decode_blocks", record)
    before = IDX.decompress_indexed.upload_bytes
    assert _indexed_decode(streams) == RAW
    assert len(handed) == 3
    assert IDX.decompress_indexed.upload_bytes - before == sum(handed)
    # the count stays on the port's function when its name is rebound to
    # something that calls it (a wrapper, the benchmark's planted fault)
    port = IDX.decompress_indexed
    monkeypatch.setattr(IDX, "decompress_indexed",
                        lambda *a, **k: port(*a, **k))
    handed.clear()
    before = port.upload_bytes
    assert _indexed_decode(streams) == RAW
    assert port.upload_bytes - before == sum(handed) > 0


class _Ev:
    """A raw profiler event: (device, name, start ns, duration ns,
    correlation id)."""

    def __init__(self, dev, name, t0, dur, corr=0):
        self.dev, self.n, self.t0, self.d, self.c = dev, name, t0, dur, corr

    def device_type(self): return f"DeviceType.{self.dev}"
    def is_user_annotation(self): return self.n.startswith(SPAN_PREFIX)
    def name(self): return self.n
    def start_ns(self): return self.t0
    def duration_ns(self): return self.d
    def correlation_id(self): return self.c


def test_profile_encode_reads_the_stage_spans():
    """profile_encode's stages come from the spans: host ms per call, and
    each device operation given to the innermost span that launched it."""
    from deflate_compression_tpu_torch.profile_encode import span_times
    evs = [_Ev("CPU", "dct/encode.shard", 0, 4_000_000),
           _Ev("CPU", "dct/encode.tokenize", 100, 1_000_000),
           _Ev("CPU", "dct/encode.tokenize", 2_000_000, 1_000_000),
           _Ev("CPU", "dct/codec.wait", 5_000_000, 10),
           _Ev("CPU", "cuLaunchKernel", 200, 5, corr=1),
           _Ev("CUDA", "find_matches_walk", 300, 600_000, corr=1),
           _Ev("CPU", "cudaLaunchKernel", 1_500_000, 5, corr=2),
           _Ev("CUDA", "add_kernel", 1_600_000, 200_000, corr=2),
           _Ev("CUDA", "dct/encode.tokenize", 300, 600_000)]
    got = span_times(evs, "encode.", 2)
    assert got == {"encode.shard": {"host_ms": 2.0, "device_ms": 0.1},
                   "encode.tokenize": {"host_ms": 1.0, "device_ms": 0.3}}
    # a CPU encode: every stage inside the shard, no device time
    x = torch.from_numpy(np.frombuffer(SHARDS[0], np.uint8).copy())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td.encode_shard(x, S, True)
    got = span_times(prof.profiler.kineto_results.events(), "encode.", 1)
    assert set(got) == {"encode.shard", "encode.huffman_codes",
                        *(f"encode.{s}" for s in STAGES)}
    stages = sum(v["host_ms"] for k, v in got.items() if k != "encode.shard")
    assert 0 < stages <= got["encode.shard"]["host_ms"]
    assert all(v["device_ms"] == 0 for v in got.values())
