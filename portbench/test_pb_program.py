"""The readers of what the port records itself (`metrics/program.py`):
each on a synthetic trace against a hand count, nothing read from a trace
without the port's spans, every existing reader reading the same with the
port's spans admitted or not, and a counter's window difference against
the calls counted one by one."""
import json
from pathlib import Path

import pytest

from portbench import run
from portbench.metrics import program
from portbench.test_pb_bounds import Ev
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"shard_size": 32768, "decode_group_bytes": 32768}
NEW = {
    "codec.upload.host_ms_per_MB": 5e-5,        # 100 ns over 2 MB
    "codec.wait.host_ms_per_MB": 1e-4,
    "codec.unpack.host_ms_per_MB": 2.5e-5,
    "codec.adler32.host_ms_per_MB": 1.5e-5,
    # encode.shard 400 less tokenize 100, pack_words 50, huffman 2 x 20
    "encode_shard.glue.host_ms_per_MB": 1.05e-4,
    "decompress_indexed.upload.host_ms_per_MB": 3e-5,
    "decompress_indexed.wait.host_ms_per_MB": 2e-5,
    "decompress_indexed.upload_bytes_per_byte": 0.5,   # 1 MB over 2 MB
    # torch's add and the copy; decode_symbols and copy_sources are not
    "decode.glue.device_ms_per_MB": 1.5e-5,
}


def synthetic():
    evs = [
        Ev("user_annotation", "pb.window", 0, 2000),
        Ev("user_annotation", "dct/codec.compress", 10, 1000),
        Ev("user_annotation", "dct/codec.upload", 20, 100),
        Ev("user_annotation", "dct/encode.shard", 130, 400),
        Ev("user_annotation", "dct/encode.tokenize", 140, 100),
        Ev("user_annotation", "dct/encode.huffman_codes", 250, 20),
        Ev("user_annotation", "dct/encode.huffman_codes", 280, 20),
        Ev("user_annotation", "dct/encode.pack_words", 400, 50),
        Ev("user_annotation", "dct/codec.wait", 540, 200),
        Ev("user_annotation", "dct/codec.unpack", 750, 50),
        Ev("user_annotation", "dct/codec.adler32", 810, 30),
        Ev("user_annotation", "dct/index.upload", 1100, 60),
        Ev("user_annotation", "dct/index.wait", 1170, 40),
        Ev("user_annotation", "dct/decode.batch", 1300, 300),
        Ev("user_annotation", "dct/checksum.adler32", 1700, 100),
        # inside decode.batch: a hand kernel and a torch kernel; inside
        # the checksum a copy; one torch kernel launched outside both
        Ev("cpu_op", "cuLaunchKernel", 1310, 5, corr=21),
        Ev("kernel", "decode_symbols_kernel", 1320, 40, corr=21),
        Ev("cpu_op", "cudaLaunchKernel", 1400, 5, corr=22),
        Ev("kernel", "void at::native::add_kernel", 1410, 20, corr=22),
        Ev("cpu_op", "cuLaunchKernel", 1450, 5, corr=23),
        Ev("kernel", "copy_sources_rounds_kernel", 1460, 30, corr=23),
        Ev("cpu_op", "cudaMemcpyAsync", 1710, 5, corr=24),
        Ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1720, 10,
           corr=24),
        Ev("cpu_op", "cudaLaunchKernel", 1900, 5, corr=25),
        Ev("kernel", "void at::native::mul_kernel", 1910, 30, corr=25),
    ]
    return evs


@pytest.mark.parametrize("name", list(NEW))
def test_new_reader_hand_counted(name):
    t = program.program_trace(synthetic(), 2.0, {}, counters={
        "decompress_indexed.upload_bytes": 1_000_000})
    assert run.load_reader(name).read(t) == pytest.approx(NEW[name])


@pytest.mark.parametrize("name", list(NEW))
def test_new_reader_reads_nothing_without_the_port(name):
    """The benchmark's own Trace, as of a tree before the port's spans and
    counter, holds neither: each reader returns None."""
    assert run.load_reader(name).read(Trace(synthetic(), 2.0, {})) is None


def _cells():
    return [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Each cell's traced CPU run at a small size: its result and the
    window's raw events (program_spans.traced_run)."""
    import sys
    sys.path.insert(0, str(ROOT))
    import program_spans
    cache = tmp_path_factory.mktemp("streams")
    out = {}
    for cell in _cells():
        counters = {}
        for name in program_spans.PROGRAM.get(cell, []):
            counters.update(getattr(run.load_reader(name), "COUNTERS", {}))
        out[cell] = program_spans.traced_run(
            cell, 2**31 + 41, 0, counters, device="cpu", scale=1000,
            overrides=SMALL, cache_root=cache)
    return out


@pytest.mark.parametrize("cell", _cells())
def test_existing_readers_same_with_and_without_the_port_spans(cell,
                                                               recorded):
    res, kept = recorded[cell]
    evs = kept["events"]
    assert any(program.is_port_span(e) for e in evs)
    without = [e for e in evs if not program.is_port_span(e)]
    args = (kept["mb"], kept["captured"], kept["copies"])
    traces = [Trace(evs, *args), Trace(without, *args),
              program.program_trace(evs, *args)]
    _, layer = run.metrics_of(BENCH, cell)
    for m in layer:
        if m["name"] in NEW:
            continue
        reader = run.load_reader(m["name"])
        got = [reader.read(t) for t in traces]
        assert got[0] == got[1] == got[2], m["name"]
        if m["name"] in res["metrics"]:
            assert res["metrics"][m["name"]]["value"] == got[0]


def test_counter_reads_the_window_difference(recorded, tmp_path):
    """The window of a 0 s run is one pass, every object once: its counter
    difference equals the calls' own differences, summed one by one."""
    from deflate_compression_tpu_torch.decode import index as IDX
    from portbench.entries import indexed_decode
    cell = "pigz_i_b1024.indexed_decode"
    res, kept = recorded[cell]
    bench, _, cfg, traffic = run.load_cell(cell)
    cfg.update(SMALL)
    entry = indexed_decode.Entry(cfg, traffic, "cpu", 2**31 + 41, 1000,
                                 tmp_path)
    entry.make_streams()
    total = 0
    for st in entry.streams:
        before = IDX.decompress_indexed.upload_bytes
        entry._decode(st)
        total += IDX.decompress_indexed.upload_bytes - before
    assert kept["counters"] == {"decompress_indexed.upload_bytes": total}
    t = program.program_trace(kept["events"], kept["mb"], kept["captured"],
                              kept["copies"], kept["counters"])
    got = run.load_reader("decompress_indexed.upload_bytes_per_byte").read(t)
    assert got == pytest.approx(total / (kept["mb"] * 1e6))
