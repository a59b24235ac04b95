"""The gzip cell on the CPU at a small size: `check()` reads 0 on a sound
run; planted faults in the timed path (a byte altered, the CRC-32 check
skipped, half the bytes left out) and the control each come out not
correct; the reference loads nothing of the port; the member cache is
keyed by what writes the members; each new reader on a hand-counted trace,
and nothing read from a trace without its spans (a tree before them)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import control_gzip, members, run
from portbench.test_pb_bounds import Ev
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parent.parent
CELL = "gzip9.gzip_indexed_decode"
SMALL = {"shard_size": 32768, "decode_group_bytes": 32768}
PORT = "deflate_compression_tpu_torch"


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("members")


def _run(cache, seed=2**31 + 11):
    return run.run(CELL, seed, 0, False, device="cpu", scale=300,
                   overrides=SMALL, cache_root=cache)[0]


def test_check_reads_zero_when_sound(cache):
    res = _run(cache)
    assert res["correct"], res["check"]
    assert set(res["check"]) == {"bytes_wrong", "verdict_wrong",
                                 "tamper_missed"}
    assert all(v["value"] == 0 for v in res["check"].values())
    assert res["attempted"] == 12 and res["failed"] == 0


def _faults(mp, fault):
    import importlib
    idx = importlib.import_module(PORT + ".decode.index")
    cont = importlib.import_module(PORT + ".format.containers")
    orig = idx.decompress_gzip_indexed

    def altered(*a, **k):
        out = bytearray(orig(*a, **k))
        out[len(out) // 3] ^= 0x10
        return bytes(out)

    def unchecked(member, index, shard_out=1 << 20, device=None):
        return idx.decompress_indexed(
            memoryview(member)[cont.gzip_parse_header(member):], index,
            shard_out, device=device)

    def half(*a, **k):
        out = orig(*a, **k)
        return out[:len(out) // 2]
    mp.setattr(idx, "decompress_gzip_indexed",
               {"altered": altered, "crc_skipped": unchecked,
                "half": half}[fault])


@pytest.mark.parametrize("fault,number", [("altered", "bytes_wrong"),
                                          ("crc_skipped", "tamper_missed"),
                                          ("half", "bytes_wrong")])
def test_broken_timed_path_is_not_correct(fault, number, cache,
                                          monkeypatch):
    assert _run(cache)["correct"]        # members cached by a sound run
    _faults(monkeypatch, fault)
    res = _run(cache)
    assert res["correct"] is False, res["check"]
    assert res["check"][number]["value"] > 0, res["check"]


def test_control_is_not_correct(cache):
    res = control_gzip.control(CELL, 2**31 + 5, dev="cpu", scale=300,
                               overrides=SMALL, cache_root=cache)
    assert res["correct"] is False, res["check"]
    assert res["check"]["verdict_wrong"]["value"] == 12
    assert res["check"]["bytes_wrong"]["value"] == 0


def test_crc32_f32_differs_from_the_register():
    data = bytes(range(256)) * 1000
    assert control_gzip.crc32_f32(data, 1 << 30) != \
        __import__("zlib").crc32(data)


def test_reference_loads_nothing_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c", """
import sys, json, zlib, gzip
from portbench import inputs, reference_gzip
obj = inputs.make(3, scale=1000)[0]
m = gzip.compress(obj, 9)
print(reference_gzip.member_valid(m, obj),
      reference_gzip.member_valid(reference_gzip.footer_altered(m, "crc32"),
                                  obj))
print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))
"""], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "True False"
    names = set(json.loads(lines[-1]))
    assert PORT not in names and not names & set(run.FORBIDDEN)


def test_member_cache_key_follows_the_writer(tmp_path):
    _, _, cfg, traffic = run.load_cell(CELL)
    key = members.writer_hash(cfg)
    assert members.writer_hash({**cfg, "shard_size": 1}) == key
    assert members.writer_hash({**cfg, "compresslevel": 6}) != key
    where = members.cache_dir(cfg, 17, 1000, tmp_path)
    assert where.name.startswith("gzip9-17-1000-") and key in where.name


# ---------------------------------------------------------------- readers

def synthetic():
    return [
        Ev("user_annotation", "pb.window", 0, 3000),
        Ev("user_annotation", "pb/decompress_gzip_indexed", 100, 2000),
        Ev("user_annotation", "pb/decode_blocks", 200, 500),
        Ev("user_annotation", "pb/decode_blocks", 900, 400),
        Ev("user_annotation", "pb/crc32_torch", 800, 50),
        Ev("user_annotation", "pb/crc32_torch", 1400, 60),
        # the kernel launched in each crc32_torch call, one decode kernel
        Ev("cpu_op", "cuLaunchKernel", 810, 5, corr=31),
        Ev("kernel", "(anonymous namespace)::crc32_kernel(...)", 900, 4,
           corr=31),
        Ev("cpu_op", "cuLaunchKernel", 1410, 5, corr=32),
        Ev("kernel", "(anonymous namespace)::crc32_kernel(...)", 1500, 6,
           corr=32),
        Ev("cpu_op", "cuLaunchKernel", 250, 5, corr=33),
        Ev("kernel", "decode_symbols_kernel", 300, 100, corr=33),
    ]


# 2 MB moved; the calls' valid_len 4 MiB and 1,000,000 bytes
CAPTURED = {"crc32_torch": [4 << 20, 1_000_000]}
HAND = {
    "crc32.device_ms_per_MB": 10e-6 / 2,            # 10 ns over 2 MB
    # (4 MiB + 8 + 1,000,000 + 8) B over 3.35 TB/s, over 10 ns
    "crc32_roofline": 100 * ((4 << 20) + 1_000_016) / 3.35e12 / 10e-9,
    # 2000 ns less 900 ns of decode_blocks, over 2 MB
    "decompress_gzip.self_ms_per_MB": 1100e-6 / 2,
    # busy 110 ns of 3000
    "device.idle_share.gzip": 100 * (1 - 110 / 3000),
}


@pytest.mark.parametrize("name", list(HAND))
def test_new_reader_hand_counted(name):
    t = Trace(synthetic(), 2.0, CAPTURED)
    assert run.load_reader(name).read(t) == pytest.approx(HAND[name])


@pytest.mark.parametrize("name", list(HAND)[:3])
def test_new_reader_reads_nothing_without_its_spans(name):
    """A window with none of the port's gzip path (a tree before it)."""
    evs = [e for e in synthetic() if not e.n.startswith(
        ("pb/crc32", "pb/decompress_gzip"))]
    assert run.load_reader(name).read(Trace(evs, 2.0, {})) is None


def test_crc32_roofline_captures_valid_len():
    cap = run.load_reader("crc32_roofline").CAPTURE["crc32_torch"]
    assert cap(("data", 123), {"init": 5}) == 123
    assert cap(("data",), {"valid_len": 77}) == 77


def test_benchmark_lists_the_new_cell_and_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e, layer = run.metrics_of(bench, CELL)
    assert e2e == {"decode_MBps", "setup_s"}
    assert {m["name"] for m in layer} == set(HAND)
