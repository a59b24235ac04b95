"""The roofline arithmetic on hand-counted cases, the kernel table's
bounds, and the trace reader's attribution on a synthetic event list."""
from pathlib import Path

import numpy as np
import pytest

from portbench.metrics import bounds
from portbench.trace import Trace, _union_ns


def test_find_matches_bytes_match_the_kernel_table():
    # PERF.md kernel table: 5.24 MB, 0.00157 ms at a 1 MB shard
    assert bounds.find_matches_bytes(1 << 20) == 5_242_880
    assert bounds.least_s(5_242_880) * 1e3 == pytest.approx(0.001565, 1e-3)
    assert bounds.least_s(bounds.find_matches_bytes(4 << 20)) * 1e3 == \
        pytest.approx(0.006260, 1e-3)


def test_copy_sources_bytes_match_the_kernel_table():
    # 9,437,184 positions and 393,216 stored bytes: 47.6 MB, 0.01420 ms
    n = bounds.copy_sources_bytes(9_437_184, 393_216)
    assert n == 5 * 9_437_184 + 393_216 == 47_579_136
    assert bounds.least_s(n) * 1e3 == pytest.approx(0.01420, 1e-3)


def test_roofline_pct():
    # 3.35 MB in 10 us: 1 us at the peak, 10 %
    assert bounds.roofline_pct(3.35e6, 10e-6) == pytest.approx(10.0)


def test_pack_words_bytes_hand_counted():
    S, H, nw = 3 * 32768, 5, 1000
    blk = np.array([0, 0, 1])                 # tiles 0-1 block 0, tile 2 b1
    huff = np.array([True, False, False])
    sto = np.array([False, True, False])
    blen = np.array([65536, 40000, 0])
    ll = np.zeros((3, 4), np.int64)
    ll[0, :3] = [5 << 16, 0, 7 << 16]         # two coded symbols in b0
    ll[1, 0] = 9 << 16                        # b1 is stored: not counted
    d = np.zeros((3, 3), np.int64)
    d[0, 0] = 3 << 16                         # one coded distance
    nbs = np.zeros((3, H), np.int64)
    nbs[0, :4] = 3                            # four header items in b0
    nbs[1, 0] = 3
    nbs[2, :] = 9                             # block 2 unused
    reads = (18 * 32768 * 2                   # two Huffman tiles
             + 32768                          # stored bytes, a tile's worth
             + 8 * 3 + 2 * (18 + 8 * H)       # tiles' blocks, used rows
             + 8 * 5 + 8 * 3 + 8)             # header items, codes, stride
    writes = 8 * (nw + 3 * 3 + 3) + 24 * (S // 64)
    assert bounds.pack_words_bytes(S, nw, blk, huff, sto, blen, ll, d,
                                   nbs) == reads + writes


def test_union_ns():
    t0 = np.array([0, 5, 6, 20, 30])
    t1 = np.array([10, 7, 12, 25, 31])
    assert _union_ns(t0, t1) == 12 + 5 + 1


class Ev:
    def __init__(self, kind, name, t0, dur, corr=0):
        self.k, self.n, self.t0, self.d = kind, name, t0, dur
        self.c = corr

    def device_type(self):
        return "DeviceType.CPU" if self.k in ("cpu_op", "user_annotation") \
            else "DeviceType.CUDA"

    def is_user_annotation(self): return "user_annotation" in self.k

    def name(self): return self.n
    def start_ns(self): return self.t0
    def duration_ns(self): return self.d
    def correlation_id(self): return self.c


def test_trace_attributes_by_launch_correlation():
    evs = [
        Ev("user_annotation", "pb.window", 0, 1000),
        Ev("user_annotation", "pb/outer", 100, 400),
        Ev("user_annotation", "pb/inner", 150, 100),
        Ev("cpu_op", "aten::add", 160, 10),
        Ev("cpu_op", "aten::mul", 600, 10),
        # a hand kernel launched through ctypes inside the inner span
        Ev("cpu_op", "cuLaunchKernel", 200, 5, corr=11),
        Ev("kernel", "inner_kernel", 300, 50, corr=11),
        # a torch kernel from aten::add, inside both spans
        Ev("cpu_op", "cudaLaunchKernel", 162, 5, corr=12),
        Ev("kernel", "add_kernel", 400, 20, corr=12),
        # launched outside every span, runs while the outer span is open
        Ev("cpu_op", "cudaLaunchKernel", 602, 5, corr=13),
        Ev("kernel", "mul_kernel", 620, 30, corr=13),
        Ev("cpu_op", "cudaMemcpyAsync", 640, 5, corr=14),
        Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 650, 10,
           corr=14),
        # the device's shadow of a span, and the profiler's own events
        Ev("gpu_user_annotation", "pb/outer", 300, 120),
        Ev("cpu_op", "Activity Buffer Request", 700, 50, corr=12),
    ]
    t = Trace(evs, mb=2.0, captured={})
    assert t.span_ns("outer") == 400 and t.calls("inner") == 1
    assert t.device_ns("inner") == 70
    assert t.device_ns("outer", expect=("inner_kernel",)) == 70
    assert t.device_ns("outer", expect=("mul",)) is None
    assert t.device_ns("nothing") is None
    assert t.window_s == 1e-6 and t.busy_s == 110e-9
    b = t.breakdown()
    assert b["device_ops"][0] == ["inner_kernel", 50e-9]
    # the longest gaps, each named by the innermost host operation at its
    # middle: the window's end (the harness's loop), then the inner span
    assert b["idle_gaps"][:2] == [["pb.window", pytest.approx(340e-9)],
                                  ["inner", pytest.approx(300e-9)]]


KINETO_COPY = b'''
  {
    "ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0, "tid": 7,
    "ts": 1466306335803.627, "dur": 21.663,
    "args": {
      "External id": 5,      "device": 0, "context": 1,      "stream": 7, "correlation": 14,      "bytes": 1048576, "memory bandwidth (GB/s)": 48.4
    }
  },
  {
    "ph": "X", "cat": "kernel", "name": "add_kernel", "pid": 0, "tid": 7,
    "ts": 1466306335903.627, "dur": 1.0,
    "args": {
      "External id": 6, "device": 0, "stream": 7, "correlation": 15, "grid": [1, 1, 1]
    }
  },
  {
    "ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "pid": 0, "tid": 7,
    "ts": 1466306336612.353, "dur": 2.817,
    "args": {
      "External id": 20,      "device": 0, "context": 1,      "stream": 7, "correlation": 67,      "bytes": 100, "memory bandwidth (GB/s)": 0.035
    }
  }'''


def test_copy_sizes_read_from_the_exported_trace(tmp_path):
    """The byte counts as the profiler's export writes them (the layout of
    torch 2.11's trace on an H100), by correlation id; the file goes."""
    from portbench.trace import copy_sizes

    class Prof:
        def export_chrome_trace(self, path):
            Path(path).write_bytes(b'{"traceEvents": [' + KINETO_COPY +
                                   b']}')
    assert copy_sizes(Prof(), tmp_path) == {14: 1048576, 67: 100}
    assert list(tmp_path.iterdir()) == []


def test_copy_bytes_by_span_and_direction():
    evs = [
        Ev("user_annotation", "pb.window", 0, 1000),
        Ev("user_annotation", "pb/decompress_indexed", 100, 400),
        Ev("cpu_op", "cudaMemcpyAsync", 150, 5, corr=14),
        Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 160, 10,
           corr=14),
        Ev("cpu_op", "cudaMemcpyAsync", 200, 5, corr=67),
        Ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 210, 10,
           corr=67),
        # a copy launched outside the span does not count
        Ev("cpu_op", "cudaMemcpyAsync", 600, 5, corr=70),
        Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 610, 10,
           corr=70),
    ]
    sizes = {14: 1048576, 67: 100, 70: 5}
    t = Trace(evs, mb=1.0, captured={}, copies=sizes)
    assert t.copy_bytes("HtoD", "decompress_indexed") == 1048576
    assert t.copy_bytes("DtoH", "decompress_indexed") == 100
    assert Trace(evs, 1.0, {}).copy_bytes("HtoD", "decompress_indexed") \
        is None
    # a copy whose size the export lacks: nothing is read
    assert Trace(evs, 1.0, {}, {67: 100}).copy_bytes(
        "HtoD", "decompress_indexed") is None
