"""Stage clocks of the encoder's block-stage kernels on one CUDA card.

    python3 block_stage_probe.py TREE [TREE ...] [--out FILE]

For each TREE (a checkout of this repository, for example the parent
commit unpacked with `git archive` into a git-ignored directory, and `.`),
copies its `csrc/block_plan.cu`, `csrc/huffman_codes.cu` and
`csrc/block_layout.cu` (with the headers they include) with clock64 and
%globaltimer stamps
added at the stage boundaries of the design it finds there (a two-kernel
`block_plan` and a `huffman_codes` that ranks by an O(n) count per
thread, or the one-launch `block_plan` and the `huffman_codes` over the
used symbols' lists; a `block_layout` that walks or scans), builds the
copies with nvcc under the git-ignored `_variants/`, and runs them on
the arguments one `encode_shard` of a 1 MB and a 4 MB shard of
`corpus.build_corpus` hands the ops (`corpus.block_stage_inputs`;
block_layout on that encode's layout, `corpus.layout_inputs`), checking
each result against its plain version. It prints one JSON line per tree
and kernel:

  * `huffman_codes`, 11 and 7 bits: per stage, the median and the largest
    clock64 cycles over the rows (the CTA's thread 0 stamps them), each
    row's span on the globaltimer, 20 launches queued behind a spin
    kernel (ms per launch, the launches' spans and the gaps between
    them), and the profiler's ms of one launch;
  * `block_plan`: the segment costs' span (first CTA's start to last
    CTA's end), the gap to the DP's start, the DP's span and its stages in
    clock64 cycles, the DP loop's cycles a step, the queued and profiler
    ms;
  * `block_layout`: thread 0's clock64 cycles from the kernel's start to
    its end (the walk or the scan, with the loads and stores), the queued
    ms of 20 launches and the profiler's ms of one;
  * `pack_words`, where the tree's kernel is the one-pass design (its
    library exports `pack_words_resident`; the two-pass design is not
    stamped), from the stamps the kernel itself writes when given a stats
    buffer, over 20 calls: each unit's wait in its look-back (clock64
    cycles: median, 90th percentile, largest) and its cycles to the
    nearest inclusive prefix; the launch's SM clock (its units' clock64
    spans over their globaltimer spans); each unit's CTA from its start to its aggregate and from
    there to its end, the last aggregate after the first start and the
    span from the first unit's start to the last unit's end
    (globaltimer); the units in flight at the median instant; the queued
    ms of 20 calls and the profiler's ms by name (the kernel, the
    memset);
  * an empty kernel's queued ms per launch (the least a launch costs).

The stamps cost a few instructions a stage; the numbers describe the
copies, which the kernels' own timings (`kernel_turns.py`, chip_smoke
phase 15) bound. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from deflate_compression_tpu_torch.corpus import (  # noqa: E402
    block_stage_inputs, build_corpus)
from deflate_compression_tpu_torch.ops import block_plan as BP  # noqa: E402
from deflate_compression_tpu_torch.ops import cuda_build  # noqa: E402
from deflate_compression_tpu_torch.ops import huffman_codes as HC  # noqa
from deflate_compression_tpu_torch.ops.timing import (  # noqa: E402
    _spin, device_ms, profiled_ms)

OUT_DIR = HERE / "_variants" / "probe"
OPT_WRITTEN = "  __syncthreads();" + " " * 26 + "// opt[] is written\n"
GT = '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}));\n'
EMPTY = """#include <cuda_runtime.h>
__global__ void empty_kernel(int* p) { if (p) *p = 1; }
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(nullptr);
  return static_cast<int>(cudaGetLastError());
}
"""


def patch(src: str, edits) -> str:
    """Apply (anchor, replacement) edits, each anchor found exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def huffman_stamped(src: str):
    """(stamped source, stage names) for either huffman_codes design."""
    end = ("  if ({t} == 0) {{\n"
           "    unsigned long long g1;\n" + GT.format("g1") +
           "    unsigned long long* o = stamps + {row} * 12;\n"
           "    for (int i = 0; i < {n}; ++i) o[i] = c[i + 1] - c[i];\n"
           "    o[6] = g0;\n    o[7] = g1;\n  }}\n")
    sig = ("int64_t* __restrict__ rev) {",
           "int64_t* __restrict__ rev,\n"
           "    unsigned long long* __restrict__ stamps) {\n"
           "  unsigned long long g0, c[8];\n" + GT.format("g0") +
           "  c[0] = clock64();")
    stamps_arg = "static_cast<unsigned long long*>(stamps));"
    launch = [('extern "C" int huffman_codes_launch',
               'extern "C" int huffman_probe_launch'),
              ("int device, void* stream) {",
               "int device, void* stream, void* stamps) {")]
    if "// ---- rank sort" in src:
        launch.append(("static_cast<int64_t*>(rev));",
                       "static_cast<int64_t*>(rev),\n        " + stamps_arg))
    else:
        launch.append(("n, max_bits, lo, co, ro);",
                       "n, max_bits, lo, co, ro,\n        " + stamps_arg))
    if "// ---- rank sort" in src:
        names = ["load", "sort", "levels", "top-down and lengths", "codes"]
        marks = ["  // ---- rank sort", "  // ---- package-merge levels",
                 "  // ---- top-down", "  // ---- canonical codes"]
        edits = [sig] + [(m, f"  c[{i + 1}] = clock64();\n{m}")
                         for i, m in enumerate(marks)]
        edits.append(("    rev[at + t] = rv;\n  }\n}",
                      "    rev[at + t] = rv;\n  }\n  c[5] = clock64();\n" +
                      end.format(t="t", row="blockIdx.x", n=5) + "}"))
    else:
        names = ["load and count", "sort", "levels", "top-down", "codes"]
        marks = ["  // stable order by (key, symbol)",
                 "  for (int l = 1; l < max_bits; ++l) {",
                 "  // top-down: the leaves among the first m items",
                 "  const int my_len = active ? len_of[t] : 0;"]
        edits = [sig] + [(m, f"  c[{i + 1}] = clock64();\n{m}")
                         for i, m in enumerate(marks)]
        edits.append(("  lengths[row + t] = my_len;",
                      "  lengths[row + t] = my_len;\n  c[5] = clock64();\n" +
                      end.format(t="t", row="blockIdx.x", n=5)))
    return patch(src, edits + launch), names


def block_plan_stamped(src: str):
    """(stamped source, one-launch design?) for either block_plan design.
    stamps: [0] the costs' first start, [1] their last end, [2] the
    longest cost CTA (globaltimer ns); [3], [4] the DP's start and end;
    [5]-[7] the DP's stages and [8] its loop (clock64 cycles)."""
    mark_end = ("  if (threadIdx.x == 0 || (threadIdx.x & 31) == 0) {\n"
                "    unsigned long long g1;\n" + GT.format("g1") +
                "    atomicMin(stamps + 0, g0);\n"
                "    atomicMax(stamps + 1, g1);\n"
                "    atomicMax(stamps + 2, g1 - g0);\n  }\n")
    start = ("    unsigned long long* __restrict__ stamps) {\n"
             "  unsigned long long g0;\n" + GT.format("g0"))
    done = ("    unsigned long long gE, cD = clock64();\n" +
            GT.format("gE") +
            "    stamps[3] = gD; stamps[4] = gE; stamps[5] = cB - cA;\n"
            "    stamps[6] = cC - cB; stamps[7] = cD - cC;\n"
            "    stamps[8] = t_dp;\n")
    begin = ("  unsigned long long cA = clock64(), gD;\n" + GT.format("gD"))
    if "block_plan_dp_kernel" not in src:
        edits = [
            ("unsigned* __restrict__ ticket) {",
             "unsigned* __restrict__ ticket,\n" + start),
            ("  // ---- the CTA that finishes last runs the DP\n",
             mark_end + "  // ---- the CTA that finishes last runs the DP\n"),
            ("  float* s_cost = reinterpret_cast<float*>(smem);",
             begin + "  float* s_cost = reinterpret_cast<float*>(smem);"),
            (OPT_WRITTEN,
             OPT_WRITTEN + "  unsigned long long cB = clock64();\n"),
            ("  atomicMin(&s_gap, __float_as_uint(gap));\n  __syncthreads();",
             "  atomicMin(&s_gap, __float_as_uint(gap));\n  __syncthreads();\n"
             "  unsigned long long cC = clock64();"),
            ("    *n_blocks = blocks;\n", "    *n_blocks = blocks;\n" + done),
            ("int device, void* stream) {",
             "int device, void* stream, void* stamps) {\n"
             "  auto* stp = static_cast<unsigned long long*>(stamps);"),
            ("c, g + 2, g, cyc, sp, nb, tk);\n    else",
             "c, g + 2, g, cyc, sp, nb, tk, stp);\n    else"),
            ("c, g + 2, g, cyc, sp, nb, tk);\n    e =",
             "c, g + 2, g, cyc, sp, nb, tk, stp);\n    e ="),
            ('extern "C" int block_plan_launch',
             'extern "C" int block_plan_probe_launch')]
        return patch(src, edits), True
    edits = [
        ("int mm, float* __restrict__ cost) {",
         "int mm, float* __restrict__ cost,\n" + start),
        ("    cost[seg] = c;\n  }\n",
         "    cost[seg] = c;\n  }\n" + mark_end),
        ("int64_t* __restrict__ n_blocks) {",
         "int64_t* __restrict__ n_blocks,\n"
         "    unsigned long long* __restrict__ stamps) {\n"
         "  long long t_dp = 0;\n" + begin),
        ("    for (int j = r0 + 1; j <= r0 + nrow; ++j) {",
         "    const long long t0 = clock64();\n"
         "    for (int j = r0 + 1; j <= r0 + nrow; ++j) {"),
        ("      tail = lane == 0 ? opt_j : up;\n    }\n",
         "      tail = lane == 0 ? opt_j : up;\n    }\n"
         "    t_dp += clock64() - t0;\n"),
        ("  // the margin of each step 2..n_valid",
         "  unsigned long long cB = clock64();\n"
         "  // the margin of each step 2..n_valid"),
        ("  atomicMin(&s_gap, __float_as_uint(gap));\n  __syncthreads();",
         "  atomicMin(&s_gap, __float_as_uint(gap));\n  __syncthreads();\n"
         "  unsigned long long cC = clock64();"),
        ("    *n_blocks = blocks;\n", "    *n_blocks = blocks;\n" + done),
        ("int device,\n                                 void* stream) {",
         "int device,\n                                 void* stream, "
         "void* stamps) {\n"
         "  auto* stp = static_cast<unsigned long long*>(stamps);"),
        ("M, mm, c);", "M, mm, c, stp);"),
        ("g, sp, nb);", "g, sp, nb, stp);"),
        ('extern "C" int block_plan_launch',
         'extern "C" int block_plan_probe_launch')]
    return patch(src, edits), False


def build(name: str, src: str, headers: dict | None = None) -> ctypes.CDLL:
    """Build `src` as _variants/probe/<name>/<name>.cu beside `headers`
    (file name -> text)."""
    folder = OUT_DIR / name
    folder.mkdir(parents=True, exist_ok=True)
    for hname, text in (headers or {}).items():
        (folder / hname).write_text(text)
    path = folder / f"{name}.cu"
    path.write_text(src)
    return ctypes.CDLL(str(cuda_build.build(path)))


def local_headers(csrc: Path, src: str) -> dict:
    """The headers `src` includes from its own folder, by name."""
    import re
    return {h: (csrc / h).read_text()
            for h in re.findall(r'^#include "([^"]+)"', src, re.M)}


STAMPS = ("__device__ unsigned long long g_stamps[16];\n"
          'extern "C" int probe_stamps(void* out, int reset) {\n'
          "  unsigned long long z[16] = {~0ull};\n"
          "  if (reset) return static_cast<int>(cudaMemcpyToSymbol(\n"
          "      g_stamps, z, sizeof z));\n"
          "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps,\n"
          "                                               sizeof z));\n"
          "}\n")


def layout_stamped(src: str) -> str:
    """block_layout.cu (either design) with thread 0's clock64 from the
    kernel's start to its end in g_stamps[0]."""
    return patch(src, [
        ("\nnamespace {\n",
         "\nnamespace {\n__device__ unsigned long long g_stamps[16];\n"),
        ("}  // namespace\n",
         "}  // namespace\n" + STAMPS.split("\n", 1)[1]),
        ("int64_t* __restrict__ p_end) {",
         "int64_t* __restrict__ p_end) {\n"
         "  const unsigned long long c0 = clock64();"),
        ("  if (threadIdx.x == 0) *p_end = p;",
         "  if (threadIdx.x == 0) *p_end = p;\n  __syncthreads();\n"
         "  if (threadIdx.x == 0) g_stamps[0] = clock64() - c0;")])


def queued(launch, n: int = 20):
    """ms per launch of n launches queued behind a spin kernel; launch(i)
    stamps into slot i."""
    launch(0)
    torch.cuda.synchronize()
    _spin(30.0)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        launch(i)
    b.record()
    covered = not a.query()
    b.synchronize()
    return a.elapsed_time(b) / n, covered


def median_max(x) -> list:
    return [float(np.median(x)), float(np.max(x))]


def probe_tree(tree: Path, inputs: dict) -> dict:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    raw = cuda_build.raw_stream()
    csrc = tree / "deflate_compression_tpu_torch" / "csrc"
    tag = "t" + str(abs(hash(str(tree))) % 10**8)
    hsrc, names = huffman_stamped((csrc / "huffman_codes.cu").read_text())
    bsrc, one_launch = block_plan_stamped(
        (csrc / "block_plan.cu").read_text())
    hlib, blib = build(f"huffman_{tag}", hsrc), build(f"block_plan_{tag}",
                                                      bsrc)
    hl = hlib.huffman_probe_launch
    hl.argtypes = [vp, i32, i32, i32, vp, vp, vp, i32, vp, vp]
    bl = blib.block_plan_probe_launch
    bl.argtypes = ([vp, vp, vp, i32, i32, i32, vp, vp, vp] +
                   ([vp] if one_launch else []) + [i32, vp, vp])
    out = {"tree": str(tree), "huffman_stages": names,
           "block_plan_one_launch": one_launch}
    for size, got in inputs.items():
        for bits in (11, 7):
            _, _, (f, mb), _ = got[f"huffman_codes {bits}-bit"]
            B, n = f.shape
            o = torch.zeros((3, B, n), dtype=torch.int64, device="cuda")
            st = torch.zeros((20, B, 12), dtype=torch.int64, device="cuda")

            def run(i, f=f, B=B, n=n, mb=mb, o=o, st=st):
                rc = hl(f.data_ptr(), B, n, mb, o[0].data_ptr(),
                        o[1].data_ptr(), o[2].data_ptr(), 0, raw(0),
                        st[i].data_ptr())
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
            run(0)
            want = HC.huffman_codes_ref(f.cpu(), mb)
            same = all(torch.equal(o[i].cpu(), want[i]) for i in range(3))
            ms, covered = queued(run)
            q = st.cpu().numpy()
            starts, ends = q[:, :, 6].min(1), q[:, :, 7].max(1)
            out[f"huffman_{bits}bit_{size}"] = {
                "shape": [B, n], "equal_plain": same,
                "stage_cycles_median_max": {
                    nm: median_max(q[0, :, i]) for i, nm in enumerate(names)},
                "row_us_median_max": median_max((q[0, :, 7] - q[0, :, 6])
                                                / 1e3),
                "queued_ms": ms, "covered": covered,
                "span_us_median": float(np.median(ends - starts) / 1e3),
                "gap_us_median": float(np.median(starts[1:] - ends[:-1])
                                       / 1e3),
                "profiler_ms": sum(profiled_ms(lambda: run(0), 5).values())}
        _, _, a, k = got["block_plan"]
        ll, d, n_valid, tb = a
        mm, M, nv = k.get("max_merge", 8), ll.shape[0], int(n_valid)
        sc = torch.empty(M * mm + M + 3, dtype=torch.float32, device="cuda")
        sp = torch.empty(M, dtype=torch.bool, device="cuda")
        nb = torch.empty((), dtype=torch.int64, device="cuda")
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        st = torch.zeros((20, 12), dtype=torch.int64, device="cuda")

        def run(i):
            extra = [ticket.data_ptr()] if one_launch else []
            rc = bl(ll.data_ptr(), d.data_ptr(), tb.data_ptr(), M, mm, nv,
                    sc.data_ptr(), sp.data_ptr(), nb.data_ptr(), *extra, 0,
                    raw(0), st[i].data_ptr())
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        st[:, 0] = -1
        run(0)
        same = torch.equal(sp.cpu(), BP.block_plan_ref(
            ll.cpu(), d.cpu(), nv, tb.cpu(), mm)[0])
        st.zero_()
        st[:, 0] = -1
        ms, covered = queued(run)
        q = st.cpu().numpy().view(np.uint64).astype(np.float64)
        out[f"block_plan_{size}"] = {
            "tiles": M, "equal_plain": same, "queued_ms": ms,
            "covered": covered,
            "costs_span_us": float(np.median(q[:, 1] - q[:, 0]) / 1e3),
            "longest_cost_cta_us": float(np.median(q[:, 2]) / 1e3),
            "costs_end_to_dp_start_us": float(np.median(q[:, 3] - q[:, 1])
                                              / 1e3),
            "dp_span_us": float(np.median(q[:, 4] - q[:, 3]) / 1e3),
            "dp_stage_cycles": [float(np.median(q[:, i])) for i in (5, 6, 7)],
            "dp_loop_cycles_per_step": float(np.median(q[:, 8])) / M,
            "gap_us_median": float(np.median(q[1:, 0] - q[:-1, 4]) / 1e3),
            "profiler_ms": sum(profiled_ms(lambda: run(0), 5).values())}
    probe_layout_and_pack(tree, inputs, out, tag)
    return out


def probe_layout_and_pack(tree: Path, inputs: dict, out: dict,
                          tag: str) -> None:
    """block_layout's and pack_words' rows of probe_tree."""
    from deflate_compression_tpu_torch import corpus
    from deflate_compression_tpu_torch.ops import block_layout as BL
    from deflate_compression_tpu_torch.ops import pack_words as PW
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    raw = cuda_build.raw_stream()
    csrc = tree / "deflate_compression_tpu_torch" / "csrc"
    src = (csrc / "block_layout.cu").read_text()
    lib = build(f"block_layout_{tag}", layout_stamped(src),
                local_headers(csrc, src))
    lib.block_layout_launch.argtypes = [vp, vp, i64, vp, vp, vp, i32, vp]
    lib.probe_stamps.argtypes = [vp, i32]
    plib = None
    if (csrc / "pack_words.cu").exists():
        psrc = (csrc / "pack_words.cu").read_text()
        plib = build(f"pack_words_{tag}", psrc, local_headers(csrc, psrc))
        # the one-pass kernel's library answers its occupancy query
        if hasattr(plib, "pack_words_resident"):
            plib.pack_words_launch.argtypes = [
                *[vp] * 14, i64, i32, i64, vp, vp, vp, i32, vp]
        else:
            out["pack_words"] = "the two-pass design: not stamped here"
            plib = None
    host = np.zeros(16, np.uint64)
    for size, got in inputs.items():
        a = got["pack_words"][2]
        rest, sto = corpus.layout_inputs(a)
        nb = rest.shape[0]
        o = torch.empty(2 * nb + 1, dtype=torch.int64, device="cuda")

        def run(_i=0):
            rc = lib.block_layout_launch(
                rest.data_ptr(), sto.data_ptr(), nb, o.data_ptr(),
                o[nb:].data_ptr(), o[2 * nb:].data_ptr(), 0, raw(0))
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        cyc = []
        for _ in range(20):
            run()
            torch.cuda.synchronize()
            lib.probe_stamps(host.ctypes.data, 0)
            cyc.append(float(host[0]))
        want = BL.block_layout_ref(rest.cpu(), sto.cpu())
        same = (torch.equal(o[:nb].cpu(), want[0])
                and torch.equal(o[nb:2 * nb].cpu(), want[1]))
        ms, covered = queued(run)
        out[f"block_layout_{size}"] = {
            "blocks": nb, "equal_plain": same,
            "kernel_cycles_median_max": median_max(cyc),
            "queued_ms": ms, "covered": covered,
            "profiler_ms": sum(profiled_ms(run, 5).values())}
        if plib is not None:
            out[f"pack_words_{size}"] = probe_one_pass(plib, a)


def probe_one_pass(plib, a) -> dict:
    """The one-pass pack_words' row of probe_tree, from the kernel's own
    stats buffer (each unit's look-back in clock64 cycles, its start and
    end on the globaltimer)."""
    from deflate_compression_tpu_torch.ops import pack_words as PW
    raw = cuda_build.raw_stream()
    S, NB, nw = a[0].shape[0], a[0].shape[0] // 32768, a[15]
    NU, NSUB = S // 4096, S // 64
    buf = torch.empty(nw + 3 * NB + 4 + 2 * NU, dtype=torch.int64,
                      device="cuda")
    ent = torch.empty(3 * NSUB, dtype=torch.int64, device="cuda")
    st = torch.zeros((20, NU, 7), dtype=torch.int64, device="cuda")

    def pack(i=0, stats=True):
        rc = plib.pack_words_launch(
            *[t.data_ptr() for t in a[:14]], S, int(a[14]), nw,
            buf.data_ptr(), ent.data_ptr(),
            st[i].data_ptr() if stats else None, 0, raw(0))
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    for i in range(20):
        pack(i)
    torch.cuda.synchronize()
    want = PW.pack_words_ref(*a)
    same = (torch.equal(buf[:nw], want.words)
            and torch.equal(buf[nw:nw + NB], want.block_base)
            and torch.equal(ent[:NSUB], want.sub_bit))
    q = st.cpu().numpy().astype(np.float64)
    cyc = q[:, :, 0].reshape(-1)
    ghz = (q[:, :, 6] - q[:, :, 5]).sum(1) / (q[:, :, 3] - q[:, :, 1]).sum(1)
    span = q[:, :, 3].max(1) - q[:, :, 1].min(1)
    mid = (q[:, :, 1].min(1) + q[:, :, 3].max(1)) / 2
    in_flight = ((q[:, :, 1] <= mid[:, None])
                 & (q[:, :, 3] >= mid[:, None])).sum(1)
    ms, covered = queued(lambda i: pack(stats=False))
    return {
        "units": NU, "blocks": NB, "equal_plain": same,
        "lookback_cycles_median_p90_max": [
            float(np.median(cyc)), float(np.percentile(cyc, 90)),
            float(cyc.max())],
        "to_inclusive_found_cycles_median": float(np.median(q[:, :, 4])),
        "clock_ghz_median_min_max": [float(np.median(ghz)),
                                     float(ghz.min()), float(ghz.max())],
        "unit_us_median": float(np.median(q[:, :, 3] - q[:, :, 1]) / 1e3),
        "to_aggregate_us_median": float(
            np.median(q[:, :, 2] - q[:, :, 1]) / 1e3),
        "after_aggregate_us_median": float(
            np.median(q[:, :, 3] - q[:, :, 2]) / 1e3),
        "last_aggregate_after_start_us_median": float(np.median(
            q[:, :, 2].max(1) - q[:, :, 1].min(1)) / 1e3),
        "span_us_median": float(np.median(span) / 1e3),
        "units_in_flight_at_mid_median": float(np.median(in_flight)),
        "queued_ms": ms, "covered": covered,
        "profiler_ms": profiled_ms(lambda: pack(stats=False), 5)}


def main(argv) -> int:
    out_file = None
    if "--out" in argv:
        i = argv.index("--out")
        out_file = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        raise SystemExit("block_stage_probe needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    inputs = {}
    for size, n in (("1mb", 1 << 20), ("4mb", 4 << 20)):
        x = torch.from_numpy(np.frombuffer(build_corpus(n), np.uint8).copy()
                             ).cuda()
        inputs[size] = block_stage_inputs(x, n)
    empty = build("empty", EMPTY).empty_launch
    empty.argtypes = [ctypes.c_void_p]
    raw = cuda_build.raw_stream()
    rows = [{"card": card, "empty_kernel_queued_ms": device_ms(
        lambda: empty(raw(0)), 20)[0]}]
    print(json.dumps(rows[0]), flush=True)
    for tree in argv:
        row = probe_tree(Path(tree).resolve(), inputs)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
