"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line and ends with torch.cuda.synchronize()):
  1. device: the card's name and power limit;
  2. build: start nvcc on every CUDA source of csrc/ at once (eleven),
     wait for all;
  3. tile_histogram against its plain PyTorch version, exact equality, on
     int32 and int64 symbols, rows 1-128, C = 30, 286 and MAX_CLASSES, and
     a skewed input (every row one symbol 32768 times); both times at the
     1 MB-shard shape (32 rows) on int32 and on the encoder's int64
     symbols, and on the skewed rows, and at the 4 MB-shard shape (128
     rows) on int64: per call, on the device per launch and summed by
     kernel name under torch.profiler (`timings`), beside the bound and a
     torch.bincount of the flattened row-offset index (context: it is not
     the same function); the wrapper once under sync debug mode "error";
  4. the encode slice: ZlibCodec.compress of an ~8.5 MB corpus on the card,
     checked by zlib.decompress, with the launch counts of its six
     kernels (find_matches, lz_parse, tile_histogram, block_plan,
     huffman_codes and pack_words: 1, 1, 2, 1, 2 and 1 per shard;
     block_layout 0: pack_words' look-back carries the layout);
  5. encode_shard on the card against the port on the CPU, bit for bit, for
     the first and the last shard, and the whole stream of phase 4;
  6. build: decode_symbols.cu, lut_gather.cu, build_tables.cu and
     copy_sources.cu (compiled in phase 2) loaded;
  7. the decoder's four kernels against their plain versions, exactly:
     decode_symbols on the corpus's first and last shards and on the whole
     flat batch (its wrapper once under sync debug mode "error"),
     lut_gather at the probe's (2048, 4096), the block-flag lookup, a
     table past 32768 entries and a bandwidth-bound 2^24 indices (in GB/s,
     beside a device-to-device copy of the same bytes), build_tables
     (phase A) and copy_sources (phase C's bytes) on the flat batch, each
     once under sync debug mode "error"; each kernel's and plain version's
     times as in phase 3, with bound and library call;
  8. the decode slice: compress_stream with an index sink, then
     decode_blocks_batch over all shards in one flat call (adler32 per
     shard, bytes, verified-decode MB/s, one launch of each of the four
     decode kernels, phase times beside the plain versions' in the same
     run), decompress_indexed of the stream with the encoder's index (the
     four kernels once per group), and of a foreign zlib-9 stream through
     build_index, then once more with build_tables and copy_sources held
     against their plain versions in every group (15-bit codes, the prefix
     carried), and the same for the flat decode of a block_type="fixed"
     and a block_type="stored" encode of 2 MB;
  9. strictness on the card and GPU against CPU: seeded bit flips at lane
     starts and inside dynamic headers flagged or rejected with the CPU's
     ok and bad lanes (build_tables and copy_sources held against their
     plain versions in each mutated decode), decompress_indexed raising,
     the declared-window violation, clean shards equal;
 10. large shards: a 32 MB corpus in 4 MB shards through ZlibCodec on the
     card (zlib.decompress, the encode's launches, MB/s beside phase
     4's, peak device memory), the first and last shard GPU == CPU,
     compress_stream's index into one flat decode_blocks_batch (adler32
     per shard, bytes, the four decode kernels once each and equal to
     their plain versions on that batch, phase times beside the plain
     versions'), and
     decompress_indexed with the encoder's index;
 11. the codec's surface: the raw, zlib and gzip codecs compress the 8.5
     MB corpus on the card (the encode kernels' launches checked) and
     decompress it on the host (zlib / gzip oracles), the self-check on 2 MB, verify_stream of its zlib and gzip
     blobs, png_decode of a PNG built here, the per-symbol trace of 256 KB
     on the card (one shard: find_matches and lz_parse once each) against
     the CPU;
 12. distributed and resumable encode of phase 4's corpus in 1 MB shards:
     compress_distributed in a 1-rank NCCL group (phase 4's bytes,
     tile_histogram 18 times), in 2 gloo ranks that both encode on cuda:0
     (subprocesses; NCCL refuses two ranks on one GPU), its index given to a
     flat decode_blocks_batch, and compress_file_resumable crashed after
     shard 3 and resumed;
 13. the command line: each subcommand as `python3 -m
     deflate_compression_tpu_torch` in a subprocess (compress, decompress
     --index and trace on the card, counting launches; decompress --index
     also on a gzip -9 member, its CRC-32 checked on the card), checked
     against the zlib oracle and the bytes of phases 4 and 11;
 14. the encoder's LZ77 kernels: find_matches and lz_parse against their
     plain versions, exactly, on phase 4's first and last shards, one 4 MB
     shard, the trace's input and the edge cases of `corpus.lz_case`;
     tokenize once under sync debug mode "error"; both kernels' and plain
     versions' times as in phase 3 at 1 MB and 4 MB shards, as tokenize
     calls them (the packed hand-off), beside the bound (bytes over 3.35
     TB/s or integer operations over the int32 rate, whichever is larger);
     each call's kernels under the profiler (find_matches: hash, sort, links, walk; lz_parse: the
     match and parse kernels), and tokenize's peak device memory at 4 MB;
 15. the encoder's block stage: block_plan, huffman_codes and block_layout
     against their plain versions on the inputs every encode_shard of
     phase 4's and phase 10's corpora handed them (block_layout, whose
     work the encoder does inside pack_words, on each encode's layout:
     `corpus.layout_inputs`), of a block_type="fixed"
     and a "stored" encode of 2 MB, and on the cases of
     `corpus.block_plan_case`, `huffman_case` and `layout_case`: the split,
     n_blocks, code lengths, codes, reversed codes and the layout exactly,
     the segment costs at rtol 1e-5 (the largest relative error printed),
     and the smallest margin of a DP step between its best and
     second-best candidate; each kernel's and plain version's times as in
     phase 3 at phase 4's first shard and phase 10's, beside its bound
     (bytes over 3.35 TB/s or operations over the float32 or int32 rate),
     its serial depth (DP steps, code-length levels, layout scan levels)
     and serial-depth bound (an empty kernel's queued launch plus the
     chain's steps at the SM clock nvidia-smi reads), with block_plan's
     DP time a step from the clock64 cycles its kernel reports;
 16. the encoder's pack: pack_words against its plain version, exactly
     (words, total_bits, layout, token bits and the decode entries
     sub_bit, sub_out, sub_blk, sub_overflow), on every call of phase 15
     and on `corpus.pack_case`'s synthetic shards, its layout against
     block_layout's plain version, the wrapper under sync debug mode
     "error"; its times as in phase 3 at phase 4's first shard and phase
     10's (the kernel and its memset each by the profiler), beside the
     bound (the bytes this data needs over 3.35 TB/s: a position's 18
     only in blocks with Huffman codes, a stored block's bytes), the
     look-back's wait per unit in clock64 cycles, taken to ns at the
     launch's own clock, and the kernel's span on the globaltimer
     (`stats`), and one 4 MB encode_shard's peak device memory;
 17. the Adler-32 kernel: adler32_torch against zlib.adler32 and its plain
     version, exactly, at lengths 0 to 4 MiB + 1 (zlib's NMAX +- 1, all
     0xFF), views at each of the 16 byte offsets, a length held on the
     card, one launch a call, the largest difference from zlib
     (`max_abs_err`); under sync debug mode "error"; its times as
     in phase 3 on 1 MiB and 4 MiB (the verified decode's group and shard)
     beside the bound, the bytes read once over 3.35 TB/s;
 18. the CRC-32 kernel: crc32_torch against zlib.crc32 and its plain
     version as phase 17 holds adler32, with starting values as ints and
     on the card, its times at 1 MiB and 4 MiB beside the bound (the bytes
     read once and 8 written), and a gzip -9 member of 32 MB through
     decompress_gzip_indexed in 4 MiB groups, one launch a group.
Any failure raises, so the script exits non-zero. Before the last line it
prints the kernels' JSON line: per kernel its launches on the main path
(the 1 MB-shard encode of phase 4 and decode of phase 8), on the 4 MB-
shard path of phase 10 (`launches_4mb`), in phase 12's 1-rank NCCL encode
(`launches_dist`) and per CLI subcommand of phase 13 (`launches_cli`), its
error against the plain
version, and its device time per launch (`ms`), its plain version's
(`plain_ms`), the bound (`bound_ms`: the bytes it must move over 3.35
TB/s, or for find_matches, lz_parse and the block stage's kernels the
larger of that and their operations over the int32 rate, or the float32
rate for block_plan, `bound_by` saying which) and
`share_of_bound`, each computed from this run; find_matches and lz_parse
are timed as tokenize calls them (packed result; bound bytes 5 and 22 a
position), carry `by_kernel`, the same at the 4 MB shard (`*_4mb`), and
find_matches `tokenize_peak_mib_4mb`;
tile_histogram's `rows128_*` keys are the same at (128, 32768);
build_tables and copy_sources carry `ms_4mb`,
`bound_ms_4mb` and `share_of_bound_4mb` on phase 10's batch, and
`call_ms_4mb` and `plain_call_ms_4mb`, one call each there by CUDA events,
and copy_sources `bound_with_gathers_ms`, its bound with the pointer
rounds' gathers added, `rounds_run` (the gather rounds the kernels ran on
phase 7's batch; `rounds_run_4mb` on phase 10's) and `plain_rounds`;
block_plan, huffman_codes and block_layout carry `serial_depth` and the
same at phase 10's first shard (`*_4mb`), huffman_codes its 7-bit call
(`ms_7bit`, `*_7bit_4mb`), block_plan `max_rel_err_cost`, `min_gap` and
`dp_ns_per_step` (`*_4mb`), the three `serial_bound_ms` (`*_4mb`,
`*_7bit`), block_layout `main_path`; pack_words carries `kernel_ms` and
`memset_ms` (each by the profiler), `clock_ghz` (the SM clock of the
launch with stats: its units' clock64 cycles over their globaltimer ns),
`lookback_ns_median` and `lookback_ns_max` (a unit's wait in its
look-back, its cycles at that clock), `to_aggregate_us`
(a unit's start to its aggregate, median), `span_us` (first unit's
start to last unit's end), the same at phase 10's first shard
(`*_4mb`), `resident_units`, `calls_held`, `layout_scan_max_abs_err`,
`peak_gib_4mb_encode` (phase 10's encode) and
`encode_shard_peak_mib_4mb` (one 4 MB encode_shard); adler32 carries its
launches in phase 8's flat decode (`launches`: one a shard) and its
indexed decode (`launches_indexed`: one a group), on the other paths as the
others do (one a shard in `launches_4mb` and `launches_dist`, none in the
CLI's compress and trace, one a group in its decompress --index),
`launches_per_call` (phase 17's loop) and the same times at 4 MiB
(`*_4mb`); crc32 carries its launches in phase 18's gzip member
(`launches_gzip`: one a group), none on the other paths but the CLI's
decompress --index of a gzip member (one a group), `launches_per_call`
and its times as adler32's.
The last line is the JSON result {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from deflate_compression_tpu_torch.ops.timing import (  # noqa: E402
    cuda_ms, device_ms, profiled_ms)

SHAPES = [(32, 32768, 286), (32, 32768, 30), (17, 32768, 286), (1, 32768, 286),
          (128, 32768, 286), (128, 32768, 30)]
CORPUS_BYTES = 8_500_000
LARGE_CORPUS_BYTES = 33_554_432  # phase 10: 8 shards of 4 MB
LARGE_SHARD = 4 << 20
SELF_CHECK_BYTES = 2 << 20       # phase 11: the Python ring replay's input
TRACE_BYTES = 256 << 10
FOREIGN_BYTES = 4_000_000
PHASE5_KEYS = ("total_bits", "btype", "block_bits", "sub_bit", "sub_out",
               "sub_blk")
IDX_KEYS = ("block_bit_base", "block_out_start", "btype", "n_blocks",
            "sub_bit", "sub_out", "sub_blk")
N_MUTATIONS = 6
N_HEADER_MUTATIONS = 4           # phase 9: flips inside dynamic headers
DECODE_KERNELS = ("build_tables", "lut_gather", "decode_symbols",
                  "copy_sources")
WINDOW = 32768


HBM_GBS = 3350.0                 # H100 SXM device memory, GB/s (data sheet)
# int32 lanes per SM and boost clock of the H100 SXM (Hopper white paper):
# the int32 rate is SMs x 64 x 1.98 GHz operations per second
INT32_LANES = 64
BOOST_GHZ = 1.98
ENCODE_KERNELS = ("find_matches", "lz_parse")
BLOCK_KERNELS = ("block_plan", "huffman_codes", "block_layout")
PACK = "pack_words"
PACK_KERNEL = "pack_words_kernel"
F32_TFLOPS = 67.0                # H100 SXM float32 outside the tensor cores
# lz_parse's integer operations per position, counted in csrc/lz_parse.cu:
# the run test and search (about 4), three chain rounds (6 each), the
# clamps (6), lazy (5), the outputs and the parse's three walks (7)
LZ_PARSE_OPS = 40
TABLE_BYTES = 17_792             # one block's decode tables (decode_symbols.cu)


def timings(kernel: str, fn, plain, n: int, prof_n: int,
            bound_bytes: int, reps: int = 25, plain_n: int | None = None,
            bound_ops: int = 0, ops_rate: float | None = None,
            expect=()) -> dict:
    """A kernel's and its plain version's times: per call (`cuda_ms`), on
    the device per launch (`device_ms`, n calls, plain_n of a slow plain
    version; plain_n=0 for a plain version that launches more kernels than
    the launch queue holds behind the spin: there its profiler sum stands
    for its device time) and by kernel name under
    torch.profiler (`profiled_ms`, prof_n calls; the kernel's own entries,
    and every device entry of the plain version; the profiler's window
    must hold `kernel` and each name of `expect`); and the bound, the
    larger of the bytes the function must move over the card's memory rate
    and its operations over `ops_rate` (per second; the int32 rate by
    default)."""
    t = {"call_ms": cuda_ms(fn, reps), "plain_call_ms": cuda_ms(plain, reps)}
    t["device_ms"], t["held"] = device_ms(fn, n)
    t["plain_device_ms"], t["plain_held"] = (
        device_ms(plain, plain_n or n) if plain_n != 0 else (None, False))
    by = profiled_ms(fn, prof_n, (kernel, *expect))
    t["prof_ms"] = sum(v for k, v in by.items() if kernel in k)
    t["by_kernel"] = {re.search(r"\w*_kernel|$", k).group() or k: v
                      for k, v in by.items() if kernel in k}
    plain_by = profiled_ms(plain, prof_n)
    t["plain_prof_ms"] = sum(plain_by.values())
    t["plain_kernels"] = len(plain_by)
    # device time per launch: queued where the call lets the device run
    # ahead, else the profiler's sum
    t["ms"] = t["device_ms"] if t["held"] else t["prof_ms"]
    t["plain_ms"] = (t["plain_device_ms"] if t["plain_held"]
                     else t["plain_prof_ms"])
    t["bound_ms"] = bound_ms(bound_bytes)
    t["bound_by"] = "bytes"
    ops_ms = bound_ops / (ops_rate or int32_rate()) * 1e3
    if ops_ms > t["bound_ms"]:
        t["bound_ms"], t["bound_by"] = ops_ms, "operations"
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    return t


def int32_rate() -> float:
    """The card's int32 operations per second: SMs x lanes x boost clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES * BOOST_GHZ * 1e9


def show(t: dict) -> str:
    """One line of a `timings` result."""
    def dev(ms, held):
        if ms is None:
            return "not queued (more launches than the queue holds)"
        return f"{ms:.4f}" + ("" if held else " (waits for the device, "
                              "host included)")
    return (f"kernel {t['call_ms']:.4f} ms per call, "
            f"{dev(t['device_ms'], t['held'])} ms device per launch, "
            f"{t['prof_ms']:.4f} ms profiler, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), share of bound {t['share_of_bound']:.3f}; "
            f"plain "
            f"{t['plain_call_ms']:.4f} ms per call, "
            f"{dev(t['plain_device_ms'], t['plain_held'])} ms device, "
            f"{t['plain_prof_ms']:.4f} ms profiler over "
            f"{t['plain_kernels']} kernel names")


def no_sync(fn):
    """fn() under torch's sync debug mode "error": raises if it waits for
    the device."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from deflate_compression_tpu_torch import CodecConfig
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.models.codec import ZlibCodec
    from deflate_compression_tpu_torch.ops import block_layout as BL
    from deflate_compression_tpu_torch.ops import block_plan as BP
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    from deflate_compression_tpu_torch.ops import cuda_build
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import find_matches as FM
    from deflate_compression_tpu_torch.ops import histogram as H
    from deflate_compression_tpu_torch.ops import huffman_codes as HC
    from deflate_compression_tpu_torch.ops import lut_gather as LG
    from deflate_compression_tpu_torch.ops import lz_parse as LP
    from deflate_compression_tpu_torch.ops import adler32 as AD
    from deflate_compression_tpu_torch.ops import pack_words as PW

    dev = torch.device("cuda")
    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, count {torch.cuda.device_count()}")
    torch.cuda.synchronize()

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    builds = [cuda_build.Build(src) for src in (
        H.SOURCE, DS.SOURCE, LG.SOURCE, BT.SOURCE, CS.SOURCE, FM.SOURCE,
        LP.SOURCE, BP.SOURCE, HC.SOURCE, BL.SOURCE, PW.SOURCE, AD.SOURCE)]
    lib = builds[0].wait()
    t_hist = time.perf_counter() - t0
    ds_lib, lg_lib, bt_lib, cs_lib, *rest_libs = (
        b.wait() for b in builds[1:])
    t_ds = time.perf_counter() - t0
    print(f"phase 2 build: nvcc started on the {len(builds)} sources "
          f"together ({', '.join(b.source.name for b in builds)}); "
          f"{lib.name} in {t_hist:.2f} s, {ds_lib.name}, {lg_lib.name}, "
          f"{bt_lib.name}, {cs_lib.name}, "
          f"{', '.join(x.name for x in rest_libs)} done {t_ds:.2f} s after "
          f"the start")
    torch.cuda.synchronize()

    # ------------------------------------------ 3. kernel vs plain version
    rng = np.random.default_rng(7)
    max_err = 0
    times = {}
    for rows, length, C in SHAPES + [(2, 32768, H.MAX_CLASSES)]:
        for dtype in (torch.int32, torch.int64):
            sym = torch.from_numpy(rng.integers(-1, C + 5, (rows, length))
                                   ).to(dtype).to(dev)
            cases = [("random", sym)]
            if rows == 32:
                cases.append(("skewed", (torch.arange(
                    rows, device=dev).unsqueeze(1) * 7 % C).expand(
                        rows, length).contiguous().to(dtype)))
            for label, x in cases:
                got = H.tile_histogram(x, C)
                want = H.tile_histogram_ref(x, C)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                if err != 0 or got.shape != (rows, C) or got.dtype != dtype:
                    raise AssertionError(
                        f"tile_histogram != plain at {(rows, length, C)} "
                        f"{dtype} {label}: max abs err {err}")
                max_err = max(max_err, err)
                if (rows == 32 and (dtype == torch.int64
                                    or label == "random")) or (
                        rows == 128 and dtype == torch.int64
                        and label == "random"):
                    key = (rows, C, str(dtype).split(".")[-1], label)
                    times[key] = hist_timings(H, x, C)
                    if key == (32, 286, "int64", "random"):
                        main_sym = x
    hist_ok = no_sync(lambda: H.tile_histogram(main_sym, 286))
    if not torch.equal(hist_ok, H.tile_histogram_ref(main_sym, 286)):
        raise AssertionError("tile_histogram under sync debug mode differs")
    shapes = ", ".join(f"{s[:2]}/C={s[2]}"
                       for s in SHAPES + [(2, 32768, H.MAX_CLASSES)])
    shown = "; ".join(f"({r}, 32768) C={c} {d} {lab}: {show(t)}; "
                      f"torch.bincount of the flat row-offset index "
                      f"{t['bincount_ms']:.4f} ms per call (context)"
                      for (r, c, d, lab), t in times.items())
    print(f"phase 3 kernel: tolerance 0 (exact), max abs err {max_err} on "
          f"{shapes}, int32 and int64, random and skewed rows; the wrapper "
          f"ran under sync debug mode \"error\"; {shown}")
    torch.cuda.synchronize()

    # ------------------------------------------------------- 4. the slice
    raw = build_corpus(CORPUS_BYTES)
    cfg = CodecConfig()
    nsh = math.ceil(len(raw) / cfg.shard_size)
    codec = ZlibCodec(cfg, device="cuda")
    codec.compress(raw)                           # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    blob, stats = codec.compress(raw, return_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    enc_launches = read_counts()
    if zlib.decompress(blob) != raw:
        raise AssertionError("zlib.decompress(blob) != raw")
    if enc_launches != encode_counts(nsh):
        raise AssertionError(f"the encode launched {enc_launches}, want "
                             f"{encode_counts(nsh)}")
    if not (stats.n_tokens > 0 and stats.n_matches > 0):
        raise AssertionError("no tokens or no matches")
    if stats.btype_counts[0] == 0 or stats.btype_counts[2] == 0:
        raise AssertionError(f"want stored and dynamic blocks, got "
                             f"{stats.btype_counts}")
    t0 = time.perf_counter()
    zc = zlib.compress(raw, 6)
    zdt = time.perf_counter() - t0
    print(f"phase 4 slice: {len(raw)} bytes, {nsh} shards, "
          f"encode {len(raw) / dt / 1e6:.3f} MB/s ({dt:.3f} s), "
          f"ratio {len(blob) / len(raw):.5f}, btype_counts "
          f"{stats.btype_counts}, tokens {stats.n_tokens}, matches "
          f"{stats.n_matches}, launches {enc_launches}; "
          f"host zlib-6 ratio {len(zc) / len(raw):.5f} at "
          f"{len(raw) / zdt / 1e6:.3f} MB/s; zlib.decompress OK")
    torch.cuda.synchronize()

    # ------------------------------------------------- 5. GPU vs CPU port
    checked = gpu_equals_cpu(raw, cfg.shard_size, dev)
    if ZlibCodec(cfg, device="cpu").compress(raw) != blob:
        raise AssertionError("whole-corpus stream differs GPU vs CPU")
    print(f"phase 5 gpu vs cpu: identical words/total_bits/btype/block_bits/"
          f"sub_* for shards (index, bytes, bits) {checked}; whole "
          f"{len(blob)}-byte zlib stream identical")
    torch.cuda.synchronize()

    ad_main, decode = decode_phases(raw, cfg, blob, dev,
                           (ds_lib.name, lg_lib.name, bt_lib.name,
                            cs_lib.name), t_ds)
    large = large_shard_phase(dev, len(raw) / dt)
    px, tr_launches = surface_phase(raw, dev)
    dist = dist_phase(raw, cfg, blob, dev, len(raw) / dt)
    cli = cli_phase(raw, blob, stats, px, dev)
    lz = lz77_phase(raw, cfg, dev)
    blk = block_stage_phase(raw, cfg, dev)
    pk = pack_phase(blk, dev)
    ad = adler32_phase(dev)
    cr = crc32_phase(dev)
    blk_peak = blk.pop("encode_peak_mib")
    del blk["packs"], blk["first_packs"]

    def new_paths(name):
        paths = {"launches_4mb": large[name],
                 "launches_dist": dist["launches"][name],
                 "launches_cli": {k: v[name] for k, v in cli.items()}}
        phase = {"build_tables": "A", "copy_sources": "C"}.get(name)
        if phase:       # phase 10's flat batch; the calls one each, by events
            paths["ms_4mb"] = large["device_ms"][name]
            paths["bound_ms_4mb"] = large["bound_ms"][name]
            paths["share_of_bound_4mb"] = (large["bound_ms"][name]
                                           / large["device_ms"][name])
            paths["call_ms_4mb"] = large["phases"][phase + "_kernel"]
            paths["plain_call_ms_4mb"] = large["phases"][phase + "_plain"]
        if name == "copy_sources":
            paths["rounds_run_4mb"] = large["rounds_run"]
        return paths

    print(json.dumps({"kernels": [{
        "name": "tile_histogram", "route": "cuda",
        "source": "deflate_compression_tpu_torch/csrc/tile_histogram.cu",
        "replaces": "deflate_compression_tpu/ops/histogram_pallas.py:74",
        "launches": enc_launches["tile_histogram"],
        **new_paths("tile_histogram"),
        "launches_dist_gloo_ranks": dist["gloo_ranks"],
        "launches_resumable": dist["resumable"],
        "max_abs_err": max_err,
        **entry(times[(32, 286, "int64", "random")]), "library_ms": None,
        "int32_ms": times[(32, 286, "int32", "random")]["ms"],
        "c30_ms": times[(32, 30, "int64", "random")]["ms"],
        "skewed_ms": times[(32, 286, "int64", "skewed")]["ms"],
        **{f"rows128_{k}": times[(128, 286, "int64", "random")][k]
           for k in ("ms", "plain_ms", "bound_ms", "share_of_bound",
                     "call_ms")},
        "rows128_c30_ms": times[(128, 30, "int64", "random")]["ms"],
        "context_bincount_ms": times[(32, 286, "int64", "random")][
            "bincount_ms"]},
        *({**d, **new_paths(d["name"])} for d in decode),
        *({"name": name, "route": "cuda",
           "source": f"deflate_compression_tpu_torch/csrc/{name}.cu",
           "replaces": replaces,
           "launches": enc_launches[name], **new_paths(name),
           "launches_trace": tr_launches[name],
           "max_abs_err": lz["max_abs_err"][name],
           **entry(lz["times"][name, "1mb"]), "library_ms": None,
           "by_kernel": lz["times"][name, "1mb"]["by_kernel"],
           **{f"{k}_4mb": lz["times"][name, "4mb"][k]
              for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                        "share_of_bound", "call_ms", "plain_call_ms",
                        "prof_ms", "plain_prof_ms")},
           **({"tokenize_peak_mib_4mb": lz["tokenize_peak_mib"]}
              if name == "find_matches" else {})}
          for name, replaces in (
              ("find_matches", "deflate_compression_tpu/core/lz77.py:88 "
               "(left to XLA there: no Pallas kernel)"),
              ("lz_parse", "deflate_compression_tpu/core/lz77.py:497 and "
               ":340 (left to XLA there: no Pallas kernel)"))),
        *({"name": name, "route": "cuda",
           "source": f"deflate_compression_tpu_torch/csrc/{name}.cu",
           "replaces": replaces,
           "launches": enc_launches[name], **new_paths(name),
           "max_abs_err": blk["max_abs_err"][name],
           **entry(blk["times"][name, "1mb"]), "library_ms": None,
           "serial_depth": blk["depth"][name, "1mb"],
           "by_kernel": blk["times"][name, "1mb"]["by_kernel"],
           **{f"{k}_4mb": blk["times"][name, "4mb"][k]
              for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                        "share_of_bound", "call_ms", "plain_call_ms",
                        "prof_ms", "plain_prof_ms")},
           "serial_depth_4mb": blk["depth"][name, "4mb"],
           **blk["extra"][name]}
          for name, replaces in (
              ("block_plan", "deflate_compression_tpu/core/cost.py:34-160 "
               "(left to XLA there: no Pallas kernel)"),
              ("huffman_codes", "deflate_compression_tpu/core/huffman.py:"
               "75-192 and core/bits.py:30-44 (left to XLA there: no "
               "Pallas kernel)"),
              ("block_layout", "deflate_compression_tpu/format/deflate.py:"
               "520-534, a lax.scan (left to XLA there: no Pallas "
               "kernel)"))),
        {"name": PACK, "route": "cuda",
         "source": "deflate_compression_tpu_torch/csrc/pack_words.cu",
         "replaces": "deflate_compression_tpu/core/bits.py:95,182 "
         "(pack_items64_to_words, pack_items96_to_words) and "
         "format/deflate.py:421-676 (token items, layout, item offsets, "
         "the two packs, stored payloads, sub-block decode entries; left "
         "to XLA there: no Pallas kernel)",
         "launches": enc_launches[PACK], **new_paths(PACK),
         "max_abs_err": pk["max_abs_err"], **entry(pk["times"]["1mb"]),
         "library_ms": None, "calls_held": pk["calls"],
         "by_kernel": pk["times"]["1mb"]["by_kernel"],
         **{k: pk["times"]["1mb"][k] for k in PACK_EXTRA},
         **{f"{k}_4mb": pk["times"]["4mb"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "share_of_bound", "call_ms", "plain_call_ms",
                      "prof_ms", "plain_prof_ms", *PACK_EXTRA)},
         "resident_units": pk["resident"],
         "peak_gib_4mb_encode": large["peak_gib"],
         "encode_shard_peak_mib_4mb": blk_peak["4mb"],
         "encode_shard_peak_mib": blk_peak["1mb"],
         "layout_scan_max_abs_err": pk["layout_err"]},
        {"name": "adler32", "route": "cuda",
         "source": "deflate_compression_tpu_torch/csrc/adler32.cu",
         "replaces": "deflate_compression_tpu/core/checksum.py::adler32_jax "
         "(plain jnp there: no Pallas kernel)",
         **ad_main, **new_paths("adler32"),
         "launches_per_call": ad["launches_per_call"],
         "max_abs_err": ad["max_abs_err"],
         **entry(ad["1mb"]), "library_ms": None,
         **{f"{k}_4mb": ad["4mb"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "share_of_bound", "call_ms", "plain_call_ms",
                      "prof_ms", "plain_prof_ms")}},
        {"name": "crc32", "route": "cuda",
         "source": "deflate_compression_tpu_torch/csrc/crc32.cu",
         "replaces": "none: the JAX package's CRC-32 is host numpy "
         "(deflate_compression_tpu/core/checksum.py::crc32_np)",
         "launches_gzip": cr["launches_gzip"], **new_paths("crc32"),
         "launches_per_call": cr["launches_per_call"],
         "max_abs_err": cr["max_abs_err"],
         **entry(cr["1mb"]), "library_ms": None,
         **{f"{k}_4mb": cr["4mb"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "share_of_bound", "call_ms", "plain_call_ms",
                      "prof_ms", "plain_prof_ms")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def entry(t: dict) -> dict:
    """The times of a kernels-line entry from a `timings` result: `ms` and
    `plain_ms` are device time per launch; where a call waits for the
    device, its device_ms includes the host and prof_ms is the device
    time."""
    return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "share_of_bound", "call_ms", "plain_call_ms",
                              "device_ms", "plain_device_ms", "prof_ms",
                              "plain_prof_ms")}


def hist_timings(H, sym, C: int) -> dict:
    """tile_histogram's `timings` at sym, its bound (sym read once, the
    counts written once) and, as context, one torch.bincount over the
    already-flattened row-offset index (the plain version's core; not the
    same function, which takes the symbols themselves)."""
    rows, length = sym.shape
    t = timings("tile_histogram_kernel", lambda: H.tile_histogram(sym, C),
                lambda: H.tile_histogram_ref(sym, C), 100, 20,
                (rows * length + rows * C) * sym.element_size())
    s = sym.long()
    s = torch.where((s >= 0) & (s < C), s, C)
    flat = (torch.arange(rows, device=sym.device).unsqueeze(1) * (C + 1)
            + s).reshape(-1)
    t["bincount_ms"] = cuda_ms(
        lambda: torch.bincount(flat, minlength=rows * (C + 1)))
    return t


def shard_input(raw: bytes, S: int, s: int):
    """Shard s of raw as encode_shard takes it: (u8[S] CPU tensor, valid
    bytes, final)."""
    part = raw[s * S:(s + 1) * S]
    buf = np.zeros(S, dtype=np.uint8)
    buf[:len(part)] = np.frombuffer(part, dtype=np.uint8)
    return torch.from_numpy(buf), len(part), s == math.ceil(len(raw) / S) - 1


def gpu_equals_cpu(raw: bytes, S: int, dev) -> list:
    """encode_shard of the first and the last shard on the card and on the
    CPU: words to total_bits and PHASE5_KEYS identical, or raise. Returns
    (index, bytes, bits) per shard."""
    from deflate_compression_tpu_torch.format.deflate import encode_shard
    checked = []
    for s in sorted({0, math.ceil(len(raw) / S) - 1}):
        x, vl, final = shard_input(raw, S, s)
        rg = encode_shard(x.to(dev), vl, final)
        rc = encode_shard(x, vl, final)
        nw = (int(rc["total_bits"]) + 31) // 32
        if not torch.equal(rg["words"][:nw].cpu(), rc["words"][:nw]):
            raise AssertionError(f"{S}-byte shard {s}: words differ GPU vs "
                                 f"CPU")
        for k in PHASE5_KEYS:
            if not torch.equal(rg[k].cpu(), rc[k]):
                raise AssertionError(f"{S}-byte shard {s}: {k} differs GPU "
                                     f"vs CPU")
        checked.append((s, vl, int(rc["total_bits"])))
    return checked


def verified_decode(raw: bytes, batch, valid, S: int):
    """One flat decode_blocks_batch over every shard of `batch`, checked
    on the card: ok, adler32 per shard equal to zlib's of the input, and
    the bytes. Returns (result, host seconds of the decode and its adler32
    checks, every kernel's launches in it: one of each decode kernel and
    one adler32 a shard); the first call warms up."""
    from deflate_compression_tpu_torch.core.checksum import adler32_torch
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    nsh = len(valid)
    want = [zlib.adler32(raw[s * S:(s + 1) * S]) for s in range(nsh)]

    def run():
        r = DI.decode_blocks_batch(*batch, valid, S)
        ads = torch.stack([adler32_torch(r["out"][s], valid[s])
                           for s in range(nsh)]).tolist()
        return r, bool(r["ok"]), ads

    run()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res, ok, ads = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    if launches != decode_counts(1, adler32=nsh):
        raise AssertionError(f"flat decode of {S}-byte shards launched "
                             f"{launches}")
    if not ok or ads != want:
        raise AssertionError(f"flat decode of {S}-byte shards: ok {ok}, "
                             f"adler {ads} != {want}")
    out = res["out"].cpu().numpy()
    for s in range(nsh):
        if out[s, :valid[s]].tobytes() != raw[s * S:(s + 1) * S]:
            raise AssertionError(f"flat decode of {S}-byte shards: shard "
                                 f"{s} bytes differ")
    return res, dt, launches


def phase_times(flat: dict, out_size: int):
    """Milliseconds of the decoder's phases by CUDA events around one flat
    decode: A (plan: the index moved, build_tables, the lanes), B and C;
    then, in the same run and on the same inputs, the two kernels' wrappers
    alone and their plain versions (A_kernel, A_plain, C_kernel, C_plain).
    Returns (times, phase C's result)."""
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    p = DI.plan(**flat)
    ev[1].record()
    b = DI.phase_b(p, out_size, WINDOW)
    ev[2].record()
    r = DI.phase_c(p, b, out_size)
    ev[3].record()
    torch.cuda.synchronize()
    t = dict(zip("ABC", (ev[i].elapsed_time(ev[i + 1]) for i in range(3))))
    a_args, c_args = phase_args(flat, p, b.tok, out_size)
    for key, fn, args in (("A_kernel", BT.build_tables, a_args),
                          ("A_plain", BT.build_tables_ref, a_args),
                          ("C_kernel", CS.resolve_bytes, c_args),
                          ("C_plain", CS.resolve_bytes_ref, c_args)):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn(*args)
        e1.record()
        torch.cuda.synchronize()
        t[key] = e0.elapsed_time(e1)
    return t, r


def show_phases(t: dict) -> str:
    return (f"phases by CUDA events: A {t['A']:.2f} ms (build_tables alone "
            f"{t['A_kernel']:.3f} ms, its plain version {t['A_plain']:.2f} "
            f"ms), B {t['B']:.2f} ms, C {t['C']:.2f} ms (resolve_bytes "
            f"alone {t['C_kernel']:.3f} ms, its plain version "
            f"{t['C_plain']:.2f} ms)")


def phase_args(flat: dict, p, tok, out_size: int):
    """The arguments of build_tables and of resolve_bytes in the decode of
    `flat` whose plan is p and whose tokens are tok."""
    dev = p.w.device
    return ((p.w, p.blk_bit, flat["blk_btype"],
             torch.tensor(flat["n_blocks"], device=dev)),
            (p.w, tok, p.blk_bit, p.blk_out, p.blk_end, p.a.blive,
             p.a.is_sto, out_size))


def build_tables_bytes(a, blk_bit, blk_btype) -> tuple:
    """The bytes build_tables must move for phase A's result `a`: the
    dynamic headers it parses, the index read (bit, btype), and per block
    slot its tables, header end and four flags. Returns (bytes, dynamic
    blocks, their header bytes)."""
    NB = blk_bit.numel()
    dyn = a.blive & (blk_btype == 2)
    hdr = int(((a.hdr_end - blk_bit + 7) >> 3)[dyn].sum())
    return hdr + NB * 16 + NB * (TABLE_BYTES + 8 + 4), int(dyn.sum()), hdr


def copy_sources_bytes(S: int, NB: int, stats: dict) -> tuple:
    """The bytes resolve_bytes must move: the tokens read (4 per position),
    the bytes written, the block table and the stored blocks' bytes; and,
    apart, the pointer rounds' gathers as the plain version ran them (4
    bytes per pointer still open per round), the algorithm's own traffic."""
    return (5 * S + NB * 26 + stats["stored_bytes"],
            4 * sum(stats["tagged"]))


def bound_ms(n_bytes: int) -> float:
    return n_bytes / (HBM_GBS * 1e9) * 1e3


def leaves(x) -> list:
    """The tensors of a kernel's result (a tensor or nested tuples), in
    order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in leaves(y)]


@contextlib.contextmanager
def against_plain(tally: dict, label: str):
    """While open, every call of build_tables and resolve_bytes (the
    decoder's phases A and C, wherever the port makes it) also runs the
    plain version on the same arguments and holds the kernel's result
    against it: tolerance 0, or raise. tally[name] counts the calls held.
    The wrappers go on counting their launches."""
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    saved = []
    for mod, name, kernel in ((BT, "build_tables", "build_tables"),
                              (CS, "resolve_bytes", "copy_sources")):
        fn, ref = getattr(mod, name), getattr(mod, name + "_ref")

        def checked(*a, _fn=fn, _ref=ref, _kernel=kernel, **k):
            got = _fn(*a, **k)
            same(leaves(got), leaves(_ref(*a, **k)), f"{_kernel}, {label}")
            tally[_kernel] = tally.get(_kernel, 0) + 1
            return got
        # the wrapper counts on its module's name, which is `checked` now
        checked.launches = fn.launches
        setattr(mod, name, checked)
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)


def same(got, want, what):
    """The largest absolute difference of a kernel's outputs from its plain
    version's; raises unless it is 0 and the shapes agree."""
    err = 0
    for g, x in zip(got, want):
        if g.shape != x.shape:
            raise AssertionError(f"{what}: shapes differ")
        err = max(err, int((g.long() - x.long()).abs().max())
                  if g.numel() else 0)
    if err:
        raise AssertionError(f"{what}: kernel != plain, max abs err {err}")
    return err


def stream_batch(raw: bytes, cfg, blob: bytes, dev):
    """compress_stream of raw with an index sink on the card, checked equal
    to `blob` (ZlibCodec.compress's); returns the raw DEFLATE body, the
    sink, its stats stacked per shard, the shards' byte counts and the
    decode_blocks_batch arguments on the card."""
    from deflate_compression_tpu_torch.format.deflate import out_words
    from deflate_compression_tpu_torch.models.codec import compress_stream
    sink = []
    pieces = list(compress_stream([raw], cfg, index_sink=sink, device=dev))
    if b"".join(pieces) != blob:
        raise AssertionError("compress_stream != ZlibCodec.compress")
    words = np.zeros((len(sink), out_words(cfg.shard_size)), np.int64)
    for s_, part in enumerate(pieces[1:-1]):
        padded = part + bytes(-len(part) % 4)
        words[s_, :len(padded) // 4] = np.frombuffer(padded, "<u4")
    stacked = {k: np.stack([st[k] for st, _, _ in sink]) for k in IDX_KEYS}
    valid = [vl for _, _, vl in sink]
    batch = [torch.from_numpy(words).to(dev)] + [
        torch.from_numpy(stacked[k]).to(dev) for k in IDX_KEYS]
    return b"".join(pieces[1:-1]), sink, stacked, valid, batch


def decode_phases(raw: bytes, cfg, blob: bytes, dev, lib_names,
                  t_build: float):
    """Phases 6-9: the decoder's kernels and the decode slice. Returns the
    decode kernels' entries of the kernels JSON line and the Adler-32
    kernel's launches in phase 8's flat and indexed decodes."""
    from deflate_compression_tpu_torch import CodecConfig
    from deflate_compression_tpu_torch.core.checksum import adler32_torch
    from deflate_compression_tpu_torch.corpus import repo_text
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.decode.index import (
        DeflateError, build_index, decompress_indexed, index_from_shards,
        native_available)
    from deflate_compression_tpu_torch.models.codec import ZlibCodec
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import lut_gather as LG

    S = cfg.shard_size
    # ----------------------------------------------------------- 6. build
    for mod in (DS, LG, BT, CS):
        mod._bind()
    print(f"phase 6 build: {', '.join(lib_names)} loaded; nvcc ran "
          f"alongside tile_histogram.cu, all done {t_build:.2f} s after the "
          f"start of phase 2")
    torch.cuda.synchronize()

    # ---------------------------------- 7. decode kernels vs plain versions
    body, sink, stacked, valid, batch = stream_batch(raw, cfg, blob, dev)
    nsh = len(sink)

    def shard_args(s_, w=None):
        """decode_blocks arguments of shard s_ alone."""
        return ([batch[0][s_] if w is None else w]
                + [x[s_] for x in batch[1:]]
                + [batch[-1].shape[1], valid[s_]])

    max_err = 0
    for s_ in (0, nsh - 1):
        p = DI.plan(*shard_args(s_))
        args = DI.phase_b_args(p, S, WINDOW)
        max_err = max(max_err, same(DS.decode_symbols(*args),
                                    DS.decode_symbols_ref(*args),
                                    f"decode_symbols shard {s_}"))
    flat = DI.flat_batch(*batch, valid, S)
    pf = DI.plan(**flat)
    bargs = DI.phase_b_args(pf, nsh * S, WINDOW)
    got = DS.decode_symbols(*bargs)
    max_err = max(max_err, same(got, DS.decode_symbols_ref(*bargs),
                                "decode_symbols flat batch"))
    n_lanes = int(pf.ln.llive.sum())
    if not bool(got.done[pf.ln.llive].all()):
        raise AssertionError("decode_symbols: a live lane did not finish")
    quiet = no_sync(lambda: DS.decode_symbols(*bargs))
    same(quiet, got, "decode_symbols under sync debug mode")
    # bytes the call must move: the stream, the lanes' state (bp, ocur,
    # lane_end, lblk, lbad) read and results (done, bad, ocur) written, one
    # table set per block with lanes, and the tokens' array written once
    # (its zero-fill and the tokens: nearly every 32-byte sector of it
    # takes a token)
    NL = pf.ln.lblk.numel()
    visit = (pf.ln.lblk >= 0) & (pf.ln.ocur < pf.ln.lane_end) & ~pf.ln.lbad
    n_visit = int(visit.sum())
    n_tblk = int(torch.unique(pf.ln.lblk[visit]).numel())
    n_tok = int(((got.tok >> 25) & 1).sum())
    ds_bytes = (len(body) + NL * (8 + 8 + 8 + 4 + 1) + NL * (1 + 1 + 8)
                + n_tblk * TABLE_BYTES + 4 * got.tok.numel())
    ds_t = timings("decode_symbols_kernel",
                   lambda: DS.decode_symbols(*bargs),
                   lambda: DS.decode_symbols_ref(*bargs), 20, 10, ds_bytes)
    print(f"phase 7 decode_symbols: tolerance 0 (exact); == plain on shards "
          f"0 and {nsh - 1} and the flat batch of {nsh} shards ({n_lanes} "
          f"live lanes, {n_visit} decoded, {n_tblk} blocks with lanes, "
          f"{n_tok} tokens, {ds_bytes} bytes to move); the wrapper ran "
          f"under sync debug mode \"error\": {show(ds_t)} (device per "
          f"launch: the whole call, the tokens' zero-fill included; the "
          f"kernel alone is the profiler's); no single PyTorch call "
          f"computes this function")

    rng = np.random.default_rng(11)

    def rand_case(n_tbl, n_idx):
        return (torch.from_numpy(rng.integers(-2**31, 2**31, n_tbl)
                                 .astype(np.int32)).to(dev),
                torch.from_numpy(rng.integers(0, n_tbl, n_idx)
                                 .astype(np.int32)).to(dev))
    ftbl = DI.block_flags(pf.a)
    fidx = flat["sub_blk"].clamp(0, pf.a.bbad.shape[0] - 1).to(torch.int32)
    cases = [("probe", *rand_case(2048, 4096)), ("block flags", ftbl, fidx),
             ("past the old cap", *rand_case(65536, 1 << 20)),
             ("bandwidth", *rand_case(2048, 1 << 24))]
    lg_err = 0
    lg_t = {}
    for label, t, i in cases:
        shape = (t.shape[0], i.shape[0])
        want = LG.lut_gather_ref(t, i)
        lg_err = max(lg_err, same([LG.lut_gather(t, i)], [want],
                                  f"lut_gather {label} {shape}"))
        r = lg_t[label] = timings("lut_gather_kernel",
                                  lambda: LG.lut_gather(t, i),
                                  lambda: LG.lut_gather_ref(t, i), 100, 20,
                                  4 * (shape[0] + 2 * shape[1]))
        # the library call: one PyTorch indexing of the same inputs
        r["library_ms"] = device_ms(lambda: t[i.long()], 100)[0]
        gbs = 8 * shape[1] / (r["device_ms"] * 1e-3) / 1e9
        copy_ms = device_ms(lambda: i.clone(), 100)[0]
        print(f"phase 7 lut_gather {label} {shape}: == tbl[idx], error 0; "
              f"{show(r)}; library tbl[idx.long()] {r['library_ms']:.4f} ms "
              f"device; {gbs:.1f} GB/s of index and output, "
              f"{gbs / HBM_GBS:.3f} of {HBM_GBS:.0f} GB/s; a copy of idx "
              f"(the same bytes) {copy_ms:.4f} ms")
    torch.cuda.synchronize()

    # build_tables and copy_sources on the flat batch, as the decode of
    # phase 8 calls them
    a_args, c_args = phase_args(flat, pf, got.tok, nsh * S)
    a_want = BT.build_tables_ref(*a_args)
    bt_err = same(leaves(BT.build_tables(*a_args)), leaves(a_want),
                  "build_tables flat batch")
    same(leaves(no_sync(lambda: BT.build_tables(*a_args))), leaves(a_want),
         "build_tables under sync debug mode")
    NB = pf.blk_bit.numel()
    bt_bytes, n_dyn, hdr_bytes = build_tables_bytes(a_want, pf.blk_bit,
                                                    flat["blk_btype"])
    bt_t = timings("build_tables_kernel", lambda: BT.build_tables(*a_args),
                   lambda: BT.build_tables_ref(*a_args), 20, 3, bt_bytes,
                   reps=5, plain_n=3)
    print(f"phase 7 build_tables: tolerance 0 (exact); == plain in every "
          f"field of {NB} block slots ({int(a_want.blive.sum())} live, "
          f"{n_dyn} dynamic with {hdr_bytes} header bytes, "
          f"{int(a_want.is_sto.sum())} stored, {bt_bytes} bytes to move); "
          f"the wrapper ran under sync debug mode \"error\": {show(bt_t)}; "
          f"no single PyTorch call computes this function")

    cs_stats = {}
    c_want = CS.resolve_bytes_ref(*c_args, stats=cs_stats)
    cs_err = same(leaves(CS.resolve_bytes(*c_args)), leaves(c_want),
                  "copy_sources flat batch")
    same(leaves(no_sync(lambda: CS.resolve_bytes(*c_args))), leaves(c_want),
         "copy_sources under sync debug mode")
    cs_bytes, gather_bytes = copy_sources_bytes(nsh * S, NB, cs_stats)
    cs_t = timings("copy_sources_", lambda: CS.resolve_bytes(*c_args),
                   lambda: CS.resolve_bytes_ref(*c_args), 20, 3, cs_bytes,
                   reps=5, plain_n=3)
    cs_t["bound_with_gathers_ms"] = bound_ms(cs_bytes + gather_bytes)
    k_stats = {}
    CS.resolve_bytes(*c_args, stats=k_stats)
    cs_t["rounds_run"] = k_stats["rounds"]
    cs_t["plain_rounds"] = len(cs_stats["tagged"])
    print(f"phase 7 copy_sources: tolerance 0 (exact); bytes, bad_dist and "
          f"unconverged == plain on {nsh * S} positions ({cs_bytes} bytes to "
          f"move; the kernels ran {k_stats['rounds']} gather rounds after "
          f"the pointers inside each tile resolved there, of a bound of "
          f"{CS.max_rounds(nsh * S)}; the plain version ran "
          f"{len(cs_stats['tagged'])} rounds over "
          f"{cs_stats['tagged']} open pointers, {gather_bytes} bytes of "
          f"gathers, bound with them {cs_t['bound_with_gathers_ms']:.5f} "
          f"ms; {cs_stats['stored_bytes']} stored bytes); the wrapper ran "
          f"under sync debug mode \"error\": {show(cs_t)}; no single PyTorch "
          f"call computes this function; profiler ms per call by kernel: "
          f"{ {k: round(v, 4) for k, v in cs_t['by_kernel'].items()} }")
    torch.cuda.synchronize()

    # ------------------------------------------------- 8. the decode slice
    want_adler = [zlib.adler32(raw[s_ * S:(s_ + 1) * S]) for s_ in range(nsh)]
    res, dt, flat_launches = verified_decode(raw, batch, valid, S)
    ph, rt = phase_times(flat, nsh * S)
    in_shard = torch.arange(S, device=dev) < torch.tensor(
        valid, device=dev).unsqueeze(1)
    if not bool(rt["ok"]) or not torch.equal(
            torch.where(in_shard, rt["out"].view(nsh, S), 0), res["out"]):
        raise AssertionError("phase-by-phase decode differs")

    index = index_from_shards(*zip(*sink))
    zero_counts()
    t0 = time.perf_counter()
    got_raw = decompress_indexed(body, index, expected_adler=zlib.adler32(raw),
                                 device=dev)
    t_idx = time.perf_counter() - t0
    idx_launches = read_counts()
    if got_raw != raw:
        raise AssertionError("decompress_indexed != input")
    n_groups = idx_launches["build_tables"]
    if n_groups < 2 or idx_launches != decode_counts(n_groups):
        raise AssertionError(f"decompress_indexed launched {idx_launches}")

    fraw = raw[:FOREIGN_BYTES]
    z9 = zlib.compress(fraw, 9)
    body9 = z9[2:-4]
    native = native_available()
    t0 = time.perf_counter()
    idx9 = build_index(body9)
    t_bi = time.perf_counter() - t0
    t0 = time.perf_counter()
    got9 = decompress_indexed(body9, idx9, expected_adler=zlib.adler32(fraw),
                              device=dev)
    t_f = time.perf_counter() - t0
    if got9 != fraw:
        raise AssertionError("foreign zlib-9 stream: decompress_indexed != "
                             "input")
    # the same decode once more with phases A and C held against their plain
    # versions in every group (codes up to 15 bits, the prefix carried)
    held = {}
    with against_plain(held, "foreign zlib-9 groups"):
        if decompress_indexed(body9, idx9, device=dev) != fraw:
            raise AssertionError("foreign zlib-9 stream, held against the "
                                 "plain versions: bytes differ")
    held9 = dict(held)
    if min(held9.get(k, 0) for k in ("build_tables", "copy_sources")) < 2:
        raise AssertionError(f"foreign zlib-9 stream: compared {held9}")
    # fixed and stored encodes of 2 MB, decoded in one flat batch
    part = raw[:2 * S]
    for bt in ("fixed", "stored"):
        bcfg = CodecConfig(block_type=bt)
        bblob = ZlibCodec(bcfg, device=dev).compress(part)
        if zlib.decompress(bblob) != part:
            raise AssertionError(f"block_type={bt}: zlib.decompress differs")
        _, _, bst, bvalid, bbatch = stream_batch(part, bcfg, bblob, dev)
        want_bt = {"fixed": 1, "stored": 0}[bt]
        if set(bst["btype"][bst["btype"] >= 0].tolist()) != {want_bt}:
            raise AssertionError(f"block_type={bt}: other block types")
        with against_plain(held, f"block_type={bt}"):
            rb = DI.decode_blocks_batch(*bbatch, bvalid, S)
        if not bool(rb["ok"]) or rb["out"].cpu().numpy().tobytes() != part:
            raise AssertionError(f"block_type={bt}: flat decode differs")
    if min(held[k] - held9[k] for k in held9) != 2:
        raise AssertionError(f"fixed and stored encodes: compared {held}")
    t0 = time.perf_counter()
    zlib.decompress(blob)
    t_z = time.perf_counter() - t0
    print(f"phase 8 decode slice: {len(raw)} bytes, {nsh} shards, "
          f"{n_lanes} lanes in one flat decode_blocks_batch: verified "
          f"decode {len(raw) / dt / 1e6:.3f} MB/s ({dt:.3f} s, adler32 per "
          f"shard OK, bytes OK), launches {flat_launches}; "
          f"{show_phases(ph)}; "
          f"decompress_indexed with the encoder's index "
          f"{len(raw) / t_idx / 1e6:.3f} MB/s ({index.n_subs} entries, "
          f"{n_groups} groups; launches {idx_launches}); "
          f"foreign zlib-9 {len(fraw)} bytes: build_index "
          f"({'native' if native else 'python'}) {t_bi:.3f} s, "
          f"decompress_indexed {len(fraw) / t_f / 1e6:.3f} MB/s, OK; again "
          f"with build_tables and copy_sources == their plain versions in "
          f"every group ({held9} calls held, tolerance 0), and in the flat "
          f"decode of a block_type=\"fixed\" and a block_type=\"stored\" "
          f"encode of {len(part)} bytes; host "
          f"zlib inflate {len(raw) / t_z / 1e6:.1f} MB/s")
    torch.cuda.synchronize()

    # ------------------------------------------- 9. strictness, GPU vs CPU
    text_end = min(len(repo_text()), S) - 4096
    sb0, so0, sk0 = (stacked[k][0] for k in ("sub_bit", "sub_out",
                                             "sub_blk"))
    bt0 = stacked["btype"][0]
    cand = np.flatnonzero((sk0 >= 0) & (so0 < text_end)
                          & np.isin(bt0[np.maximum(sk0, 0)], (1, 2)))
    picks = np.random.default_rng(1234).choice(cand, N_MUTATIONS,
                                               replace=False)
    cpu_args = [a.cpu() for a in batch]
    n_bad = 0
    held_mut = {}
    for lane in picks:
        bit = int(sb0[lane])
        wm = batch[0][0].clone()
        wm[bit >> 5] ^= 1 << (bit & 31)
        with against_plain(held_mut, f"mutation at bit {bit}"):
            g = DI.decode_blocks(*shard_args(0, wm), S)
        c = DI.decode_blocks(wm.cpu(), *[x[0] for x in cpu_args[1:]],
                             cpu_args[-1].shape[1], valid[0], S)
        if bool(g["ok"]) != bool(c["ok"]) or not torch.equal(
                g["bad_lanes"].cpu(), c["bad_lanes"]):
            raise AssertionError(f"mutation at bit {bit}: GPU and CPU "
                                 f"differ in ok or bad lanes")
        if bool(g["ok"]):
            o = g["out"][:valid[0]]
            if (o.cpu().numpy().tobytes() == raw[:S]
                    or int(adler32_torch(o, valid[0])) == want_adler[0]):
                raise AssertionError(f"mutation at bit {bit} not rejected")
        else:
            n_bad += 1
        mb = bytearray(body)
        mb[bit >> 3] ^= 1 << (bit & 7)
        try:
            decompress_indexed(bytes(mb), index,
                               expected_adler=zlib.adler32(raw), device=dev)
        except DeflateError:
            pass
        else:
            raise AssertionError(f"decompress_indexed accepted the "
                                 f"mutation at bit {bit}")

    # flips inside the dynamic headers of shard 0: blocks go bad in phase A
    bb0 = stacked["block_bit_base"][0]
    dyn0 = np.flatnonzero(bt0 == 2)
    hrng = np.random.default_rng(4321)
    n_bbad = 0
    for _ in range(N_HEADER_MUTATIONS):
        bit = int(bb0[hrng.choice(dyn0)]) + 3 + int(hrng.integers(0, 200))
        wm = batch[0][0].clone()
        wm[bit >> 5] ^= 1 << (bit & 31)
        with against_plain(held_mut, f"header mutation at bit {bit}"):
            g = DI.decode_blocks(*shard_args(0, wm), S)
            n_bbad += int(BT.build_tables(
                DI._words(wm), batch[1][0].long(), batch[3][0].long(),
                batch[4][0].long().reshape(1)).bbad.any())
        c = DI.decode_blocks(wm.cpu(), *[x[0] for x in cpu_args[1:]],
                             cpu_args[-1].shape[1], valid[0], S)
        if bool(g["ok"]) != bool(c["ok"]) or not torch.equal(
                g["bad_lanes"].cpu(), c["bad_lanes"]):
            raise AssertionError(f"header mutation at bit {bit}: GPU and "
                                 f"CPU differ in ok or bad lanes")
        if bool(g["ok"]) and int(adler32_torch(
                g["out"][:valid[0]], valid[0])) == want_adler[0]:
            raise AssertionError(f"header mutation at bit {bit} not "
                                 f"rejected")
    if n_bbad == 0:
        raise AssertionError("no header mutation flagged a block bad")

    pat = b"The quick brown fox jumps over the lazy dog 0123456789!"
    wdata = pat * 20 + bytes(np.random.default_rng(3).integers(
        0, 256, 2000, dtype=np.uint8)) + pat * 20
    wbody = zlib.compress(wdata, 9)[2:-4]
    widx = build_index(wbody)
    try:
        decompress_indexed(wbody, widx, max_dist=512, device=dev)
    except DeflateError:
        pass
    else:
        raise AssertionError("window violation decoded at max_dist=512")
    if decompress_indexed(wbody, widx, max_dist=WINDOW, device=dev) != wdata:
        raise AssertionError("window stream at max_dist=32768 differs")

    for s_ in (0, nsh - 1):
        c = DI.decode_blocks(*[x[s_] for x in cpu_args],
                             cpu_args[-1].shape[1], valid[s_], S)
        if not (bool(c["ok"]) and torch.equal(c["out"].cpu(),
                                              res["out"][s_].cpu())
                and torch.equal(c["bad_lanes"],
                                res["bad_lanes"][s_].cpu())):
            raise AssertionError(f"clean shard {s_}: GPU != CPU")
    print(f"phase 9 strictness: {N_MUTATIONS} seeded bit flips at lane "
          f"starts of shard 0: {n_bad} flagged bad, the rest rejected by "
          f"adler32, ok and bad lanes equal on GPU and CPU, "
          f"decompress_indexed raised DeflateError on each; "
          f"{N_HEADER_MUTATIONS} flips inside dynamic headers: {n_bbad} "
          f"flagged a block bad in phase A, all flagged or rejected by "
          f"adler32, GPU == CPU; build_tables and copy_sources == their "
          f"plain versions in every mutated decode ({held_mut} calls held, "
          f"tolerance 0); window "
          f"violation raised at max_dist=512 and decoded at 32768; clean "
          f"shards 0 and {nsh - 1}: GPU == CPU (out, ok, bad lanes)")
    torch.cuda.synchronize()

    adler = {"launches": flat_launches["adler32"],
             "launches_indexed": idx_launches["adler32"]}
    return adler, [{"name": "build_tables", "route": "cuda",
             "source": "deflate_compression_tpu_torch/csrc/build_tables.cu",
             "replaces": "deflate_compression_tpu/decode/tpu_inflate.py:352 "
                         "(left to XLA there: no Pallas kernel)",
             "launches": flat_launches["build_tables"],
             "launches_indexed": idx_launches["build_tables"],
             "max_abs_err": bt_err, **entry(bt_t), "library_ms": None,
             "held_against_plain": {"foreign_and_block_types": held,
                                    "mutations": held_mut}},
            {"name": "copy_sources", "route": "cuda",
             "source": "deflate_compression_tpu_torch/csrc/copy_sources.cu",
             "replaces": "deflate_compression_tpu/decode/tpu_inflate.py:600 "
                         "(left to XLA there: no Pallas kernel)",
             "launches": flat_launches["copy_sources"],
             "launches_indexed": idx_launches["copy_sources"],
             "max_abs_err": cs_err, **entry(cs_t), "library_ms": None,
             "bound_with_gathers_ms": cs_t["bound_with_gathers_ms"],
             "rounds_run": cs_t["rounds_run"],
             "plain_rounds": cs_t["plain_rounds"]},
            {"name": "decode_symbols", "route": "cuda",
             "source": "deflate_compression_tpu_torch/csrc/decode_symbols.cu",
             "replaces": "tools/probe_pallas_r5.py:35",
             "launches": flat_launches["decode_symbols"],
             "max_abs_err": max_err,
             **entry(ds_t), "library_ms": None,
             "kernel_ms": ds_t["prof_ms"]},
            {"name": "lut_gather", "route": "cuda",
             "source": "deflate_compression_tpu_torch/csrc/lut_gather.cu",
             "replaces": "tools/probe_pallas_r5.py:35",
             "launches": flat_launches["lut_gather"], "max_abs_err": lg_err,
             **entry(lg_t["block flags"]),
             "library_ms": lg_t["block flags"]["library_ms"],
             "probe_ms": lg_t["probe"]["ms"]}]


def large_shard_phase(dev, mbs_1mb: float) -> dict:
    """Phase 10: the 32 MB corpus at 4 MB shards through the encoder and
    the decoder on the card. Returns each kernel's launches on this path
    (its counts set to 0 just before it and read just after)."""
    from deflate_compression_tpu_torch import CodecConfig
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.decode.index import (
        decompress_indexed, index_from_shards)
    from deflate_compression_tpu_torch.format.deflate import encode_shard
    from deflate_compression_tpu_torch.models.codec import ZlibCodec
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import histogram as H
    from deflate_compression_tpu_torch.ops import lut_gather as LG

    raw = build_corpus(LARGE_CORPUS_BYTES)
    cfg = CodecConfig(shard_size=LARGE_SHARD)
    S = cfg.shard_size
    nsh = math.ceil(len(raw) / S)

    x0, vl0, fin0 = shard_input(raw, S, 0)
    encode_shard(x0.to(dev), vl0, fin0)          # warm-up at the new shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    blob, stats = ZlibCodec(cfg, device=dev).compress(raw, return_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    enc_launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if zlib.decompress(blob) != raw:
        raise AssertionError("4 MB shards: zlib.decompress(blob) != raw")
    if enc_launches != encode_counts(nsh):
        raise AssertionError(f"4 MB shards: the encode launched "
                             f"{enc_launches}, want {encode_counts(nsh)}")

    t0 = time.perf_counter()
    checked = gpu_equals_cpu(raw, S, dev)
    t_cpu = time.perf_counter() - t0

    body, sink, _, valid, batch = stream_batch(raw, cfg, blob, dev)
    flat = DI.flat_batch(*batch, valid, S)
    pf = DI.plan(**flat)
    bargs = DI.phase_b_args(pf, nsh * S, WINDOW)
    ds_err = same(DS.decode_symbols(*bargs), DS.decode_symbols_ref(*bargs),
                  "decode_symbols, 4 MB-shard flat batch")
    ftbl = DI.block_flags(pf.a)
    fidx = flat["sub_blk"].clamp(0, pf.a.bbad.shape[0] - 1).to(torch.int32)
    lg_err = same([LG.lut_gather(ftbl, fidx)], [LG.lut_gather_ref(ftbl, fidx)],
                  "lut_gather, 4 MB-shard block flags")
    n_lanes = int(pf.ln.llive.sum())
    a_args, c_args = phase_args(flat, pf, DS.decode_symbols(*bargs).tok,
                                nsh * S)
    a_want = BT.build_tables_ref(*a_args)
    bt_err = same(leaves(BT.build_tables(*a_args)), leaves(a_want),
                  "build_tables, 4 MB-shard flat batch")
    cs_stats = {}
    c_want = CS.resolve_bytes_ref(*c_args, stats=cs_stats)
    k_stats = {}
    cs_err = same(leaves(CS.resolve_bytes(*c_args, stats=k_stats)),
                  leaves(c_want), "copy_sources, 4 MB-shard flat batch")
    # device ms per launch of both kernels at this batch, beside the bound
    NB = pf.blk_bit.numel()
    bt_bytes = build_tables_bytes(a_want, pf.blk_bit, flat["blk_btype"])[0]
    cs_bytes, gather_bytes = copy_sources_bytes(nsh * S, NB, cs_stats)
    dev_ms = {"build_tables": device_ms(lambda: BT.build_tables(*a_args),
                                        20)[0],
              "copy_sources": device_ms(lambda: CS.resolve_bytes(*c_args),
                                        20)[0]}
    bounds = {"build_tables": bound_ms(bt_bytes),
              "copy_sources": bound_ms(cs_bytes)}
    del c_want, a_want

    _, ddt, launches = verified_decode(raw, batch, valid, S)
    ph, _ = phase_times(flat, nsh * S)

    index = index_from_shards(*zip(*sink))
    t0 = time.perf_counter()
    got_raw = decompress_indexed(body, index, shard_out=S,
                                 expected_adler=zlib.adler32(raw), device=dev)
    t_idx = time.perf_counter() - t0
    if got_raw != raw:
        raise AssertionError("4 MB shards: decompress_indexed != input")
    print(f"phase 10 large shards: {len(raw)} bytes, {nsh} shards of {S}, "
          f"encode {len(raw) / dt / 1e6:.3f} MB/s ({dt:.3f} s; 1 MB shards "
          f"in phase 4: {mbs_1mb / 1e6:.3f} MB/s), ratio "
          f"{len(blob) / len(raw):.5f}, btype_counts {stats.btype_counts}, "
          f"peak device memory {peak_gib:.2f} GiB, zlib.decompress OK, "
          f"launches {enc_launches} (tile_histogram at ({S // 32768}, "
          f"32768)); "
          f"GPU == "
          f"CPU (words, total_bits, btype, block_bits, sub_*) for shards "
          f"(index, bytes, bits) {checked}, the two CPU and GPU encodes "
          f"{t_cpu:.2f} s; one flat decode_blocks_batch of {n_lanes} live "
          f"lanes: build_tables, lut_gather, decode_symbols and copy_sources "
          f"== plain (max abs err {bt_err}, {lg_err}, {ds_err}, {cs_err}), "
          f"launches {launches}, "
          f"verified decode {len(raw) / ddt / 1e6:.3f} MB/s ({ddt:.3f} s, "
          f"adler32 per shard OK, bytes OK); {show_phases(ph)}; "
          f"device ms per launch on this batch: build_tables "
          f"{dev_ms['build_tables']:.4f} ({NB} block slots, {bt_bytes} "
          f"bytes, bound {bounds['build_tables']:.5f} ms), copy_sources "
          f"{dev_ms['copy_sources']:.4f} ({cs_bytes} bytes, bound "
          f"{bounds['copy_sources']:.5f} ms; the kernels ran "
          f"{k_stats['rounds']} gather rounds, the plain version's "
          f"{len(cs_stats['tagged'])} rounds gathered {gather_bytes} bytes "
          f"over {cs_stats['tagged']} open pointers); "
          f"decompress_indexed with the encoder's index ({index.n_subs} "
          f"entries, groups of {S} bytes) {len(raw) / t_idx / 1e6:.3f} MB/s")
    torch.cuda.synchronize()
    return {**launches,
            **{k: enc_launches[k] for k in ("tile_histogram",
                                            *ENCODE_KERNELS,
                                            *BLOCK_KERNELS, PACK)},
            "peak_gib": peak_gib,
            "phases": ph, "device_ms": dev_ms, "bound_ms": bounds,
            "rounds_run": k_stats["rounds"]}


def png_bytes(px: np.ndarray) -> bytes:
    """An RGBA8 PNG of px (H, W, 4), built with zlib and struct, its rows
    filtered None, Sub, Up, Average and Paeth in turn."""
    import struct

    def chunk(name, payload):
        return (struct.pack(">I", len(payload)) + name + payload
                + struct.pack(">I", zlib.crc32(name + payload)))
    h, w, _ = px.shape
    raw = bytearray()
    prev = np.zeros(4 * w, np.int16)
    for y in range(h):
        x = px[y].reshape(-1).astype(np.int16)
        left = np.concatenate([np.zeros(4, np.int16), x[:-4]])
        ul = np.concatenate([np.zeros(4, np.int16), prev[:-4]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        f = y % 5
        pred = [0 * x, left, prev, (left + prev) // 2, paeth][f]
        raw.append(f)
        raw += ((x - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = x
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + chunk(b"IEND", b""))


def surface_phase(raw: bytes, dev) -> tuple:
    """Phase 11: the codec's surface around the card's encoder: the three
    containers' compress on the card (each kernel's launches checked)
    and decompress on the host, the
    self-check, verify_stream, png_decode and the per-symbol trace. Returns
    the pixels of the PNG it decoded and the trace's launches."""
    import gzip

    from deflate_compression_tpu_torch import (
        CodecConfig, DeflateCodec, GzipCodec, ZlibCodec, per_symbol_trace_csv,
        png_decode, verify_stream)
    from deflate_compression_tpu_torch.decode.index import native_available

    inflater = "native" if native_available() else "python"
    rows = []
    for cls, container, oracle in (
            (DeflateCodec, "raw", lambda b: zlib.decompress(b, wbits=-15)),
            (ZlibCodec, "zlib", zlib.decompress),
            (GzipCodec, "gzip", gzip.decompress)):
        cfg = CodecConfig(container=container)
        codec = cls(cfg, device=dev)
        zero_counts()
        t0 = time.perf_counter()
        blob = codec.compress(raw)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        launches = read_counts()
        if launches != encode_counts(math.ceil(len(raw) / cfg.shard_size)):
            raise AssertionError(f"{container}: the encode launched "
                                 f"{launches}")
        if oracle(blob) != raw:
            raise AssertionError(f"{container}: the oracle's bytes differ")
        t0 = time.perf_counter()
        back = codec.decompress(blob)
        t_dec = time.perf_counter() - t0
        if back != raw:
            raise AssertionError(f"{container}: decompress != input")
        rows.append(f"{container} {len(blob)} bytes, encode "
                    f"{len(raw) / t_enc / 1e6:.3f} MB/s, host decompress "
                    f"{len(raw) / t_dec / 1e6:.1f} MB/s")

    part = raw[:SELF_CHECK_BYTES]
    t0 = time.perf_counter()
    checked = ZlibCodec(CodecConfig(self_check=True), device=dev).compress(
        part)
    t_sc = time.perf_counter() - t0
    if (checked != ZlibCodec(CodecConfig(), device=dev).compress(part)
            or zlib.decompress(checked) != part):
        raise AssertionError("self_check changed the stream or it is wrong")
    gz = GzipCodec(CodecConfig(container="gzip"), device=dev).compress(part)
    n_checks = 0
    t0 = time.perf_counter()
    for name, b in (("zlib", checked), ("gzip", gz)):
        reports, checks = verify_stream(b, part)
        bad = [c for c in checks if not c[1]]
        if bad or not reports:
            raise AssertionError(f"verify_stream {name}: {bad}")
        n_checks += len(checks)
    t_vs = time.perf_counter() - t0

    px = np.random.default_rng(17).integers(0, 256, (120, 160, 4),
                                            dtype=np.uint8)
    img = png_decode(png_bytes(px))
    if not (img.pixels.shape == px.shape and (img.pixels == px).all()):
        raise AssertionError("png_decode != the pixels")

    tr = raw[:TRACE_BYTES]
    kw = {"stride": 64, "header_stride": 16}
    zero_counts()
    t0 = time.perf_counter()
    on_card = per_symbol_trace_csv(tr, device=dev, **kw)
    t_tr = time.perf_counter() - t0
    tr_launches = read_counts()
    if on_card != per_symbol_trace_csv(tr, device="cpu", **kw):
        raise AssertionError("per_symbol_trace_csv: card != CPU")
    if tr_launches != {**decode_counts(0), **{k: 1 for k in ENCODE_KERNELS}}:
        raise AssertionError(f"per_symbol_trace_csv launched {tr_launches}")
    print(f"phase 11 codec surface: {len(raw)} bytes in 1 MB shards, "
          f"compress on the card, decompress on the host ({inflater} "
          f"inflater): {'; '.join(rows)}; all equal the input and zlib / "
          f"gzip.decompress; self_check on {len(part)} bytes {t_sc:.2f} s, "
          f"the stream unchanged; verify_stream of its zlib and gzip blobs: "
          f"{n_checks} checks true ({t_vs:.2f} s); png_decode of a "
          f"{px.shape[1]}x{px.shape[0]} RGBA8 PNG, five filters: pixels "
          f"equal; per_symbol_trace_csv of {len(tr)} bytes on the card "
          f"({t_tr:.2f} s, {len(on_card.splitlines()) - 1} records, "
          f"launches {tr_launches}) == CPU")
    torch.cuda.synchronize()
    return px, tr_launches


# ------------------------------------------------------- 12. distributed

def counters() -> dict:
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from deflate_compression_tpu_torch.ops import adler32 as AD
    from deflate_compression_tpu_torch.ops import block_layout as BL
    from deflate_compression_tpu_torch.ops import block_plan as BP
    from deflate_compression_tpu_torch.ops import build_tables as BT
    from deflate_compression_tpu_torch.ops import copy_sources as CS
    from deflate_compression_tpu_torch.ops import crc32 as CR
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import find_matches as FM
    from deflate_compression_tpu_torch.ops import histogram as H
    from deflate_compression_tpu_torch.ops import huffman_codes as HC
    from deflate_compression_tpu_torch.ops import lut_gather as LG
    from deflate_compression_tpu_torch.ops import lz_parse as LP
    from deflate_compression_tpu_torch.ops import pack_words as PW
    return {"tile_histogram": H.tile_histogram,
            "find_matches": FM.find_matches, "lz_parse": LP.lz_parse,
            "block_plan": BP.block_plan, "huffman_codes": HC.huffman_codes,
            "block_layout": BL.block_layout, PACK: PW.pack_words,
            "decode_symbols": DS.decode_symbols, "lut_gather": LG.lut_gather,
            "build_tables": BT.build_tables, "copy_sources": CS.resolve_bytes,
            "adler32": AD.adler32, "crc32": CR.crc32}


def encode_counts(nsh: int, adler32: int = 0) -> dict:
    """Each kernel's launches in an encode of nsh shards of more than one
    tile, the blocks chosen by cost (pack_words carries the layout), and
    `adler32` Adler-32 launches (the codecs' checksum is the host's;
    compress_distributed's one a shard on the card); no CRC-32 (the gzip
    codec's is the host's)."""
    return {"tile_histogram": 2 * nsh, **{k: nsh for k in ENCODE_KERNELS},
            "block_plan": nsh, "huffman_codes": 2 * nsh, "block_layout": 0,
            PACK: nsh, **{k: 0 for k in DECODE_KERNELS}, "adler32": adler32,
            "crc32": 0}


def decode_counts(n: int, adler32: int | None = None,
                  crc32: int = 0) -> dict:
    """Each kernel's launches in n decodes (flat batches or groups), with
    `adler32` Adler-32 launches (one a decode unless given: a group of
    decompress_indexed; a flat batch checks each shard) and `crc32`
    CRC-32 launches (one a group of a gzip member's decode)."""
    return {"tile_histogram": 0, **{k: 0 for k in ENCODE_KERNELS},
            **{k: 0 for k in BLOCK_KERNELS}, PACK: 0,
            **{k: n for k in DECODE_KERNELS},
            "adler32": n if adler32 is None else adler32, "crc32": crc32}


def zero_counts() -> None:
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {k: f.launches for k, f in counters().items()}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_GLOO_RANK = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[5])
from deflate_compression_tpu_torch.parallel.dist import (
    compress_distributed, make_mesh)
from deflate_compression_tpu_torch.parallel.launcher import init_distributed
from deflate_compression_tpu_torch.ops import adler32 as AD
from deflate_compression_tpu_torch.ops import block_layout as BL
from deflate_compression_tpu_torch.ops import block_plan as BP
from deflate_compression_tpu_torch.ops import histogram as H
from deflate_compression_tpu_torch.ops import huffman_codes as HC
from deflate_compression_tpu_torch.ops import pack_words as PW
rank, world, init, out, dev, S = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4], sys.argv[6], int(sys.argv[7])
raw = open(out + ".in", "rb").read()
info = init_distributed(init, world, rank, device=dev, backend="gloo",
                        timeout_s=300)
mesh = make_mesh(info["group"], dev)
compress_distributed(raw[:S], mesh, shard_size=S)    # warm-up
torch.cuda.synchronize()
FNS = {"tile_histogram": H.tile_histogram, "block_plan": BP.block_plan,
       "huffman_codes": HC.huffman_codes, "block_layout": BL.block_layout,
       "pack_words": PW.pack_words, "adler32": AD.adler32}
for f in FNS.values():
    f.launches = 0
t0 = time.perf_counter()
blob, idx = compress_distributed(raw, mesh, shard_size=S, return_index=True)
torch.cuda.synchronize()
dt = time.perf_counter() - t0
launches = {k: f.launches for k, f in FNS.items()}
open(f"{out}.{rank}.zz", "wb").write(blob)
open(f"{out}.{rank}.dcx", "wb").write(idx.to_bytes())
torch.distributed.destroy_process_group()
print("RANK " + json.dumps({"rank": rank, **launches, "seconds": dt}),
      flush=True)
"""


def run_procs(cmds: dict, timeout: float) -> dict:
    """Start every command at once and wait for all, each within `timeout`
    seconds (killing any left); return name -> (stdout, stderr, seconds
    from the start to its exit). Raises if one exits non-zero."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}

    def wait(p):
        so, se = p.communicate(timeout=timeout)
        return so, se, time.perf_counter() - t0
    try:
        with ThreadPoolExecutor(len(procs)) as ex:
            futs = {k: ex.submit(wait, p) for k, p in procs.items()}
            res = {k: f.result() for k, f in futs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"{k} exited {p.returncode}: "
                                 f"{res[k][1][-3000:]}")
    return res


def index_batch(body: bytes, idx, S: int, n: int, dev) -> tuple:
    """decode_blocks_batch arguments of a stream of n bytes in S-byte shards
    from its stream-level DecodeIndex: each shard's blocks and sub-entries
    rebased to the shard's first byte (each shard starts byte-aligned with
    a block), dead slots btype -1 and dead lanes sub_blk -1."""
    nsh = math.ceil(n / S)
    first = [int(np.searchsorted(idx.out_start, s * S)) for s in range(nsh)]
    first.append(idx.n_blocks)
    byte0 = [int(idx.bit_base[b]) // 8 for b in first[:-1]] + [len(body)]
    sk_all = idx.sub_blk.astype(np.int64)
    sfirst = [int(np.searchsorted(sk_all, b)) for b in first]
    nb = max(first[s + 1] - first[s] for s in range(nsh))
    nl = max(sfirst[s + 1] - sfirst[s] for s in range(nsh))
    cw = max((byte0[s + 1] - byte0[s] + 3) // 4 for s in range(nsh)) + 1
    words = np.zeros((nsh, cw), np.int64)
    blk = np.zeros((3, nsh, nb), np.int64)
    blk[2] = -1
    sub = np.zeros((3, nsh, nl), np.int64)
    sub[0], sub[2] = -1, -1
    nblk = np.zeros(nsh, np.int64)
    for s in range(nsh):
        part = body[byte0[s]:byte0[s + 1]]
        part += bytes(-len(part) % 4)
        words[s, :len(part) // 4] = np.frombuffer(part, "<u4")
        b0, b1 = first[s], first[s + 1]
        nblk[s] = b1 - b0
        blk[0, s, :b1 - b0] = idx.bit_base[b0:b1] - 8 * byte0[s]
        blk[1, s, :b1 - b0] = idx.out_start[b0:b1] - s * S
        blk[2, s, :b1 - b0] = idx.btype[b0:b1]
        l0, l1 = sfirst[s], sfirst[s + 1]
        sub[0, s, :l1 - l0] = idx.sub_bit[l0:l1] - 8 * byte0[s]
        sub[1, s, :l1 - l0] = idx.sub_out[l0:l1] - s * S
        sub[2, s, :l1 - l0] = sk_all[l0:l1] - b0
    t = [torch.from_numpy(x).to(dev) for x in (words, blk[0], blk[1], blk[2],
                                               nblk, sub[0], sub[1], sub[2])]
    return t, [min(S, n - s * S) for s in range(nsh)]


def dist_phase(raw: bytes, cfg, blob: bytes, dev, mbs_1mb: float) -> dict:
    """Phase 12: compress_distributed of phase 4's corpus in a 1-rank NCCL
    group (its launches counted), in 2 gloo ranks on one card (each rank's
    count), the index of the gloo run decoded in one flat
    decode_blocks_batch, and compress_file_resumable crashed after shard 3
    and resumed. Returns the launches of each path."""
    import tempfile

    import torch.distributed as tdist
    from deflate_compression_tpu_torch import compress_file_resumable
    from deflate_compression_tpu_torch.parallel.dist import (
        compress_distributed, make_mesh)
    from deflate_compression_tpu_torch.parallel.launcher import \
        init_distributed

    S = cfg.shard_size
    nsh = math.ceil(len(raw) / S)
    info = init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                            device=dev)
    try:
        mesh = make_mesh(info["group"], dev)
        compress_distributed(raw[:S], mesh, shard_size=S)     # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out, idx = compress_distributed(raw, mesh, shard_size=S,
                                        return_index=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts()
        backend = tdist.get_backend(info["group"])
    finally:
        tdist.destroy_process_group()
    if out != blob:
        raise AssertionError("1-rank NCCL compress_distributed != phase 4")
    if launches != encode_counts(nsh, adler32=nsh):
        raise AssertionError(f"1-rank NCCL run launched {launches}")

    with tempfile.TemporaryDirectory() as d:
        base = str(Path(d) / "g")
        Path(base + ".in").write_bytes(raw)
        init = f"tcp://127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        rank_dev = "cuda:0" if dev.type == "cuda" else "cpu"
        res = run_procs({r: [sys.executable, "-c", _GLOO_RANK, str(r), "2",
                             init, base, str(ROOT), rank_dev, str(S)]
                         for r in range(2)}, 600)
        t_procs = time.perf_counter() - t0
        ranks = [json.loads(res[r][0].split("RANK ", 1)[1]) for r in range(2)]
        outs = [Path(f"{base}.{r}.zz").read_bytes() for r in range(2)]
        dcx = [Path(f"{base}.{r}.dcx").read_bytes() for r in range(2)]

        src, dst = Path(d) / "in.bin", Path(d) / "out.zz"
        src.write_bytes(raw)

        class Crash(Exception):
            pass

        def crash_after_3(s_, n_):
            if s_ == 3:
                raise Crash()
        zero_counts()
        try:
            compress_file_resumable(str(src), str(dst), cfg,
                                    progress_cb=crash_after_3, device=dev)
        except Crash:
            pass
        else:
            raise AssertionError("the injected crash did not happen")
        first = read_counts()
        zero_counts()
        info_r = compress_file_resumable(str(src), str(dst), cfg, device=dev)
        second = read_counts()
        resumed = dst.read_bytes()
    if any(o != blob for o in outs) or dcx[0] != dcx[1] or \
            dcx[0] != idx.to_bytes():
        raise AssertionError("2 gloo ranks: bytes or index differ from the "
                             "1-rank NCCL run")
    per_rank = [len(range(r, nsh, 2)) for r in range(2)]
    if [[x[k] for k in ("tile_histogram", *BLOCK_KERNELS, PACK, "adler32")]
            for x in ranks] != [[2 * n, n, 2 * n, 0, n, n]
                                for n in per_rank]:
        raise AssertionError(f"2 gloo ranks launched {ranks}")
    if info_r["resumed_at_shard"] != 4 or resumed != blob or \
            zlib.decompress(resumed) != raw or (first, second) != (
                encode_counts(4), encode_counts(nsh - 4)):
        raise AssertionError(f"resumable encode: {info_r}, launches "
                             f"{first} + {second}")

    from deflate_compression_tpu_torch.core.checksum import adler32_torch
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.decode.index import DecodeIndex
    gidx = DecodeIndex.from_bytes(dcx[0])
    batch, valid = index_batch(outs[0][2:-4], gidx, S, len(raw), dev)
    r = DI.decode_blocks_batch(*batch, valid, S)
    dec = r["out"].cpu().numpy()
    ads = [int(adler32_torch(r["out"][s_], valid[s_])) for s_ in range(nsh)]
    if not bool(r["ok"]) or ads != [zlib.adler32(raw[s_ * S:(s_ + 1) * S])
                                    for s_ in range(nsh)] or b"".join(
            dec[s_, :valid[s_]].tobytes() for s_ in range(nsh)) != raw:
        raise AssertionError("flat decode of the gloo run's index failed")
    g_sec = max(x["seconds"] for x in ranks)
    print(f"phase 12 distributed: {len(raw)} bytes, {nsh} shards; "
          f"compress_distributed in a 1-rank {backend} group on {dev}: "
          f"{len(raw) / dt / 1e6:.3f} MB/s ({dt:.3f} s; phase 4's ZlibCodec "
          f"{mbs_1mb / 1e6:.3f} MB/s), bytes == phase 4, launches "
          f"{launches}; 2 gloo ranks (subprocesses, {t_procs:.1f} s with "
          f"start-up) both on {rank_dev}, since NCCL refuses two ranks on one "
          f"GPU: tile_histogram launches per rank "
          f"{[x['tile_histogram'] for x in ranks]}, "
          f"{len(raw) / g_sec / 1e6:.3f} MB/s ({g_sec:.3f} s, the slower "
          f"rank; two ranks share one card, so this is no scaling figure), "
          f"bytes == phase 4 on both ranks, .dcx index ({gidx.n_blocks} "
          f"blocks, {gidx.n_subs} entries) == the NCCL run's; its index in "
          f"one flat decode_blocks_batch: ok, adler32 per shard and bytes "
          f"OK; compress_file_resumable crashed after shard 3 "
          f"({first['tile_histogram']} tile_histogram launches, each "
          f"encode kernel as many as its shards ask) and resumed at shard "
          f"{info_r['resumed_at_shard']} ({second['tile_histogram']}): "
          f"bytes == "
          f"phase 4, zlib.decompress OK")
    torch.cuda.synchronize()
    return {"launches": launches,
            "gloo_ranks": [x["tile_histogram"] for x in ranks],
            "resumable": [first["tile_histogram"],
                          second["tile_histogram"]]}


# --------------------------------------------------------- 13. the CLI

# `python3 -m deflate_compression_tpu_torch` (runpy with alter_sys, as -m
# runs it) that prints each kernel's launches in the process at exit
_COUNTING_MAIN = r"""
import atexit, json, runpy, sys
from deflate_compression_tpu_torch.ops import adler32 as AD
from deflate_compression_tpu_torch.ops import block_layout as BL
from deflate_compression_tpu_torch.ops import block_plan as BP
from deflate_compression_tpu_torch.ops import build_tables as BT
from deflate_compression_tpu_torch.ops import copy_sources as CS
from deflate_compression_tpu_torch.ops import crc32 as CR
from deflate_compression_tpu_torch.ops import decode_symbols as DS
from deflate_compression_tpu_torch.ops import find_matches as FM
from deflate_compression_tpu_torch.ops import histogram as H
from deflate_compression_tpu_torch.ops import huffman_codes as HC
from deflate_compression_tpu_torch.ops import lut_gather as LG
from deflate_compression_tpu_torch.ops import lz_parse as LP
from deflate_compression_tpu_torch.ops import pack_words as PW


def _counts():
    print("LAUNCHES " + json.dumps({
        "tile_histogram": H.tile_histogram.launches,
        "block_plan": BP.block_plan.launches,
        "huffman_codes": HC.huffman_codes.launches,
        "block_layout": BL.block_layout.launches,
        "pack_words": PW.pack_words.launches,
        "find_matches": FM.find_matches.launches,
        "lz_parse": LP.lz_parse.launches,
        "decode_symbols": DS.decode_symbols.launches,
        "lut_gather": LG.lut_gather.launches,
        "build_tables": BT.build_tables.launches,
        "copy_sources": CS.resolve_bytes.launches,
        "adler32": AD.adler32.launches,
        "crc32": CR.crc32.launches}), file=sys.stderr,
        flush=True)


atexit.register(_counts)
sys.argv[0] = "deflate_compression_tpu_torch"
runpy.run_module("deflate_compression_tpu_torch", run_name="__main__",
                 alter_sys=True)
"""


def cli_phase(raw: bytes, blob: bytes, stats, px: np.ndarray, dev) -> dict:
    """Phase 13: every subcommand in a subprocess on phase 4's corpus.
    compress, trace and decompress --index run on the card through the
    module's entry point with a launch count; decompress, inspect, verify
    and png, which touch no card, as `python3 -m
    deflate_compression_tpu_torch`. Returns the launches of each
    kernel in each counted subcommand's process."""
    import tempfile

    from deflate_compression_tpu_torch.decode.index import build_index
    from deflate_compression_tpu_torch.format.containers import \
        gzip_parse_header

    with tempfile.TemporaryDirectory() as d:
        def f(name):
            return str(Path(d) / name)
        Path(f("in.bin")).write_bytes(raw)
        Path(f("p4.zz")).write_bytes(blob)
        Path(f("in.png")).write_bytes(png_bytes(px))
        counted = [sys.executable, "-c", _COUNTING_MAIN]
        module = [sys.executable, "-m", "deflate_compression_tpu_torch"]
        t0 = time.perf_counter()
        res = run_procs({
            "compress": counted + ["compress", f("in.bin"), "-o",
                                   f("cli.zz"), "--index", f("cli.dcx"),
                                   "--stats", f("cli.csv"), "--device",
                                   dev.type],
            "trace": counted + ["trace", f("in.bin"), "-o", f("trace.csv"),
                                "--device", dev.type],
            "decompress": module + ["decompress", f("p4.zz"), "-o",
                                    f("p4.out")],
            "inspect": module + ["inspect", f("p4.zz")],
            "verify": module + ["verify", f("p4.zz"), "--original",
                                f("in.bin"), "-v"],
            "png": module + ["png", f("in.png"), "--raw", "-o",
                             f("png.raw")]}, 600)
        member = gzip_member(raw)
        Path(f("in.gz")).write_bytes(member)
        Path(f("gz.dcx")).write_bytes(build_index(
            member[gzip_parse_header(member):]).to_bytes())
        res.update(run_procs({"decompress --index": counted + [
            "decompress", f("cli.zz"), "--index", f("cli.dcx"), "-o",
            f("idx.out"), "--device", dev.type],
            "decompress --index (gzip)": counted + [
            "decompress", f("in.gz"), "--index", f("gz.dcx"), "-o",
            f("gz.out"), "--device", dev.type]}, 600))
        t_all = time.perf_counter() - t0
        got = {k: Path(f(k)).read_bytes() for k in (
            "cli.zz", "cli.dcx", "cli.csv", "trace.csv", "p4.out",
            "png.raw", "idx.out", "gz.out")}
    counts = {k: json.loads(res[k][1].rsplit("LAUNCHES ", 1)[1])
              for k in ("compress", "trace", "decompress --index",
                        "decompress --index (gzip)")}
    gz = counts["decompress --index (gzip)"]
    csv = stats.to_csv().encode()
    checks = [
        ("compress: phase 4's stream", got["cli.zz"] == blob),
        ("compress: zlib.decompress", zlib.decompress(got["cli.zz"]) == raw),
        ("compress --stats: phase 4's CSV", got["cli.csv"] == csv),
        ("compress --index: build_index of the stream",
         got["cli.dcx"] == build_index(blob[2:]).to_bytes()),
        ("trace: phase 4's CSV", got["trace.csv"] == csv),
        ("decompress", got["p4.out"] == raw),
        ("decompress --index", got["idx.out"] == raw),
        ("inspect", res["inspect"][0].splitlines()[-1].startswith("total: ")
         and f" {len(raw)} bytes out," in res["inspect"][0]),
        ("verify", "OK: " in res["verify"][1]
         and "PASS original" in res["verify"][1]),
        ("png --raw: phase 11's pixels",
         got["png.raw"] == px[..., :3].tobytes()),
        ("compress launches", counts["compress"] == encode_counts(
            math.ceil(len(raw) / (1 << 20)))),
        ("trace launches", counts["trace"] == counts["compress"]),
        ("decompress --index launches",
         min(counts["decompress --index"][k] for k in DECODE_KERNELS) >= 1
         and counts["decompress --index"]["adler32"]
         == counts["decompress --index"]["build_tables"]
         and counts["decompress --index"]["crc32"] == 0),
        ("decompress --index (gzip): a gzip -9 member", got["gz.out"] == raw),
        ("decompress --index (gzip) launches",
         gz == decode_counts(gz["build_tables"], adler32=0,
                             crc32=gz["build_tables"])
         and gz["build_tables"] >= 2)]
    bad = [name for name, ok in checks if not ok]
    if bad:
        raise AssertionError(f"CLI checks failed: {bad}; launches {counts}")
    print(f"phase 13 CLI: {len(res)} subprocesses ({t_all:.1f} s, six at "
          f"once, then the two decompress --index), seconds from their "
          f"start to "
          f"exit: {', '.join(f'{k} {v[2]:.1f}' for k, v in res.items())}; "
          f"{len(checks)} checks true "
          f"({', '.join(n for n, _ in checks)}); "
          f"launches per process {counts}; inspect: "
          f"{res['inspect'][0].splitlines()[-1]}")
    torch.cuda.synchronize()
    return counts


# ------------------------------------------------ 14. the LZ77 kernels

def lz77_phase(raw: bytes, cfg, dev) -> dict:
    """Phase 14: find_matches and lz_parse against their plain versions,
    exactly, on phase 4's first and last shards, one 4 MB shard, the
    trace's input and the edge cases of `corpus.lz_case`, both as int64
    calls and through the packed hand-off; tokenize under sync debug mode
    "error"; both kernels' times at phase 4's first shard and at the 4 MB
    shard; tokenize's peak device memory at 4 MB. Returns each kernel's
    largest error, its `timings` by (kernel, "1mb" or "4mb") and the
    peak."""
    from deflate_compression_tpu_torch import corpus
    from deflate_compression_tpu_torch.core.lz77 import tokenize
    from deflate_compression_tpu_torch.ops import find_matches as FM
    from deflate_compression_tpu_torch.ops import lz_parse as LP

    S = cfg.shard_size
    cases = {}                  # label -> (data, valid_len, lazy, K)
    for s_ in (0, math.ceil(len(raw) / S) - 1):
        x, vl, _ = shard_input(raw, S, s_)
        cases[f"1 MB shard {s_}"] = (x.to(dev), vl, cfg.lazy,
                                     cfg.num_candidates)
    big = np.frombuffer(corpus.build_corpus(LARGE_SHARD), np.uint8)
    cases["4 MB shard 0"] = (torch.from_numpy(big.copy()).to(dev),
                             LARGE_SHARD, cfg.lazy, cfg.num_candidates)
    tr = np.frombuffer(raw[:TRACE_BYTES], np.uint8)
    cases["the trace's input"] = (torch.from_numpy(tr.copy()).to(dev),
                                  TRACE_BYTES, True, 32)
    for name in corpus.LZ_CASES:
        data, vl, lazy, K = corpus.lz_case(name)
        cases[name] = (torch.from_numpy(data).to(dev), vl, lazy, K)

    err = {"find_matches": 0, "lz_parse": 0}
    work = {}
    for label, (x, vl, lazy, K) in cases.items():
        work[label] = {}
        m = FM.find_matches(x, K)
        err["find_matches"] = max(err["find_matches"], same(
            m, FM.find_matches_ref(x, K, stats=work[label]),
            f"find_matches, {label}"))
        want = LP.lz_parse_ref(x, *m, vl, lazy)
        pm = FM.find_matches_packed(x, K)
        err["find_matches"] = max(err["find_matches"], same(
            [pm], [FM.pack(*m)], f"find_matches_packed, {label}"))
        for how, got in (("", LP.lz_parse(x, *m, vl, lazy)),
                         ("_packed", LP.lz_parse_packed(x, pm, vl, lazy))):
            err["lz_parse"] = max(err["lz_parse"], same(
                [got[k] for k in want], list(want.values()),
                f"lz_parse{how}, {label}"))
    x, vl, lazy, K = cases["1 MB shard 0"]
    want = LP.lz_parse_ref(x, *FM.find_matches_ref(x, K), vl, lazy)
    quiet = no_sync(lambda: tokenize(x, vl, K, lazy))
    same([quiet[k] for k in want], list(want.values()),
         "tokenize under sync debug mode")

    times, shown = {}, []
    for size, label in (("1mb", "1 MB shard 0"), ("4mb", "4 MB shard 0")):
        x, vl, lazy, K = cases[label]
        n = x.numel()
        m = FM.find_matches(x, K)
        pm = FM.find_matches_packed(x, K)
        w = work[label]
        # operations: the hash, link and outputs (8 per position); per
        # candidate, the load of its link and at least one compare (the
        # one-byte check turns most away); the rescore's 4-byte compares
        ops = 8 * n + 2 * w["visits"] + w["rescore_words"]
        # as tokenize calls them, through the packed hand-off: find_matches
        # reads the shard and writes 4 bytes a position; lz_parse reads the
        # shard and those 4 bytes, and writes chosen, length and dist
        fm = times["find_matches", size] = timings(
            "find_matches_", lambda: FM.find_matches_packed(x, K),
            lambda: FM.pack(*FM.find_matches_ref(x, K)), 20, 3, 5 * n,
            reps=5, plain_n=3, bound_ops=ops)
        lp = times["lz_parse", size] = timings(
            "lz_parse_", lambda: LP.lz_parse_packed(x, pm, vl, lazy),
            lambda: LP.lz_parse_ref(x, *m, vl, lazy), 20, 3, 22 * n,
            reps=5, plain_n=3, bound_ops=LZ_PARSE_OPS * n)
        parts = {}
        for name, fn in (("find_matches", lambda: FM.find_matches_packed(
                x, K)), ("lz_parse", lambda: LP.lz_parse_packed(
                    x, pm, vl, lazy)), ("tokenize", lambda: tokenize(
                        x, vl, K, lazy))):
            parts[name] = {}
            for k, v in profiled_ms(fn, 3).items():
                k = re.search(r"\w*(_kernel|Kernel)|$", k).group() or k[:30]
                parts[name][k] = round(parts[name].get(k, 0.0) + v, 4)
        shown.append(
            f"{label} ({n} bytes, {w['visits']} candidates scored, "
            f"{w['rescore_words']} rescore words, {ops} operations): "
            f"find_matches (packed) {show(fm)}; lz_parse (packed) "
            f"{show(lp)}; by kernel under the profiler, ms "
            f"(find_matches: hash, CUB's sort of the 16-bit keys, links, "
            f"walk; lz_parse: staging and runs to lazy in the match "
            f"kernel, staging and parse in the parse kernel) {parts}")
    x, vl, lazy, K = cases["4 MB shard 0"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tokenize(x, vl, K, lazy)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    shown.append(f"tokenize's peak device memory at 4 MB, above its input: "
                 f"{peak:.1f} MiB")
    print(f"phase 14 LZ77 kernels: tolerance 0 (exact); find_matches (max "
          f"abs err {err['find_matches']}) and lz_parse (max abs err "
          f"{err['lz_parse']}) == their plain versions on {len(cases)} "
          f"inputs ({', '.join(cases)}); tokenize ran under sync debug mode "
          f"\"error\"; {'; '.join(shown)}; no single PyTorch call computes "
          f"either function")
    torch.cuda.synchronize()
    return {"max_abs_err": err, "times": times, "tokenize_peak_mib": peak}



# ----------------------------------------- 15. the encoder's block stage

def block_plan_ops(a) -> int:
    """block_plan's float32 operations on its arguments (ll, d, n_valid,
    tile_bytes, max_merge): a log2, a subtraction, a product and a sum for
    each used symbol of each segment, and the DP's add and compare for
    each candidate."""
    ll, d, _, _, mm = a
    M = ll.shape[0]
    cnt = torch.cat([ll, d], 1).long()
    cum = torch.cat([torch.zeros_like(cnt[:1]), cnt.cumsum(0)])
    j = torch.arange(1, M + 1, device=cnt.device).unsqueeze(1)
    i = (j - torch.arange(1, mm + 1, device=cnt.device)).clamp(min=0)
    used = int(((cum[j] - cum[i]) > 0).sum())
    return 4 * used + 2 * M * mm


def huffman_codes_ops(freqs, max_bits: int) -> int:
    """The least integer operations of huffman_codes on these rows: for k
    used symbols in a row, a comparison sort (k ceil(log2 k)), two per
    item of each of the max_bits - 1 package-merge levels (2k), and k +
    max_bits for the canonical codes."""
    k = (freqs > 0).sum(1).double()
    lg = torch.log2(k.clamp(min=1)).ceil()
    return int((k * lg + 2 * k * (max_bits - 1) + k + max_bits).sum())


# cycles a shared-memory round trip (load, an ALU operation, store) takes
# on the chain of huffman_codes: one per package-merge level and per sort
# round (about 23 each for the load and the store on Hopper)
SMEM_ROUND_CYCLES = 50
# block_plan's DP step: one float32 add and log2(8) = 3 minima, 4 cycles each
DP_STEP_CYCLES = 16
# a level of the layout scan: three shuffles in flight (about 25 cycles)
# and the composition's selects and adds (about 8)
LAYOUT_LEVEL_CYCLES = 33


def sm_clock_ghz() -> float:
    """The card's SM clock now, in GHz, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) / 1e3


def launch_floor_ms() -> float:
    """Device ms per launch of an empty kernel (torch.cuda._sleep(0)),
    queued 20 deep: the least any launch costs on this card."""
    return device_ms(lambda: torch.cuda._sleep(0), 20)[0]


def block_stage_phase(raw: bytes, cfg, dev) -> dict:
    """Phase 15: block_plan, huffman_codes and block_layout against their
    plain versions, on the inputs every encode_shard of phase 4's and
    phase 10's corpora and of a fixed and a stored 2 MB encode handed
    them (block_layout on the layout that encode's pack_words carried in
    its look-back: `corpus.layout_inputs`), and on corpus's block-stage
    cases; their times at phase 4's first shard ("1mb") and phase 10's
    ("4mb"). Returns each kernel's largest error, timings, serial depth
    and extra keys, the pack_words calls for phase 16 and the device
    memory each first shard's encode_shard allocated at its peak."""
    from deflate_compression_tpu_torch import corpus
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.format import constants as C
    from deflate_compression_tpu_torch.format.deflate import (MAX_MERGE,
                                                              encode_shard)
    from deflate_compression_tpu_torch.ops import block_layout as BL
    from deflate_compression_tpu_torch.ops import block_plan as BP
    from deflate_compression_tpu_torch.ops import huffman_codes as HC

    calls = []                      # (label, row, args)
    packs = []                      # (label, pack_words args)
    first, peak = {}, {}
    for size, data, S in (("1mb", raw, cfg.shard_size),
                          ("4mb", build_corpus(LARGE_CORPUS_BYTES),
                           LARGE_SHARD)):
        for s_ in range(math.ceil(len(data) / S)):
            x, vl, fin = shard_input(data, S, s_)
            got = corpus.block_stage_inputs(x.to(dev), vl, fin)
            if set(got) != {"block_plan", "huffman_codes 11-bit",
                            "huffman_codes 7-bit", "pack_words"}:
                raise AssertionError(f"shard {s_} of {size}: the encode "
                                     f"called {sorted(got)}")
            got["block_layout"] = (None, None, corpus.layout_inputs(
                got["pack_words"][2]), {})
            packs.append((f"{size} shard {s_}", got.pop("pack_words")[2]))
            calls += [(f"{size} shard {s_}", row, a)
                      for row, (_, _, a, _) in got.items()]
            if s_ == 0:
                first[size] = {row: a for row, (_, _, a, _) in got.items()}
                first[size]["pack_words"] = packs[-1][1]
                xd = x.to(dev)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                encode_shard(xd, vl, fin)
                torch.cuda.synchronize()
                peak[size] = (torch.cuda.max_memory_allocated()
                              - base) / 2**20
                del xd
    for btype, label in ((C.BTYPE_FIXED, "fixed"), (C.BTYPE_STORED,
                                                    "stored")):
        x, vl, _ = shard_input(raw[:2 << 20], 2 << 20, 0)
        got = corpus.block_stage_inputs(x.to(dev), vl, True,
                                        force_btype=btype)
        if "block_plan" in got:
            raise AssertionError(f"a {label} encode ran block_plan")
        got["block_layout"] = (None, None, corpus.layout_inputs(
            got["pack_words"][2]), {})
        packs.append((f"2 MB {label}", got.pop("pack_words")[2]))
        calls += [(f"2 MB {label}", row, a)
                  for row, (_, _, a, _) in got.items()]
    for name in corpus.BLOCK_PLAN_CASES:
        ll, d, nv, tb = corpus.block_plan_case(name)
        calls.append((name, "block_plan", (
            *(torch.from_numpy(t).to(dev) for t in (ll, d)), nv,
            torch.from_numpy(tb).to(dev), 8)))
    for name in corpus.HUFFMAN_CASES:
        f, mb = corpus.huffman_case(name)
        calls.append((name, f"huffman_codes {mb}-bit",
                      (torch.from_numpy(f).to(dev), mb)))
    for name in corpus.LAYOUT_CASES:
        calls.append((name, "block_layout", tuple(
            torch.from_numpy(t).to(dev) for t in corpus.layout_case(name))))

    def plan_args(a):
        """core/cost.py passes max_merge by keyword; the case calls by
        position: both as (ll, d, n_valid, tile_bytes, max_merge)."""
        return a if len(a) == 5 else (*a, MAX_MERGE)
    err = {k: 0 for k in BLOCK_KERNELS}
    rel, gaps, n_calls = 0.0, [], {k: 0 for k in BLOCK_KERNELS}
    for label, row, a in calls:
        name = row.split()[0]
        n_calls[name] += 1
        if name == "block_plan":
            a = plan_args(a)
            st, st_ref = {}, {}
            got = BP.block_plan(*a, stats=st)
            want = BP.block_plan_ref(*a, stats=st_ref)
            torch.cuda.synchronize()
            if not torch.equal(got[0], want[0]) or int(got[1]) != int(
                    want[1]):
                raise AssertionError(
                    f"block_plan's split differs from the plain version's "
                    f"on {label}: smallest DP margin {float(st['gap'])} "
                    f"(plain {float(st_ref['gap'])})")
            r = float(((st["cost"] - st_ref["cost"]).abs()
                       / st_ref["cost"].abs()).max())
            if r > 1e-5:
                raise AssertionError(f"block_plan's segment costs on {label}"
                                     f": relative error {r} over 1e-5")
            rel = max(rel, r)
            gaps.append((float(st["gap"]), label))
        else:
            op, ref = ((HC.huffman_codes, HC.huffman_codes_ref)
                       if name == "huffman_codes" else
                       (BL.block_layout, BL.block_layout_ref))
            err[name] = max(err[name], same(
                list(op(*a)), list(ref(*a)), f"{row}, {label}"))

    times, depth, shown = {}, {}, []
    floor, ghz = launch_floor_ms(), sm_clock_ghz()
    serial, dp_ns = {}, {}
    for size in ("1mb", "4mb"):
        a = plan_args(first[size]["block_plan"])
        M = a[0].shape[0]
        times["block_plan", size] = timings(
            "block_plan_", lambda: BP.block_plan(*a),
            lambda: BP.block_plan_ref(*a), 20, 5,
            M * (C.NUM_LITLEN + C.NUM_DIST + 1) * a[0].element_size()
            + M + 8, reps=5, plain_n=0, bound_ops=block_plan_ops(a),
            ops_rate=F32_TFLOPS * 1e12)
        depth["block_plan", size] = M
        st = {}
        BP.block_plan(*a, stats=st)
        dp_ns[size] = int(st["dp_cycles"]) / M / ghz
        serial["block_plan", size] = floor + M * DP_STEP_CYCLES / ghz / 1e6
        for bits in (11, 7):
            f, mb = first[size][f"huffman_codes {bits}-bit"]
            key = "huffman_codes" if bits == 11 else "huffman_codes_7bit"
            times[key, size] = timings(
                "huffman_codes_kernel", lambda: HC.huffman_codes(f, mb),
                lambda: HC.huffman_codes_ref(f, mb), 20, 5,
                f.numel() * (f.element_size() + 24), reps=5, plain_n=0,
                bound_ops=huffman_codes_ops(f, mb))
            used = int((f > 0).sum(1).max())
            rounds = (mb - 1) + max(used - 1, 0).bit_length()
            serial[key, size] = (floor + rounds * SMEM_ROUND_CYCLES
                                 / ghz / 1e6)
        depth["huffman_codes", size] = 11
        rest, sto = first[size]["block_layout"]
        NB = rest.shape[0]
        times["block_layout", size] = timings(
            "block_layout_kernel", lambda: BL.block_layout(rest, sto),
            lambda: BL.block_layout_ref(rest, sto), 20, 5, 25 * NB + 8,
            reps=5, plain_n=0, bound_ops=6 * NB)
        depth["block_layout", size] = max(NB - 1, 0).bit_length()
        serial["block_layout", size] = (
            floor + depth["block_layout", size] * LAYOUT_LEVEL_CYCLES
            / ghz / 1e6)
        shown.append(
            f"{size} shard 0: block_plan ({M} tiles, {M} DP steps, "
            f"{dp_ns[size]:.2f} ns a step by its clock64 at {ghz:.3f} GHz, "
            f"serial-depth bound {serial['block_plan', size]:.5f} ms) "
            f"{show(times['block_plan', size])}; huffman_codes "
            f"11-bit ({tuple(first[size]['huffman_codes 11-bit'][0].shape)}, "
            f"11 levels) {show(times['huffman_codes', size])}; 7-bit "
            f"({tuple(first[size]['huffman_codes 7-bit'][0].shape)}, 7 "
            f"levels) {show(times['huffman_codes_7bit', size])}; "
            f"block_layout ({NB} blocks, {depth['block_layout', size]} scan "
            f"levels, serial-depth bound "
            f"{serial['block_layout', size]:.5f} ms) "
            f"{show(times['block_layout', size])}")
    gap, gap_at = min(gaps)
    print(f"phase 15 serial-depth bounds (an empty kernel {floor:.5f} ms a "
          f"launch, the SM clock {ghz:.3f} GHz): " + ", ".join(
              f"{k} {size} {v:.5f} ms (share {v / times[k, size]['ms']:.3f})"
              for (k, size), v in serial.items()))
    print(f"phase 15 block stage: tolerance 0 (exact) on the split, "
          f"n_blocks, code lengths, codes, reversed codes and layout, rtol "
          f"1e-5 on the segment costs; == the plain versions on "
          f"{sum(n_calls.values())} calls ({n_calls}: every shard of phases "
          f"4 and 10, a fixed and a stored 2 MB encode, "
          f"{len(corpus.BLOCK_PLAN_CASES)} + {len(corpus.HUFFMAN_CASES)} + "
          f"{len(corpus.LAYOUT_CASES)} cases; block_layout on the layout "
          f"each encode's pack_words carried in its look-back); max abs err "
          f"{err}; segment "
          f"costs' largest relative error {rel:.3e}; smallest DP margin "
          f"between best and second-best candidate {gap:.4f} bits ({gap_at})"
          f"; {'; '.join(shown)}; no single PyTorch call computes any of "
          f"the three functions")
    torch.cuda.synchronize()
    t7 = {f"{k}_7bit{'' if size == '1mb' else '_4mb'}": times[
        "huffman_codes_7bit", size][k] for size in ("1mb", "4mb")
        for k in ("ms", "plain_ms", "bound_ms", "share_of_bound", "call_ms")}

    def bound_keys(key):
        return {f"serial_bound_ms{'' if size == '1mb' else '_4mb'}":
                serial[key, size] for size in ("1mb", "4mb")}
    t7.update({k.replace("serial_bound_ms", "serial_bound_ms_7bit"): v
               for k, v in bound_keys("huffman_codes_7bit").items()})
    return {"max_abs_err": err, "times": times, "depth": depth,
            "extra": {"block_plan": {"max_rel_err_cost": rel,
                                     "min_gap": gap,
                                     "dp_ns_per_step": dp_ns["1mb"],
                                     "dp_ns_per_step_4mb": dp_ns["4mb"],
                                     **bound_keys("block_plan")},
                      "huffman_codes": {**t7,
                                        **bound_keys("huffman_codes")},
                      "block_layout": {**bound_keys("block_layout"),
                                       "main_path": "carried by pack_words' "
                                       "look-back (the maps of csrc/"
                                       "layout_scan.cuh)"}},
            "packs": packs, "first_packs": {k: v["pack_words"]
                                            for k, v in first.items()},
            "encode_peak_mib": peak}


# ------------------------------------------------ 16. the encoder's pack

PACK_EXTRA = ("kernel_ms", "memset_ms", "clock_ghz", "lookback_ns_median",
              "lookback_ns_max", "to_aggregate_us", "span_us")


def pack_bytes(a) -> int:
    """The bytes pack_words must move on its arguments `a` (as encode_shard
    hands them), counted on this data. Read once: 18 a position of the
    tiles whose block has Huffman codes (the chosen flag, the byte, the
    int64 length and distance), a stored block's `blen` bytes, each tile's
    block, the used blocks' start, flags, blen and header widths, the
    values of their nonzero-width header items, the table words of the
    symbols a Huffman block codes, the stride. Written once: the words
    (zeroed by the memset and written, counted once), the layout and token
    bits of every bucket, the tail and the NSUB decode entries, three
    int64 each."""
    from deflate_compression_tpu_torch.ops.pack_words import H_ITEMS
    blk, huff, sto, blen, ll, d, nbs = (a[i].cpu() for i in
                                        (4, 6, 7, 8, 9, 10, 12))
    S, NB, nw = a[0].shape[0], a[0].shape[0] // WINDOW, a[15]
    nbu = int(blk.max()) + 1                  # the blocks used
    huff, sto, blen, nbs = huff[:nbu], sto[:nbu], blen[:nbu], nbs[:nbu]
    tabs = torch.cat([ll[:nbu][huff][:, :-1], d[:nbu][huff][:, :-1]], 1)
    reads = (18 * WINDOW * int(huff[blk].sum())
             + int(blen[sto].clamp(max=WINDOW).sum())
             + 8 * NB + nbu * (8 + 1 + 1 + 8 + 8 * H_ITEMS)
             + 8 * int((nbs > 0).sum()) + 8 * int((tabs >> 16 > 0).sum())
             + 8)
    return reads + 8 * (nw + 3 * NB + 3) + 24 * (S // 64)


def adler32_phase(dev) -> dict:
    """Phase 17: adler32_torch (the kernel) against zlib.adler32 and
    adler32_torch_ref on the card, exactly: lengths 0 to 4 MiB + 1, all
    0xFF at 4 MiB, views at each byte offset of a 16-byte line, lengths
    held on the card; one launch a call; under sync debug mode "error";
    its and its plain version's times on 1 MiB and 4 MiB of bytes beside
    the bound, the bytes read once over 3.35 TB/s (warm in L2, as the
    decode that wrote them leaves them)."""
    from deflate_compression_tpu_torch.core import checksum as CK
    from deflate_compression_tpu_torch.ops import adler32 as AD
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, LARGE_SHARD + 64, dtype=np.uint8)
    x = torch.from_numpy(data).to(dev)
    ff = torch.full((LARGE_SHARD,), 0xFF, dtype=torch.uint8, device=dev)
    cases = [(x, data, n) for n in (0, 1, 5551, 5552, 5553, 1 << 20,
                                    LARGE_SHARD, LARGE_SHARD + 1)]
    cases += [(x[o:], data[o:], n) for o in range(1, 16)
              for n in (17, (1 << 20) + o, LARGE_SHARD)]
    cases.append((ff, np.full(LARGE_SHARD, 0xFF, np.uint8), LARGE_SHARD))
    launches = AD.adler32.launches
    err = 0
    for t, host, n in cases:
        want = zlib.adler32(host[:n].tobytes())
        got = [int(CK.adler32_torch(t, n)),
               int(CK.adler32_torch(t, torch.tensor(n, device=dev))),
               int(CK.adler32_torch_ref(t, n))]
        err = max(err, *(abs(g - want) for g in got[:2]))
        if got != [want] * 3:
            raise AssertionError(f"adler32 of {n} bytes at offset "
                                 f"{t.data_ptr() % 16}: kernel, kernel with "
                                 f"the length on the card, plain {got} != "
                                 f"zlib {want}")
    per_call = (AD.adler32.launches - launches) / (2 * len(cases))
    if per_call != 1:
        raise AssertionError(f"adler32_torch launched {per_call} a call")
    n_card = torch.tensor(LARGE_SHARD - 3, device=dev)
    got = no_sync(lambda: (CK.adler32_torch(x, LARGE_SHARD),
                           CK.adler32_torch(x, n_card)))
    if [int(g) for g in got] != [zlib.adler32(data[:n].tobytes())
                                 for n in (LARGE_SHARD, LARGE_SHARD - 3)]:
        raise AssertionError("adler32 under sync debug mode differs")
    times, shown = {}, []
    for label, n in (("1mb", 1 << 20), ("4mb", LARGE_SHARD)):
        t = times[label] = timings(
            "adler32_kernel", lambda: CK.adler32_torch(x, n),
            lambda: CK.adler32_torch_ref(x, n), 100, 20, n, plain_n=20)
        shown.append(f"{label}: {show(t)}")
    print(f"phase 17 adler32: tolerance 0 (exact), == zlib and plain on "
          f"{len(cases)} cases (lengths 0 to {LARGE_SHARD + 1}, offsets "
          f"1-15, all 0xFF), with the length as an int and on the card; "
          f"one launch a call; no wait under sync debug mode \"error\"; "
          f"{'; '.join(shown)}")
    torch.cuda.synchronize()
    return {**times, "launches_per_call": per_call, "max_abs_err": err}


def gzip_member(raw: bytes) -> bytes:
    """`raw` as one gzip -9 member, as CPython's gzip writes a named file."""
    import gzip
    import io
    buf = io.BytesIO()
    with gzip.GzipFile(filename="corpus", mode="wb", compresslevel=9,
                       fileobj=buf, mtime=0) as f:
        f.write(raw)
    return buf.getvalue()


def crc32_phase(dev) -> dict:
    """Phase 18: crc32_torch (the kernel) against zlib.crc32 and
    crc32_torch_ref on the card, exactly: lengths 0 to 4 MiB + 1, all 0xFF
    at 4 MiB, views at each byte offset of a 16-byte line, starting values
    as ints and held on the card, lengths held on the card; one launch a
    call; under sync debug mode "error"; its and its plain version's times
    on 1 MiB and 4 MiB beside the bound (the bytes read once and the 8-byte
    result, over 3.35 TB/s, warm in L2 as the decode that wrote them
    leaves them); a gzip -9 member of phase 10's size through
    decompress_gzip_indexed in 4 MiB groups, one launch a group."""
    from deflate_compression_tpu_torch.core import checksum as CK
    from deflate_compression_tpu_torch.corpus import build_corpus
    from deflate_compression_tpu_torch.decode import index as IDX
    from deflate_compression_tpu_torch.format.containers import \
        gzip_parse_header
    from deflate_compression_tpu_torch.ops import crc32 as CR
    rng = np.random.default_rng(18)
    data = rng.integers(0, 256, LARGE_SHARD + 64, dtype=np.uint8)
    x = torch.from_numpy(data).to(dev)
    ff = torch.full((LARGE_SHARD,), 0xFF, dtype=torch.uint8, device=dev)
    cases = [(x, data, n) for n in (0, 1, 3, 4, 5, 4095, 4096, 4097, 65543,
                                    1 << 20, (1 << 20) + 3, LARGE_SHARD,
                                    LARGE_SHARD + 1)]
    cases += [(x[o:], data[o:], n) for o in range(1, 16)
              for n in (3, 17, (1 << 20) + o, LARGE_SHARD)]
    cases.append((ff, np.full(LARGE_SHARD, 0xFF, np.uint8), LARGE_SHARD))
    launches = CR.crc32.launches
    err = 0
    for k, (t, host, n) in enumerate(cases):
        init = 0 if k % 2 else int(rng.integers(0, 2 ** 32))
        want = zlib.crc32(host[:n].tobytes(), init)
        got = [int(CK.crc32_torch(t, n, init)),
               int(CK.crc32_torch(t, torch.tensor(n, device=dev),
                                  torch.tensor(init, device=dev))),
               int(CK.crc32_torch_ref(t, n, init))]
        err = max(err, *(abs(g - want) for g in got[:2]))
        if got != [want] * 3:
            raise AssertionError(f"crc32 of {n} bytes at offset "
                                 f"{t.data_ptr() % 16} from {init:#x}: "
                                 f"kernel, kernel with the length and start "
                                 f"on the card, plain {got} != zlib {want}")
    per_call = (CR.crc32.launches - launches) / (2 * len(cases))
    if per_call != 1:
        raise AssertionError(f"crc32_torch launched {per_call} a call")
    n_card = torch.tensor(LARGE_SHARD - 3, device=dev)
    a, b = no_sync(lambda: (lambda a: (a, CK.crc32_torch(x, n_card, a)))(
        CK.crc32_torch(x, LARGE_SHARD)))
    whole = zlib.crc32(data[:LARGE_SHARD].tobytes())
    if [int(a), int(b)] != [whole, zlib.crc32(
            data[:LARGE_SHARD - 3].tobytes(), whole)]:
        raise AssertionError("crc32 under sync debug mode differs")
    times, shown = {}, []
    for label, n in (("1mb", 1 << 20), ("4mb", LARGE_SHARD)):
        t = times[label] = timings(
            "crc32_kernel", lambda: CK.crc32_torch(x, n),
            lambda: CK.crc32_torch_ref(x, n), 100, 20, n + 8, plain_n=0)
        shown.append(f"{label}: {show(t)}")
    raw = build_corpus(LARGE_CORPUS_BYTES, seed=18)
    member = gzip_member(raw)
    idx = IDX.build_index(member[gzip_parse_header(member):])
    IDX.decompress_gzip_indexed(member, idx, LARGE_SHARD, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    out = IDX.decompress_gzip_indexed(member, idx, LARGE_SHARD, device=dev)
    dt = time.perf_counter() - t0
    gz = read_counts()
    groups = gz["build_tables"]
    if out != raw or gz != decode_counts(groups, adler32=0, crc32=groups):
        raise AssertionError(f"decompress_gzip_indexed: bytes "
                             f"{out == raw}, launches {gz}")
    print(f"phase 18 crc32: tolerance 0 (exact), == zlib and plain on "
          f"{len(cases)} cases (lengths 0 to {LARGE_SHARD + 1}, offsets "
          f"1-15, all 0xFF), the length and start as ints and on the card; "
          f"one launch a call; no wait under sync debug mode \"error\"; "
          f"{'; '.join(shown)}; a {len(raw)}-byte gzip -9 member "
          f"({len(member)} bytes, {idx.n_blocks} blocks) through "
          f"decompress_gzip_indexed in {groups} groups of 4 MiB: "
          f"{len(raw) / dt / 1e6:.1f} MB/s, launches {gz}")
    torch.cuda.synchronize()
    return {**times, "launches_per_call": per_call, "max_abs_err": err,
            "launches_gzip": gz["crc32"]}


def pack_phase(blk: dict, dev) -> dict:
    """Phase 16: pack_words against its plain version, exactly (words,
    total_bits, block_base, pad, token bits, sub_bit, sub_out, sub_blk,
    sub_overflow), on every call of phase 15 (every shard of phases 4 and
    10, a fixed and a stored encode) and on corpus.pack_case's shards; its
    layout against block_layout's plain version on those encodes; the
    wrapper once under sync debug mode "error"; its and its plain
    version's times at phase 4's first shard ("1mb") and phase 10's
    ("4mb"), the kernel and its memset by the profiler, beside the bound;
    the look-back's wait per unit (clock64) and the kernel's span
    (globaltimer) from one call with `stats`."""
    from deflate_compression_tpu_torch import corpus
    from deflate_compression_tpu_torch.ops import block_layout as BL
    from deflate_compression_tpu_torch.ops import pack_words as PW
    from deflate_compression_tpu_torch.ops.timing import profiled_ms
    calls = list(blk["packs"])
    calls += [(name, tuple(torch.from_numpy(x).to(dev)
                           if isinstance(x, np.ndarray) else x
                           for x in corpus.pack_case(name)))
              for name in corpus.PACK_CASES]
    err = lay_err = 0
    for label, a in calls:
        got = PW.pack_words(*a)
        err = max(err, same(got, PW.pack_words_ref(*a),
                            f"pack_words, {label}"))
    for label, a in blk["packs"]:
        got = PW.pack_words(*a)
        want = BL.block_layout_ref(*corpus.layout_inputs(a))
        lay_err = max(lay_err, same([got.block_base, got.pad], want[:2],
                                    f"pack_words' layout scan, {label}"))
    a1 = blk["first_packs"]["1mb"]
    got = no_sync(lambda: PW.pack_words(*a1))
    same(got, PW.pack_words_ref(*a1), "pack_words under sync debug mode")
    resident = PW.resident_units(dev)
    times, shown = {}, []
    for size, a in blk["first_packs"].items():
        n_bytes = pack_bytes(a)
        t = times[size] = timings(PACK_KERNEL, lambda: PW.pack_words(*a),
                                  lambda: PW.pack_words_ref(*a), 20, 5,
                                  n_bytes, reps=5, plain_n=0)
        by = profiled_ms(lambda: PW.pack_words(*a), 5, (PACK_KERNEL,))
        t["kernel_ms"] = sum(v for k, v in by.items() if PACK_KERNEL in k)
        mem = [v for k, v in by.items() if "emset" in k]
        t["memset_ms"] = sum(mem) if mem else None
        st = {}
        same(PW.pack_words(*a, stats=st), PW.pack_words_ref(*a),
             f"pack_words with stats, {size}")
        torch.cuda.synchronize()
        # cycles to ns at this launch's own clock: its units' clock64 spans
        # over their globaltimer spans
        ghz = t["clock_ghz"] = float(
            (st["end_cycles"] - st["start_cycles"]).double().sum()
            / (st["end_ns"] - st["start_ns"]).double().sum())
        cyc = st["lookback_cycles"].double()
        t["lookback_ns_median"] = float(cyc.median()) / ghz
        t["lookback_ns_max"] = float(cyc.max()) / ghz
        t["span_us"] = float(st["end_ns"].max() - st["start_ns"].min()) / 1e3
        t["to_aggregate_us"] = float(
            (st["aggregate_ns"] - st["start_ns"]).double().median()) / 1e3
        nu = a[0].shape[0] // PW.UNIT
        mems = ("not measured (the profiler kept no memset event)"
                if t["memset_ms"] is None else f"{t['memset_ms']:.4f} ms")
        shown.append(
            f"{size} shard 0 ({a[0].shape[0]} positions, {nu} units, "
            f"{a[0].shape[0] // WINDOW} tiles, {n_bytes} bytes, stride "
            f"{int(a[13])}): one launch, the kernel {t['kernel_ms']:.4f} ms "
            f"and the memset {mems} by the profiler; a unit's look-back "
            f"waits {t['lookback_ns_median']:.0f} ns (median), "
            f"{t['lookback_ns_max']:.0f} ns (longest) at {ghz:.3f} GHz "
            f"(the launch's clock64 over its globaltimer), "
            f"after {t['to_aggregate_us']:.2f} us from its start to its "
            f"aggregate (median); "
            f"first unit's start to last unit's end {t['span_us']:.2f} us; "
            f"{show(t)}")
    print(f"phase 16 pack_words: tolerance 0 (exact); words, total_bits, "
          f"block_base, pad, token bits and sub_bit, sub_out, sub_blk, "
          f"sub_overflow == the plain version "
          f"on {len(calls)} calls (every shard of phases 4 and 10, a fixed "
          f"and a stored 2 MB encode, {len(corpus.PACK_CASES)} synthetic "
          f"shards), max abs err {err}; the look-back's layout == "
          f"block_layout's plain version on {len(blk['packs'])} encodes "
          f"(max abs err {lay_err}); the wrapper ran under sync debug mode "
          f"\"error\"; {resident} units resident at once; "
          f"{'; '.join(shown)}; one encode_shard's peak device memory "
          f"{blk['encode_peak_mib']['1mb']:.1f} MiB (1 MB), "
          f"{blk['encode_peak_mib']['4mb']:.1f} MiB (4 MB) above its "
          f"input; no single PyTorch call computes the function")
    torch.cuda.synchronize()
    return {"max_abs_err": err, "layout_err": lay_err, "times": times,
            "calls": len(calls), "resident": resident}


if __name__ == "__main__":
    sys.exit(main())
