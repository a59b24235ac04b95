"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line and ends with torch.cuda.synchronize()):
  1. device: the card's name and power limit;
  2. build: start nvcc on every CUDA source of csrc/ at once, wait for all;
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
     checked by zlib.decompress, with the kernel's launch count;
  5. encode_shard on the card against the port on the CPU, bit for bit, for
     the first and the last shard, and the whole stream of phase 4;
  6. build: decode_symbols.cu and lut_gather.cu (compiled in phase 2)
     loaded;
  7. decode_symbols and lut_gather against their plain versions, exactly,
     decode_symbols on the corpus's first and last shards and on the whole
     flat batch (its wrapper once under sync debug mode "error"),
     lut_gather at the probe's (2048, 4096), the block-flag lookup, a
     table past 32768 entries and a bandwidth-bound 2^24 indices (in GB/s,
     beside a device-to-device copy of the same bytes); each kernel's and
     plain version's times as in phase 3, with bound and library call;
  8. the decode slice: compress_stream with an index sink, then
     decode_blocks_batch over all shards in one flat call (adler32 per
     shard, bytes, verified-decode MB/s, launch counts, phase times),
     decompress_indexed of the stream with the encoder's index, and of a
     foreign zlib-9 stream through build_index;
  9. strictness on the card and GPU against CPU: seeded bit flips flagged
     or rejected with the CPU's ok and bad lanes, decompress_indexed
     raising on each, the declared-window violation, clean shards equal;
 10. large shards: a 32 MB corpus in 4 MB shards through ZlibCodec on the
     card (zlib.decompress, tile_histogram launches, MB/s beside phase
     4's, peak device memory), the first and last shard GPU == CPU,
     compress_stream's index into one flat decode_blocks_batch (adler32
     per shard, bytes, decode_symbols and lut_gather once each and equal
     to their plain versions on that batch, phase times), and
     decompress_indexed with the encoder's index;
 11. the codec's surface: the raw, zlib and gzip codecs compress the 8.5
     MB corpus on the card and decompress it on the host (zlib / gzip
     oracles), the self-check on 2 MB, verify_stream of its zlib and gzip
     blobs, png_decode of a PNG built here, the per-symbol trace of 256 KB
     on the card against the CPU.
Any failure raises, so the script exits non-zero. Before the last line it
prints the kernels' JSON line: per kernel its launches on the main path
(the 1 MB-shard encode of phase 4 and decode of phase 8) and on the 4 MB-
shard path of phase 10 (`launches_4mb`), its error against the plain
version, and its device time per launch (`ms`), its plain version's
(`plain_ms`), the bound (`bound_ms`: the bytes it must move over 3.35
TB/s; the operations are far below the peak rates) and `share_of_bound`,
each computed from this run; tile_histogram's `rows128_*` keys are the
same at (128, 32768). The last line is the JSON result
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
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
WINDOW = 32768


HBM_GBS = 3350.0                 # H100 SXM device memory, GB/s (data sheet)
TABLE_BYTES = 17_792             # one block's decode tables (decode_symbols.cu)


def timings(kernel: str, fn, plain, n: int, prof_n: int,
            bound_bytes: int) -> dict:
    """A kernel's and its plain version's times: per call (`cuda_ms`), on
    the device per launch (`device_ms`, n calls) and by kernel name under
    torch.profiler (`profiled_ms`, prof_n calls; the kernel's own entries,
    and every device entry of the plain version); and the bound, the
    bytes the function must move over the card's memory rate."""
    t = {"call_ms": cuda_ms(fn), "plain_call_ms": cuda_ms(plain)}
    t["device_ms"], t["held"] = device_ms(fn, n)
    t["plain_device_ms"], t["plain_held"] = device_ms(plain, n)
    by = profiled_ms(fn, prof_n)
    t["prof_ms"] = sum(v for k, v in by.items() if kernel in k)
    plain_by = profiled_ms(plain, prof_n)
    t["plain_prof_ms"] = sum(plain_by.values())
    t["plain_kernels"] = len(plain_by)
    # device time per launch: queued where the call lets the device run
    # ahead, else the profiler's sum
    t["ms"] = t["device_ms"] if t["held"] else t["prof_ms"]
    t["plain_ms"] = (t["plain_device_ms"] if t["plain_held"]
                     else t["plain_prof_ms"])
    t["bound_ms"] = bound_bytes / (HBM_GBS * 1e9) * 1e3
    t["bound_by"] = "bytes"
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    return t


def show(t: dict) -> str:
    """One line of a `timings` result."""
    def dev(ms, held):
        return f"{ms:.4f}" + ("" if held else " (waits for the device, "
                              "host included)")
    return (f"kernel {t['call_ms']:.4f} ms per call, "
            f"{dev(t['device_ms'], t['held'])} ms device per launch, "
            f"{t['prof_ms']:.4f} ms profiler, bound {t['bound_ms']:.5f} ms "
            f"(bytes), share of bound {t['share_of_bound']:.3f}; plain "
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
    from deflate_compression_tpu_torch.ops import cuda_build
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import histogram as H
    from deflate_compression_tpu_torch.ops import lut_gather as LG

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
    builds = [cuda_build.Build(src) for src in (H.SOURCE, DS.SOURCE,
                                                  LG.SOURCE)]
    lib = builds[0].wait()
    t_hist = time.perf_counter() - t0
    ds_lib, lg_lib = builds[1].wait(), builds[2].wait()
    t_ds = time.perf_counter() - t0
    print(f"phase 2 build: nvcc started on tile_histogram.cu, "
          f"decode_symbols.cu and lut_gather.cu together; {lib.name} in "
          f"{t_hist:.2f} s, {ds_lib.name} and {lg_lib.name} done {t_ds:.2f} s "
          f"after the start")
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
    H.tile_histogram.launches = 0
    t0 = time.perf_counter()
    blob, stats = codec.compress(raw, return_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = H.tile_histogram.launches
    if zlib.decompress(blob) != raw:
        raise AssertionError("zlib.decompress(blob) != raw")
    if launches != 2 * nsh:
        raise AssertionError(f"tile_histogram launched {launches} times, "
                             f"want {2 * nsh}")
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
          f"{stats.n_matches}, tile_histogram launches {launches}; "
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

    decode = decode_phases(raw, cfg, blob, dev, (ds_lib.name, lg_lib.name),
                           t_ds)
    large = large_shard_phase(dev, len(raw) / dt)
    surface_phase(raw, dev)

    print(json.dumps({"kernels": [{
        "name": "tile_histogram", "route": "cuda",
        "source": "deflate_compression_tpu_torch/csrc/tile_histogram.cu",
        "replaces": "deflate_compression_tpu/ops/histogram_pallas.py:74",
        "launches": launches, "launches_4mb": large["tile_histogram"],
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
        *({**d, "launches_4mb": large[d["name"]]} for d in decode)]}))
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
    checks, decode_symbols and lut_gather launches in it); the first call
    warms up."""
    from deflate_compression_tpu_torch.core.checksum import adler32_torch
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import lut_gather as LG
    nsh = len(valid)
    want = [zlib.adler32(raw[s * S:(s + 1) * S]) for s in range(nsh)]

    def run():
        r = DI.decode_blocks_batch(*batch, valid, S)
        ads = torch.stack([adler32_torch(r["out"][s], valid[s])
                           for s in range(nsh)]).tolist()
        return r, bool(r["ok"]), ads

    run()
    torch.cuda.synchronize()
    DS.decode_symbols.launches = LG.lut_gather.launches = 0
    t0 = time.perf_counter()
    res, ok, ads = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (DS.decode_symbols.launches, LG.lut_gather.launches)
    if launches != (1, 1):
        raise AssertionError(f"flat decode of {S}-byte shards launched "
                             f"decode_symbols and lut_gather {launches} times")
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
    """Milliseconds of the decoder's phases A (plan), B and C by CUDA
    events around one flat decode, and phase C's result."""
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    p = DI.plan(**flat)
    ev[1].record()
    b = DI.phase_b(p, out_size, WINDOW)
    ev[2].record()
    r = DI.phase_c(p, b, out_size)
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], r


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
    decode kernels' entries of the kernels JSON line."""
    from deflate_compression_tpu_torch.core.checksum import adler32_torch
    from deflate_compression_tpu_torch.corpus import repo_text
    from deflate_compression_tpu_torch.decode import device_inflate as DI
    from deflate_compression_tpu_torch.decode.index import (
        DeflateError, build_index, decompress_indexed, index_from_shards,
        native_available)
    from deflate_compression_tpu_torch.ops import decode_symbols as DS
    from deflate_compression_tpu_torch.ops import lut_gather as LG

    S = cfg.shard_size
    # ----------------------------------------------------------- 6. build
    DS._bind()
    LG._bind()
    print(f"phase 6 build: {' and '.join(lib_names)} loaded; nvcc ran "
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

    # ------------------------------------------------- 8. the decode slice
    want_adler = [zlib.adler32(raw[s_ * S:(s_ + 1) * S]) for s_ in range(nsh)]
    res, dt, (ds_launches, lg_launches) = verified_decode(raw, batch, valid,
                                                          S)
    ph, rt = phase_times(flat, nsh * S)
    in_shard = torch.arange(S, device=dev) < torch.tensor(
        valid, device=dev).unsqueeze(1)
    if not bool(rt["ok"]) or not torch.equal(
            torch.where(in_shard, rt["out"].view(nsh, S), 0), res["out"]):
        raise AssertionError("phase-by-phase decode differs")

    index = index_from_shards(*zip(*sink))
    DS.decode_symbols.launches = LG.lut_gather.launches = 0
    t0 = time.perf_counter()
    got_raw = decompress_indexed(body, index, expected_adler=zlib.adler32(raw),
                                 device=dev)
    t_idx = time.perf_counter() - t0
    idx_launches = (DS.decode_symbols.launches, LG.lut_gather.launches)
    if got_raw != raw:
        raise AssertionError("decompress_indexed != input")
    if min(idx_launches) < 1:
        raise AssertionError(f"decompress_indexed launched decode_symbols "
                             f"and lut_gather {idx_launches} times")

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
    t0 = time.perf_counter()
    zlib.decompress(blob)
    t_z = time.perf_counter() - t0
    print(f"phase 8 decode slice: {len(raw)} bytes, {nsh} shards, "
          f"{n_lanes} lanes in one flat decode_blocks_batch: verified "
          f"decode {len(raw) / dt / 1e6:.3f} MB/s ({dt:.3f} s, adler32 per "
          f"shard OK, bytes OK), decode_symbols launches {ds_launches}, "
          f"lut_gather launches {lg_launches}; phases by CUDA events: A "
          f"{ph[0]:.2f} ms, B {ph[1]:.2f} ms, C {ph[2]:.2f} ms; "
          f"decompress_indexed with the encoder's index "
          f"{len(raw) / t_idx / 1e6:.3f} MB/s ({index.n_subs} entries; "
          f"decode_symbols and lut_gather launches {idx_launches}); "
          f"foreign zlib-9 {len(fraw)} bytes: build_index "
          f"({'native' if native else 'python'}) {t_bi:.3f} s, "
          f"decompress_indexed {len(fraw) / t_f / 1e6:.3f} MB/s, OK; host "
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
    for lane in picks:
        bit = int(sb0[lane])
        wm = batch[0][0].clone()
        wm[bit >> 5] ^= 1 << (bit & 31)
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
          f"decompress_indexed raised DeflateError on each; window "
          f"violation raised at max_dist=512 and decoded at 32768; clean "
          f"shards 0 and {nsh - 1}: GPU == CPU (out, ok, bad lanes)")
    torch.cuda.synchronize()

    return [{"name": "decode_symbols", "route": "cuda",
             "source": "deflate_compression_tpu_torch/csrc/decode_symbols.cu",
             "replaces": "tools/probe_pallas_r5.py:35",
             "launches": ds_launches, "max_abs_err": max_err,
             **entry(ds_t), "library_ms": None,
             "kernel_ms": ds_t["prof_ms"]},
            {"name": "lut_gather", "route": "cuda",
             "source": "deflate_compression_tpu_torch/csrc/lut_gather.cu",
             "replaces": "tools/probe_pallas_r5.py:35",
             "launches": lg_launches, "max_abs_err": lg_err,
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
    H.tile_histogram.launches = 0
    t0 = time.perf_counter()
    blob, stats = ZlibCodec(cfg, device=dev).compress(raw, return_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hist_launches = H.tile_histogram.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if zlib.decompress(blob) != raw:
        raise AssertionError("4 MB shards: zlib.decompress(blob) != raw")
    if hist_launches != 2 * nsh:
        raise AssertionError(f"4 MB shards: tile_histogram launched "
                             f"{hist_launches} times, want {2 * nsh}")

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

    _, ddt, (ds_launches, lg_launches) = verified_decode(raw, batch, valid,
                                                         S)
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
          f"tile_histogram launches {hist_launches} at ({S // 32768}, 32768); "
          f"GPU == "
          f"CPU (words, total_bits, btype, block_bits, sub_*) for shards "
          f"(index, bytes, bits) {checked}, the two CPU and GPU encodes "
          f"{t_cpu:.2f} s; one flat decode_blocks_batch of {n_lanes} live "
          f"lanes: decode_symbols and lut_gather == plain (max abs err "
          f"{ds_err}, {lg_err}), launches {ds_launches} and {lg_launches}, "
          f"verified decode {len(raw) / ddt / 1e6:.3f} MB/s ({ddt:.3f} s, "
          f"adler32 per shard OK, bytes OK); phases by CUDA events: A "
          f"{ph[0]:.2f} ms, B {ph[1]:.2f} ms, C {ph[2]:.2f} ms; "
          f"decompress_indexed with the encoder's index ({index.n_subs} "
          f"entries, groups of {S} bytes) {len(raw) / t_idx / 1e6:.3f} MB/s")
    torch.cuda.synchronize()
    return {"tile_histogram": hist_launches, "decode_symbols": ds_launches,
            "lut_gather": lg_launches}


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


def surface_phase(raw: bytes, dev) -> None:
    """Phase 11: the codec's surface around the card's encoder: the three
    containers' compress on the card and decompress on the host, the
    self-check, verify_stream, png_decode and the per-symbol trace."""
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
        codec = cls(CodecConfig(container=container), device=dev)
        t0 = time.perf_counter()
        blob = codec.compress(raw)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    on_card = per_symbol_trace_csv(tr, device=dev, **kw)
    t_tr = time.perf_counter() - t0
    if on_card != per_symbol_trace_csv(tr, device="cpu", **kw):
        raise AssertionError("per_symbol_trace_csv: card != CPU")
    print(f"phase 11 codec surface: {len(raw)} bytes in 1 MB shards, "
          f"compress on the card, decompress on the host ({inflater} "
          f"inflater): {'; '.join(rows)}; all equal the input and zlib / "
          f"gzip.decompress; self_check on {len(part)} bytes {t_sc:.2f} s, "
          f"the stream unchanged; verify_stream of its zlib and gzip blobs: "
          f"{n_checks} checks true ({t_vs:.2f} s); png_decode of a "
          f"{px.shape[1]}x{px.shape[0]} RGBA8 PNG, five filters: pixels "
          f"equal; per_symbol_trace_csv of {len(tr)} bytes on the card "
          f"({t_tr:.2f} s, {len(on_card.splitlines()) - 1} records) == CPU")
    torch.cuda.synchronize()


if __name__ == "__main__":
    sys.exit(main())
