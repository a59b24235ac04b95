"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line and ends with torch.cuda.synchronize()):
  1. device: the card's name and power limit;
  2. build: start nvcc on every CUDA source of csrc/ at once, wait for all;
  3. tile_histogram against its plain PyTorch version, exact equality, on
     int32 and int64 symbols, rows 1-32, C = 30, 286 and MAX_CLASSES, and
     a skewed input (every row one symbol 32768 times); both times at the
     main-path shape on int32 and on the encoder's int64 symbols, and on
     the skewed rows: per call, on the device per launch and summed by
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
     raising on each, the declared-window violation, clean shards equal.
Any failure raises, so the script exits non-zero. Before the last line it
prints the kernels' JSON line: per kernel its launches on the main path,
its error against the plain version, and its device time per launch
(`ms`), its plain version's (`plain_ms`), the bound (`bound_ms`: the bytes
it must move over 3.35 TB/s; the operations are far below the peak rates)
and `share_of_bound`, each computed from this run. The last line is the
JSON result {"ok": true, "device": {...}}.
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

SHAPES = [(32, 32768, 286), (32, 32768, 30), (17, 32768, 286), (1, 32768, 286)]
CORPUS_BYTES = 8_500_000
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
    from deflate_compression_tpu_torch.format.deflate import encode_shard
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
                if rows == 32 and (dtype == torch.int64 or label == "random"):
                    key = (C, str(dtype).split(".")[-1], label)
                    times[key] = hist_timings(H, x, C)
                    if key == (286, "int64", "random"):
                        main_sym = x
    hist_ok = no_sync(lambda: H.tile_histogram(main_sym, 286))
    if not torch.equal(hist_ok, H.tile_histogram_ref(main_sym, 286)):
        raise AssertionError("tile_histogram under sync debug mode differs")
    shapes = ", ".join(f"{s[:2]}/C={s[2]}"
                       for s in SHAPES + [(2, 32768, H.MAX_CLASSES)])
    shown = "; ".join(f"(32, 32768) C={c} {d} {lab}: {show(t)}; "
                      f"torch.bincount of the flat row-offset index "
                      f"{t['bincount_ms']:.4f} ms per call (context)"
                      for (c, d, lab), t in times.items())
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
    S = cfg.shard_size
    checked = []
    for s in (0, nsh - 1):
        part = raw[s * S:(s + 1) * S]
        buf = np.zeros(S, dtype=np.uint8)
        buf[:len(part)] = np.frombuffer(part, dtype=np.uint8)
        x = torch.from_numpy(buf)
        rg = encode_shard(x.to(dev), len(part), s == nsh - 1)
        rc = encode_shard(x, len(part), s == nsh - 1)
        nw = (int(rc["total_bits"]) + 31) // 32
        if not torch.equal(rg["words"][:nw].cpu(), rc["words"][:nw]):
            raise AssertionError(f"shard {s}: words differ GPU vs CPU")
        for k in PHASE5_KEYS:
            if not torch.equal(rg[k].cpu(), rc[k]):
                raise AssertionError(f"shard {s}: {k} differs GPU vs CPU")
        checked.append((s, len(part), int(rc["total_bits"])))
    if ZlibCodec(cfg, device="cpu").compress(raw) != blob:
        raise AssertionError("whole-corpus stream differs GPU vs CPU")
    print(f"phase 5 gpu vs cpu: identical words/total_bits/btype/block_bits/"
          f"sub_* for shards (index, bytes, bits) {checked}; whole "
          f"{len(blob)}-byte zlib stream identical")
    torch.cuda.synchronize()

    decode = decode_phases(raw, cfg, blob, dev, (ds_lib.name, lg_lib.name),
                           t_ds)

    print(json.dumps({"kernels": [{
        "name": "tile_histogram", "route": "cuda",
        "source": "deflate_compression_tpu_torch/csrc/tile_histogram.cu",
        "replaces": "deflate_compression_tpu/ops/histogram_pallas.py:74",
        "launches": launches, "max_abs_err": max_err,
        **entry(times[(286, "int64", "random")]), "library_ms": None,
        "int32_ms": times[(286, "int32", "random")]["ms"],
        "c30_ms": times[(30, "int64", "random")]["ms"],
        "skewed_ms": times[(286, "int64", "skewed")]["ms"],
        "context_bincount_ms": times[(286, "int64", "random")][
            "bincount_ms"]}, *decode]}))
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
    from deflate_compression_tpu_torch.format.deflate import out_words
    from deflate_compression_tpu_torch.models.codec import compress_stream
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
    sink = []
    pieces = list(compress_stream([raw], cfg, index_sink=sink, device=dev))
    if b"".join(pieces) != blob:
        raise AssertionError("compress_stream != ZlibCodec.compress")
    body = b"".join(pieces[1:-1])
    nsh = len(sink)
    CW = out_words(S)
    words = np.zeros((nsh, CW), np.int64)
    for s_, part in enumerate(pieces[1:-1]):
        padded = part + bytes(-len(part) % 4)
        words[s_, :len(padded) // 4] = np.frombuffer(padded, "<u4")
    stacked = {k: np.stack([st[k] for st, _, _ in sink]) for k in IDX_KEYS}
    valid = [vl for _, _, vl in sink]
    batch = [torch.from_numpy(words).to(dev)] + [
        torch.from_numpy(stacked[k]).to(dev) for k in IDX_KEYS]

    def shard_args(s_, w=None):
        """decode_blocks arguments of shard s_ alone."""
        return ([batch[0][s_] if w is None else w]
                + [x[s_] for x in batch[1:]]
                + [batch[-1].shape[1], valid[s_]])

    def same(got, want, what):
        err = 0
        for g, x in zip(got, want):
            if g.shape != x.shape:
                raise AssertionError(f"{what}: shapes differ")
            err = max(err, int((g.long() - x.long()).abs().max())
                      if g.numel() else 0)
        if err:
            raise AssertionError(f"{what}: kernel != plain, max abs err "
                                 f"{err}")
        return err

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

    def verified_decode():
        r = DI.decode_blocks_batch(*batch, valid, S)
        ads = torch.stack([adler32_torch(r["out"][s_], valid[s_])
                           for s_ in range(nsh)]).tolist()
        return r, bool(r["ok"]), ads

    verified_decode()
    torch.cuda.synchronize()
    DS.decode_symbols.launches = LG.lut_gather.launches = 0
    t0 = time.perf_counter()
    res, ok, ads = verified_decode()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ds_launches = DS.decode_symbols.launches
    lg_launches = LG.lut_gather.launches
    if ds_launches != 1 or lg_launches != 1:
        raise AssertionError(f"decode path launched decode_symbols "
                             f"{ds_launches} and lut_gather {lg_launches} "
                             f"times")
    if not ok or ads != want_adler:
        raise AssertionError(f"batch decode: ok {ok}, adler {ads} != "
                             f"{want_adler}")
    out_host = res["out"].cpu().numpy()
    for s_ in range(nsh):
        if out_host[s_, :valid[s_]].tobytes() != raw[s_ * S:(s_ + 1) * S]:
            raise AssertionError(f"batch decode: shard {s_} bytes differ")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    pt = DI.plan(**flat)
    ev[1].record()
    bt = DI.phase_b(pt, nsh * S, WINDOW)
    ev[2].record()
    rt = DI.phase_c(pt, bt, nsh * S)
    ev[3].record()
    torch.cuda.synchronize()
    ph = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
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


if __name__ == "__main__":
    sys.exit(main())
