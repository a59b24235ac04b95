"""Where one shard's encode spends its time on the card.

    python3 -m deflate_compression_tpu_torch.profile_encode [--shards N]
        [--shard-size BYTES]

Prints host-clock times (best of 3 after a warm-up, each ending in
torch.cuda.synchronize()):
  * the whole encode_shard of the corpus's first shard, with the device
    memory it allocated at its peak;
  * each of its stages in that encode, read from the stage's span
    "encode.<stage>" under torch.profiler with nothing synchronized
    between the stages: its host ms and the device ms of the operations
    launched inside it, per encode (the mean of 3 after a warm-up; the
    first row is the whole "encode.shard", its device ms what it launches
    outside its stages): tokenize, token_fields,
    tile_histograms, block_plan, block_histograms, huffman_codes (the
    11-bit and 7-bit builds together), tree_rle, clen_histogram,
    bit_costs, code_tables, header_items, sub_entries (the stride, from
    the tile histograms), pack_words (the token items, layout, offsets,
    words, stored payloads and decode entries: one memset and one launch
    of the kernel);
  * the block stage's and back end's ops (block_plan, huffman_codes at 11
    and 7 bits, pack_words) on the inputs that encode handed them, each
    beside its plain version on the same inputs on the card, and
    block_plan's DP loop in clock64 cycles a step;
  * some stages run alone on inputs of the main-path shapes (tokenize is
    the find_matches and lz_parse kernels with the packed hand-off, timed
    alone beside their int64 calls; their plain versions, which the card
    never runs on the encode path, are timed beside them as context), each
    with the device memory its call allocated at its peak;
then the torch.profiler table of device time by operator over N encodes,
and the device busy share of that window. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .corpus import block_stage_inputs, build_corpus
from .core import huffman, lz77
from .format.deflate import encode_shard
from .ops.block_plan import block_plan as block_plan_op
from .utils.logging_util import SPAN_PREFIX


def _timed(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def span_times(events, prefix: str, calls: int) -> dict:
    """{span: {"host_ms", "device_ms"}} per call of each span of the
    profile's raw `events` whose name starts with "dct/" + `prefix`: its
    host time, and the device time of the kernels, copies and memsets
    launched inside it (a device operation goes to the innermost such
    span open when the host launched it, by the launch's correlation id)."""
    spans, launched, ops = [], {}, []
    for e in events:
        name, t0 = e.name(), e.start_ns()
        if not str(e.device_type()).endswith("CPU"):
            if not e.is_user_annotation():
                ops.append((e.correlation_id(), e.duration_ns()))
        elif name.startswith(SPAN_PREFIX + prefix):
            spans.append((name[len(SPAN_PREFIX):], t0, t0 + e.duration_ns()))
        elif name.startswith("cu"):
            launched[e.correlation_id()] = t0
    out = {}
    for name, t0, t1 in spans:
        row = out.setdefault(name, {"host_ms": 0.0, "device_ms": 0.0})
        row["host_ms"] += (t1 - t0) / 1e6 / calls
    for corr, dur in ops:
        at = launched.get(corr)
        inside = [(t1 - t0, n) for n, t0, t1 in spans
                  if at is not None and t0 <= at < t1]
        if inside:
            out[min(inside)[1]]["device_ms"] += dur / 1e6 / calls
    return out


def stage_times(x: torch.Tensor, valid_len: int, reps: int = 3) -> dict:
    """Host and device ms of each stage of encode_shard(x) per encode,
    from the stage spans of `reps` encodes under torch.profiler after a
    warm-up (span_times); nothing is synchronized between the stages."""
    encode_shard(x, valid_len, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            encode_shard(x, valid_len, True)
        torch.cuda.synchronize()
    return span_times(prof.profiler.kineto_results.events(), "encode.",
                      reps)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--shard-size", type=int, default=1 << 20)
    args = ap.parse_args()
    shard = args.shard_size
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    raw = np.frombuffer(build_corpus(args.shards * shard), np.uint8)
    shards = [torch.from_numpy(raw[i * shard:(i + 1) * shard].copy()).cuda()
              for i in range(args.shards)]
    x = shards[0]
    nb = shard // 32768

    def row(name, ms, peak=None):
        tail = ("" if peak is None else
                f", peak {peak:9.1f} MiB above the inputs")
        print(f"{name:28s} {ms:9.3f} ms (host clock, best of 3){tail}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    row("encode_shard", _timed(lambda: encode_shard(x, shard, True)),
        (torch.cuda.max_memory_allocated() - base) / 2**20)
    for name, t in stage_times(x, shard).items():
        print(f"  {name:26s} {t['host_ms']:9.3f} ms host, "
              f"{t['device_ms']:9.3f} ms device (spans, mean of 3)")
    for name, (op, ref, a, k) in block_stage_inputs(x, shard).items():
        row(name, _timed(lambda: op(*a, **k)))
        row(f"plain {name}", _timed(lambda: ref(*a, **k)))
        if name == "block_plan":
            st = {}
            block_plan_op(*a, **k, stats=st)
            M = a[0].shape[0]
            print(f"{'  its DP loop':28s} {int(st['dp_cycles']) / M:9.1f} "
                  f"cycles a step (clock64, {M} steps)")

    lens, dists = lz77.find_matches(x)
    packed = lz77.find_matches_packed(x)
    tok_len = torch.where(lens >= 3, lens, 1)
    sym = torch.where(lens >= 3, 257 + lens % 29, x.long()).view(nb, -1)
    rows = {
        "tokenize": lambda: lz77.tokenize(x, shard),
        "find_matches": lambda: lz77.find_matches(x),
        "lz_parse": lambda: lz77.lz_parse(x, lens, dists, shard),
        "find_matches pack": lambda: lz77.find_matches_packed(x),
        "lz_parse packed": lambda: lz77.lz_parse_packed(x, packed, shard),
        "plain find_matches": lambda: lz77.find_matches_ref(x),
        "plain lz_parse": lambda: lz77.lz_parse_ref(x, lens, dists, shard),
        "greedy_parse": lambda: lz77.greedy_parse(tok_len),
        "tile_hist x2": lambda: (huffman.histogram_rows(sym, 286),
                                 huffman.histogram_rows(sym, 30)),
    }
    for name, fn in rows.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = _timed(fn)
        row(name, ms, (torch.cuda.max_memory_allocated() - base) / 2**20)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in shards:
            encode_shard(s, shard, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    print(f"window: {args.shards} shards in {wall * 1e3:.3f} ms host clock; "
          f"device time {dev_us / 1e3:.3f} ms; busy share "
          f"{dev_us / 1e6 / wall:.4f}")
    print(evs.table(sort_by="self_device_time_total", row_limit=30,
                    max_name_column_width=60))


if __name__ == "__main__":
    main()
