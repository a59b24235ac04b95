"""Where one shard's encode spends its time on the card.

    python3 -m deflate_compression_tpu_torch.profile_encode [--shards N]
        [--shard-size BYTES]

Prints host-clock times (each ending in torch.cuda.synchronize()) of the
whole encode_shard and of some of its stages run alone on inputs of the
main-path shapes (tokenize is the find_matches and lz_parse kernels with
the packed hand-off, timed alone beside their int64 calls; their plain
versions, which the card never runs on the encode path, are timed beside
them as context), each with the device memory its call allocated
at its peak, then the torch.profiler table of device time by operator over
N encodes, and the device busy share of that window. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .corpus import build_corpus
from .core import huffman, lz77
from .core.cost import block_plan
from .format.deflate import encode_shard

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
    lens, dists = lz77.find_matches(x)
    packed = lz77.find_matches_packed(x)
    tok_len = torch.where(lens >= 3, lens, 1)
    sym = torch.where(lens >= 3, 257 + lens % 29, x.long()).view(nb, -1)
    ll = huffman.histogram_rows(sym, 286)
    dd = huffman.histogram_rows(lens.view(nb, -1) % 30, 30)
    freqs = torch.cat([ll, ll], 0)
    rows = {
        "encode_shard": lambda: encode_shard(x, shard, True),
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
        "block_plan": lambda: block_plan(ll, dd, nb, torch.full((nb,), 32768,
                                                                device=x.device)),
        "code_lengths": lambda: huffman.huffman_code_lengths(freqs, 11),
    }
    for name, fn in rows.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = _timed(fn)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"{name:18s} {ms:9.3f} ms (host clock, best of 3), "
              f"peak {peak:9.1f} MiB above the inputs")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in shards:
            encode_shard(s, shard, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"window: {args.shards} shards in {wall * 1e3:.3f} ms host clock; "
          f"device time {dev_us / 1e3:.3f} ms; busy share "
          f"{dev_us / 1e6 / wall:.4f}")
    print(evs.table(sort_by="self_device_time_total", row_limit=30,
                    max_name_column_width=60))


if __name__ == "__main__":
    main()
