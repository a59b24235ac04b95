"""The gzip cells' control: the plain reference put in the port's place with
one of the configuration's guarantees broken, run through the harness's
own window and `check()`; it must come out not correct.

In place of `decompress_gzip_indexed`, CPython's zlib inflates the body and
the CRC-32 that the verified decode states is chained from group to group
as the port chains it, but carried in float32, the nearest precision below
its 32-bit register (the step a faster checksum would tempt): the footer
check then refuses sound members (`verdict_wrong`).

    python3 -m portbench.control_gzip --workload <cell> --seed <n> [<n> ...]

runs the control at the cell's own size, one pass over the objects for
each seed (the members made and cached where the cache lacks them), and
prints one JSON line a seed. The benchmark's runs do not run it.
`control.py` holds the other cells' controls.
"""
from __future__ import annotations

import argparse
import json
import sys
import zlib

import numpy as np


def crc32_f32(data, group: int) -> int:
    """zlib.crc32 of `data`, chained over pieces of `group` bytes with the
    running value carried in float32 between them."""
    crc = np.float32(0)
    mv = memoryview(data)
    for at in range(0, len(mv), group):
        crc = np.float32(zlib.crc32(mv[at:at + group], int(crc)))
    return int(crc)


def _gzip(member, index, shard_out=1 << 20, device=None):
    from deflate_compression_tpu_torch.decode.index import DeflateError
    from deflate_compression_tpu_torch.format.containers import \
        gzip_parse_header
    d = zlib.decompressobj(-15)
    out = d.decompress(memoryview(member)[gzip_parse_header(member):])
    if crc32_f32(out, shard_out) != int.from_bytes(member[-8:-4], "little"):
        raise DeflateError("E_ADLER", "control: float32 crc32 mismatch")
    if len(out) & 0xFFFFFFFF != int.from_bytes(member[-4:], "little"):
        raise DeflateError("E_SIZE", "control: ISIZE mismatch")
    return out


def control(workload: str, seed: int, dev="cuda", scale: int = 1,
            overrides: dict | None = None, cache_root=None) -> dict:
    """One pass of the cell with the control in place; the run's result
    (its `check` holds the numbers compared)."""
    import importlib
    from .run import load_cell, run
    idx = importlib.import_module("deflate_compression_tpu_torch.decode."
                                  "index")
    entry = load_cell(workload)[3]["entry"]
    cls = importlib.import_module(f"portbench.entries.{entry}").Entry
    warm, orig = cls.warm_up, idx.decompress_gzip_indexed

    def warm_up(self, k):      # the control may refuse a sound member
        try:
            warm(self, k)
        except Exception:
            pass
    cls.warm_up, idx.decompress_gzip_indexed = warm_up, _gzip
    try:
        return run(workload, seed, 0, False, device=dev, scale=scale,
                   overrides=overrides, cache_root=cache_root)[0]
    finally:
        cls.warm_up, idx.decompress_gzip_indexed = warm, orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the gzip cells' control")
    ap.add_argument("--workload", default="gzip9.gzip_indexed_decode")
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for s in args.seed:
        res = control(args.workload, s)
        print(json.dumps({"workload": args.workload, "seed": s,
                          "control": {k: v["value"] for k, v in
                                      res["check"].items()},
                          "attempted": res["attempted"],
                          "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
