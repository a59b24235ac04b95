"""The controls: the plain reference put in the port's place with one of
the configuration's guarantees broken, run through the harness's own
window and `check()`. Each must come out not correct.

- encode cells: `ZlibCodec.compress` replaced by zlib level 6 over the
  whole object, one stream with one window across the shard boundaries
  (pigz without -i): it breaks the independent blocks, so
  `shards_not_independent` reads every boundary;
- decode cells: the bytes decoded by zlib, with the Adler-32 that the
  verified decode states taken in float32, the nearest precision below
  its integer arithmetic (the step a faster checksum would tempt), in
  place of `decompress_indexed` (which then refuses sound streams:
  `verdict_wrong`) and of the device decode's call (whose per-shard
  Adler-32 then reads wrong: `adler_wrong`, `verdict_wrong`).

    python3 -m portbench.control --workload <cell> --seed <n> [<n> ...]

runs a cell's control at the cell's own size, one pass over the objects
for each seed (the decode cells' cached streams, made by the port's
encoder where the cache lacks them), and prints one JSON line a seed.
The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import zlib

import torch
import torch.nn.functional as F

NMAX = 5552
MOD = 65521


def adler32_f32(data: torch.Tensor) -> int:
    """Adler-32 of a u8 tensor by adler32_torch's chunked formula, every
    sum in float32, on the tensor's device."""
    n = data.shape[0]
    nch = max(1, -(-n // NMAX))
    d = F.pad(data.to(torch.float32), (0, nch * NMAX - n)).view(nch, NMAX)
    m = (n - torch.arange(nch, device=d.device) * NMAX).clamp(0, NMAX) \
        .to(torch.float32)
    w = torch.arange(NMAX, device=d.device, dtype=torch.float32)
    csum = d.sum(1)
    wsum = ((m[:, None] - w[None, :]) * d).sum(1)
    a_before = (1 + torch.cumsum(csum, 0) - csum) % MOD
    b = (m * a_before + wsum).sum() % MOD
    a = (1 + csum.sum()) % MOD
    return (int(b) << 16) | int(a)


def _inflate(body: bytes) -> bytes:
    d = zlib.decompressobj(-15)
    return d.decompress(body) + d.flush()


def _u8(b: bytes, dev) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)


def _encode(self, data) -> bytes:
    return zlib.compress(bytes(data), 6)


def _indexed(data, index, shard_out=None, expected_adler=None,
             device=None, **_):
    from deflate_compression_tpu_torch.decode.index import DeflateError
    out = _inflate(bytes(data))
    if expected_adler is not None and adler32_f32(
            _u8(out, device or "cpu")) != expected_adler & 0xFFFFFFFF:
        raise DeflateError("E_ADLER", "control: float32 adler mismatch")
    return out


def _device(self, b):
    out = _inflate(b["body"])
    nsh, S = len(b["valid"]), self.S
    m = min(len(out), nsh * S)
    t = torch.zeros(nsh * S, dtype=torch.uint8, device=self.dev)
    t[:m] = _u8(out[:m], self.dev)
    t = t.view(nsh, S)
    ad = torch.tensor([adler32_f32(t[s, :v]) for s, v in
                       enumerate(b["valid"])], device=self.dev)
    ok = torch.tensor(True, device=self.dev)
    return {"out": t, "ok": ok}, ad, bool((ad == b["want"]).all())


@contextlib.contextmanager
def in_place(entry: str):
    """The control put in the timed path's place for a traffic entry."""
    import importlib
    if entry == "encode":
        owner = importlib.import_module(
            "deflate_compression_tpu_torch.models.codec").ZlibCodec
        attr, repl = "compress", _encode
    elif entry == "indexed_decode":
        owner = importlib.import_module(
            "deflate_compression_tpu_torch.decode.index")
        attr, repl = "decompress_indexed", _indexed
    else:
        owner = importlib.import_module(
            "portbench.entries.device_decode").Entry
        attr, repl = "_decode", _device
    orig = owner.__dict__[attr] if isinstance(owner, type) \
        else getattr(owner, attr)
    setattr(owner, attr, repl)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def control(workload: str, seed: int, dev="cuda", scale: int = 1,
            overrides: dict | None = None, cache_root=None) -> dict:
    """One pass of the cell with the control in place; the run's result
    (its `check` holds the numbers compared)."""
    import importlib
    from .run import load_cell, run
    entry = load_cell(workload)[3]["entry"]
    cls = importlib.import_module(f"portbench.entries.{entry}").Entry
    warm = cls.warm_up

    def warm_up(self, k):      # the control may refuse a sound stream
        try:
            warm(self, k)
        except Exception:
            pass
    cls.warm_up = warm_up
    try:
        with in_place(entry):
            return run(workload, seed, 0, False, device=dev, scale=scale,
                       overrides=overrides, cache_root=cache_root)[0]
    finally:
        cls.warm_up = warm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for s in args.seed:
        res = control(args.workload, s)
        print(json.dumps({"workload": args.workload, "seed": s,
                          "control": {k: v["value"] for k, v in
                                      res["check"].items()},
                          "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
