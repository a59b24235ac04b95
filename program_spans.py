"""One traced run of a benchmark cell, read with the port's own spans and
counter beside the benchmark's readings.

    python3 program_spans.py --workload <cell> --seed <n> --seconds <s>
        [--out FILE] [--device cpu --scale N]

Runs the cell as `python3 -m portbench.run ... --trace 1` does and prints
its result line, then reads the same window again as the benchmark will
once `portbench/trace.py` takes the port's "dct/" spans and
`portbench/run.py` a reader's `COUNTERS` (PERF.md, open questions):

  * the port's readers (`portbench/metrics/`, PROGRAM below) on a Trace
    with the port's spans and the counters' differences over the window
    (`portbench/metrics/program.py::program_trace`; a counter is read
    where the window starts and ends: before the benchmark's wrappers go
    in and after they come out, since it stays on the port's function);
  * how much of the benchmark's outside readings the port's spans account
    for: the `codec.*` spans against `codec.self_ms_per_MB`, the indexed
    decode's group spans against `decompress_indexed.self_ms_per_MB`, the
    counter against `h2d_bytes_per_byte.indexed`, and `dct/encode.shard`
    against the benchmark's `encode_shard` span;
  * each port span's calls, host ms a MB and the device ms a MB launched
    inside it, and the host-to-device copies launched inside it; the
    breakdown's longest idle gaps named by the innermost
    port span or torch operation at their middle; and the share of the
    window's idle time inside each of the spans that hold most of it.

The last line is one JSON object; `--out` writes it to a file as well.
Needs a CUDA card; `--device cpu` with a `--scale` rehearses on the CPU
(no device operations, so no idle time).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from portbench import run, spans as spans_mod, trace
from portbench.metrics import program

PROGRAM = {
    "pigz_i_b4096.bulk_encode": [
        "codec.upload.host_ms_per_MB", "codec.wait.host_ms_per_MB",
        "codec.unpack.host_ms_per_MB", "codec.adler32.host_ms_per_MB",
        "encode_shard.glue.host_ms_per_MB"],
    "pigz_i_b1024.indexed_decode": [
        "decompress_indexed.upload.host_ms_per_MB",
        "decompress_indexed.wait.host_ms_per_MB",
        "decompress_indexed.upload_bytes_per_byte"],
    "pigz_i_b4096.device_decode": ["decode.glue.device_ms_per_MB"],
}
CODEC = ("codec.upload", "codec.wait", "codec.unpack", "codec.adler32",
         "codec.wrap")
GROUP = ("index.group", "index.upload", "index.wait", "index.adler32",
         "index.copy_back", "index.window")
SMALL = {"shard_size": 32768, "decode_group_bytes": 32768}


def traced_run(cell: str, seed: int, seconds: float, counters: dict,
               **kw) -> tuple[dict, dict]:
    """run.run with --trace 1; returns its result and what the window
    left: the raw events, the MB, the captured arguments, the copies'
    sizes and each counter's difference over the window."""
    kept = {}
    base_trace, base_spans = trace.Trace, spans_mod.Spans

    class Keep(base_trace):
        def __init__(self, events, mb, captured, copies=None):
            events = list(events)
            kept.update(events=events, mb=mb, captured=captured,
                        copies=copies)
            super().__init__(events, mb, captured, copies)

    class Count(base_spans):
        def __init__(self, *a):
            self.at_start = {k: program.counter(v)
                             for k, v in counters.items()}
            super().__init__(*a)

        def restore(self):
            super().restore()
            kept["counters"] = {
                k: program.counter(v) - self.at_start[k]
                for k, v in counters.items()
                if self.at_start[k] is not None}

    trace.Trace, spans_mod.Spans = Keep, Count
    try:
        res, _ = run.run(cell, seed, seconds, True, **kw)
    finally:
        trace.Trace, spans_mod.Spans = base_trace, base_spans
    return res, kept


def idle_in_spans(t) -> dict:
    """Per cent of the window's idle time inside each port span."""
    inside = (t.dev_t1 > t.w0) & (t.dev_t0 < t.w1)
    t0 = np.clip(t.dev_t0[inside], t.w0, t.w1)
    t1 = np.clip(t.dev_t1[inside], t.w0, t.w1)
    order = np.argsort(t0)
    t0, t1 = t0[order], np.maximum.accumulate(t1[order])
    g0 = np.concatenate([[t.w0], t1])
    g1 = np.concatenate([t0, [t.w1]])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    total = int((g1 - g0).sum())
    if not total:
        return {}
    before = np.concatenate([[0], np.cumsum(g1 - g0)])

    def idle_before(x):                 # idle ns in [w0, x)
        k = np.searchsorted(g0, x, side="right") - 1
        ok = k >= 0
        out = np.zeros(x.shape, np.int64)
        out[ok] = before[k[ok]] + np.clip(x[ok] - g0[k[ok]], 0,
                                          (g1 - g0)[k[ok]])
        return out

    return {name: 100.0 * int((idle_before(iv[:, 1])
                               - idle_before(iv[:, 0])).sum()) / total
            for name, iv in t.spans.items()
            if name.startswith(program.PORT_PREFIX)}


def read_program(cell: str, res: dict, kept: dict) -> dict:
    t = program.program_trace(kept["events"], kept["mb"], kept["captured"],
                              kept["copies"], kept.get("counters"))
    out = {"metrics": {}, "counters": t.counters}
    for name in PROGRAM.get(cell, []):
        out["metrics"][name] = run.load_reader(name).read(t)
    layer = {k: v["value"] for k, v in res["metrics"].items()}

    def share(names, whole):
        if not whole or not t.mb:
            return None
        return sum(t.span_ns("dct/" + n) for n in names) / 1e6 / t.mb \
            / whole
    out["accounting"] = {
        "codec_spans_over_codec_self": share(
            CODEC, layer.get("codec.self_ms_per_MB")),
        "group_spans_over_decompress_indexed_self": share(
            GROUP, layer.get("decompress_indexed.self_ms_per_MB")),
        "group_and_join_over_decompress_indexed_self": share(
            GROUP + ("index.join",),
            layer.get("decompress_indexed.self_ms_per_MB")),
        "encode_shard_span_over_wrapper": (
            t.span_ns("dct/encode.shard") / t.span_ns("encode_shard")
            if t.calls("encode_shard") else None),
        "upload_bytes_over_h2d": (
            out["metrics"]["decompress_indexed.upload_bytes_per_byte"]
            / layer["h2d_bytes_per_byte.indexed"]
            if out["metrics"].get("decompress_indexed.upload_bytes_per_byte")
            and layer.get("h2d_bytes_per_byte.indexed") else None),
    }
    out["spans"] = {
        name: {"calls": t.calls(name),
               "host_ms_per_MB": t.span_ns(name) / 1e6 / t.mb,
               "device_ms_per_MB": (t.device_ns(name) or 0) / 1e6 / t.mb}
        for name in sorted(t.spans) if name.startswith("dct/")}
    copies = {name: sum(op.startswith("Memcpy HtoD")
                        for op, _ in t.device_ops(name))
              for name in sorted(t.spans) if name.startswith("dct/")}
    out["htod_copies_in_spans"] = {k: n for k, n in copies.items() if n}
    idle = idle_in_spans(t)
    out["idle_share_in_spans"] = dict(sorted(
        idle.items(), key=lambda kv: -kv[1])[:8])
    out["breakdown"] = t.breakdown()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1)
    args = ap.parse_args(argv)
    run.bytecode_cache()
    counters = {}
    for name in PROGRAM.get(args.workload, []):
        counters.update(getattr(run.load_reader(name), "COUNTERS", {}))
    kw = {} if args.device == "cuda" else {
        "device": args.device, "scale": args.scale, "overrides": SMALL}
    res, kept = traced_run(args.workload, args.seed, args.seconds, counters,
                           **kw)
    print(json.dumps(res), flush=True)
    line = {"workload": args.workload, "seed": args.seed,
            "card": run.power_limit() if args.device == "cuda" else "cpu",
            **read_program(args.workload, res, kept)}
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
