"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding `BENCHMARK.json`. The cell names a
configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`, whose "entry" picks `entries/<entry>.py`); each
per-layer metric is read by `metrics/<name>.py`. Set-up is stamped in five
parts, printed on an earlier line: (a) interpreter and imports (their
bytecode cached in `cache/pyc`), (b) the CUDA context, (c) the objects
from the seed, (d) the decode cells' cached streams, (e) one warm-up call
on the smallest object. The window then
calls the entry on the objects in their fixed order from an object drawn
from the seed, for `--seconds` seconds and on to the end of the pass in
flight, so every run covers whole passes. After the window: the peak
memory, the plain reference's check, the trace's per-layer metrics
(`--trace 1`), and the last line of standard output, one JSON object.
"""
from __future__ import annotations

import time

T_ENTER = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deflate_compression_tpu")


def process_age() -> float:
    """Seconds since this process started (the interpreter's own start
    included), from /proc; 0 where it cannot be read."""
    try:
        import os
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = T_ENTER - process_age()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def load_cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """BENCHMARK.json, the cell's entry in it, its configuration and its
    traffic mix."""
    bench = load_bench(HERE.parent)
    cell = cell_of(bench, workload)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return bench, cell, cfg, traffic


def metrics_of(bench: dict, cell: str) -> tuple[set, list]:
    """The names of the cell's end-to-end metrics, and its per-layer
    metrics: those that list the cell, or list none and move one of its
    end-to-end metrics."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in e2e)]
    return e2e, layer


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", scale: int = 1, overrides: dict | None = None,
        cache_root: Path | None = None) -> tuple[dict, dict]:
    """One run; returns the result object (the last line's keys) and the
    set-up's parts in seconds. `device`, `scale` (a divisor of every
    object's size), `overrides` (configuration keys) and `cache_root`
    serve the tests on the CPU."""
    import numpy as np
    import torch

    bench, _, cfg, traffic = load_cell(workload)
    cfg.update(overrides or {})
    entry_mod = importlib.import_module(
        f"portbench.entries.{traffic['entry']}")
    from portbench import inputs
    stamps = {}
    last = [T0]

    def lap(part):
        now = time.perf_counter()
        stamps[part] = now - last[0]
        last[0] = now

    lap("a_imports")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize()
    lap("b_cuda_context")
    entry = entry_mod.Entry(cfg, traffic, dev, seed, scale, cache_root)
    entry.make_inputs()
    lap("c_inputs")
    entry.make_streams()
    lap("d_streams")
    objs = inputs.objects(traffic["objects"])
    smallest = min(range(len(objs)), key=lambda i: objs[i]["size"])
    entry.warm_up(smallest)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    lap("e_warm_up")
    setup_s = sum(stamps.values())

    e2e, layer = metrics_of(bench, workload)
    spans = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from portbench.spans import Spans
        from portbench.trace import WINDOW
        readers = {m["name"]: load_reader(m["name"]) for m in layer}
        want_spans, capture = {}, {}
        for r in readers.values():
            want_spans.update(getattr(r, "SPANS", {}))
            capture.update(getattr(r, "CAPTURE", {}))
        spans = Spans(want_spans, capture)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()

    rng = np.random.default_rng([int(seed) & (2**63 - 1), 1])
    k = start = int(rng.integers(len(objs)))
    failed = moved = 0
    first_error = None
    ctx = record_function(WINDOW) if trace else None
    if ctx is not None:
        ctx.__enter__()
    cpu0 = time.thread_time(), time.process_time()
    w0 = time.perf_counter()
    passes = [w0]
    while True:
        try:
            moved += entry.call(k)
        except Exception as e:            # a call that fails is counted
            failed += 1
            entry.results.append((k, e))
            first_error = first_error or traceback.format_exc()
        k = (k + 1) % len(objs)
        if k == start:
            passes.append(time.perf_counter())
            if passes[-1] - w0 >= seconds:
                break
    window = passes[-1] - w0
    host = {"main_thread_cpu_s": time.thread_time() - cpu0[0],
            "process_cpu_s": time.process_time() - cpu0[1]}
    stamps_pass = [b - a for a, b in zip(passes, passes[1:])]
    if ctx is not None:
        ctx.__exit__(None, None, None)
    if prof is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        spans.restore()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if first_error:
        print(first_error, file=sys.stderr)

    metrics = {}
    if trace:
        import tempfile
        from portbench.trace import Trace, copy_sizes, events
        copies = None
        if any(getattr(r, "COPIES", False) for r in readers.values()):
            with tempfile.TemporaryDirectory() as tmp:
                copies = copy_sizes(prof, tmp)
        tr = Trace(events(prof), moved / 1e6, spans.captured, copies)
        for m in layer:
            v = readers[m["name"]].read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = entry.end_to_end(window)
        vals["setup_s"] = setup_s
        for m in bench["end_to_end"]:
            if m["name"] in e2e and m["name"] in vals:
                metrics[m["name"]] = {"value": vals[m["name"]],
                                      "unit": m["unit"]}
    numbers = entry.check()
    check = {n: {"value": v, "limit": 0} for n, v in numbers.items()}
    result = {
        "correct": failed == 0 and all(v <= 0 for v in numbers.values()),
        "attempted": len(entry.results), "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["check"] = check
    return result, {**stamps, "pass_s": stamps_pass, "host": host}


def bytecode_cache() -> None:
    """Cache the bytecode of every module the run imports in the checkout
    (`cache/pyc`, a fixed path). Where the environment turns writing it
    off (PYTHONDONTWRITEBYTECODE) and the installation ships none, every
    run would compile torch's thousand modules again: 8-12 s of set-up.
    Only a checkout's first run compiles them."""
    sys.pycache_prefix = str(HERE / "cache" / "pyc")
    sys.dont_write_bytecode = False


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bytecode_cache()
    import torch
    bench = load_bench(HERE.parent)
    chips = cell_of(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {chips} CUDA card(s) needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    res, stamps = run(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    passes = stamps.pop("pass_s")
    host = stamps.pop("host")
    print(json.dumps({"setup_parts_s": stamps,
                      "a_interpreter_s": T_ENTER - T0,
                      "pass_s": passes, "host": host,
                      "card": power_limit()}), flush=True)
    print("setup parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stamps.items()), file=sys.stderr)
    print("passes (s): " + ", ".join(f"{v:.3f}" for v in passes),
          file=sys.stderr)
    print("CPU s in the window: " + ", ".join(
        f"{k} {v:.3f}" for k, v in host.items()), file=sys.stderr)
    for name, c in res["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
