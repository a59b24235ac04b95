"""Timing helpers for the port's kernels on a CUDA card: per call between
two CUDA events, on the device per launch with the calls queued behind a
spin kernel, and by kernel name under torch.profiler. chip_smoke.py and
kernel_turns.py time with these; the codec does not use them."""
from __future__ import annotations

import numpy as np
import torch


def _event():
    return torch.cuda.Event(enable_timing=True)


def cuda_ms(fn, reps: int = 25) -> float:
    """Per-call time: the median milliseconds of one fn() between two CUDA
    events, after a warm-up. For a call of a few microseconds of device
    work this is the host's enqueue time as much as the device's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = _event(), _event()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _spin(ms: float) -> None:
    """Hold the current stream for about `ms` milliseconds."""
    if not hasattr(_spin, "cycles_per_ms"):
        a, b = _event(), _event()
        torch.cuda._sleep(1_000_000)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        _spin.cycles_per_ms = 10_000_000 / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * _spin.cycles_per_ms))


def device_ms(fn, n: int):
    """Milliseconds per call from one CUDA event pair around n back-to-back
    calls, after a warm-up. A spin kernel first holds the stream while the
    host queues the n calls, so the pair times the device's work and the
    gaps between launches, not the host's enqueue; the spin grows until the
    device is still in it when the last call is queued. Returns (ms, held):
    held is False where fn waits for the device itself (an .item() inside),
    so nothing can be queued ahead and the pair times host and device."""
    fn()
    torch.cuda.synchronize()
    _spin(50.0)
    c = _event()
    c.record()
    fn()
    held = not c.query()            # fn returned while the spin still ran
    torch.cuda.synchronize()
    spin = 5.0
    while True:
        a, b = _event(), _event()
        if held:
            _spin(spin)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        covered = not a.query()
        b.synchronize()
        if covered or not held:
            return a.elapsed_time(b) / n, held
        if spin > 2000:
            raise AssertionError("device_ms: the host did not queue the run "
                                 "within a 2 s spin")
        spin *= 4


def profiled_ms(fn, n: int) -> dict:
    """Device milliseconds per call by kernel name, summed over a
    torch.profiler window of n calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.self_device_time_total / 1e3 / n
    return by
