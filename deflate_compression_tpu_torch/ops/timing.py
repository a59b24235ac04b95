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


def profiled_ms(fn, n: int, expect=()) -> dict:
    """Device milliseconds per call by kernel name over a torch.profiler
    window of n calls after a warm-up: each name's mean time per launch
    times its launches per call. A window lost device events where it
    holds none, or where a kernel named by a substring of `expect` is
    missing or launched a number of times that is not a multiple of n (fn
    launches it the same number of times on every call): it is taken
    again, up to three times, over twice the calls each time, and the
    window that kept the most events is used. Empty only if no window
    recorded a device event."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, best_n = {}, n
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            # a span's shadow on the device is no device work
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    not getattr(e, "is_user_annotation", False):
                ms, k = seen.get(e.name, (0.0, 0))
                seen[e.name] = (ms + e.self_device_time_total / 1e3, k + 1)
        if sum(k for _, k in seen.values()) > sum(
                k for _, k in best.values()):
            best, best_n = seen, n
        held = [k for name, (_, k) in seen.items()
                if any(w in name for w in expect)]
        if seen and all(k % n == 0 for k in held) and all(
                any(w in name for name in seen) for w in expect):
            break
        n *= 2
    return {name: ms / k * max(1, round(k / best_n))
            for name, (ms, k) in best.items()}
