"""Reading a traced window: the profiler's events as arrays, the spans
that `spans.py` recorded, and each device operation given to the span
whose host call launched it.

The profiler gives every device operation (kernel, copy, memset) the
correlation id of the CUDA API call (`cuda*` or `cu*`) that launched it, and
that call its time on the host thread; a hand kernel launched through
ctypes is found so as well as a torch kernel. An operation belongs to a
span when its launch lies inside one of the span's intervals. Everything
here reads the profiler's raw event list once, which stays fast for the
million events of a window.

The raw events carry no byte count of a copy; `copy_bytes` reads it from
the profiler's exported trace, where a reader asks for it.
"""
from __future__ import annotations

import re

import numpy as np

SPAN_PREFIX = "pb/"
WINDOW = "pb.window"


def _fields(e) -> tuple:
    """(kind, name, start ns, duration ns) of a raw profiler event, kind
    one of "host" (a torch operation or a span), "launch" (a CUDA runtime
    API call), "device" (a kernel, copy or memset) or None (the
    profiler's own events, and a span's shadow on the device)."""
    name = e.name()
    if hasattr(e, "start_ns"):
        t0, dur = e.start_ns(), e.duration_ns()
    else:
        t0, dur = e.start_us() * 1000, e.duration_us() * 1000
    if str(e.device_type()).endswith("CPU"):
        if name.startswith(("aten::", SPAN_PREFIX)) or name == WINDOW:
            return "host", name, t0, dur
        return ("launch" if name.startswith("cu") else None), name, t0, dur
    return (None if e.is_user_annotation() else "device"), name, t0, dur


class Trace:
    """One traced window. `mb` is the megabytes (10^6 bytes) the window's
    calls moved, `captured` what the span wrappers kept of their calls'
    arguments (name -> list)."""

    def __init__(self, events, mb: float, captured: dict,
                 copies: dict | None = None):
        self.mb = mb
        self.captured = captured
        self.copies = copies
        host_t0, host_t1, host_name = [], [], []
        dev_t0, dev_t1, dev_name, dev_corr = [], [], [], []
        launched = {}
        for e in events:
            kind, name, t0, dur = _fields(e)
            if kind == "launch":
                launched[e.correlation_id()] = t0
            elif kind == "host":
                host_t0.append(t0)
                host_t1.append(t0 + dur)
                host_name.append(name)
            elif kind is not None:
                dev_t0.append(t0)
                dev_t1.append(t0 + dur)
                dev_name.append(name)
                dev_corr.append(e.correlation_id())
        self.host_t0 = np.array(host_t0, np.int64)
        self.host_t1 = np.array(host_t1, np.int64)
        self.host_name = host_name
        self.dev_t0 = np.array(dev_t0, np.int64)
        self.dev_t1 = np.array(dev_t1, np.int64)
        self.dev_name = np.array(dev_name, object)
        self.dev_corr = np.array(dev_corr, np.int64)
        # when each device operation was launched, on the host's clock
        self.dev_launch = np.array([launched.get(c, -1) for c in dev_corr],
                                   np.int64)
        self.spans = {}
        for name, t0, t1 in zip(host_name, host_t0, host_t1):
            if name.startswith(SPAN_PREFIX) or name == WINDOW:
                self.spans.setdefault(name.removeprefix(SPAN_PREFIX),
                                      []).append((t0, t1))
        self.spans = {k: np.array(sorted(v), np.int64).reshape(-1, 2)
                      for k, v in self.spans.items()}
        w = self.spans.get(WINDOW)
        if w is None or not len(w):
            raise RuntimeError("the traced window's span is missing")
        self.w0, self.w1 = int(w[0, 0]), int(w[-1, 1])
        inside = (self.dev_t1 > self.w0) & (self.dev_t0 < self.w1)
        self._busy = _union_ns(np.clip(self.dev_t0[inside], self.w0, self.w1),
                               np.clip(self.dev_t1[inside], self.w0, self.w1))

    # --------------------------------------------------------------- spans
    def span_ns(self, name: str) -> int:
        """Host nanoseconds inside the span, summed over its calls."""
        iv = self.spans.get(name)
        return 0 if iv is None else int((iv[:, 1] - iv[:, 0]).sum())

    def calls(self, name: str) -> int:
        iv = self.spans.get(name)
        return 0 if iv is None else len(iv)

    def _in_spans(self, names, times) -> np.ndarray:
        hit = np.zeros(times.shape, bool)
        for name in names:
            iv = self.spans.get(name)
            if iv is None or not len(iv):
                continue
            k = np.searchsorted(iv[:, 0], times, side="right") - 1
            ok = k >= 0
            hit[ok] |= times[ok] < iv[k[ok], 1]
        return hit

    def device_ops(self, *names) -> list[tuple[str, int]]:
        """(name, device ns) of every device operation launched inside any
        of the spans `names`."""
        sel = self._in_spans(names, self.dev_launch) & (self.dev_launch >= 0)
        return list(zip(self.dev_name[sel].tolist(),
                        (self.dev_t1 - self.dev_t0)[sel].tolist()))

    def device_ns(self, *names, expect=()) -> int | None:
        """Device nanoseconds launched inside the spans `names`; None where
        no operation was found or a kernel whose name holds one of `expect`
        is missing (the launch correlation did not reach it)."""
        ops = self.device_ops(*names)
        if not ops or any(not any(x in n for n, _ in ops) for x in expect):
            return None
        return sum(t for _, t in ops)

    def copy_bytes(self, direction: str, *names) -> int | None:
        """Bytes of the copies of `direction` ("HtoD", "DtoH", ...) launched
        inside the spans `names`, from the exported trace; None where the
        byte counts were not read or a copy of the window has none."""
        if self.copies is None:
            return None
        sel = self._in_spans(names, self.dev_launch) & (self.dev_launch >= 0)
        total = 0
        for name, corr in zip(self.dev_name[sel], self.dev_corr[sel]):
            if name.startswith("Memcpy " + direction):
                got = self.copies.get(int(corr))
                if got is None:
                    return None
                total += got
        return total

    # -------------------------------------------------------------- device
    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return self._busy / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, and
        the longest idle gaps, each named by the innermost host operation
        running at its middle."""
        inside = (self.dev_t0 >= self.w0) & (self.dev_t0 < self.w1)
        tot = {}
        for n, t in zip(self.dev_name[inside],
                        (self.dev_t1 - self.dev_t0)[inside]):
            tot[n] = tot.get(n, 0) + int(t)
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        t0 = np.clip(self.dev_t0[inside], self.w0, self.w1)
        t1 = np.clip(self.dev_t1[inside], self.w0, self.w1)
        if t0.size:
            order = np.argsort(t0)
            t0, t1 = t0[order], np.maximum.accumulate(t1[order])
            g0 = np.concatenate([[self.w0], t1])
            g1 = np.concatenate([t0, [self.w1]])
            for i in np.argsort(g0 - g1)[:top]:
                if g1[i] <= g0[i]:
                    break
                mid = (g0[i] + g1[i]) // 2
                cover = (self.host_t0 <= mid) & (self.host_t1 >= mid)
                name = "idle"
                if cover.any():
                    j = np.flatnonzero(cover)
                    j = j[np.argmin((self.host_t1 - self.host_t0)[j])]
                    name = self.host_name[j].removeprefix(SPAN_PREFIX)
                gaps.append([name, (g1[i] - g0[i]) / 1e9])
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": gaps}


def idle_share(t: Trace) -> float | None:
    """Per cent of the traced window in which no operation ran on the
    card: the reading of every `device.idle_share.*` metric."""
    if not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _union_ns(t0: np.ndarray, t1: np.ndarray) -> int:
    """Length of the union of the intervals [t0, t1)."""
    if not t0.size:
        return 0
    order = np.argsort(t0)
    t0, t1 = t0[order], t1[order]
    reach = np.maximum.accumulate(t1)
    prev = np.concatenate([[t0[0]], reach[:-1]])
    return int((np.maximum(reach, t0) - np.maximum(prev, t0)).clip(0).sum())


def events(prof):
    """The profiler's raw event list after the profile has stopped."""
    return prof.profiler.kineto_results.events()


_COPY = re.compile(
    rb'"cat":\s*"gpu_memcpy",\s*"name":\s*"Memcpy[^"]*"[^{}]*'
    rb'"args":\s*\{[^{}]*?"correlation":\s*(\d+)[^{}]*?"bytes":\s*(\d+)')


def copy_sizes(prof, where) -> dict:
    """Correlation id -> bytes of every copy in the profile, from the trace
    the profiler exports (written to `where`, then deleted): the raw
    events give a copy's time but not its size."""
    from pathlib import Path
    path = Path(where) / "trace.json"
    try:
        prof.export_chrome_trace(str(path))
        text = path.read_bytes()
    finally:
        path.unlink(missing_ok=True)
    return {int(c): int(b) for c, b in _COPY.findall(text)}
