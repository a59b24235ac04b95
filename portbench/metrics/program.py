"""What the port records itself, for the readers of its spans and counter.

The port marks its layer boundaries with spans named "dct/<name>"
(`deflate_compression_tpu_torch/utils/logging_util.py`) and counts the
bytes its indexed decode hands to the card
(`decompress_indexed.upload_bytes`). `trace.py` takes only the
benchmark's own "pb/" spans and `run.py` reads no counter, so a reader of
these reads nothing in a benchmark run until a `benchmark` change admits
both (PERF.md, open questions). Meanwhile `program_trace` builds the
`Trace` such a reader reads from a traced window's raw events, as that
change would: each port span keyed by its full name, "dct/<name>", beside
the benchmark's spans, and `counters`, each counter's difference over the
window (`program_spans.py` at the checkout's root runs a cell so).
"""
from __future__ import annotations

from portbench.spans import _owner
from portbench.trace import SPAN_PREFIX, Trace

PORT_PREFIX = "dct/"
# the port's hand kernels, by a part of their names in the device trace
HAND_KERNELS = ("decode_symbols", "copy_sources", "build_tables",
                "lut_gather")


class _PortSpan:
    """A raw profiler event of a port span, named as `trace.py` takes a
    span: "pb/dct/<name>", which `Trace.spans` keys as "dct/<name>"."""

    def __init__(self, event):
        self._e = event

    def name(self):
        return SPAN_PREFIX + self._e.name()

    def __getattr__(self, attr):
        return getattr(self._e, attr)


def is_port_span(e) -> bool:
    return e.name().startswith(PORT_PREFIX) and \
        str(e.device_type()).endswith("CPU")


def program_trace(events, mb: float, captured: dict, copies=None,
                  counters: dict | None = None) -> Trace:
    """The window's Trace with the port's spans and counters in it."""
    t = Trace([_PortSpan(e) if is_port_span(e) else e for e in events], mb,
              captured, copies)
    t.counters = dict(counters or {})
    return t


def counter(target: str):
    """The value of a counter named "module:function.attribute", or None
    where the function has no such attribute (a tree before the
    counter)."""
    owner, attr = _owner(target)
    return getattr(owner, attr, None)


def host_ms_per_MB(t, name: str, less=()) -> float | None:
    """Host ms a MB in the port's span `name`, less its spans `less`; None
    where the trace holds no such span."""
    key = PORT_PREFIX + name
    if not t.calls(key) or not t.mb:
        return None
    ns = t.span_ns(key) - sum(t.span_ns(PORT_PREFIX + n) for n in less)
    return ns / 1e6 / t.mb
