"""Per-layer metrics: one reader a metric, `<name>.py`, found by the
metric's name in BENCHMARK.json. A reader may name `SPANS` (span name ->
"module:attribute" of the port, wrapped in traced runs) and `CAPTURE`
(span name -> a function of the call's positional and keyword arguments
whose result is kept), and has `read(trace)`, which returns the metric's
value or None where it finds nothing to read. `bounds.py` holds the
roofline arithmetic."""
