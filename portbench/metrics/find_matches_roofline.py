"""find_matches' share of its roofline: 5 B a position over 3.35 TB/s,
over the device time of everything the call launches (hash, sort, links,
walk)."""
from portbench.metrics import bounds

P = "deflate_compression_tpu_torch."
SPANS = {"find_matches": P + "core.lz77:find_matches_packed"}
CAPTURE = {"find_matches": lambda a, k: int(a[0].shape[0])}


def read(t):
    ns = t.device_ns("find_matches", expect=("find_matches",))
    sizes = t.captured.get("find_matches", [])
    if ns is None or not sizes or None in sizes:
        return None
    return bounds.roofline_pct(sum(map(bounds.find_matches_bytes, sizes)),
                               ns / 1e9)
