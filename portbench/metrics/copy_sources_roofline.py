"""copy_sources' share of its roofline (decoder phase C): 4 B of token
read and 1 B written a position of the flat decode and each stored byte
read, over 3.35 TB/s, over the device time resolve_bytes launches."""
from portbench.metrics import bounds

P = "deflate_compression_tpu_torch."
SPANS = {"resolve_bytes": P + "ops.copy_sources:resolve_bytes"}
# (positions, blk_out, blk_end, blive, is_sto)
CAPTURE = {"resolve_bytes": lambda a, k: (int(a[7]), a[3], a[4], a[5],
                                          a[6])}


def read(t):
    ns = t.device_ns("resolve_bytes", expect=("copy_sources",))
    calls = t.captured.get("resolve_bytes", [])
    if ns is None or not calls or None in calls:
        return None
    nbytes = 0
    for n, out, end, live, sto in calls:
        keep = (live & sto).cpu().numpy()
        span = (end - out).cpu().numpy()
        nbytes += bounds.copy_sources_bytes(n, int(span[keep].sum()))
    return bounds.roofline_pct(nbytes, ns / 1e9)
