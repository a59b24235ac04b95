"""pack_words' share of its roofline: the bytes each call must move,
counted on its own arguments (bounds.pack_words_bytes), over the device
time of its memset and kernel."""
from portbench.metrics import bounds

P = "deflate_compression_tpu_torch."
SPANS = {"pack_words": P + "format.deflate:pack_words"}
# (S, words, each tile's block, huff, stored, blen, ll and d tables, nbs)
CAPTURE = {"pack_words": lambda a, k: (int(a[0].shape[0]), int(a[15]), a[4],
                                       a[6], a[7], a[8], a[9], a[10], a[12])}


def read(t):
    ns = t.device_ns("pack_words", expect=("pack_words",))
    calls = t.captured.get("pack_words", [])
    if ns is None or not calls or None in calls:
        return None
    nbytes = sum(bounds.pack_words_bytes(S, nw, *(x.cpu().numpy()
                                                  for x in rest))
                 for S, nw, *rest in calls)
    return bounds.roofline_pct(nbytes, ns / 1e9)
