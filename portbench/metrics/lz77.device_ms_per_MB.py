"""Device milliseconds a MB of input launched by the LZ77 stage
(core/lz77.py::tokenize: find_matches and lz_parse)."""
P = "deflate_compression_tpu_torch."
SPANS = {"tokenize": P + "core.lz77:tokenize"}


def read(t):
    ns = t.device_ns("tokenize", expect=("find_matches", "lz_parse"))
    return None if ns is None or not t.mb else ns / 1e6 / t.mb
