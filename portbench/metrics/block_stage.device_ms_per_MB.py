"""Device milliseconds a MB of input launched by the block stage: the
tile histograms, block_plan and huffman_codes."""
P = "deflate_compression_tpu_torch."
SPANS = {"tile_histogram": P + "core.huffman:tile_histogram",
         "block_plan": P + "format.deflate:block_plan",
         "huffman_codes": P + "format.deflate:huffman_codes"}


def read(t):
    ns = t.device_ns(*SPANS, expect=tuple(SPANS))
    return None if ns is None or not t.mb else ns / 1e6 / t.mb
