"""Host milliseconds a MB of input inside encode_shard (the torch glue
and the kernels' launches)."""
P = "deflate_compression_tpu_torch."
SPANS = {"encode_shard": P + "format.deflate:encode_shard"}


def read(t):
    if not t.calls("encode_shard") or not t.mb:
        return None
    return t.span_ns("encode_shard") / 1e6 / t.mb
