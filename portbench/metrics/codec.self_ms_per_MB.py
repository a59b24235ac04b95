"""Host milliseconds a MB of input in ZlibCodec.compress outside
encode_shard: padding the shards, the words back, the stats."""
P = "deflate_compression_tpu_torch."
SPANS = {"compress": P + "models.codec:ZlibCodec.compress",
         "encode_shard": P + "format.deflate:encode_shard"}


def read(t):
    if not t.calls("compress") or not t.calls("encode_shard") or not t.mb:
        return None
    return (t.span_ns("compress") - t.span_ns("encode_shard")) / 1e6 / t.mb
