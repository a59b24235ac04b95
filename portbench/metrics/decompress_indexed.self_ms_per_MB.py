"""Host milliseconds a MB of output in decompress_indexed outside
decode_blocks: grouping, the rest of the stream cut and uploaded per
group, the window carried, the bytes copied back, Adler-32 combined."""
P = "deflate_compression_tpu_torch."
SPANS = {"decompress_indexed": P + "decode.index:decompress_indexed",
         "decode_blocks": P + "decode.device_inflate:decode_blocks"}


def read(t):
    if not t.calls("decompress_indexed") or not t.calls("decode_blocks") \
            or not t.mb:
        return None
    return (t.span_ns("decompress_indexed")
            - t.span_ns("decode_blocks")) / 1e6 / t.mb
