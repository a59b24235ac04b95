"""Host milliseconds a MB of output in decompress_gzip_indexed outside
decode_blocks: the header and footer read, grouping, each group's bytes
cut and uploaded, the window carried, the bytes copied back,
the CRC-32 launched a group and read once."""
P = "deflate_compression_tpu_torch."
SPANS = {"decompress_gzip_indexed":
         P + "decode.index:decompress_gzip_indexed",
         "decode_blocks": P + "decode.device_inflate:decode_blocks"}


def read(t):
    if not t.calls("decompress_gzip_indexed") or \
            not t.calls("decode_blocks") or not t.mb:
        return None
    return (t.span_ns("decompress_gzip_indexed")
            - t.span_ns("decode_blocks")) / 1e6 / t.mb
