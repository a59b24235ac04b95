"""Bytes copied host to device a byte of output, inside
decompress_indexed: the profiler's records of every HtoD copy that the
calls launched, with each copy's size from the exported trace. The
per-group upload of the rest of the stream shows here, and so does any
upload that a repair moves or removes."""
COPIES = True
SPANS = {"decompress_indexed":
         "deflate_compression_tpu_torch.decode.index:decompress_indexed"}


def read(t):
    if not t.calls("decompress_indexed") or not t.mb:
        return None
    n = t.copy_bytes("HtoD", "decompress_indexed")
    return None if not n else n / (t.mb * 1e6)
