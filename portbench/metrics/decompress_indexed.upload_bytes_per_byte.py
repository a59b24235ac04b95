"""Bytes that decompress_indexed hands to the card a byte of output: the
window's difference of the port's counter decompress_indexed.upload_bytes
(the rest of the stream and the index arrays of every group)."""
NAME = "decompress_indexed.upload_bytes"
COUNTERS = {NAME: "deflate_compression_tpu_torch.decode.index:"
                  "decompress_indexed.upload_bytes"}


def read(t):
    n = getattr(t, "counters", {}).get(NAME)
    return None if not n or not t.mb else n / (t.mb * 1e6)
