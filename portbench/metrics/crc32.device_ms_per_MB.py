"""Device milliseconds a MB of output in crc32_torch, the gzip member's
CRC-32 taken on the card a decoded group."""
P = "deflate_compression_tpu_torch."
SPANS = {"crc32_torch": P + "core.checksum:crc32_torch"}


def read(t):
    ns = t.device_ns("crc32_torch", expect=("crc32_kernel",))
    return None if ns is None or not t.mb else ns / 1e6 / t.mb
