"""Device milliseconds a MB of output in adler32_torch, the per-shard
checksum of the verified decode."""
P = "deflate_compression_tpu_torch."
SPANS = {"adler32_torch": P + "core.checksum:adler32_torch"}


def read(t):
    ns = t.device_ns("adler32_torch")
    return None if ns is None or not t.mb else ns / 1e6 / t.mb
