"""crc32's share of its roofline (the checksum layer): each call's
`valid_len` bytes read once and its 8-byte result written, over 3.35 TB/s,
over the device time crc32_torch launches."""
from portbench.metrics import bounds

P = "deflate_compression_tpu_torch."
SPANS = {"crc32_torch": P + "core.checksum:crc32_torch"}
# valid_len, an int on the decode's path
CAPTURE = {"crc32_torch": lambda a, k: int(a[1] if len(a) > 1
                                           else k["valid_len"])}


def crc32_bytes(valid_len: int) -> int:
    return valid_len + 8


def read(t):
    ns = t.device_ns("crc32_torch", expect=("crc32_kernel",))
    calls = t.captured.get("crc32_torch", [])
    if ns is None or not calls or None in calls:
        return None
    return bounds.roofline_pct(sum(crc32_bytes(n) for n in calls), ns / 1e9)
