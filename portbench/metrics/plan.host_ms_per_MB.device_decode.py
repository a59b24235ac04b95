"""Host milliseconds a MB of output in the decoder's phase A set-up
(device_inflate.flat_batch and plan)."""
P = "deflate_compression_tpu_torch."
SPANS = {"flat_batch": P + "decode.device_inflate:flat_batch",
         "plan": P + "decode.device_inflate:plan"}


def read(t):
    if not t.calls("plan") or not t.mb:
        return None
    return (t.span_ns("plan") + t.span_ns("flat_batch")) / 1e6 / t.mb
