"""Device milliseconds a MB of output of the operations launched inside
the port's spans decode.batch and checksum.adler32 that are none of the
port's hand kernels: the torch glue of the verified flat decode."""
from portbench.metrics import program

SPANS_READ = ("dct/decode.batch", "dct/checksum.adler32")


def read(t):
    if not t.calls(SPANS_READ[0]) or not t.mb:
        return None
    ns = sum(d for n, d in t.device_ops(*SPANS_READ)
             if not any(k in n for k in program.HAND_KERNELS))
    return ns / 1e6 / t.mb
