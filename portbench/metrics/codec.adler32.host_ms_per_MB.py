"""Host milliseconds a MB of input in the port's span codec.adler32: the
zlib footer's Adler-32 of the whole object on the host."""
from portbench.metrics import program


def read(t):
    return program.host_ms_per_MB(t, "codec.adler32")
