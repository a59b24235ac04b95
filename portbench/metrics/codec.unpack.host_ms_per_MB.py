"""Host milliseconds a MB of input in the port's span codec.unpack: the
rest of each shard's read-back (total bits, its bytes, the per-block
stats) and the stats loop after the last shard."""
from portbench.metrics import program


def read(t):
    return program.host_ms_per_MB(t, "codec.unpack")
