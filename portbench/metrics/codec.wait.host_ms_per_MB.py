"""Host milliseconds a MB of input in the port's span codec.wait: the
first read of each shard's results, where the host waits for the card to
finish the shard."""
from portbench.metrics import program


def read(t):
    return program.host_ms_per_MB(t, "codec.wait")
