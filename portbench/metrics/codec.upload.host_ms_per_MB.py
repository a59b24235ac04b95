"""Host milliseconds a MB of input in the port's span codec.upload: each
shard zero-padded on the host and its upload (pageable) to the card."""
from portbench.metrics import program


def read(t):
    return program.host_ms_per_MB(t, "codec.upload")
