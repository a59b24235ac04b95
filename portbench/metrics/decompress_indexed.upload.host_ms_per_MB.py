"""Host milliseconds a MB of output in the port's span index.upload: the
rest of the stream cut, padded and uploaded for each group."""
from portbench.metrics import program


def read(t):
    return program.host_ms_per_MB(t, "index.upload")
