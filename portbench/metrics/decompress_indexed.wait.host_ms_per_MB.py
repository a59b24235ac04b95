"""Host milliseconds a MB of output in the port's span index.wait: each
group's verdict read, where the host waits for the card's decode."""
from portbench.metrics import program


def read(t):
    return program.host_ms_per_MB(t, "index.wait")
