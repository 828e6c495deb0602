"""The median of every request of the window, ms."""
from portbench.core.readers import latency_ms


def read(run):
    return latency_ms(run, 50.0)
