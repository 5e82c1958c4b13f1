"""95th percentile of every align_many call's latency in the window, ms."""
from benchmark.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
