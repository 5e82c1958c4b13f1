"""95th percentile of every align_many call's latency in the window, ms:
the end-to-end tail, read as a per-layer number in the cells where the
host's own speed spreads it too widely to hold a bound."""
from benchmark.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
