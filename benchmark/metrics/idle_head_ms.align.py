"""Device-idle ms a traced call while the host is inside model.head (the
bi-GRU's launches, its packing and the lengths' copy to the host)."""
from benchmark.spans import ALIGN_SPANS, idle_ms


def read(run):
    return idle_ms(run, ALIGN_SPANS, ("model.head",))
