"""Device-idle ms a traced call while the host is inside model.mel or
model.encode (the launches of the log-mel, its mask and the encoder)."""
from benchmark.spans import ALIGN_SPANS, idle_ms


def read(run):
    return idle_ms(run, ALIGN_SPANS, ("model.mel", "model.encode"))
