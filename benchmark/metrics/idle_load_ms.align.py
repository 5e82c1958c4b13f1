"""Device-idle ms a traced call while the host is inside align.bucket,
align.load or align.upload (the innermost of the program's spans)."""
from benchmark.spans import ALIGN_SPANS, idle_ms


def read(run):
    return idle_ms(run, ALIGN_SPANS, ("align.bucket", "align.load", "align.upload"))
