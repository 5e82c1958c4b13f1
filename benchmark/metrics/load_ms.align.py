"""Host ms a traced call inside the program's spans align.bucket (the
header reads that assign buckets) and align.load (WAV decode, tokens,
labels, the host arrays)."""
from benchmark.spans import span_ms


def read(run):
    return span_ms(run, ("align.bucket", "align.load"))
