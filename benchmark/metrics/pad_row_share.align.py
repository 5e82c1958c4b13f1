"""Pad rows (rows that hold no request, added to round a batch up) over
the rows the aligner built, %, from the program's counters over the
process."""
from benchmark.spans import counts


def read(run):
    found = counts()
    if not found or not found.get("align.rows"):
        return None
    return 100.0 * (found["align.rows"] - found.get("align.requests", 0)) / found["align.rows"]
