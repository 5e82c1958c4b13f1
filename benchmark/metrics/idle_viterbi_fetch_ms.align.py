"""Device-idle ms a traced call while the host is inside align.viterbi or
align.fetch (the DP's launches, the onsets' copy to the host and the
result lists)."""
from benchmark.spans import ALIGN_SPANS, idle_ms


def read(run):
    return idle_ms(run, ALIGN_SPANS, ("align.viterbi", "align.fetch"))
