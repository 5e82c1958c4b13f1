"""Device-idle ms a traced call while the host is inside decode.step,
decode.select or decode.sync (the innermost of the transcription path's
spans): the step loop's launch and sync gaps."""
from benchmark.decode_spans import DECODE_SPANS, LOOP_SPANS
from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, DECODE_SPANS, LOOP_SPANS)
