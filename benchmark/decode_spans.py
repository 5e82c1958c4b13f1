"""The transcription path's spans, as the ``*.transcribe`` metrics read
them (``spans.py`` holds the arithmetic; this module names the spans).

``transcribe.call`` (``api.transcribe_many``; not on the cells' path, which
calls ``transcribe_records``), ``transcribe.load``, ``transcribe.upload``,
``model.mel``, ``model.encode``, ``decode.fetch``
(``cli/inference_transcript.py``), and ``decode.init``, ``decode.prime``,
``decode.step``, ``decode.select``, ``decode.sync`` (``decode/beam.py``).
A program without them reads as nothing, never as an error.
"""

from __future__ import annotations

import bisect
from typing import List, Optional

from benchmark.spans import program_spans

# outermost first
DECODE_SPANS = ("transcribe.call", "transcribe.load", "transcribe.upload", "model.mel",
                "model.encode", "decode.init", "decode.prime", "decode.step", "decode.select",
                "decode.sync", "decode.fetch")
# the loop over the steps: the step's forward, the selection, the host's read
LOOP_SPANS = ("decode.step", "decode.select", "decode.sync")
STEP = r"^decode\.step$"


def steps_by_batch(run) -> Optional[List[int]]:
    """The traced ``decode.step`` spans of each batch: those between its
    ``decode.prime`` and the next one. None without either span."""
    if run.trace is None:
        return None
    primes = sorted(op.start_us for op in program_spans(run.trace, ("decode.prime",)))
    steps = program_spans(run.trace, ("decode.step",))
    if not primes or not steps:
        return None
    out = [0] * len(primes)
    for op in steps:
        k = bisect.bisect_right(primes, op.start_us) - 1
        if k >= 0:
            out[k] += 1
    return out


def step_device_s(run) -> Optional[float]:
    """Device seconds of the spans launched inside ``decode.step``."""
    found = run.trace.launched_within(STEP) if run.trace is not None else []
    if not found:
        return None
    return sum(s.end_us - s.start_us for s in found) / 1e6
