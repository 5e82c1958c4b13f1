"""The program's own spans and counters, as the metrics under ``metrics/``
read them.

The port opens ``trace(name)`` spans (``torch.profiler.record_function``)
at its layer boundaries (``align.call``, ``align.load``, ``model.encode``,
...). In a traced sub-window they are host ops of the :class:`trace.Trace`
on the profiler's one clock with the device's spans, so an idle gap of the
device can be charged to the span the host was inside while it lasted.
(Its own kernels launch inside an op of their launcher's name, so they are
linked to a host op, and through it to the span, as an aten op's are.)
The counters are the process's ``utils.observability.counts``. A program
without a span or counter reads as nothing here, never as an error.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

# the profiler's own work on the host, charged to no stage of the program:
# CUPTI's activity buffers handed out and emptied, on the calling thread.
# (They carry the correlation id of the op they interrupt, so a lookup by
# id can find them in that op's place.)
OVERHEAD = re.compile(r"^(Activity Buffer Request|Buffer Flush)$")
OVERHEAD_KEY = "(profiler overhead)"
# the alignment path's spans, outermost first
ALIGN_SPANS = ("align.call", "align.bucket", "align.batch", "align.load", "align.upload",
               "model.mel", "model.encode", "model.head", "align.viterbi", "align.fetch")
NO_SPAN_KEY = "(no span)"


def program_spans(tr, names) -> List:
    """The trace's host ops named one of ``names`` (the program's spans)."""
    names = set(names)
    return [op for op in tr.host if op.name in names]


def span_ms(run, names) -> Optional[float]:
    """Host ms a traced call inside the spans named ``names`` (their
    union, so a span nested in another counts once)."""
    from benchmark.trace import busy_us

    if run.trace is None or not run.traced_calls:
        return None
    found = program_spans(run.trace, names)
    if not found:
        return None
    return busy_us((op.start_us, op.end_us) for op in found) / 1e3 / len(run.traced_calls)


def idle_gaps_us(tr, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The device's idle intervals inside [t0, t1]: the time between one
    device span's end and the next one's start, on the union of the spans
    (as ``Trace.idle_gaps`` walks them; the union ``idle_share`` reads)."""
    gaps, end = [], t0
    for s in sorted(tr.device, key=lambda s: s.start_us):
        if s.start_us > end:
            gaps.append((end, min(s.start_us, t1)))
        end = max(end, s.end_us)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return [(a, b) for a, b in gaps if b > a]


def stage_timeline(tr, names) -> List[Tuple[float, float, str]]:
    """The host's time cut into pieces, each labelled with the innermost
    span of ``names`` open during it (the latest-started, as spans nest in
    time on the calling thread), or :data:`OVERHEAD_KEY` where a profiler
    overhead event covers it; pieces outside every span are left out."""
    spans = program_spans(tr, names)
    overhead = [(op.start_us, op.end_us) for op in tr.host if OVERHEAD.match(op.name)]
    cuts = sorted({t for op in spans for t in (op.start_us, op.end_us)}
                  | {t for iv in overhead for t in iv})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        if any(o0 <= mid < o1 for o0, o1 in overhead):
            label = OVERHEAD_KEY
        else:
            inner = None
            for op in spans:
                if op.start_us <= mid < op.end_us and (inner is None
                                                       or op.start_us >= inner.start_us):
                    inner = op
            if inner is None:
                continue
            label = inner.name
        if out and out[-1][2] == label and out[-1][1] == a:
            out[-1] = (out[-1][0], b, label)
        else:
            out.append((a, b, label))
    return out


def idle_by_span(tr, names) -> Optional[Dict[str, float]]:
    """Device-idle us charged to the innermost program span (of ``names``)
    the host was inside, each part of a gap to its own span; the part under
    a profiler overhead event to :data:`OVERHEAD_KEY`, the part inside no
    span to :data:`NO_SPAN_KEY`. The window runs from the first span's or
    device span's start to the last one's end; ``"total"`` is all its idle
    time, which the other entries add up to. None without device spans or
    program spans."""
    spans = program_spans(tr, names)
    if not tr.device or not spans:
        return None
    t0 = min(min(s.start_us for s in tr.device), min(op.start_us for op in spans))
    t1 = max(max(s.end_us for s in tr.device), max(op.end_us for op in spans))
    gaps = idle_gaps_us(tr, t0, t1)
    pieces = stage_timeline(tr, names)
    starts = [p[0] for p in pieces]
    out: Dict[str, float] = {"total": sum(b - a for a, b in gaps)}
    charged = 0.0
    for g0, g1 in gaps:
        k = max(0, bisect.bisect_right(starts, g0) - 1)
        while k < len(pieces) and pieces[k][0] < g1:
            p0, p1, label = pieces[k]
            part = min(g1, p1) - max(g0, p0)
            if part > 0:
                out[label] = out.get(label, 0.0) + part
                charged += part
            k += 1
    out[NO_SPAN_KEY] = out["total"] - charged
    return out


def idle_ms(run, names, stages) -> Optional[float]:
    """Device-idle ms a traced call while the host was inside one of
    ``stages`` (innermost among the spans ``names``)."""
    if run.trace is None or not run.traced_calls or not program_spans(run.trace, stages):
        return None
    by = idle_by_span(run.trace, names)
    if by is None:
        return None
    return sum(by.get(s, 0.0) for s in stages) / 1e3 / len(run.traced_calls)


def counts() -> Optional[Dict[str, int]]:
    """The program's counters over the process, or None where the program
    keeps none."""
    from lyricalignment_tpu_torch.utils import observability

    found = getattr(observability, "counts", None)
    return dict(found) if found is not None else None
