"""What the metric files under ``metrics/`` share. Each metric is a file
``metrics/<name>.py`` with a ``read(run)`` that returns its value, or None
where the run has nothing for it to read (then the metric is left out of
the result)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def rate(run, unit: str) -> float:
    """``unit`` completed over the window's wall time."""
    return run.units(unit) / run.window_s


def latency_ms(run, q: float) -> float:
    """The ``q`` percentile of every call's latency in the window, ms."""
    return float(np.percentile([(c["t1"] - c["t0"]) * 1e3 for c in run.calls], q))


def idle_share(run) -> Optional[float]:
    """1 - device busy / wall time of the traced sub-window, in %."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def roofline_share(run, spans: str, calls: str,
                   least_s: Callable[[dict], float]) -> Optional[float]:
    """The function's least time over the device time of the spans that
    implement it, in %: ``spans`` matches every kernel of the function,
    ``calls`` the one launched once a call; ``least_s(shapes)`` is one
    call's least time."""
    if run.trace is None:
        return None
    found = run.trace.matching(spans)
    n = len(run.trace.matching(calls))
    if not found or not n:
        return None
    busy = sum(s.end_us - s.start_us for s in found) / 1e6
    return 100.0 * n * least_s(run.shapes) / busy


def host_op_ms(run, op_pattern: str, per: int) -> Optional[float]:
    """Device ms of the spans launched inside host ops matching
    ``op_pattern``, a traced call (``per`` calls)."""
    if run.trace is None:
        return None
    found = run.trace.launched_within(op_pattern)
    if not found:
        return None
    return sum(s.end_us - s.start_us for s in found) / 1e3 / per


def launches_per(run, per: int) -> Optional[float]:
    if run.trace is None or not run.trace.launches:
        return None
    return run.trace.launches / per
