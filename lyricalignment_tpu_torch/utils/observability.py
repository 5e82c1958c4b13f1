"""Tracing, profiling and structured metric logging.

Port of ``lyricalignment_tpu/utils/observability.py:28-89``:

* ``trace(name)``: a ``torch.profiler.record_function`` span, which names a
  host-side phase in a profile;
* ``annotate(fn, name)``: ``fn`` with its calls inside such a span;
* ``profile_session(log_dir)``: ``torch.profiler.profile`` around a block
  (CPU activity, and CUDA activity when a card is in use), its Chrome trace
  written into ``log_dir`` as ``trace.json`` on exit;
* ``MetricLogger``: JSONL metrics (one object per line: step, wall time,
  metrics) and, with ``tensorboard=True``, TensorBoard scalars through
  ``torch.utils.tensorboard.SummaryWriter`` in ``log_dir/tb``. Where that
  package cannot be imported it writes JSONL only, as the JAX logger does
  without TensorFlow.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Dict

import torch

TRACE_FILE = "trace.json"


def trace(name: str):
    """A named host-side span (shows in profiler timelines)."""
    return torch.profiler.record_function(name)


def annotate(fn, name: str):
    """``fn`` with each call inside a ``trace(name)`` span."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with trace(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def profile_session(log_dir: str):
    """Profile the block (host spans, and device kernels when CUDA is in
    use) and write its Chrome trace to ``log_dir/trace.json``; yields the
    profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class MetricLogger:
    """JSONL metrics + optional TensorBoard scalars.

    Each ``log(step, metrics)`` appends one line to ``metrics.jsonl``:
    ``{"step": N, "time": unix_ts, "wall_s": since-start, ...metrics}``.
    """

    def __init__(self, log_dir: str, tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a", encoding="utf-8")
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": int(step), "time": time.time(),
               "wall_s": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))
            self._tb.flush()

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
