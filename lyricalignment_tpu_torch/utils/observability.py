"""Tracing, profiling and structured metric logging.

Port of ``lyricalignment_tpu/utils/observability.py:28-89``:

* ``trace(name)``: a ``torch.profiler.record_function`` span, which names a
  host-side phase in a profile and shares the profile's clock with the
  device's kernels; with no profiler running it is a shared no-op context
  and costs one check;
* ``op_span(name)``: a host op the profiler ties the device work launched
  inside it to (a ``trace`` span is a user annotation, which it does not):
  the port's own kernel launches, which no aten op wraps; a shared no-op
  with no profiler running;
* ``counts`` / ``add_counts`` / ``reset_counts``: the program's own counts
  since the last reset, by name (the alignment path's ``align.*``);
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
import json
import os
import threading
import time
from collections import Counter
from typing import Dict, Mapping

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()

#: the program's counts since the last reset, by name; each counting site
#: adds once a unit of its work (the alignment path: once a batch)
counts: Counter = Counter()
_count_lock = threading.Lock()


def trace(name: str):
    """A named host-side span (shows in profiler timelines). Outside a
    profiler (on this thread) it is a shared no-op context."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def op_span(name: str):
    """A named host op that the device work launched inside it is linked
    to in a profile, as an aten op's kernels are. Outside a profiler (on
    this thread) it is the shared no-op context."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(name)


def add_counts(values: Mapping[str, int]) -> None:
    """Add each of ``values`` to its count, under one lock."""
    with _count_lock:
        counts.update(values)


def reset_counts() -> None:
    with _count_lock:
        counts.clear()


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
