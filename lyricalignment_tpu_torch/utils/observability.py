"""Structured metric logging.

Port of ``lyricalignment_tpu/utils/observability.py:52-89``, JSONL only:
each ``MetricLogger.log(step, metrics)`` appends one line to
``metrics.jsonl``. TensorBoard scalars and device profiles are not ported
yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    """``{"step": N, "time": unix_ts, "wall_s": since-start, ...metrics}``
    one object per line."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a", encoding="utf-8")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": int(step), "time": time.time(),
               "wall_s": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
