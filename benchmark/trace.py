"""What a torch.profiler (CUPTI) trace of a steady sub-window says.

The device spans come from the profiler's own kineto events, and the busy
time is the union of their intervals (streams may overlap). Each device
span is tied to the host op that launched it by the event's linked
correlation id, so a device span can be charged to a host op (the cuDNN
GRU's kernels to ``aten::_cudnn_rnn``) and an idle gap to what the host was
doing when the device got work again.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

# the host runtime and driver calls that put work on the device: a kernel
# launch or a graph launch, each counted once
LAUNCH_CALLS = re.compile(r"^(cuda|cu)(LaunchKernel(ExC|Ex)?(_v\d+)?|LaunchCooperativeKernel\w*|"
                          r"GraphLaunch(_v\d+)?)$")


@dataclass
class HostOp:
    name: str
    start_us: float
    end_us: float
    thread: int
    ident: int


@dataclass
class DeviceSpan:
    start_us: float
    end_us: float
    name: str
    linked: int          # ident of the host op that launched it (0: none)


@dataclass
class Trace:
    """The spans of one profiled sub-window."""

    device: List[DeviceSpan]
    host: List[HostOp]
    launches: int
    window_s: float
    _by_ident: Dict[int, HostOp] = field(default_factory=dict)

    def __post_init__(self):
        self._by_ident = {op.ident: op for op in self.host}

    def busy_s(self) -> float:
        return busy_us([(s.start_us, s.end_us) for s in self.device]) / 1e6

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """{device span name: (seconds, count)}."""
        out: Dict[str, Tuple[float, int]] = {}
        for s in self.device:
            sec, n = out.get(s.name, (0.0, 0))
            out[s.name] = (sec + (s.end_us - s.start_us) / 1e6, n + 1)
        return out

    def matching(self, pattern: str) -> List[DeviceSpan]:
        rx = re.compile(pattern)
        return [s for s in self.device if rx.search(s.name)]

    def launched_within(self, op_pattern: str) -> List[DeviceSpan]:
        """Device spans whose launching host op lies inside (in time, on the
        same thread) a host op whose name matches ``op_pattern``."""
        rx = re.compile(op_pattern)
        outer = [op for op in self.host if rx.search(op.name)]
        if not outer:
            return []
        by_thread: Dict[int, List[Tuple[float, float]]] = {}
        for op in outer:
            by_thread.setdefault(op.thread, []).append((op.start_us, op.end_us))
        out = []
        for s in self.device:
            op = self._by_ident.get(s.linked)
            if op is None:
                continue
            for t0, t1 in by_thread.get(op.thread, ()):
                if t0 <= op.start_us <= t1:
                    out.append(s)
                    break
        return out

    def top_device_ops(self, n: int = 10) -> List[list]:
        ranked = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:n]
        return [[name, sec] for name, (sec, _) in ranked]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device spans, summed by the host op that
        launched the span ending each gap (what the host was doing while the
        device waited); the ``n`` largest sums, in seconds."""
        spans = sorted(self.device, key=lambda s: s.start_us)
        sums: Dict[str, float] = {}
        end = -math.inf
        for s in spans:
            if end > -math.inf and s.start_us > end:
                op = self._by_ident.get(s.linked)
                label = op.name if op is not None else "(no host op)"
                sums[label] = sums.get(label, 0.0) + (s.start_us - end) / 1e6
            end = max(end, s.end_us)
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The union of the intervals' lengths."""
    total, end = 0.0, -math.inf
    for t0, t1 in sorted(intervals):
        total += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return total


def read_profile(prof, window_s: float) -> Trace:
    """A finished ``torch.profiler.profile``'s events as a :class:`Trace`:
    device kernels, copies and memsets; host ops (aten ops and
    ``record_function`` spans) with their correlation ids; the count of
    launch calls."""
    from torch.autograd import DeviceType

    device, host, launches = [], [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if LAUNCH_CALLS.match(name):
                launches += 1
            elif e.linked_correlation_id() == 0:
                host.append(HostOp(name, e.start_ns() / 1e3, e.end_ns() / 1e3,
                                   e.start_thread_id(), e.correlation_id()))
        elif not e.is_user_annotation():
            device.append(DeviceSpan(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                                     e.linked_correlation_id()))
    device.sort(key=lambda s: s.start_us)
    return Trace(device, host, launches, window_s)


def profile(fn, host: bool = True, on_card: bool = True):
    """Run ``fn()`` under the profiler (CUDA activity on the card, and CPU
    activity when ``host``), synchronising at the end; returns (fn's
    result, the profiler, wall seconds)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity

    acts = ([ProfilerActivity.CUDA] if on_card else []) + ([ProfilerActivity.CPU] if host else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall

