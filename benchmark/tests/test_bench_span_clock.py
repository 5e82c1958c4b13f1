"""The program's spans and the device's spans share one clock in a traced
window: 20 ms of host work inside a ``trace`` span between two kernels lies
inside the device's idle gap and is charged to that span, and the gap's
ends lie on the host events that bound them: the synchronise that waited
for the first kernel, the launch call of the second. (The profiler's own
host path between the span's ends and those events takes 0.2-0.6 ms, so
the span's ends are not held to 0.2 ms.) A kernel of the port's own is
charged to the span it was launched in. On the card only:

    python -m pytest benchmark/tests/test_bench_span_clock.py -q -m cuda
"""

import time

import pytest
import torch

from benchmark import spans, trace

pytestmark = pytest.mark.cuda
WAIT_S = 0.020
EDGE_US = 200.0


def test_span_and_device_clocks_agree(card):
    from lyricalignment_tpu_torch.utils.observability import trace as span

    x = torch.randn(2048, 2048, device=card)
    for _ in range(3):                                   # cuBLAS handles, clocks warm
        x @ x
    torch.cuda.synchronize()

    def work():
        x @ x
        torch.cuda.synchronize()
        with span("t.wait"):
            # a spin, not a sleep: the OS wakes a sleeper up to ~1 ms late
            end = time.perf_counter() + WAIT_S
            while time.perf_counter() < end:
                pass
        x @ x

    _, prof, wall = trace.profile(work, host=True, on_card=True)
    tr = trace.read_profile(prof, wall)
    (waited,) = spans.program_spans(tr, ("t.wait",))
    by = spans.idle_by_span(tr, ("t.wait",))
    assert 19e3 <= by["t.wait"] <= 21e3, by
    (gap,) = [g for g in spans.idle_gaps_us(tr, waited.start_us - 5e3, waited.end_us + 5e3)
              if g[1] - g[0] > 10e3]
    assert gap[0] <= waited.start_us and waited.end_us <= gap[1], (gap, waited)
    (synced,) = [op for op in tr.host if op.name == "cudaDeviceSynchronize"
                 and op.start_us < waited.start_us <= op.end_us + 5e3]
    assert 0 <= synced.end_us - gap[0] <= EDGE_US, (gap, synced)
    launched = max(e.start_ns() / 1e3 for e in prof.profiler.kineto_results.events()
                   if trace.LAUNCH_CALLS.match(e.name()) and e.start_ns() / 1e3 < gap[1])
    assert waited.end_us < launched and 0 <= gap[1] - launched <= EDGE_US, (gap, launched)


def test_port_kernels_are_charged_to_their_span(card):
    """A kernel of the port's own, launched by ctypes with no aten op
    around it, is linked to its launch's op, so it counts among the device
    spans launched inside the program span it ran in (as ``encoder_ms``
    counts the attention kernel inside ``model.encode``)."""
    from lyricalignment_tpu_torch.ops.mel import log_mel
    from lyricalignment_tpu_torch.utils.observability import trace as span

    audio = torch.randn(2, 16000, device=card)
    log_mel(audio, n_mels=80)                            # built and loaded
    torch.cuda.synchronize()

    def work():
        with span("t.mel"):
            log_mel(audio, n_mels=80)

    _, prof, wall = trace.profile(work, host=True, on_card=True)
    tr = trace.read_profile(prof, wall)
    mel = tr.matching(r"\blog10_mel_kernel\b")
    assert mel and all(s.linked for s in mel), mel
    assert {id(s) for s in mel} <= {id(s) for s in tr.launched_within(r"^t\.mel$")}
