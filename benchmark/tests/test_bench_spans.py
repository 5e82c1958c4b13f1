"""The program's spans and counters as the metrics read them: idle time
charged to the innermost span on synthetic spans, the readers' values and
their silence where a run has no trace, no span or no counter (a program
that keeps none), and a traced run on the CPU at a tiny size that prints
the host-side ones."""

import json
import types

import pytest
import torch

from benchmark import harness, spans
from benchmark.trace import DeviceSpan, HostOp, Trace

SPAN_METRICS = ("load_ms.align", "idle_load_ms.align", "idle_head_ms.align", "encoder_ms.align",
                "idle_mel_encode_ms.align", "idle_viterbi_fetch_ms.align")
COUNTER_METRICS = ("encoder_useful_share.align", "pad_row_share.align")


@pytest.fixture
def tr():
    """Spans on thread 1 (align.load and align.upload inside align.call,
    model.head inside it too; align.fetch after it), a profiler overhead
    event on thread 2, device spans leaving gaps [5, 45], [55, 65], [68, 95]
    and [100, 110] (us)."""
    host = [HostOp("align.call", 0, 100, 1, 1), HostOp("align.load", 10, 40, 1, 2),
            HostOp("aten::copy_", 41, 44, 1, 3), HostOp("align.upload", 40, 50, 1, 4),
            HostOp("model.encode", 50, 58, 1, 5), HostOp("aten::mm", 51, 52, 1, 6),
            HostOp("model.head", 60, 90, 1, 7), HostOp("Buffer Flush", 70, 75, 2, 0),
            HostOp("align.fetch", 100, 104, 1, 8)]
    device = [DeviceSpan(0, 5, "k0", 1), DeviceSpan(45, 55, "memcpy", 3),
              DeviceSpan(52, 54, "gemm", 6), DeviceSpan(65, 68, "rnn", 7),
              DeviceSpan(95, 100, "k1", 1), DeviceSpan(110, 120, "k2", 0)]
    return Trace(device, host, launches=6, window_s=120e-6)


def test_idle_charged_to_the_innermost_span(tr):
    by = spans.idle_by_span(tr, spans.ALIGN_SPANS)
    assert by["total"] == pytest.approx(40 + 10 + 27 + 10)
    # [5, 45] splits over the call, the load and the upload (the aten op
    # inside the upload is no program span); the load takes its part from
    # the call it is nested in
    assert by["align.load"] == pytest.approx(30)
    assert by["align.upload"] == pytest.approx(5)
    assert by["align.call"] == pytest.approx(5 + 2 + 5)
    assert by["model.encode"] == pytest.approx(3)
    # [68, 95]: the head's part around the overhead event, which takes none
    assert by["model.head"] == pytest.approx(5 + 2 + 15)
    assert by[spans.OVERHEAD_KEY] == pytest.approx(5)
    assert by["align.fetch"] == pytest.approx(4)
    assert by[spans.NO_SPAN_KEY] == pytest.approx(6)       # [104, 110]: no span open
    assert sum(v for k, v in by.items() if k != "total") == pytest.approx(by["total"])


def test_idle_gaps_are_the_union_complement(tr):
    assert spans.idle_gaps_us(tr, 0, 120) == [(5, 45), (55, 65), (68, 95), (100, 110)]
    assert spans.idle_gaps_us(tr, 20, 60) == [(20, 45), (55, 60)]


def _run(trace, calls=2):
    return types.SimpleNamespace(trace=trace, traced_calls=[{}] * calls)


def test_readers_on_spans(tr):
    run = _run(tr)
    assert harness.reader("load_ms.align")(run) == pytest.approx(30 / 1e3 / 2)
    assert harness.reader("idle_load_ms.align")(run) == pytest.approx(35 / 1e3 / 2)
    assert harness.reader("idle_head_ms.align")(run) == pytest.approx(22 / 1e3 / 2)
    assert harness.reader("idle_mel_encode_ms.align")(run) == pytest.approx(3 / 1e3 / 2)
    assert harness.reader("idle_viterbi_fetch_ms.align")(run) == pytest.approx(4 / 1e3 / 2)
    # the gemm launched by the mm inside model.encode
    assert harness.reader("encoder_ms.align")(run) == pytest.approx(2 / 1e3 / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_silent_without_trace_or_span(name, tr):
    read = harness.reader(name)
    assert read(_run(None)) is None
    bare = Trace(tr.device, [op for op in tr.host if not op.name.startswith(("align.", "model."))],
                 launches=6, window_s=120e-6)
    assert read(_run(bare)) is None


@pytest.mark.parametrize("name,found,value", [
    ("encoder_useful_share.align",
     {"align.audio_samples": 29 * 16000, "model.encoded_samples": 480000}, 100 * 29 / 30),
    ("pad_row_share.align", {"align.requests": 3, "align.rows": 4}, 25.0),
])
def test_counter_reader(monkeypatch, name, found, value):
    from lyricalignment_tpu_torch.utils import observability

    read = harness.reader(name)
    observability.reset_counts()
    assert read(_run(None)) is None
    observability.add_counts(found)
    assert read(_run(None)) == pytest.approx(value)
    observability.reset_counts()
    monkeypatch.delattr(observability, "counts")        # a program that keeps no counters
    assert read(_run(None)) is None


def test_traced_cpu_run_prints_the_host_metrics(tiny_cfg, tmp_path, capfd):
    """A tiny cell traced on the CPU: the host-side metrics are printed,
    the device-side ones (no device spans) are left out."""
    from benchmark.tests.test_bench_faults import SMALL, SEED, TRAFFIC

    cell = "align-medium"
    params = dict(harness.load_json(harness.HERE, "traffic", f"{TRAFFIC[cell]}.json"), **SMALL[cell])
    ctx = harness.Context(cell=cell, cfg=tiny_cfg, traffic=params,
                          limits=harness.load_json(harness.HERE, "workloads", f"{cell}.json")["limits"],
                          seed=SEED, dev=torch.device("cpu"), control=None, workdir=str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        assert harness._run(ctx, harness.spec(), types.SimpleNamespace(seconds=0.5, trace=1), 0.0) == 0
    finally:
        torch.set_num_threads(n)
    metrics = json.loads(capfd.readouterr().out.strip().splitlines()[-1])["metrics"]
    assert metrics["load_ms.align"]["value"] > 0
    assert 0 < metrics["encoder_useful_share.align"]["value"] < 100
    assert 0 <= metrics["pad_row_share.align"]["value"] < 100
    assert not set(metrics) & (set(SPAN_METRICS) - {"load_ms.align"})
