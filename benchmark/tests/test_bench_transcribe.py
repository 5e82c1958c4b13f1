"""The transcription cells on the CPU at a tiny size: a sound traced run is
correct and prints the host-side metric; a broken answer (a score moved,
a suppressed token served) comes out not correct under the cells' own
limits. The decode readers on synthetic spans, silent without them; the
decode work counts against hand counts at whisper-large-v3's widths."""

import json
import types

import pytest
import torch

from benchmark import harness, roofline_decode
from benchmark.trace import DeviceSpan, HostOp, Trace

SEED = 2 ** 31 + 5151
CELLS = ("transcribe-large-v3", "transcribe-turbo")
SMALL = {"pool_groups": 1, "per_group": 4, "seconds": [3.0, 4.5], "requests_per_call": 3,
         "batch_size": 2, "beam_size": 3, "max_new_tokens": 8, "warm_calls": 1,
         "check_calls": 2, "trace_calls": 1}
V3 = {"n_text_state": 1280, "n_text_layer": 32, "n_audio_ctx": 1500, "n_vocab": 51866}
SPAN_METRICS = ("decode_step_ms.transcribe", "idle_decode_ms.transcribe",
                "launches_per_step.transcribe", "decode_step_roofline.transcribe")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def result(cell, tiny_cfg, tmp_path, capfd, trace=0):
    params = dict(harness.load_json(harness.HERE, "traffic", "transcribe-16x30s.json"), **SMALL)
    ctx = harness.Context(cell=cell, cfg=tiny_cfg, traffic=params,
                          limits=harness.load_json(harness.HERE, "workloads", f"{cell}.json")["limits"],
                          seed=SEED, dev=torch.device("cpu"), control=None, workdir=str(tmp_path))
    rc = harness._run(ctx, harness.spec(), types.SimpleNamespace(seconds=0.3, trace=trace), 0.0)
    assert rc == 0
    return json.loads(capfd.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_traced_run_is_correct(cell, tiny_cfg, tmp_path, capfd):
    out = result(cell, tiny_cfg, tmp_path, capfd, trace=1)
    assert out["correct"], out["checks"]
    assert out["checks"]["transcribe_beam_shortfall_max_nats"]["value"] <= 1e-3
    # no device spans on the CPU: the device-side readers are silent
    assert out["metrics"]["mfu.transcribe"]["value"] > 0
    assert not set(out["metrics"]) & set(SPAN_METRICS)


def _patch_beam(monkeypatch, edit):
    from lyricalignment_tpu_torch.cli import inference_transcript as it

    real = it.beam_search

    def broken(*a, **k):
        tokens, avg = real(*a, **k)
        return edit(tokens.clone(), avg.clone())
    monkeypatch.setattr(it, "beam_search", broken)


def test_score_moved_is_not_correct(tiny_cfg, tmp_path, capfd, monkeypatch):
    _patch_beam(monkeypatch, lambda tokens, avg: (tokens, avg + 0.1))
    out = result("transcribe-turbo", tiny_cfg, tmp_path, capfd)
    assert not out["correct"] and out["checks"]["transcribe_invalid_tokens"]["value"] == 0


def test_suppressed_token_is_not_correct(tiny_cfg, tmp_path, capfd, monkeypatch):
    def swap(tokens, avg):
        tokens[:, 0] = 50258                            # <|startoftranscript|>
        return tokens, avg
    _patch_beam(monkeypatch, swap)
    out = result("transcribe-turbo", tiny_cfg, tmp_path, capfd)
    assert not out["correct"] and out["checks"]["transcribe_invalid_tokens"]["value"] > 0


@pytest.fixture
def tr():
    """Two batches on thread 1: each a prime, then steps with their select
    and sync; device spans: a step kernel of 10 us linked to each step's
    aten op, a select kernel of 2 us, a copy under each sync."""
    host, device, ident = [HostOp("transcribe.load", 0, 5, 1, 1)], [], 10
    t = 10.0
    for _batch in range(2):
        host.append(HostOp("decode.prime", t, t + 5, 1, ident))
        t += 10
        for _step in range(3):
            host += [HostOp("decode.sync", t, t + 2, 1, ident + 1),
                     HostOp("aten::copy_", t, t + 1, 1, ident + 2),
                     HostOp("decode.step", t + 2, t + 6, 1, ident + 3),
                     HostOp("aten::mm", t + 3, t + 4, 1, ident + 4),
                     HostOp("decode.select", t + 6, t + 9, 1, ident + 5),
                     HostOp("aten::topk", t + 7, t + 8, 1, ident + 6)]
            device += [DeviceSpan(t + 1, t + 1.5, "Memcpy DtoH", ident + 2),
                       DeviceSpan(t + 4, t + 14, "gemm", ident + 4),
                       DeviceSpan(t + 14, t + 16, "topk", ident + 6)]
            ident += 7
            t += 20
    return Trace(sorted(device, key=lambda s: s.start_us), host, launches=18, window_s=t * 1e-6)


def _run(trace, calls=2, shapes=None):
    return types.SimpleNamespace(trace=trace, traced_calls=[{}] * calls, shapes=shapes or {})


def test_decode_readers_on_spans(tr):
    shapes = {"windows": 16, "beam": 5, "prompt": 4, "elem": 2, "dims": V3}
    run = _run(tr, shapes=shapes)
    assert harness.reader("decode_step_ms.transcribe")(run) == pytest.approx(10e-3)
    assert harness.reader("launches_per_step.transcribe")(run) == pytest.approx(3.0)
    least = 2 * roofline_decode.steps_least_s(V3, 16, 5, 4, 3)
    assert harness.reader("decode_step_roofline.transcribe")(run) == pytest.approx(
        100 * least / (6 * 10e-6))
    # idle a step: the sync's 1 us before its copy and 0.5 after it, the
    # step's 2 until the gemm; the select's none (the gemm runs through it),
    # and [t+9, t+20) lies in no span
    idle = harness.reader("idle_decode_ms.transcribe")(run)
    assert idle == pytest.approx(6 * (1.0 + 0.5 + 2.0) / 1e3 / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_decode_readers_silent_without_spans(name, tr):
    read = harness.reader(name)
    assert read(_run(None)) is None
    bare = Trace(tr.device, [op for op in tr.host if not op.name.startswith("decode.")],
                 launches=18, window_s=tr.window_s)
    assert read(_run(bare, shapes={"windows": 16, "beam": 5, "prompt": 4, "elem": 2,
                                   "dims": V3})) is None


def test_step_bytes_by_hand():
    """Step 0 of large-v3 at 16 windows x beam 5, bf16: the 32 layers'
    14 d^2 matrices 1.468 GB, cross K/V 3.932 GB, the prompt's K/V 10.5 MB,
    the first generated slot 13.1 MB; the float32 unembedding 265.6 MB and
    80 rows of float32 logits 16.6 MB: 5.706 GB, 1.70 ms at 3.35 TB/s."""
    got = roofline_decode.step_bytes(V3, 16, 5, 4, 0)
    parts = (32 * 14 * 1280 ** 2 * 2, 32 * 2 * 16 * 1500 * 1280 * 2, 32 * 2 * 16 * 4 * 1280 * 2,
             32 * 2 * 80 * 1 * 1280 * 2, 51866 * 1280 * 4, 80 * 51866 * 4)
    assert got == sum(parts)
    assert got / 1e9 == pytest.approx(5.706, abs=1e-3)
    # each later step reads one more generated slot a row
    assert roofline_decode.step_bytes(V3, 16, 5, 4, 63) - got == 63 * parts[3]
    assert roofline_decode.steps_least_s(V3, 16, 5, 4, 63) * 1e3 == pytest.approx(
        sum(roofline_decode.step_bytes(V3, 16, 5, 4, s) for s in range(63)) / 3.35e9)


def test_decoder_flops_by_hand():
    """A batch of large-v3 at 16 windows, beam 5, 63 steps after a prompt
    of 4: the cross K/V projections 5.033 TFLOP, the prime 0.114, each
    step ~0.148 (80 rows x 32 layers x 14 d^2 and the attention over 1500
    frames and the step's keys, the unembedding), 14.48 in all."""
    d = 1280
    cross = 2 * 32 * 16 * 1500 * 2 * d * d
    assert cross / 1e12 == pytest.approx(5.033, abs=1e-3)
    assert (roofline_decode.decoder_flops(V3, 16, 5, 4, 0) - cross) / 1e12 == pytest.approx(
        0.114, abs=1e-3)
    one = roofline_decode.decoder_flops(V3, 16, 5, 4, 1) - roofline_decode.decoder_flops(
        V3, 16, 5, 4, 0)
    assert one == 2 * 80 * (32 * (14 * d * d + 2 * 5 * d + 2 * 1500 * d) + d * 51866)
    assert one / 1e12 == pytest.approx(0.148, abs=1e-3)
    assert roofline_decode.decoder_flops(V3, 16, 5, 4, 63) / 1e12 == pytest.approx(14.48, abs=0.01)
