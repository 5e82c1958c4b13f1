"""The port's observability layer (``utils/observability.py``, the
counterpart of ``lyricalignment_tpu/utils/observability.py``): a profile
written by ``profile_session`` holds the ``trace`` spans run inside it, and
outside a profiler ``trace`` and ``op_span`` are a shared no-op, and
inside one ``op_span`` is an op the profiler links device work to (no user
annotation); the counters add exactly under threads; the alignment path
(``LyricAligner.align_many`` -> ``align_records`` -> ``forward_from_audio``)
opens its spans once a batch, nested under ``align.batch`` and
``align.call``, and counts its requests, rows and samples and the
encoder's windows; the transcription path (``transcribe_records`` ->
``beam_search``) opens its load, upload, mel, encode and decode spans side
by side (``decode.step`` once a step, ``decode.sync`` once a group) and
counts its windows, rows, steps and tokens; ``MetricLogger`` writes the JAX logger's JSONL
rows always and, with ``tensorboard=True``, TensorBoard scalars under
``tb/``."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import RecordScope

from lyricalignment_tpu.utils import observability as jax_obs
from lyricalignment_tpu_torch import N_SAMPLES
from lyricalignment_tpu_torch.api import LyricAligner
from lyricalignment_tpu_torch.data.audio_io import write_wav
from lyricalignment_tpu_torch.models.align_model import AlignModel, AlignModelConfig
from lyricalignment_tpu_torch.models.whisper import WhisperConfig
from lyricalignment_tpu_torch.text.bert_tokenizer import (
    BertWordPieceTokenizer,
    make_synthetic_vocab,
)
from lyricalignment_tpu_torch.text.pinyin import PronunciationTable
from lyricalignment_tpu_torch.utils import observability as obs

BATCH_SPANS = ("align.load", "align.upload", "model.mel", "model.encode", "model.head",
               "align.viterbi", "align.fetch")


def test_profile_session_records_the_spans(tmp_path):
    with obs.profile_session(str(tmp_path / "profile")):
        with obs.trace("data"):
            x = torch.ones(8)
        with obs.trace("train_step"):
            with obs.trace("add_step"):
                y = x + x
    assert float(y.sum()) == 16.0
    events = json.loads((tmp_path / "profile" / obs.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"data", "train_step", "add_step"} <= names


def test_trace_outside_a_session_is_a_no_op(tmp_path):
    """No profiler: every span is the one shared no-op context, and a
    profile started afterwards holds none of them."""
    assert obs.trace("outside") is obs.trace("elsewhere")
    with obs.trace("outside"):
        pass
    with obs.profile_session(str(tmp_path / "profile")):
        assert obs.trace("inside") is not obs.trace("outside")
        x = torch.ones(4) * 2
    events = json.loads((tmp_path / "profile" / obs.TRACE_FILE).read_text())["traceEvents"]
    assert "outside" not in {e.get("name") for e in events} and float(x.sum()) == 8.0


def test_op_span_is_a_linking_op():
    """``op_span`` is the shared no-op outside a profiler; inside one it is
    recorded as a function op, not the user annotation that ``trace`` is
    (a profiler links the kernels launched inside an op to it, and those
    launched inside a user annotation to nothing)."""
    assert obs.op_span("la_launch") is obs.trace("outside")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.trace("t.user"):
            with obs.op_span("la_launch"):
                torch.ones(2) + 1
    scopes = {e.name: e.scope for e in prof.events() if e.name in ("t.user", "la_launch")}
    assert scopes == {"t.user": int(RecordScope.USER_SCOPE),
                      "la_launch": int(RecordScope.FUNCTION)}


def test_counts_add_exactly_under_threads():
    """16 threads adding at once, with the interpreter switching often."""
    obs.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                obs.add_counts({"t.a": 1, "t.b": 3})

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert obs.counts["t.a"] == 8000 and obs.counts["t.b"] == 24000
    obs.reset_counts()
    assert not obs.counts


@pytest.fixture(scope="module")
def aligner(tmp_path_factory):
    """A miniature float32 model on the CPU and four requests of 10, 10, 10
    and 40 s: a 10 s bucket of 3 (a batch of 4, one pad row) and a 40 s
    one, encoded as two 30 s windows."""
    d = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(5)
    chars = "你好世界天空海洋"
    requests = []
    for i, sec in enumerate([10.0, 10.0, 10.0, 40.0]):
        path = str(d / f"song{i}.wav")
        write_wav(path, (0.1 * rng.standard_normal(int(sec * 16000))).astype(np.float32))
        requests.append((path, chars[2 * i: 2 * i + 3]))
    vocab = make_synthetic_vocab(chars=chars, size=64)
    table = PronunciationTable((), {}, {}, rng.integers(2, 30, size=64).astype(np.int32))
    torch.manual_seed(0)
    wcfg = WhisperConfig(n_mels=80, n_vocab=64, n_audio_ctx=1500, n_audio_state=32,
                         n_audio_head=2, n_audio_layer=1, n_text_ctx=16, n_text_state=32,
                         n_text_head=2, n_text_layer=1)
    model = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=8, output_dim=32)).eval()
    return LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table, use_ctc=True,
                        batch_size=4), requests


def test_align_path_spans_and_counts(aligner):
    port, requests = aligner
    obs.reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = port.align_many(requests)
    assert [len(r) for r in out] == [3, 3, 3, 2]
    # two batches through the head's two bi-GRU layers, grad disabled: the
    # recurrence kernel's route
    assert dict(obs.counts) == {
        "align.requests": 4, "align.rows": 4 + 1, "align.audio_samples": 3 * 160000 + 640000,
        "model.encoded_samples": 4 * N_SAMPLES + 1 * 2 * N_SAMPLES,
        "head.gru_kernel_layers": 2 * 2}

    # the spans as the profiler keeps them (its event tree takes minutes to
    # build over the plain Viterbi's ops); nesting is containment in time
    spans = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("align.", "model."))]
    names = [sp[0] for sp in spans]
    assert names.count("align.call") == 1 and names.count("align.bucket") == 1
    assert names.count("align.batch") == 2
    for name in BATCH_SPANS:
        assert names.count(name) == 2, name
    assert len({sp[3] for sp in spans}) == 1

    for name, t0, t1, _ in spans:
        up = {o[0] for o in spans if o[1] <= t0 and t1 <= o[2] and o[1:3] != (t0, t1)}
        if name == "align.call":
            assert not up
            continue
        assert "align.call" in up, (name, up)
        if name in BATCH_SPANS:
            assert "align.batch" in up, (name, up)
            assert not up & set(BATCH_SPANS), (name, up)   # none inside another
        else:
            assert "align.batch" not in up, (name, up)
    obs.reset_counts()


@pytest.mark.parametrize("tensorboard", [False, True])
def test_metric_logger_rows_match_jax(tmp_path, tensorboard):
    """The same rows as the JAX logger (step and metrics; the clock fields
    differ), and the tb/ event file only with ``tensorboard``."""
    metrics = [(1, {"total": 2.5, "align_ce": 1.25}), (2, {"total": 2.0, "align_ce": 1.0})]
    for mod, d in ((obs, tmp_path / "port"), (jax_obs, tmp_path / "jax")):
        logger = mod.MetricLogger(str(d), tensorboard=False if mod is jax_obs else tensorboard)
        for step, m in metrics:
            logger.log(step, m)
        logger.close()
    rows = {}
    for name in ("port", "jax"):
        lines = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        rows[name] = [{k: v for k, v in json.loads(l).items() if k not in ("time", "wall_s")}
                      for l in lines]
    assert rows["port"] == rows["jax"] == [{"step": s, **m} for s, m in metrics]
    events = list((tmp_path / "port" / "tb").glob("events.out.tfevents.*"))
    assert bool(events) == tensorboard
    if tensorboard:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(str(tmp_path / "port" / "tb"))
        acc.Reload()
        assert [e.value for e in acc.Scalars("total")] == [2.5, 2.0]


DECODE_LOOP = ("decode.step", "decode.select", "decode.sync")


def test_transcribe_path_spans_and_counts(tmp_path):
    """A miniature float32 whisper transcribes three 10 s songs in batches
    of 2 at beam 2, 8 positions and decode group 3, eot's embedding zeroed
    so no beam ends early: each batch primes once, runs 7 steps, reads the
    done flag ceil(7 / 3) times, and selects 1 + 7 times plus the
    finalisation; the spans do not nest in one another, and the counters are
    exact. Outside a profiler ``decode.beam``'s spans are the shared no-op."""
    from types import SimpleNamespace

    from lyricalignment_tpu_torch.cli.inference_transcript import transcribe_records
    from lyricalignment_tpu_torch.data.records import Record
    from lyricalignment_tpu_torch.decode import beam as beam_mod
    from lyricalignment_tpu_torch.models.whisper import Whisper
    from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    rng = np.random.default_rng(7)
    records = []
    for i in range(3):
        path = str(tmp_path / f"song{i}.wav")
        write_wav(path, (0.1 * rng.standard_normal(10 * 16000)).astype(np.float32))
        records.append(Record(audio_path=path, text=""))
    torch.manual_seed(0)
    wcfg = WhisperConfig(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=32,
                         n_audio_head=2, n_audio_layer=1, n_text_ctx=16, n_text_state=32,
                         n_text_head=2, n_text_layer=1)
    whisper = Whisper(wcfg).eval()
    tok = WhisperTokenizer()
    with torch.no_grad():
        whisper.decoder.token_embedding.weight[tok.eot] = 0.0
    args = SimpleNamespace(is_mixture=0, batch_size=2, beam_size=2, max_new_tokens=8,
                           use_groundtruth=False, temperature_fallback=False, fast_windows=False,
                           length_penalty=None, patience=None,
                           no_condition_on_previous_text=False, seed=0, decode_group=3)
    obs.reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = transcribe_records(records, whisper, wcfg, tok, args)
    assert all(len(json.loads(r["inference"])) == 8 and len(r["avg_logprob"]) == 1 for r in out)
    assert dict(obs.counts) == {"decode.windows": 3, "decode.rows": 3 * 2, "decode.steps": 2 * 8,
                                "decode.tokens": 3 * 8}

    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("decode.", "transcribe.", "model."))]
    names = [sp[0] for sp in spans]
    want = {"transcribe.load": 1 + 2, "transcribe.upload": 2, "model.mel": 2, "model.encode": 2,
            "decode.init": 2, "decode.prime": 2, "decode.step": 2 * 7, "decode.sync": 2 * 3,
            "decode.select": 2 * (1 + 7 + 1), "decode.fetch": 2}
    assert {n: names.count(n) for n in want} == want
    for name, t0, t1 in spans:
        inside = {o[0] for o in spans if o[1] <= t0 and t1 <= o[2] and o[1:] != (t0, t1)}
        assert not inside, (name, inside)
    obs.reset_counts()
    assert beam_mod.trace is obs.trace
    assert beam_mod.trace("decode.step") is obs.trace("decode.sync") is obs.trace("x")
