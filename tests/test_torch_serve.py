"""The port's JSONL serving loop (``cli/serve.py``) on the CPU: the nine
cases of ``tests/test_serve.py`` (continuous batching, per-request error
isolation, echoed ids, decode knobs, the decode batch), then the port's
responses against the JAX ``serve``'s on the same model dir: alignments
within one 20 ms frame on at most 1 boundary in 50 (float32 summation
order differs, as ``tests/test_torch_slice.py`` holds it), transcription
text equal, errors where JAX has them, ids echoed alike."""

import io
import json

import numpy as np
import pytest
import torch

from lyricalignment_tpu.api import LyricAligner as JaxAligner
from lyricalignment_tpu.cli.serve import parse_args as jax_parse_args
from lyricalignment_tpu.cli.serve import serve as jax_serve
from lyricalignment_tpu_torch.api import LyricAligner
from lyricalignment_tpu_torch.cli.serve import parse_args, serve
from lyricalignment_tpu_torch.data.audio_io import write_wav
from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from lyricalignment_tpu_torch.train.checkpoints import save_json
from tests.conftest import forge_wav_bytes
from tests.torch_port_helpers import TINY_DIMS, jax_tiny_model
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

DIMS = dict(n_vocab=51865, n_text_ctx=64)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A reference-.pt model dir of a tiny backbone with the real vocabulary
    and a CTC head, weights from a seed (sharp emissions: no near-ties)."""
    d = tmp_path_factory.mktemp("serve_model")
    cfg, params = jax_tiny_model(seed=1, hidden_dim=384, output_dim=21129, fc_scale=8.0,
                                 dims=DIMS, onepass_encoder=True)
    # damp the text rows past the byte range so the decoder's picks differ
    # from one another by more than rounding
    params["whisper"]["decoder"]["token_embedding"][256:50257] *= 0.05
    save_json(str(d / "args.json"), {"whisper_model": "custom", "use_ctc_loss": True,
                                     "whisper_dims": {**TINY_DIMS, **DIMS}})
    save_json(str(d / "model_args.json"), {
        "embed_dim": 64, "hidden_dim": 384, "output_dim": 21129, "bidirectional": True,
        "freeze_encoder": False, "train_alignment": True, "train_transcript": False})
    torch.save(state_dict_from_jax_params(params), str(d / "best_model.pt"))
    return str(d)


@pytest.fixture(scope="module")
def aligner(model_dir):
    return LyricAligner.from_model_dir(model_dir, synthetic_vocab=True, use_ctc=True,
                                       batch_size=4, device="cpu")


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_wavs")
    sr = 16000
    t = np.arange(2 * sr) / sr
    path = str(d / "song.wav")
    write_wav(path, (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), sr)
    return path


def _argv(max_batch, window_ms, extra_flags):
    return ["--model-dir", "ignored", "--use-ctc-loss", "--synthetic-vocab",
            "--max-batch", str(max_batch), "--beam-size", "2", "--max-new-tokens", "8",
            "--batch-window-ms", str(window_ms), *extra_flags]


def _stream(requests):
    return io.StringIO("".join(json.dumps(r) + "\n" if isinstance(r, dict) else r + "\n"
                               for r in requests))


def _run(aligner, requests, max_batch=8, window_ms=300.0, extra_flags=()):
    args = parse_args(_argv(max_batch, window_ms, extra_flags) + ["--device", "cpu"])
    stdout = io.StringIO()
    serve(aligner, args, stdin=_stream(requests), stdout=stdout)
    return [json.loads(line) for line in stdout.getvalue().splitlines()]


def test_batched_alignment_in_order(aligner, wav):
    reqs = [{"song_path": wav, "lyric": "你好"},
            {"song_path": wav, "lyric": "世界人民"}]
    out = _run(aligner, reqs)
    assert len(out) == 2
    assert [len(r["alignment"]) for r in out] == [2, 4]
    for r in out:
        assert r["song_path"] == wav
        for on, off, ch in r["alignment"]:
            assert 0.0 <= on <= off


def test_batch_matches_single(aligner, wav):
    """One fused batch == two independent requests (exact segments)."""
    batched = _run(aligner, [{"song_path": wav, "lyric": "你好"},
                             {"song_path": wav, "lyric": "好你"}])
    single = [_run(aligner, [{"song_path": wav, "lyric": "你好"}])[0],
              _run(aligner, [{"song_path": wav, "lyric": "好你"}])[0]]
    assert [b["alignment"] for b in batched] == [s["alignment"] for s in single]


def test_bad_request_isolated_in_batch(aligner, wav):
    reqs = [{"song_path": wav, "lyric": "你好"},
            {"song_path": "/nonexistent/x.wav", "lyric": "你好"},
            "not json {{{",
            {"song_path": wav, "lyric": "人"}]
    out = _run(aligner, reqs)
    assert len(out) == 4
    assert "alignment" in out[0] and "alignment" in out[3]
    assert "error" in out[1] and out[1]["song_path"] == "/nonexistent/x.wav"
    assert "error" in out[2]


def test_malformed_wav_isolated_in_batch(aligner, wav, tmp_path):
    """A corrupt WAV (forged bits-per-sample) surfaces as a per-request
    error, not a dead server."""
    bad = tmp_path / "bad_bits.wav"
    bad.write_bytes(forge_wav_bytes(bits=4, data=b"\x00" * 64))
    out = _run(aligner, [{"song_path": wav, "lyric": "你好"},
                         {"song_path": str(bad), "lyric": "你好"}])
    assert len(out) == 2
    assert "alignment" in out[0]
    assert "error" in out[1] and out[1]["song_path"] == str(bad)


def test_request_id_echoed(aligner, wav):
    reqs = [{"song_path": wav, "lyric": "你好", "id": 7},
            {"song_path": "/nonexistent/x.wav", "lyric": "你", "id": "req-b"},
            {"song_path": wav, "lyric": "人"}]
    out = _run(aligner, reqs)
    assert out[0]["id"] == 7 and "alignment" in out[0]
    assert out[1]["id"] == "req-b" and "error" in out[1]
    assert "id" not in out[2]


def test_batched_transcription(aligner, wav):
    out = _run(aligner, [{"song_path": wav, "task": "transcribe"},
                         {"song_path": wav, "task": "transcribe"}])
    assert len(out) == 2
    assert all("inference" in r for r in out)
    assert out[0]["inference"] == out[1]["inference"]


def test_transcription_decode_knobs_thread_through(aligner, wav):
    """--patience/--length-penalty reach the beam search on both the fused
    batched path and the single-request fallback (patience < 1 included)."""
    flags = ("--patience", "0.6", "--length-penalty", "1.0")
    batched = _run(aligner, [{"song_path": wav, "task": "transcribe"},
                             {"song_path": wav, "task": "transcribe"}], extra_flags=flags)
    single = _run(aligner, [{"song_path": wav, "task": "transcribe"}], max_batch=1,
                  extra_flags=flags)
    assert all("inference" in r for r in batched + single)
    assert batched[0]["inference"] == batched[1]["inference"] == single[0]["inference"]
    with pytest.raises(SystemExit):  # round(2 * 0.2) = 0: refused before loading
        parse_args(_argv(8, 0, ("--patience", "0.2")))


def test_max_batch_one_still_serves(aligner, wav):
    out = _run(aligner, [{"song_path": wav, "lyric": "你好"}], max_batch=1, window_ms=0.0)
    assert len(out) == 1 and len(out[0]["alignment"]) == 2


def test_transcribe_decode_batch_operating_point(aligner, wav, monkeypatch):
    """The decode batch defaults to min(serving batch, 8) and is
    overridable per call and by ``--transcribe-batch``."""
    import lyricalignment_tpu_torch.cli.inference_transcript as it

    seen = []

    def fake_transcribe_records(records, whisper, wcfg, wt, args):
        seen.append(args.batch_size)
        return [{"inference": ""} for _ in records]

    monkeypatch.setattr(it, "transcribe_records", fake_transcribe_records)
    orig = aligner.batch_size
    try:
        aligner.transcribe_many([wav])                  # serving batch 4 -> 4
        aligner.batch_size = 16
        aligner.transcribe_many([wav])                  # capped at 8
        aligner.transcribe_many([wav], batch_size=2)    # explicit override
        _run(aligner, [{"song_path": wav, "task": "transcribe"},
                       {"song_path": wav, "task": "transcribe"}],
             extra_flags=("--transcribe-batch", "3"))
    finally:
        aligner.batch_size = orig
    assert seen == [4, 8, 2, 3]


def test_responses_equal_jax_serve(model_dir, aligner, wav, tmp_path):
    """One stream (fused alignments of 16 kHz mono and 44.1 kHz stereo WAVs,
    a fused transcription pair, a bad path, a bad JSON line, ids) through
    both packages' ``serve`` on the same model dir."""
    rng = np.random.default_rng(11)
    stereo = str(tmp_path / "stereo44k.wav")
    t = np.arange(int(3.3 * 44100)) / 44100
    tone = 0.2 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 0.8 * t))
    write_wav(stereo, np.stack([tone, tone + 0.05 * rng.standard_normal(t.shape)]), 44100)
    reqs = [{"song_path": wav, "lyric": "你好世界", "id": 1},
            {"song_path": stereo, "lyric": "天地玄黄宇宙", "id": "b"},
            {"song_path": stereo, "task": "transcribe", "id": 3},
            "not json {{{",
            {"song_path": wav, "task": "transcribe"},
            {"song_path": "/nonexistent/x.wav", "lyric": "你", "id": 6},
            {"song_path": stereo, "lyric": "日月盈昃辰宿列张"}]

    got = _run(aligner, reqs)
    jax_aligner = JaxAligner.from_model_dir(model_dir, synthetic_vocab=True, use_ctc=True,
                                            batch_size=4)
    stdout = io.StringIO()
    jax_serve(jax_aligner, jax_parse_args(_argv(8, 300.0, ())), stdin=_stream(reqs),
              stdout=stdout)
    want = [json.loads(line) for line in stdout.getvalue().splitlines()]

    assert len(got) == len(want) == len(reqs)
    flips = total = 0
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        assert g.get("id") == w.get("id") and g["song_path"] == w["song_path"]
        if "inference" in w:
            assert g["inference"] == w["inference"]
        for (g_on, g_off, g_ch), (w_on, w_off, w_ch) in zip(g.get("alignment", []),
                                                             w.get("alignment", [])):
            assert g_ch == w_ch
            for a, b in ((g_on, w_on), (g_off, w_off)):
                total += 1
                flips += a != b
                assert abs(a - b) <= 0.02 + 1e-9, (a, b)
    assert [("error" in r) for r in got] == [False, False, False, True, False, True, False]
    assert total == 2 * (4 + 6 + 8)
    assert flips <= total // 50, f"{flips} of {total} boundaries differ"
