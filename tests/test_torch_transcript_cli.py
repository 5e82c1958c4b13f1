"""The port's transcription entry points against the JAX package's:
``cli.inference_transcript.transcribe_records`` with ``--device cpu`` on
converted weights equals JAX's ``transcribe_records`` on the same WAV
records (clips within one window, ``--fast-windows`` and long-form, with
and without a BPE ranks file), besides the port's ``avg_logprob`` (one
score a window, ``None`` for a long-form song); ``main`` writes that JSON
and refuses to overwrite it; ``LyricAligner.transcribe_many`` returns the
same texts."""

import base64
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lyricalignment_tpu.cli.inference_transcript import transcribe_records as jax_transcribe
from lyricalignment_tpu.data.records import Record as JaxRecord
from lyricalignment_tpu.text.whisper_tokenizer import WhisperTokenizer as JaxWhisperTokenizer
from lyricalignment_tpu_torch.cli import inference_transcript as cli
from lyricalignment_tpu_torch.data.audio_io import write_wav
from lyricalignment_tpu_torch.data.records import Record
from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
from tests.torch_port_helpers import TINY_DIMS, as_jax, jax_tiny_model, torch_model
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

DIMS = dict(n_vocab=51865, n_text_ctx=64)
SECONDS = (12.0, 30.0, 40.0, 70.0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("transcribe")
    # the configuration load_model_dir builds: head width 384, one-pass encoder
    cfg, params = jax_tiny_model(seed=1, hidden_dim=384, dims=DIMS, onepass_encoder=True)
    # damp the text rows past the byte range, so the decoder picks tokens
    # the byte-level ranks file can render
    params["whisper"]["decoder"]["token_embedding"][256:50257] *= 0.05
    model = torch_model(cfg, params)
    rng = np.random.default_rng(3)
    paths = []
    for i, sec in enumerate(SECONDS):
        path = str(d / f"song{i}.wav")
        write_wav(path, (rng.standard_normal(int(sec * 16000)) * 0.1).astype(np.float32))
        paths.append(path)
    ranks = d / "ranks.tiktoken"
    ranks.write_text("\n".join(base64.b64encode(bytes([i])).decode() + f" {i}"
                               for i in range(256)))
    return SimpleNamespace(dir=d, cfg=cfg, params=params, model=model, paths=paths,
                           ranks=str(ranks))


def _args(**kw):
    base = dict(is_mixture=0, batch_size=2, beam_size=3, max_new_tokens=8,
                use_groundtruth=True, temperature_fallback=False, fast_windows=False,
                length_penalty=None, patience=None, no_condition_on_previous_text=False,
                seed=114514, decode_group=1)
    return SimpleNamespace(**{**base, **kw})


CASES = {
    # two clips within a window, two long songs through the lockstep seek loop
    "beam3_longform": dict(kw={}, bpe=False),
    "greedy_fast_windows_bpe": dict(kw=dict(beam_size=1, fast_windows=True), bpe=True),
    "beam2_one_longform_bpe": dict(kw=dict(beam_size=2), bpe=True, songs=(0, 3)),
}


@pytest.fixture(scope="module")
def runs(setup):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's Python WAV reader, which the port copies
        mp.setattr("lyricalignment_tpu.data.native_loader.available", lambda: False)
        for name, case in CASES.items():
            songs = case.get("songs", range(len(SECONDS)))
            paths = [setup.paths[i] for i in songs]
            bpe = setup.ranks if case["bpe"] else None
            args = _args(**case["kw"])
            got = cli.transcribe_records(
                [Record(audio_path=p, text=f"lyric{i}") for i, p in enumerate(paths)],
                setup.model.whisper_model, setup.model.cfg.whisper,
                WhisperTokenizer(bpe_path=bpe), args)
            want = jax_transcribe(
                [JaxRecord(audio_path=p, text=f"lyric{i}") for i, p in enumerate(paths)],
                as_jax(setup.params)["whisper"], setup.cfg.whisper,
                JaxWhisperTokenizer(bpe_path=bpe), args)
            out[name] = (got, want)
    return out


def _without_scores(results):
    """The results less the port's ``avg_logprob``, which JAX's lack."""
    return [{k: v for k, v in entry.items() if k != "avg_logprob"} for entry in results]


@pytest.mark.parametrize("name", list(CASES))
def test_transcribe_records_equals_jax(runs, name):
    got, want = runs[name]
    assert _without_scores(got) == want
    assert all(entry["inference"] not in ("", "[]") for entry in want)
    case = CASES[name]
    for entry, i in zip(got, case.get("songs", range(len(SECONDS)))):
        if SECONDS[i] > 30.0 and not case["kw"].get("fast_windows"):
            assert entry["avg_logprob"] is None
        else:
            scores = entry["avg_logprob"]
            assert len(scores) == -(-int(SECONDS[i]) // 30)
            assert all(isinstance(x, float) and x < 0 for x in scores)


@pytest.fixture(scope="module")
def model_dir(setup):
    d = setup.dir / "model"
    d.mkdir()
    (d / "args.json").write_text(json.dumps({"whisper_model": "custom",
                                             "whisper_dims": {**TINY_DIMS, **DIMS}}))
    (d / "model_args.json").write_text(json.dumps({"output_dim": 420}))
    torch.save(setup.model.state_dict(), d / "best_model.pt")
    data = setup.dir / "test.json"
    data.write_text(json.dumps([{"song_path": p, "lyric": f"lyric{i}"}
                                for i, p in enumerate(setup.paths)]))
    return str(d), str(data)


def test_main_writes_the_json_and_refuses_to_overwrite(setup, runs, model_dir, capsys):
    d, data = model_dir
    out = str(setup.dir / "out" / "result.json")
    argv = ["-f", data, "--model-dir", d, "-o", out, "--device", "cpu", "--beam_size", "3",
            "--max-new-tokens", "8", "--batch-size", "2", "--use-groundtruth"]
    cli.main(argv)
    with open(out, encoding="utf-8") as f:
        written = json.load(f)
    assert _without_scores(written) == runs["beam3_longform"][1]
    before = os.path.getmtime(out)
    capsys.readouterr()
    cli.main(argv + ["--beam_size", "1"])
    assert "File Exists, Pass" in capsys.readouterr().out
    assert os.path.getmtime(out) == before
    with open(out, encoding="utf-8") as f:
        assert json.load(f) == written


def test_transcribe_many_returns_the_same_texts(setup, runs):
    from lyricalignment_tpu_torch.api import LyricAligner

    aligner = LyricAligner(setup.model, None, None, batch_size=2)
    texts = aligner.transcribe_many(setup.paths, beam_size=3, max_new_tokens=8)
    assert texts == [entry["inference"] for entry in runs["beam3_longform"][1]]
    assert aligner.transcribe(setup.paths[0], beam_size=3, max_new_tokens=8) == texts[0]


def test_main_transcribes_with_a_pretrained_openai_checkpoint(setup, tmp_path):
    """``--use-pretrained --whisper-checkpoint``: the config comes from the
    checkpoint's dims (the flash route, float32, as JAX's
    ``load_openai_checkpoint`` gives it), the weights load strictly, and
    ``main`` writes what ``transcribe_records`` gives with that model."""
    ckpt = str(tmp_path / "whisper.pt")
    torch.save({"dims": {**TINY_DIMS, **DIMS},
                "model_state_dict": setup.model.whisper_model.state_dict()}, ckpt)
    wcfg, whisper = cli.load_pretrained_whisper(ckpt, bf16=False, device="cpu")
    assert not wcfg.onepass_encoder and wcfg.compute_dtype == torch.float32
    for name, value in setup.model.whisper_model.state_dict().items():
        assert torch.equal(whisper.state_dict()[name], value), name
    data = tmp_path / "one.json"
    data.write_text(json.dumps([{"song_path": setup.paths[0], "lyric": "lyric0"}]))
    out = str(tmp_path / "pretrained.json")
    cli.main(["-f", str(data), "--model-dir", str(tmp_path / "absent"), "--use-pretrained",
              "--whisper-checkpoint", ckpt, "-o", out, "--device", "cpu", "--beam_size", "1",
              "--max-new-tokens", "8"])
    want = cli.transcribe_records([Record(audio_path=setup.paths[0], text="lyric0")], whisper,
                                  wcfg, WhisperTokenizer(), _args(beam_size=1,
                                                                  use_groundtruth=False))
    with open(out, encoding="utf-8") as f:
        assert json.load(f) == want
