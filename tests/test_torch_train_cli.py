"""The port's train CLI end to end on the CPU (``--device cpu``): a few
synthetic WAVs with character timings, 2 steps of a miniature
backbone (registered as "tiny" for the run), eval every step, best/last
checkpoints (eval at the last step); the written model dir then loads through
``cli.common.load_model_dir`` and aligns with ``LyricAligner``; ``--resume``
continues from the last checkpoint's step."""

import json

import numpy as np
import pytest
import torch

from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig

MINI = WhisperConfig(n_vocab=64, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
                     n_text_state=64, n_text_head=1, n_text_layer=1)
LYRICS = ["天地玄黄", "宇宙洪荒日月"]


@pytest.fixture
def data(tmp_path, monkeypatch):
    from lyricalignment_tpu_torch.data.audio_io import write_wav

    monkeypatch.setitem(WHISPER_CONFIGS, "tiny", MINI)
    rng = np.random.default_rng(0)
    records = []
    for i, lyric in enumerate(LYRICS * 2):
        t = np.arange(int(3.0 * 16000)) / 16000.0
        audio = 0.2 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.02 * rng.standard_normal(t.shape)
        path = str(tmp_path / f"song{i}.wav")
        write_wav(path, audio.astype(np.float32))
        step = 2.5 / len(lyric)
        records.append({"song_path": path, "lyric": lyric,
                        "on_offset": [[0.2 + k * step, 0.2 + (k + 0.8) * step]
                                      for k in range(len(lyric))]})
    data = tmp_path / "data.json"
    data.write_text(json.dumps(records, ensure_ascii=False))
    dev = tmp_path / "dev.json"
    dev.write_text(json.dumps(records[:2], ensure_ascii=False))
    return tmp_path, str(data), str(dev)


def _argv(data, save_dir, steps, *extra):
    train, dev = data
    return ["--train-data", train, "--dev-data", dev, "--whisper-model", "tiny",
            "--train-alignment", "--train-transcript", "--use-ctc-loss",
            "--train-batch-size", "2", "--dev-batch-size", "2", "--accum-grad-steps", "1",
            "--train-steps", str(steps), "--eval-steps", str(steps), "--warmup-steps", "0",
            "--synthetic-vocab", "--device", "cpu", "--save-dir", save_dir, *extra]


def test_train_cli_two_steps_then_align_and_resume(data):
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.cli.common import load_model_dir
    from lyricalignment_tpu_torch.cli.train_multitask import main
    from lyricalignment_tpu_torch.text.bert_tokenizer import (
        BertWordPieceTokenizer,
        make_synthetic_vocab,
    )
    from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table

    tmp, data_json, dev_json = data
    save = str(tmp / "result")
    main(_argv((data_json, dev_json), save, 2))
    rows = [json.loads(line) for line in open(f"{save}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["total"]) and r["align_ctc"] > 0 for r in rows)
    for name in ("args.json", "model_args.json", "last_model.pt", "last_state.pt"):
        assert (tmp / "result" / name).exists(), name

    _, model, _ = load_model_dir(save, "last", device="cpu")
    assert model.cfg.whisper.onepass_encoder  # the inference default
    aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=make_synthetic_vocab(size=21128)),
                           load_pronunciation_table(), use_ctc=True)
    records = json.load(open(data_json))
    segments = aligner.align_many([(r["song_path"], r["lyric"]) for r in records[:2]])
    for segs, lyric in zip(segments, LYRICS):
        assert len(segs) == len(lyric)
        assert all(np.isfinite(on) and on < off <= 3.0 + 0.04 for on, off, _ in segs)

    state = torch.load(f"{save}/last_state.pt", weights_only=True)
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    main(_argv((data_json, dev_json), save, 3, "--resume", f"{save}/last_model"))
    rows = [json.loads(line) for line in open(f"{save}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert torch.load(f"{save}/last_state.pt", weights_only=True)["step"] == 3


@pytest.mark.parametrize("flags", [["--fused-losses"], ["--tensorboard", "--profile-at-step", "2"],
                                   ["--fused-losses", "--tensorboard", "--profile-at-step", "2"]])
def test_fused_losses_tensorboard_and_profile_flags(data, flags):
    """``--fused-losses`` trains on the fused losses (alone: step 1's losses
    equal an unfused run's, rtol 1e-4: the same data, seed and dropout);
    ``--tensorboard`` writes event files under ``tb/`` beside
    ``metrics.jsonl``; ``--profile-at-step 2`` writes the profile of step 2
    with its ``data`` and ``train_step`` spans."""
    from lyricalignment_tpu_torch.cli.train_multitask import main

    tmp, data_json, dev_json = data
    save = tmp / "r"
    main(_argv((data_json, dev_json), str(save), 2, *flags))
    rows = [json.loads(line) for line in open(save / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["total"]) and r["align_ctc"] > 0 for r in rows)
    assert json.loads((save / "args.json").read_text())["fused_losses"] == ("--fused-losses" in flags)
    if flags == ["--fused-losses"]:
        main(_argv((data_json, dev_json), str(tmp / "plain"), 1))
        plain = json.loads(open(tmp / "plain" / "metrics.jsonl").readline())
        for k in ("total", "align_ce", "align_ctc", "trans_ce", "trans_ctc"):
            np.testing.assert_allclose(rows[0][k], plain[k], rtol=1e-4, err_msg=k)
    assert any((save / "tb").glob("events.out.tfevents.*")) == ("--tensorboard" in flags)
    trace = save / "profile" / "trace.json"
    assert trace.exists() == ("--profile-at-step" in flags)
    if trace.exists():
        names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
        assert {"data", "train_step"} <= names


def test_whisper_checkpoint_initialises_the_backbone(tmp_path):
    """``--whisper-checkpoint``: an OpenAI-format ``.pt`` ({"dims",
    "model_state_dict"} in the port's key names) overwrites the random
    backbone; other dims are refused."""
    from types import SimpleNamespace

    from lyricalignment_tpu_torch.cli.common import (
        WHISPER_DIMS,
        build_model_config,
        init_model,
    )
    from lyricalignment_tpu_torch.models.whisper import Whisper

    mcfg = build_model_config("custom", output_dim=11,
                              whisper_dims={k: getattr(MINI, k) for k in WHISPER_DIMS})
    source = Whisper(mcfg.whisper)
    for p in source.parameters():
        p.data.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    path = tmp_path / "openai.pt"
    torch.save({"dims": {k: getattr(MINI, k) for k in WHISPER_DIMS},
                "model_state_dict": source.state_dict()}, path)
    args = SimpleNamespace(whisper_checkpoint=str(path))
    model = init_model(args, mcfg, seed=0, device=torch.device("cpu"))
    for name, value in source.state_dict().items():
        torch.testing.assert_close(model.whisper_model.state_dict()[name], value, msg=name)

    bad = dict(torch.load(path, weights_only=False), dims={
        k: getattr(MINI, k) + (k == "n_audio_layer") for k in WHISPER_DIMS})
    torch.save(bad, path)
    with pytest.raises(SystemExit, match="dims"):
        init_model(args, mcfg, seed=0, device=torch.device("cpu"))
