"""Meshed training of the port on gloo ranks spawned on the CPU.

One ``make_train_step`` of two micro-batches of 2, with the head's dropout
drawn, under data=2, model=2 (4 heads over 2 ranks, the vocabulary sharded)
and data=2 x model=2. Each micro-batch puts its align sample on one data
rank and its transcript sample on the other, and the samples' valid frames
and tokens differ, which is where a rank's local group mean averaged over
ranks would differ from the global one (by a factor of 2 here). Against
the single-process step on the same weights: losses rtol 1e-5; the
gradients the optimizer got, gathered, rtol 1e-5 of each entry or of its
tensor's largest (a few near-zero entries of the decoder's positional
embedding move by 2-3 ulp when a batch is summed in another order); the
updates by ``chip_smoke.py`` phase "train" (b)'s rule (at most 1 in 1000
entries off by more than 2e-2 lr); the clip's norm rtol 1e-5 of the single
process's and of the gathered gradients' norm in float64 (a float32 norm
of these gradients is itself 2e-6 from float64). The step trains align
CE and transcript CE: with the CTC loss its float32 gradient moves by up
to 5e-5 (rel-L2) when a batch is split in two, as it does in any
reordering (optax's float32 CTC gradient is 2.2e-3 from float64, ROADMAP
queue 3). The CTC losses' global counts are held without dropout: each
micro-batch's losses, CTC included, against JAX's ``make_eval_step`` at rel
1e-4 under data parallelism and 1e-3 under tensor parallelism, as JAX's own
tests hold its meshes (``tests/test_trainer.py:117-151``).

Then (marked slow) the train CLI over two ranks, ``--mesh-data 2`` for 2 steps: one
``metrics.jsonl`` and one model dir, written by rank 0 alone, which loads
unsharded with ``strict=True``; ``--resume`` from it under
``--mesh-model 2`` re-shards it and continues at step 3."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.align_model import AlignModelConfig as JaxAlignConfig
from lyricalignment_tpu.models.align_model import init_align_model
from lyricalignment_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from lyricalignment_tpu.train.trainer import TrainConfig as JaxTrainConfig
from lyricalignment_tpu.train.trainer import make_eval_step as jax_make_eval_step
from lyricalignment_tpu_torch.models.whisper import WhisperConfig
from tests import torch_parallel_helpers as tph
from tests.torch_port_helpers import as_jax, torch_model

VOCAB = 10  # tiny stand-in for 21128, as in tests/test_trainer.py
TCFG = dict(accum_grad_steps=2, use_ctc=False, vocab_size=VOCAB, total_steps=10,
            warmup_steps=0, head_lr=5e-3, backbone_lr=1e-3)
EVAL = dict(use_ctc=True)
SEED = 7
# align (True) and transcript samples of the two micro-batches: row 0 goes
# to data rank 0, row 1 to data rank 1
HAS_ALIGNMENT = ([True, False], [False, True])


def _jax_setup():
    cfg = JaxAlignConfig(
        whisper=JaxWhisperConfig(
            n_mels=80, n_vocab=32, n_audio_ctx=1500, n_audio_state=256, n_audio_head=4,
            n_audio_layer=1, n_text_ctx=16, n_text_state=256, n_text_head=4, n_text_layer=1),
        hidden_dim=8, output_dim=VOCAB + 1, train_alignment=True, train_transcript=True)
    params = init_align_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    return cfg, params


def _micro(rng, has_alignment):
    b = len(has_alignment)
    return {
        "audio": rng.standard_normal((b, 480000)).astype(np.float32) * 0.05,
        "ctc_labels": np.where(np.arange(6)[None, :] < rng.integers(1, 6, (b, 1)),
                               rng.integers(1, VOCAB - 1, (b, 6)), -100).astype(np.int32),
        "frame_labels": np.where(rng.random((b, 1500)) < rng.uniform(0.1, 0.5, (b, 1)),
                                 rng.integers(1, VOCAB - 1, (b, 1500)), -100).astype(np.int32),
        "label_lengths": np.full((b,), 3, np.int32),
        "has_alignment": np.array(has_alignment, np.bool_),
        "decoder_input": rng.integers(0, 32, (b, 5)).astype(np.int32),
        "decoder_output": np.where(rng.random((b, 5)) < 0.8, rng.integers(0, 32, (b, 5)),
                                   -100).astype(np.int32),
    }


@pytest.fixture(scope="module")
def setup():
    cfg, params = _jax_setup()
    rng = np.random.default_rng(1)
    micros = [_micro(rng, h) for h in HAS_ALIGNMENT]
    stacked = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    model = torch_model(cfg, params)
    payload = {"cfg": model.cfg, "sd": tph.numpy_dict(model.state_dict()), "tcfg": TCFG,
               "stacked": stacked, "seed": SEED, "eval_kw": EVAL}
    single = tph.train_results(model.cfg, payload["sd"], TCFG, stacked, SEED, eval_kw=EVAL)
    eval_fn = jax_make_eval_step(cfg, JaxTrainConfig(**dict(TCFG, **EVAL)))
    jax_eval = [{k: float(v) for k, v in eval_fn(as_jax(params), jax.tree_util.tree_map(
        jnp.asarray, m)).items()} for m in micros]
    return payload, single, jax_eval


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    payload = dict(setup[0], meshes=[(2, 1), (1, 2)])
    return tph.run_ranks(tph.train_checks, 2, tmp_path_factory.mktemp("w2"), payload)


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    payload = dict(setup[0], meshes=[(2, 2)])
    return tph.run_ranks(tph.train_checks, 4, tmp_path_factory.mktemp("w4"), payload)


def _cases(world2, world4):
    return {(2, 1): [r[(2, 1)] for r in world2], (1, 2): [r[(1, 2)] for r in world2],
            (2, 2): [r[(2, 2)] for r in world4]}


@pytest.fixture(scope="module", params=[(2, 1), (1, 2), (2, 2)], ids=["data2", "model2", "2x2"])
def meshed(request, world2, world4):
    return request.param, _cases(world2, world4)[request.param]


def test_losses_and_gathered_gradients_match_single(setup, meshed):
    _, single, _ = setup
    _, ranks = meshed
    assert single["losses"]["align_ce"] > 0 and single["losses"]["trans_ce"] > 0
    for out in ranks:
        for k, v in single["losses"].items():
            np.testing.assert_allclose(out["losses"][k], v, rtol=1e-5, err_msg=k)
        assert set(out["grads"]) == set(single["grads"])
        for name, g in single["grads"].items():
            if g is None:
                assert out["grads"][name] is None, name
                continue
            np.testing.assert_allclose(out["grads"][name], g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_clip_norm_is_the_full_gradients(setup, meshed):
    _, single, _ = setup
    _, ranks = meshed
    for out in ranks:
        np.testing.assert_allclose(out["norm"], out["full_norm"], rtol=1e-5)
        np.testing.assert_allclose(out["norm"], single["norm"], rtol=1e-5)


def test_updates_match_single(setup, meshed):
    payload, single, _ = setup
    _, ranks = meshed
    for out in ranks:
        for name, want in single["after"].items():
            lr = TCFG["head_lr"] if name.startswith("align_rnn.") else TCFG["backbone_lr"]
            off = np.abs(out["after"][name] - want) > 2e-2 * lr
            assert off.mean() <= 1e-3, name


def test_losses_without_dropout_match_jax_eval(setup, meshed):
    _, single, jax_eval = setup
    shape, ranks = meshed
    rel = 1e-4 if shape[1] == 1 else 1e-3
    assert all(e["align_ctc"] > 0 and e["trans_ctc"] > 0 for e in jax_eval)
    for out in [{"eval": single["eval"]}] + ranks:
        for got, want, base in zip(out["eval"], jax_eval, single["eval"]):
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=rel, abs=1e-6), k
                assert got[k] == pytest.approx(base[k], rel=1e-5), k


MINI = WhisperConfig(n_vocab=64, n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                     n_text_state=128, n_text_head=2, n_text_layer=1)
LYRICS = ["天地玄黄", "宇宙洪荒日月"]


@pytest.mark.slow  # two 2-rank CLI runs with the CLI's 384-wide bi-GRU head, ~40 s
def test_train_cli_over_two_ranks_then_resume_tensor_parallel(tmp_path, monkeypatch):
    from lyricalignment_tpu_torch.cli.common import load_model_dir
    from lyricalignment_tpu_torch.data.audio_io import write_wav
    from lyricalignment_tpu_torch.text.bert_tokenizer import make_synthetic_vocab

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
    (tmp_path / "data.json").write_text(json.dumps(records, ensure_ascii=False))
    # a 500-token vocabulary (above the 402 syllable classes) keeps the head small
    vocab = make_synthetic_vocab("".join(LYRICS), size=500)
    (tmp_path / "vocab.txt").write_text(
        "\n".join(t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])) + "\n")

    def argv(save, steps, *extra):
        return ["--train-data", str(tmp_path / "data.json"), "--dev-data",
                str(tmp_path / "data.json"), "--whisper-model", "tiny", "--train-alignment",
                "--train-transcript", "--use-ctc-loss", "--bert-vocab", str(tmp_path / "vocab.txt"),
                "--train-batch-size", "2", "--dev-batch-size", "2", "--accum-grad-steps", "1",
                "--train-steps", str(steps), "--eval-steps", str(steps), "--warmup-steps", "0",
                "--device", "cpu", "--save-dir", save, *extra]

    save = str(tmp_path / "result")
    printed = tph.run_ranks(tph.train_cli, 2, tmp_path / "run1",
                            {"tiny": MINI, "argv": argv(save, 2, "--mesh-data", "2")})
    assert "mesh: {'data': 2, 'model': 1}" in printed[0] and printed[1] == ""
    rows = [json.loads(line) for line in open(f"{save}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["total"]) and r["align_ctc"] > 0 for r in rows)
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS

    monkeypatch.setitem(WHISPER_CONFIGS, "tiny", MINI)
    _, model, _ = load_model_dir(save, "last", device="cpu")  # strict, unsharded
    assert model.whisper_model.encoder.blocks[0].attn.n_head == 2

    save2 = str(tmp_path / "resumed")
    printed = tph.run_ranks(tph.train_cli, 2, tmp_path / "run2", {
        "tiny": MINI, "argv": argv(save2, 3, "--mesh-model", "2",
                                   "--resume", f"{save}/last_model")})
    assert f"resumed from {save}/last_model at step 2" in printed[0] and printed[1] == ""
    rows = [json.loads(line) for line in open(f"{save2}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [3] and np.isfinite(rows[0]["total"])
    full = torch.load(f"{save2}/last_model.pt", weights_only=True)
    assert full["whisper_model.encoder.blocks.0.attn.query.weight"].shape == (128, 128)
    assert full["whisper_model.decoder.token_embedding.weight"].shape == (64, 128)
