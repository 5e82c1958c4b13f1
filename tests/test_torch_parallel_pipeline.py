"""GPipe pipeline parallelism of the port (``parallel/pipeline.py``) on gloo
ranks spawned on the CPU, against the JAX functions that JAX's own
``tests/test_pipeline.py`` holds its pipeline equal to, computed here in
one process, and against the port's single process.

Two worlds, each running several cases: four ranks (DP2 x PP2, and a pure
pipe mesh of 4) and two (a pure pipe mesh of 2, the layout of two stages on
one card). The cases of ``tests/test_pipeline.py``: the encoder for n_micro
1 and 2, with pre-stacked blocks, on a pure pipe mesh and with 2 layers a
stage, at JAX's rtol / atol 2e-5; the gradients of sum(encode_audio ** 2)
with and without remat, and the decoder's logits and the gradients of
mean(logits ** 2) wrt its parameters and the cross-attention memory, at
JAX's 5e-4 / 5e-5 and at 1e-5 of the port's single process; the train step
with both halves staged. That step is JAX's case with one micro-batch a
step (half the time on the CPU), a transcript-only row, warmup 0 and a
backbone rate of 1e-3 (JAX's warmup 1 makes the first update's rate 0, so
the parameters would not move): losses at 1e-4 of JAX's unpipelined step
and 1e-5 of the port's single process, the gradients the clip saw at 1e-5
of the single process's (elementwise, or 1e-5 of the tensor's largest
entry; under DP2 the CTC gradient of a split batch moves ~5e-5, so there
1e-4), the clip's norm at 1e-5, and the updates by ``chip_smoke.py`` phase
"train" (b)'s rule (at most 1 in 1000 entries off by more than 2e-2 of the
rate) of each tensor against the single process's, and of the whole model
against JAX's (JAX's float32 CTC gradient differs from the port's on
near-zero entries, whose clipped first Adam step is then another). Then
the alignment CLI under ``--mesh-data 2 --mesh-pipe 2`` with an even and an
odd local batch (one micro-batch) at JAX's atol 1e-4
(``tests/test_parallel_infer.py:72-91, 140-166``), the
"pick one" refusal, the refusals of indivisible layers, of a batch that
n_micro does not divide and of the sequence-parallel encode on a pipelined
model, and each rank's block bytes (1 / S of the model's). A checkpoint written under the pure pipe mesh loads
unsharded and resumes. Every CLI has every flag of its JAX counterpart.

Under ``slow``: the train CLI over two ranks with ``--mesh-pipe 2`` and
both halves staged, then ``--resume`` under ``--mesh-pipe 2``."""

import argparse
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from lyricalignment_tpu.cli.inference_alignment import align_records as jax_align_records
from lyricalignment_tpu.data.records import Record as JaxRecord
from lyricalignment_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from lyricalignment_tpu.models.whisper import decoder_logits as jax_decoder_logits
from lyricalignment_tpu.models.whisper import encode_audio as jax_encode_audio
from lyricalignment_tpu.models.whisper import init_whisper_params as jax_init_whisper
from lyricalignment_tpu.train.trainer import TrainConfig as JaxTrainConfig
from lyricalignment_tpu.train.trainer import init_train_state as jax_init_train_state
from lyricalignment_tpu.train.trainer import make_train_step as jax_make_train_step
from lyricalignment_tpu_torch.data.audio_io import write_wav
from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from lyricalignment_tpu_torch.models.whisper import WhisperConfig, decoder_logits, encode_audio
from lyricalignment_tpu_torch.parallel.pipeline import stack_decoder_blocks, stack_encoder_blocks
from tests import torch_parallel_helpers as tph
from tests.torch_port_helpers import as_jax, jax_tiny_model, jax_whisper_sd, torch_model

ENC = dict(n_mels=8, n_vocab=32, n_audio_ctx=32, n_audio_state=16, n_audio_head=2,
           n_audio_layer=4, n_text_ctx=8, n_text_state=16, n_text_head=2, n_text_layer=1)
DEC = dict(ENC, n_audio_ctx=16, n_audio_layer=1, n_text_layer=4)
TRAIN_DIMS = dict(n_audio_state=16, n_audio_head=2, n_audio_layer=4, n_text_ctx=8,
                  n_text_state=16, n_text_head=2, n_text_layer=4, n_vocab=32)
ALIGN_DIMS = dict(n_audio_state=256, n_audio_head=4, n_audio_layer=2, n_text_state=256,
                  n_text_head=4, n_text_layer=1, n_vocab=64)
VOCAB = 12
TCFG = dict(accum_grad_steps=1, use_ctc=True, vocab_size=VOCAB, total_steps=4, warmup_steps=0,
            head_lr=5e-3, backbone_lr=1e-3)


def _whisper(dims, seed):
    """(port config, port state dict, JAX params) of a JAX-initialised
    whisper."""
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_init_whisper(jax.random.PRNGKey(seed),
                                                     JaxWhisperConfig(**dims)))
    return WhisperConfig(**dims), jax_whisper_sd(params, dims["n_audio_ctx"]), params


def _port_grads(module, prefix):
    return {n: p.grad.numpy().copy() for n, p in module.named_parameters()
            if n.startswith(prefix)}


def _jax_grads(grads, n_audio_ctx, prefix):
    """JAX's gradients in the port's names (the converter adds the
    encoder's positional buffer, not a parameter: dropped)."""
    sd = jax_whisper_sd(jax.tree_util.tree_map(np.asarray, grads), n_audio_ctx)
    return {n: np.asarray(v) for n, v in sd.items()
            if n.startswith(prefix) and n != "encoder.positional_embedding"}


def _train_batch(rng):
    accum, b = 1, 4
    return {
        "audio": rng.standard_normal((accum, b, 32000)).astype(np.float32) * 0.05,
        "ctc_labels": np.pad(rng.integers(1, VOCAB - 1, (accum, b, 3)).astype(np.int32),
                             ((0, 0), (0, 0), (0, 3)), constant_values=-100),
        "frame_labels": np.where(rng.random((accum, b, 1500)) < 0.3,
                                 rng.integers(1, VOCAB - 1, (accum, b, 1500)),
                                 -100).astype(np.int32),
        "label_lengths": np.full((accum, b), 3, np.int32),
        # a transcript-only row on one data rank: the loss groups' global counts
        "has_alignment": np.array([[True, False, True, True]]),
        "decoder_input": rng.integers(0, 32, (accum, b, 5)).astype(np.int32),
        "decoder_output": rng.integers(0, 32, (accum, b, 5)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(7)
    ref = {}
    # the encoder: 4 layers (2 a stage over 2 stages, 1 over 4)
    cfg, sd, params = _whisper(ENC, 0)
    mel = rng.standard_normal((4, 8, 64)).astype(np.float32)
    jcfg = JaxWhisperConfig(**ENC)
    ref["enc"] = np.asarray(jax.jit(jax_encode_audio, static_argnums=1)(
        as_jax(params), jcfg, jnp.asarray(mel)))
    ref["enc_grads"] = _jax_grads(jax.jit(jax.grad(lambda p: jnp.sum(
        jax_encode_audio(p, jcfg, jnp.asarray(mel)) ** 2)))(as_jax(params)), 32, "encoder.")
    single = tph.whisper_model(cfg, sd)
    y = encode_audio(single, torch.tensor(mel))
    (y ** 2).sum().backward()
    ref["port_enc"], ref["port_enc_grads"] = y.detach().numpy(), _port_grads(single, "encoder.")

    # the decoder: 4 layers, loss mean(logits ** 2)
    dcfg, dsd, dparams = _whisper(DEC, 5)
    tokens = rng.integers(0, 32, (4, 6)).astype(np.int32)
    xa = rng.standard_normal((4, 16, 16)).astype(np.float32)
    jdcfg = JaxWhisperConfig(**DEC)
    ref["dec"] = np.asarray(jax.jit(jax_decoder_logits, static_argnums=1)(
        as_jax(dparams), jdcfg, jnp.asarray(tokens), jnp.asarray(xa)))
    g_p, g_xa = jax.jit(jax.grad(lambda p, a: jnp.mean(jax_decoder_logits(
        p, jdcfg, jnp.asarray(tokens), a) ** 2), argnums=(0, 1)))(as_jax(dparams),
                                                                  jnp.asarray(xa))
    ref["dec_grads"], ref["dec_dxa"] = _jax_grads(g_p, 16, "decoder."), np.asarray(g_xa)
    single = tph.whisper_model(dcfg, dsd)
    a = torch.tensor(xa, requires_grad=True)
    (decoder_logits(single, torch.tensor(tokens), a) ** 2).mean().backward()
    ref["port_dec_grads"], ref["port_dec_dxa"] = _port_grads(single, "decoder."), a.grad.numpy()

    # the train step with both halves staged
    jcfg_t, tparams = jax_tiny_model(output_dim=VOCAB + 1, hidden_dim=8, seed=3,
                                     dims=TRAIN_DIMS)
    jcfg_t = dataclasses.replace(jcfg_t, train_transcript=True, dropout=0.0)
    tmodel = torch_model(jcfg_t, tparams)
    tsd = tph.numpy_dict(tmodel.state_dict())
    stacked = _train_batch(rng)
    state, tx = jax_init_train_state(as_jax(tparams), JaxTrainConfig(**TCFG))
    state, losses = jax_make_train_step(jcfg_t, JaxTrainConfig(**TCFG), tx)(
        state, jax.tree_util.tree_map(jnp.asarray, stacked), jax.random.PRNGKey(4))
    ref["jax_losses"] = {k: float(v) for k, v in losses.items()}
    ref["jax_after"] = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params)).items()}
    from lyricalignment_tpu_torch.train.trainer import TrainConfig

    ref["single"], st = tph.step_results(tph.align_model(tmodel.cfg, tsd), TrainConfig(**TCFG),
                                         stacked, 0)
    ref["single2"], _ = tph.step_results(st[0].model, TrainConfig(**TCFG), stacked, 0, state=st)

    # the alignment CLI: 6 records in batches of 4
    d = tmp_path_factory.mktemp("audio")
    wavs = []
    for i in range(6):
        wavs.append(str(d / f"r{i}.wav"))
        write_wav(wavs[-1], (rng.standard_normal(int((3.0 + 0.7 * i) * 16000)) * 0.1)
                  .astype(np.float32))
    acfg, aparams = jax_tiny_model(dims=ALIGN_DIMS, output_dim=tph.N_CLASSES + 1, fc_scale=4.0,
                                   seed=5)
    amodel = torch_model(acfg, aparams)
    ref["align_single"] = tph.align_segments(amodel, wavs)
    ref["align_jax"] = [seg for _, seg in jax_align_records(
        [JaxRecord(audio_path=w, text="abcde") for w in wavs], as_jax(aparams), acfg,
        tph.StubTable(), tph.StubBert(), tph.align_args())]

    payload = {"enc": (cfg, sd, mel), "dec": (dcfg, dsd, tokens, xa),
               "train": (tmodel.cfg, tsd, TCFG, stacked, 0),
               "align": (amodel.cfg, tph.numpy_dict(amodel.state_dict()), wavs),
               "tmp": str(tmp_path_factory.mktemp("ckpt"))}
    return payload, ref


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    return tph.run_ranks(tph.pipe_checks_world4, 4, tmp_path_factory.mktemp("w4"), setup[0])


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    return tph.run_ranks(tph.pipe_checks_world2, 2, tmp_path_factory.mktemp("w2"), setup[0])


def _rows(ranks, key, model_size):
    """The global batch from each data rank's output (every pipe member of
    a data rank holds the same); checks the members agree bit for bit."""
    parts = []
    for start in range(0, len(ranks), model_size):
        group = [r[key] for r in ranks[start:start + model_size]]
        for other in group[1:]:
            np.testing.assert_array_equal(other, group[0])
        parts.append(group[0])
    return np.concatenate(parts)


ENCODER_CASES = {"dp2pp2_m1": (4, 2), "dp2pp2_m2": (4, 2), "prestacked": (4, 2),
                 "pp4_m1": (4, 4), "pp4_m2": (4, 4), "pp2_m1": (2, 2), "pp2_m2": (2, 2)}


@pytest.mark.parametrize("case", ENCODER_CASES)
def test_encoder_matches_jax(setup, world4, world2, case):
    _, ref = setup
    world, model_size = ENCODER_CASES[case]
    got = _rows(world4 if world == 4 else world2, case, model_size)
    np.testing.assert_allclose(got, ref["enc"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref["port_enc"], rtol=1e-5, atol=1e-6)


def _check_grads(got, jax_ref, port_ref):
    assert set(got) == set(jax_ref) == set(port_ref)
    for name, g in got.items():
        np.testing.assert_allclose(g, jax_ref[name], rtol=5e-4, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(g, port_ref[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(port_ref[name]).max(), err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", ["dp2pp2", "pp2", "pp4"])
def test_encoder_gradients_match(setup, world4, world2, case, remat):
    _, ref = setup
    ranks = world2 if case == "pp2" else world4
    for out in ranks:
        _check_grads(out[f"{case}_grads_remat{remat}"], ref["enc_grads"], ref["port_enc_grads"])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", ["dec_dp2pp2", "dec_pp2"])
def test_decoder_logits_and_gradients_match(setup, world4, world2, case, remat):
    """The gradient wrt xa is each stage's contribution summed over the
    pipe group; the parameters' are their owners'."""
    _, ref = setup
    ranks, model_size = (world4, 2) if case == "dec_dp2pp2" else (world2, 2)
    np.testing.assert_allclose(_rows(ranks, f"{case}_logits", model_size), ref["dec"],
                               rtol=2e-5, atol=2e-5)
    dxa = _rows(ranks, f"{case}_dxa_remat{remat}", model_size)
    np.testing.assert_allclose(dxa, ref["dec_dxa"], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(dxa, ref["port_dec_dxa"], rtol=1e-5, atol=1e-7)
    for out in ranks:
        _check_grads(out[f"{case}_grads_remat{remat}"], ref["dec_grads"], ref["port_dec_grads"])


def test_each_rank_holds_its_stage(setup, world4):
    cfg, sd, _ = setup[0]["enc"]
    full = tph.block_bytes(tph.whisper_model(cfg, sd), ("encoder",))
    assert full > 0
    for out in world4:
        assert out["pp4_bytes"] * 4 == full
        assert out["train"]["bytes"] * 2 == tph.block_bytes(
            tph.align_model(*setup[0]["train"][:2]).whisper_model)


def _lr(name):
    return TCFG["head_lr"] if name.startswith("align_rnn.") else TCFG["backbone_lr"]


def _updates_close(got, want, per_tensor=True):
    """At most 1 in 1000 entries off by more than 2e-2 of the rate: of each
    tensor, or (``per_tensor`` False) of the whole model."""
    off = {name: np.abs(got[name] - w) > 2e-2 * _lr(name) for name, w in want.items()}
    if per_tensor:
        for name, o in off.items():
            assert o.mean() <= 1e-3, name
    else:
        assert sum(o.sum() for o in off.values()) <= 1e-3 * sum(o.size for o in off.values())


@pytest.mark.parametrize("world", [4, 2], ids=["dp2pp2", "pp2"])
def test_train_step_with_both_halves_staged(setup, world4, world2, world):
    _, ref = setup
    single = ref["single"]
    assert single["losses"]["align_ce"] > 0 and single["losses"]["trans_ce"] > 0
    # a split batch moves the float32 CTC gradient by ~5e-5 (rel-L2)
    rel = 1e-4 if world == 4 else 1e-5
    for out in (world4 if world == 4 else world2):
        out = out["train"]
        for k, v in ref["jax_losses"].items():
            assert out["losses"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
            assert out["losses"][k] == pytest.approx(single["losses"][k], rel=1e-5), k
        assert out["norm"] == pytest.approx(single["norm"], rel=1e-5)
        for name, g in single["grads"].items():
            np.testing.assert_allclose(out["grads"][name], g, rtol=rel,
                                       atol=rel * np.abs(g).max(), err_msg=name)
        _updates_close(out["after"], single["after"])
        # JAX's float32 CTC gradient differs from the port's by ~1e-3 on
        # near-zero entries, whose clipped Adam steps then differ
        _updates_close(out["after"], ref["jax_after"], per_tensor=False)


def test_checkpoint_under_pipe_loads_unsharded_and_resumes(setup, world2):
    """Rank 0 wrote the full state of the pipe mesh's first step: it loads
    into an unsharded AlignModel with strict=True and holds the single
    process's parameters; restored onto freshly staged ranks it resumes at
    step 1, and the second step equals the single process's."""
    payload, ref = setup
    from lyricalignment_tpu_torch.models.align_model import AlignModel

    full = torch.load(f"{payload['tmp']}/last_model.pt", weights_only=True)
    model = AlignModel(payload["train"][0])
    model.load_state_dict(full, strict=True)
    _updates_close({k: v.numpy() for k, v in full.items()}, ref["single"]["after"])
    for out in world2:
        assert out["train"]["resumed_step"] == 1
        second = out["train"]["second"]
        for k, v in ref["single2"]["losses"].items():
            assert second["losses"][k] == pytest.approx(v, rel=1e-5), k
        _updates_close(second["after"], ref["single2"]["after"])


def _segments_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("case", ["align", "align_odd"])
def test_alignment_cli_dp_pp_matches_single(setup, world4, case):
    """``--mesh-data 2 --mesh-pipe 2``: batches of 4 (2 rows a data rank, 2
    micro-batches) and of 6 (3 rows: one micro-batch)."""
    _, ref = setup
    _segments_close(ref["align_single"], ref["align_jax"])
    for out in world4:
        _segments_close(out[case], ref["align_single"])
        _segments_close(out[case], ref["align_jax"])


def test_mesh_pipe_excludes_tensor_parallelism(setup):
    acfg, asd, wavs = setup[0]["align"]
    with pytest.raises(SystemExit, match="pick one"):
        tph.align_segments(tph.align_model(acfg, asd), wavs[:4], mesh_data=2, mesh_model=2,
                           mesh_pipe=2)


def test_refusals(world4):
    blocks = nn.ModuleList(nn.Linear(2, 2) for _ in range(3))
    with pytest.raises(ValueError, match="3 encoder layers not divisible by 2 stages"):
        stack_encoder_blocks(blocks, 2)
    with pytest.raises(ValueError, match="3 decoder layers not divisible by 2 stages"):
        stack_decoder_blocks(blocks, 2)
    for out in world4:
        batch, sequence = out["refusals"]
        assert "per-shard batch 3 not divisible by n_micro=2" in batch
        assert "not a pipelined one" in sequence


class _Parsed(Exception):
    pass


def _options(module, monkeypatch):
    """Every option string of a CLI module's parser (``sub --flag`` for a
    subcommand's), read by stopping its ``parse_args``."""
    def stop(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as caught:
        importlib.import_module(module).parse_args()
    parser = caught.value.args[0]
    opts = set(parser._option_string_actions)
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                opts |= {f"{name} {o}" for o in sub._option_string_actions}
    return opts


@pytest.mark.parametrize("cli", ["convert_checkpoint", "evaluate_transcript",
                                 "inference_alignment", "inference_alignment_nogt",
                                 "inference_transcript", "postprocess", "serve",
                                 "train_multitask"])
def test_cli_has_every_jax_flag(cli, monkeypatch):
    jax_opts = _options(f"lyricalignment_tpu.cli.{cli}", monkeypatch)
    port_opts = _options(f"lyricalignment_tpu_torch.cli.{cli}", monkeypatch)
    assert not jax_opts - port_opts


MINI = WhisperConfig(n_vocab=64, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                     n_text_state=128, n_text_head=2, n_text_layer=2)
LYRICS = ["天地玄黄", "宇宙洪荒日月"]


@pytest.mark.slow  # two 2-rank CLI runs with the CLI's 384-wide bi-GRU head, ~60 s
def test_train_cli_mesh_pipe_then_resume(tmp_path, monkeypatch):
    from lyricalignment_tpu_torch.cli.common import load_model_dir
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
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
    vocab = make_synthetic_vocab("".join(LYRICS), size=500)
    (tmp_path / "vocab.txt").write_text(
        "\n".join(t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])) + "\n")

    def argv(save, steps, *extra):
        return ["--train-data", str(tmp_path / "data.json"), "--dev-data",
                str(tmp_path / "data.json"), "--whisper-model", "tiny", "--train-alignment",
                "--train-transcript", "--use-ctc-loss", "--bert-vocab", str(tmp_path / "vocab.txt"),
                "--train-batch-size", "2", "--dev-batch-size", "2", "--accum-grad-steps", "1",
                "--train-steps", str(steps), "--eval-steps", str(steps), "--warmup-steps", "0",
                "--device", "cpu", "--save-dir", save, "--mesh-pipe", "2", *extra]

    save = str(tmp_path / "result")
    printed = tph.run_ranks(tph.train_cli, 2, tmp_path / "run1", {"tiny": MINI,
                                                                 "argv": argv(save, 2)})
    assert "pipeline-parallel encoder+decoder: 2 stages x 2 microbatches" in printed[0]
    assert "mesh: {'data': 1, 'model': 2}" in printed[0] and printed[1] == ""
    rows = [json.loads(line) for line in open(f"{save}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["total"]) and r["align_ctc"] > 0 for r in rows)
    monkeypatch.setitem(WHISPER_CONFIGS, "tiny", MINI)
    _, model, _ = load_model_dir(save, "last", device="cpu")  # strict, unsharded
    assert all(not p.is_meta for p in model.parameters())

    save2 = str(tmp_path / "resumed")
    printed = tph.run_ranks(tph.train_cli, 2, tmp_path / "run2", {
        "tiny": MINI, "argv": argv(save2, 3, "--resume", f"{save}/last_model")})
    assert f"resumed from {save}/last_model at step 2" in printed[0] and printed[1] == ""
    rows = [json.loads(line) for line in open(f"{save2}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [3] and np.isfinite(rows[0]["total"])
    full = torch.load(f"{save2}/last_model.pt", weights_only=True)
    assert full["whisper_model.encoder.blocks.1.attn.query.weight"].shape == (128, 128)
    assert full["whisper_model.decoder.blocks.1.mlp.0.weight"].shape == (512, 128)
