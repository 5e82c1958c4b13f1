"""The port's multitask trainer (``train/trainer.py``) against the JAX
package's, on the model dims of tests/test_trainer.py with dropout 0:

* ``multitask_losses``: rtol 1e-5; every parameter's gradient: rel-L2
  1e-5 (float32 reduction order) without the CTC loss, 5e-3 with it: optax's
  float32 CTC gradient is itself 2.2e-3 from the float64 one, which the
  port's ``F.ctc_loss`` matches (tests/test_torch_losses.py);
* one ``make_train_step`` with 2 accumulated micro-batches (CE and
  transcript losses, whose gradients agree to 1e-5), float32 and the
  bench's bf16 accumulation + bf16 Adam mu: each parameter's update within
  2e-2 x its group's lr (Adam's g / (|g| + eps) turns reduction-order noise
  in near-zero gradients into update noise of that size);
* ``freeze_encoder``: the encoder keeps its weights and gets no optimizer
  state; dropout draws from the micro-batch generator."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.align_model import AlignModelConfig as JaxAlignConfig
from lyricalignment_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from lyricalignment_tpu.train.trainer import TrainConfig as JaxTrainConfig
from lyricalignment_tpu.train.trainer import init_train_state as jax_init_state
from lyricalignment_tpu.train.trainer import make_train_step as jax_make_train_step
from lyricalignment_tpu.train.trainer import multitask_losses as jax_multitask_losses
from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from lyricalignment_tpu_torch.train.trainer import (
    LOSS_KEYS,
    TrainConfig,
    init_train_state,
    make_eval_step,
    make_train_step,
    multitask_losses,
    to_device,
)
from tests.torch_port_helpers import as_jax, rel_l2, torch_model

VOCAB = 10  # tiny stand-in for 21128, as in tests/test_trainer.py


def _jax_setup(seed=0, **cfg_kw):
    from lyricalignment_tpu.models.align_model import init_align_model

    cfg = JaxAlignConfig(
        whisper=JaxWhisperConfig(
            n_mels=80, n_vocab=32, n_audio_ctx=1500, n_audio_state=16, n_audio_head=2,
            n_audio_layer=1, n_text_ctx=16, n_text_state=16, n_text_head=2, n_text_layer=1),
        hidden_dim=8, output_dim=VOCAB + 1, train_alignment=True, train_transcript=True,
        dropout=0.0, **cfg_kw)
    params = init_align_model(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    return cfg, params


def _batch(rng, batch=2):
    return {
        "audio": rng.standard_normal((batch, 480000)).astype(np.float32) * 0.05,
        "ctc_labels": np.where(np.arange(6)[None, :] < 3,
                               rng.integers(1, VOCAB - 1, (batch, 6)), -100).astype(np.int32),
        "frame_labels": np.where(rng.random((batch, 1500)) < 0.3,
                                 rng.integers(1, VOCAB - 1, (batch, 1500)), -100).astype(np.int32),
        "label_lengths": np.full((batch,), 3, np.int32),
        "has_alignment": np.array([True, False] * (batch // 2), np.bool_),
        "decoder_input": rng.integers(0, 32, (batch, 5)).astype(np.int32),
        "decoder_output": rng.integers(0, 32, (batch, 5)).astype(np.int32),
    }


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _port_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _jax_as_port(tree):
    """A JAX parameter-shaped tree (parameters or gradients) by port name."""
    return {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


TCFG = dict(accum_grad_steps=2, use_ctc=True, vocab_size=VOCAB, total_steps=10,
            warmup_steps=0, head_lr=5e-3, backbone_lr=1e-3)


@pytest.mark.parametrize("use_ctc", [False, True])
def test_losses_and_gradients_match_jax(rng, use_ctc):
    cfg, params = _jax_setup()
    batch = _batch(rng)
    kw = dict(TCFG, use_ctc=use_ctc)
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_multitask_losses(p, cfg, JaxTrainConfig(**kw), b, dropout_rng=None),
        has_aux=True))(as_jax(params), jax.tree_util.tree_map(jnp.asarray, batch))
    model = torch_model(cfg, params)
    total, losses = multitask_losses(model, TrainConfig(**kw), to_device(batch, "cpu"), None)
    total.backward()
    assert set(losses) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k].detach()), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(losses["trans_ce"].detach()) > 0
    assert (float(losses["align_ctc"].detach()) > 0) == use_ctc
    ref_grads = _jax_as_port(ref_grads)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert rel_l2(p.grad.numpy(), ref_grads[name]) < (5e-3 if use_ctc else 1e-5), name


@pytest.mark.parametrize("low_precision", [False, True])
def test_train_step_matches_jax(rng, low_precision):
    cfg, params = _jax_setup(seed=1)
    stacked = _stack([_batch(rng) for _ in range(2)])
    kw = dict(TCFG, use_ctc=False)
    dt = dict(grad_accum_dtype=jnp.bfloat16, adam_mu_dtype=jnp.bfloat16) if low_precision else {}
    jtcfg = JaxTrainConfig(**kw, **dt)
    state, tx = jax_init_state(as_jax(params), jtcfg)
    state, jlosses = jax_make_train_step(cfg, jtcfg, tx)(
        state, jax.tree_util.tree_map(jnp.asarray, stacked), jax.random.PRNGKey(0))
    ref_after = _jax_as_port(state.params)

    dt = dict(grad_accum_dtype=torch.bfloat16, adam_mu_dtype=torch.bfloat16) if low_precision else {}
    tcfg = TrainConfig(**kw, **dt)
    model = torch_model(cfg, params)
    before = _port_params(model)
    tstate, ttx = init_train_state(model, tcfg)
    tstate, losses = make_train_step(tcfg, ttx)(tstate, stacked)
    assert tstate.step == 1 and tstate.opt_state.count == 1
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    for name, p in model.named_parameters():
        lr = TCFG["head_lr"] if name.startswith("align_rnn.") else TCFG["backbone_lr"]
        got, want = p.detach().numpy() - before[name], ref_after[name] - before[name]
        assert np.abs(got - want).max() <= 2e-2 * lr, name
        assert np.abs(got).max() > 0.5 * lr, name  # every parameter moved


def test_freeze_encoder_keeps_encoder_and_has_no_state(rng):
    cfg, params = _jax_setup(freeze_encoder=True)
    tcfg = TrainConfig(**TCFG, freeze_encoder=True)
    model = torch_model(cfg, params)
    before = _port_params(model)
    state, tx = init_train_state(model, tcfg)
    assert not any(n.startswith("whisper_model.encoder.") for n in state.opt_state.mu)
    state, _ = make_train_step(tcfg, tx)(state, _stack([_batch(rng) for _ in range(2)]))
    for name, p in model.named_parameters():
        moved = not np.array_equal(p.detach().numpy(), before[name])
        assert moved != name.startswith("whisper_model.encoder."), name


def test_eval_step_is_deterministic_and_dropout_uses_the_generator(rng):
    cfg, params = _jax_setup(seed=2)
    cfg = dataclasses.replace(cfg, dropout=0.5)
    model = torch_model(cfg, params)
    tcfg = TrainConfig(**TCFG)
    batch = _batch(rng)
    eval_step = make_eval_step(tcfg)
    a, b = eval_step(model, batch), eval_step(model, batch)
    assert all(float(a[k]) == float(b[k]) for k in LOSS_KEYS)
    tb = to_device(batch, "cpu")
    with torch.no_grad():
        drop = [multitask_losses(model, tcfg, tb, torch.Generator().manual_seed(s))[1]["align_ce"]
                for s in (5, 5, 6)]
    assert float(drop[0]) == float(drop[1]) != float(drop[2])
    assert float(drop[0]) != float(a["align_ce"])


@pytest.mark.parametrize("use_ctc", [False, True])
def test_fused_losses_match_jax_and_unfused(rng, use_ctc):
    """``fused_losses``: the port's fused composition against the JAX fused
    one (losses rtol 1e-5, every gradient rel-L2 1e-5, 1e-4 with the fused
    CTC), and against the port's own unfused losses (rtol 1e-5; gradients
    1e-5 without CTC, 5e-3 with it, as against JAX's unfused)."""
    cfg, params = _jax_setup(seed=3)
    batch = _batch(rng)
    kw = dict(TCFG, use_ctc=use_ctc)
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_multitask_losses(p, cfg, JaxTrainConfig(**kw, fused_losses=True), b,
                                          dropout_rng=None),
        has_aux=True))(as_jax(params), jax.tree_util.tree_map(jnp.asarray, batch))
    ref_grads = _jax_as_port(ref_grads)
    runs = {}
    for fused in (True, False):
        model = torch_model(cfg, params)
        total, losses = multitask_losses(model, TrainConfig(**kw, fused_losses=fused),
                                         to_device(batch, "cpu"), None)
        total.backward()
        runs[fused] = ({k: float(v.detach()) for k, v in losses.items()},
                       {n: p.grad.numpy() for n, p in model.named_parameters()})
    (fused_losses, fused_grads), (plain_losses, plain_grads) = runs[True], runs[False]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(fused_losses[k], float(ref[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(fused_losses[k], plain_losses[k], rtol=1e-5, err_msg=k)
    assert (fused_losses["align_ctc"] > 0) == use_ctc
    for name, grad in fused_grads.items():
        assert rel_l2(grad, ref_grads[name]) < (1e-4 if use_ctc else 1e-5), name
        assert rel_l2(grad, plain_grads[name]) < (5e-3 if use_ctc else 1e-5), name


def test_fused_train_step_matches_jax(rng):
    """One fused ``make_train_step`` (CE, CTC and transcript losses, 2
    micro-batches) against the JAX fused step: losses rtol 1e-5, every
    parameter's update within 2e-2 x its group's lr."""
    cfg, params = _jax_setup(seed=4)
    stacked = _stack([_batch(rng) for _ in range(2)])
    kw = dict(TCFG, fused_losses=True)
    jtcfg = JaxTrainConfig(**kw)
    state, tx = jax_init_state(as_jax(params), jtcfg)
    state, jlosses = jax_make_train_step(cfg, jtcfg, tx)(
        state, jax.tree_util.tree_map(jnp.asarray, stacked), jax.random.PRNGKey(0))
    ref_after = _jax_as_port(state.params)
    tcfg = TrainConfig(**kw)
    model = torch_model(cfg, params)
    before = _port_params(model)
    tstate, ttx = init_train_state(model, tcfg)
    tstate, losses = make_train_step(tcfg, ttx)(tstate, stacked)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    assert float(losses["align_ctc"]) > 0
    for name, p in model.named_parameters():
        lr = TCFG["head_lr"] if name.startswith("align_rnn.") else TCFG["backbone_lr"]
        got, want = p.detach().numpy() - before[name], ref_after[name] - before[name]
        assert np.abs(got - want).max() <= 2e-2 * lr, name
        assert np.abs(got).max() > 0.5 * lr, name
