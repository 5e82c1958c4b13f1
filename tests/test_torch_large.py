"""The large family in the port against the JAX package, on the CPU at
micro widths (the counterparts of tests/test_large_v3.py):

* every ``WHISPER_CONFIGS`` name has the JAX package's dims;
* a v3-shaped micro model (128 mel bands, vocabulary 51866, a 1-layer
  decoder under a 2-layer encoder) from audio through the log-mel, the
  encoder, the primed cache and ``decode_step`` on the v3 prompt: mel and
  features atol 1e-4, logits atol 1e-4 (tests/test_torch_decode_cache.py's);
* one update of the one-card large recipe (bench.py's ``BENCH_TRAIN_FREEZE``
  with remat): a frozen, bf16-resident encoder, block checkpoints, bf16
  gradient accumulation and bf16 Adam mu; losses rtol 1e-5 and each
  parameter's update within 2e-2 of its group's lr of the JAX
  ``make_train_step`` (tests/test_torch_trainer.py's), the encoder bit for
  bit unchanged and without optimizer state;
* an OpenAI-format v3 checkpoint (128 mel bands) through the port's
  ``load_openai_checkpoint`` and ``la-convert import-openai``: the encoder
  output equals the JAX reader's to atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models import whisper as jw
from lyricalignment_tpu.models.convert import load_openai_checkpoint as jax_load_openai
from lyricalignment_tpu.ops.mel import log_mel as jax_log_mel
from lyricalignment_tpu.ops.mel import pad_or_trim as jax_pad_or_trim
from lyricalignment_tpu.text.whisper_tokenizer import WhisperTokenizer as JaxWhisperTokenizer
from lyricalignment_tpu.train.trainer import TrainConfig as JaxTrainConfig
from lyricalignment_tpu.train.trainer import init_train_state as jax_init_state
from lyricalignment_tpu.train.trainer import make_train_step as jax_make_train_step
from lyricalignment_tpu_torch.cli.common import load_model_dir
from lyricalignment_tpu_torch.cli.convert_checkpoint import main as convert_main
from lyricalignment_tpu_torch.models import whisper as tw
from lyricalignment_tpu_torch.models.convert import load_openai_checkpoint
from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim
from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
from lyricalignment_tpu_torch.train.trainer import TrainConfig, init_train_state, make_train_step
from tests.test_convert_openai import make_openai_ckpt
from tests.test_torch_trainer import TCFG, _batch, _jax_as_port, _jax_setup, _stack
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model

ATOL = 1e-4


@pytest.mark.parametrize("name", sorted(jw.WHISPER_CONFIGS))
def test_whisper_configs_match_jax(name):
    """Each named config has the JAX package's ten architecture ints (and
    the JAX package names no config the port lacks)."""
    assert set(tw.WHISPER_CONFIGS) == set(jw.WHISPER_CONFIGS)
    got, want = tw.WHISPER_CONFIGS[name], jw.WHISPER_CONFIGS[name]
    assert {k: getattr(got, k) for k in tw.WHISPER_DIMS} == {
        k: getattr(want, k) for k in tw.WHISPER_DIMS}
    assert got.is_multilingual


def test_v3_micro_model_matches_jax():
    """mel -> encoder -> primed cache -> decode_step of a v3-shaped micro
    model on the v3 sot sequence (<|transcribe|> at 50360), fed three
    steps, against the JAX functions on the same weights and audio."""
    dims = dict(n_mels=128, n_vocab=51866, n_audio_ctx=50, n_audio_layer=2, n_text_ctx=24,
                n_text_layer=1)
    cfg, params = jax_tiny_model(seed=7, dims=dims)
    jcfg, jparams = cfg.whisper, as_jax(params)["whisper"]
    model = torch_model(cfg, params).whisper_model
    wcfg = model.cfg
    prompt = np.asarray([JaxWhisperTokenizer(num_languages=100).sot_sequence], np.int32)
    assert prompt.tolist() == [WhisperTokenizer(num_languages=100).sot_sequence]
    assert prompt[0, -1] == 50360
    audio = (np.random.default_rng(1).standard_normal((1, 16000)) * 0.1).astype(np.float32)
    fed = np.random.default_rng(2).integers(0, 51866, (3, 1, 1)).astype(np.int32)

    mel_j = jax_pad_or_trim(jax_log_mel(jnp.asarray(audio), n_mels=128), 100, axis=-1)
    xa_j = jax.jit(jw.encode_audio, static_argnums=1)(jparams, jcfg, mel_j)
    cache = jax.jit(jw.init_decode_cache, static_argnums=(1, 3, 4, 5))(jparams, jcfg, xa_j, 3,
                                                                        4, 1)
    logits_j, _, cache = jax.jit(jw.prime_decode_cache, static_argnums=1)(
        jparams, jcfg, jnp.asarray(prompt), cache, jnp.asarray([3], jnp.int32))
    step = jax.jit(jw.decode_step, static_argnums=1)
    steps_j = []
    for tok in fed:
        out, cache = step(jparams, jcfg, jnp.asarray(tok), cache)
        steps_j.append(np.asarray(out))

    with torch.no_grad():
        mel = pad_or_trim(log_mel(torch.from_numpy(audio), n_mels=128), 100)
        xa = model.embed_audio(mel)
        cache = tw.init_decode_cache(model, wcfg, xa, 3, 4, beam_size=1)
        logits, _, cache = tw.prime_decode_cache(model, wcfg, torch.from_numpy(prompt), cache,
                                                 torch.tensor([3]))
        steps = []
        for tok in fed:
            out, cache = tw.decode_step(model, wcfg, torch.from_numpy(tok), cache)
            steps.append(out.numpy())
    assert mel.shape == (1, 128, 100) and logits.shape == (1, 51866)
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xa.numpy(), np.asarray(xa_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), atol=ATOL, rtol=0)
    for got, want in zip(steps, steps_j):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_one_card_large_recipe_matches_jax(rng):
    """freeze_encoder + remat with the frozen encoder bf16-resident (the
    JAX recipe's ``bf16_resident_params`` of the encoder, the port's
    ``bf16_resident`` of the encoder module), bf16 accumulation and Adam mu,
    2 micro-batches, float32 compute: one update each."""
    cfg, params = _jax_setup(seed=4, freeze_encoder=True)
    stacked = _stack([_batch(rng) for _ in range(2)])
    kw = dict(TCFG, use_ctc=False, remat=True, freeze_encoder=True)
    jparams = as_jax(params)
    jparams["whisper"]["encoder"] = jw.bf16_resident_params(jparams["whisper"]["encoder"])
    jtcfg = JaxTrainConfig(**kw, grad_accum_dtype=jnp.bfloat16, adam_mu_dtype=jnp.bfloat16)
    state, tx = jax_init_state(jparams, jtcfg)
    state, jlosses = jax_make_train_step(cfg, jtcfg, tx)(
        state, jax.tree_util.tree_map(jnp.asarray, stacked), jax.random.PRNGKey(0))
    ref_after = _jax_as_port(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), state.params))

    tcfg = TrainConfig(**kw, grad_accum_dtype=torch.bfloat16, adam_mu_dtype=torch.bfloat16)
    model = torch_model(cfg, params)
    tw.bf16_resident(model.whisper_model.encoder)
    encoder = {n: p for n, p in model.named_parameters()
               if n.startswith("whisper_model.encoder.")}
    assert {p.dtype for p in encoder.values() if p.dim() >= 2} == {torch.bfloat16}
    before = {n: p.detach().float().numpy().copy() for n, p in model.named_parameters()}
    tstate, ttx = init_train_state(model, tcfg)
    assert not any(n in encoder for n in (*tstate.opt_state.mu, *tstate.opt_state.nu))
    assert all(tstate.opt_state.mu[n].dtype == torch.bfloat16 for n in tstate.opt_state.mu)
    tstate, losses = make_train_step(tcfg, ttx)(tstate, stacked)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    after = {n: p.detach().float().numpy() for n, p in model.named_parameters()}
    for name in after:
        got, want = after[name] - before[name], ref_after[name] - before[name]
        if name in encoder:
            assert not got.any() and not want.any(), name  # bit for bit unchanged
            continue
        lr = TCFG["head_lr"] if name.startswith("align_rnn.") else TCFG["backbone_lr"]
        assert np.abs(got - want).max() <= 2e-2 * lr, name
        assert np.abs(got).max() > 0.5 * lr, name  # every trained parameter moved


def test_v3_openai_checkpoint_imports_as_jax(tmp_path):
    """One micro OpenAI-format checkpoint with v3 dims (128 mel bands)
    through the port's ``load_openai_checkpoint`` and through ``la-convert
    import-openai`` then ``load_model_dir``: each encoder output equals the
    JAX reader's on the same mel (atol 1e-6)."""
    cfg = jw.WhisperConfig(n_mels=128, n_vocab=100, n_audio_ctx=50, n_audio_state=32,
                           n_audio_head=4, n_audio_layer=1, n_text_ctx=12, n_text_state=32,
                           n_text_head=4, n_text_layer=1)
    path, _ = make_openai_ckpt(tmp_path, cfg)
    jcfg, jparams = jax_load_openai(path)
    mel = np.random.default_rng(3).standard_normal((1, 128, 100)).astype(np.float32)
    want = np.asarray(jw.encode_audio(jparams, jcfg, jnp.asarray(mel)))

    pcfg, sd = load_openai_checkpoint(path)
    assert {k: getattr(pcfg, k) for k in tw.WHISPER_DIMS} == {
        k: getattr(cfg, k) for k in tw.WHISPER_DIMS}
    whisper = tw.Whisper(pcfg)
    whisper.load_state_dict(sd, strict=True)
    out = str(tmp_path / "imported")
    assert convert_main(["import-openai", "--pt", path, "--output-dir", out]) == 0
    mcfg, model, train_args = load_model_dir(out, device="cpu")
    assert train_args["whisper_model"] == "custom" and mcfg.whisper.n_mels == 128
    with torch.no_grad():
        for got in (whisper.embed_audio(torch.from_numpy(mel)),
                    model.whisper_model.embed_audio(torch.from_numpy(mel))):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
