"""The port's teacher-forced decoder (``Whisper.decoder_logits``) against
JAX ``decoder_logits`` on the tiny backbone (atol 1e-4, float32; exact and
tanh GELU), and the encoder's training options against each other on the
port: ``remat`` (block checkpoints) and ``onepass_encoder`` (the key-bias
route) give the plain run's features and gradients."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.whisper import decoder_logits as jax_decoder_logits
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model


@pytest.mark.parametrize("fast_gelu", [False, True])
def test_decoder_logits_match_jax(rng, fast_gelu):
    cfg, params = jax_tiny_model(fast_gelu=fast_gelu)
    tokens = rng.integers(0, 64, (2, 11)).astype(np.int32)
    xa = (rng.standard_normal((2, 1500, 64)) * 0.5).astype(np.float32)
    ref = np.asarray(jax_decoder_logits(as_jax(params)["whisper"], cfg.whisper,
                                        jnp.asarray(tokens), jnp.asarray(xa)))
    model = torch_model(cfg, params)
    with torch.no_grad():
        got = model.whisper_model.decoder_logits(torch.from_numpy(tokens), torch.from_numpy(xa))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, 11, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_decoder_is_causal(rng):
    cfg, params = jax_tiny_model()
    model = torch_model(cfg, params)
    tokens = torch.from_numpy(rng.integers(0, 64, (1, 8)))
    xa = torch.randn(1, 1500, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model.whisper_model.decoder_logits(tokens, xa)
        tokens[0, 5:] = (tokens[0, 5:] + 1) % 64
        b = model.whisper_model.decoder_logits(tokens, xa)
    torch.testing.assert_close(a[:, :5], b[:, :5], atol=0, rtol=0)
    assert not torch.equal(a[:, 5:], b[:, 5:])


def _features_and_grads(model, mel, tokens, remat):
    model.zero_grad()
    feats = model.whisper_model.embed_audio(mel, remat=remat)
    logits = model.whisper_model.decoder_logits(tokens, feats, remat=remat)
    (feats.square().mean() + logits.logsumexp(-1).mean()).backward()
    return feats.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                            if p.grad is not None}


@pytest.mark.parametrize("variant", ["remat", "onepass"])
def test_encoder_training_options_agree(rng, variant):
    cfg, params = jax_tiny_model()
    plain = torch_model(cfg, params)
    other = torch_model(dataclasses.replace(cfg, whisper=dataclasses.replace(
        cfg.whisper, onepass_encoder=variant == "onepass")), params)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 3000)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 64, (2, 6)))
    f0, g0 = _features_and_grads(plain, mel, tokens, remat=False)
    f1, g1 = _features_and_grads(other, mel, tokens, remat=variant == "remat")
    torch.testing.assert_close(f1, f0, atol=1e-5, rtol=0)
    assert g0.keys() == g1.keys() and len(g0) > 20
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-5, rtol=1e-5, msg=name)
