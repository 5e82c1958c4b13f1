"""Port Whisper encoder vs ``encode_audio`` on the same (perturbed, tiny)
weights. float32: atol 1e-4 for both JAX attention routes (einsum and the
pad-once one-pass path, whose padding the port does not need). bfloat16:
the port and the JAX encoder each stay within rel-L2 2e-2 of the float32
JAX result, the bf16 rounding class PARITY.md records for the encoder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.whisper import bf16_resident_params, encode_audio
from lyricalignment_tpu_torch.models.whisper import bf16_resident
from tests.torch_port_helpers import (
    as_jax,
    jax_tiny_model,
    rel_l2,
    torch_model,
    with_whisper,
)


def _mel(rng, batch=2):
    return rng.standard_normal((batch, 80, 3000)).astype(np.float32) * 0.5


@pytest.mark.parametrize("onepass,fast_gelu", [(False, False), (True, True)])
def test_encoder_f32_matches_jax(rng, onepass, fast_gelu):
    cfg, params = jax_tiny_model(fast_gelu=fast_gelu)
    mel = _mel(rng)
    jcfg = with_whisper(cfg, onepass_encoder=onepass)
    ref = np.asarray(encode_audio(as_jax(params)["whisper"], jcfg.whisper, jnp.asarray(mel)))
    model = torch_model(cfg, params)
    with torch.inference_mode():
        got = model.whisper_model.embed_audio(torch.from_numpy(mel))
    assert got.shape == ref.shape == (2, 1500, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_encoder_bf16_rounding_class(rng):
    cfg, params = jax_tiny_model(fast_gelu=True)
    mel = _mel(rng, batch=1)
    jparams = as_jax(params)["whisper"]
    ref32 = np.asarray(encode_audio(jparams, cfg.whisper, jnp.asarray(mel)))
    jcfg16 = with_whisper(cfg, compute_dtype=jnp.bfloat16, onepass_encoder=True)
    jax16 = encode_audio(bf16_resident_params(jparams), jcfg16.whisper, jnp.asarray(mel))

    model = torch_model(cfg, params, compute_dtype=torch.bfloat16)
    bf16_resident(model.whisper_model)
    assert model.whisper_model.encoder.blocks[0].attn.query.weight.dtype == torch.bfloat16
    with torch.inference_mode():
        got = model.whisper_model.embed_audio(torch.from_numpy(mel))
    assert got.dtype == torch.bfloat16
    assert rel_l2(np.asarray(jax16.astype(jnp.float32)), ref32) < 2e-2
    assert rel_l2(got.float().numpy(), ref32) < 2e-2
