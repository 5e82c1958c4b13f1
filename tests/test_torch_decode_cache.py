"""The port's KV-cached decoder (``init_decode_cache``,
``prime_decode_cache``, ``decode_step``) against the JAX functions on a
seeded tiny backbone (float32, atol 1e-4): primed logits, the aux logits at
each sample's sot position and N steps, with ragged prompt lengths in one
batch and g = 1 or 5 beam rows a sample; the same logits from the port's
teacher-forced ``decoder_logits``; and ``_check_context`` refusing where
JAX's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.decode.beam import _check_context as jax_check_context
from lyricalignment_tpu.models import whisper as jw
from lyricalignment_tpu_torch.decode.beam import _check_context
from lyricalignment_tpu_torch.models import whisper as tw
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

DIMS = dict(n_vocab=64, n_audio_ctx=50, n_text_ctx=24, n_text_layer=2)
B, P, LENGTHS, AUX = 2, 6, [6, 3], [2, 0]
ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg, params = jax_tiny_model(seed=5, dims=DIMS)
    model = torch_model(cfg, params).whisper_model
    rng = np.random.default_rng(11)
    xa = (rng.standard_normal((B, 50, 64)) * 0.5).astype(np.float32)
    prompt = rng.integers(0, 64, (B, P)).astype(np.int32)
    return cfg.whisper, as_jax(params)["whisper"], model, xa, prompt


def _fed_tokens(g, n_steps, max_new):
    rng = np.random.default_rng(100 + g + max_new)
    return rng.integers(0, 64, (n_steps, B * g, 1)).astype(np.int32)


def _jax_run(jcfg, jparams, xa, prompt, g, n_steps, max_new):
    init = jax.jit(jw.init_decode_cache, static_argnums=(1, 3, 4, 5))
    prime = jax.jit(jw.prime_decode_cache, static_argnums=(1,))
    step = jax.jit(jw.decode_step, static_argnums=(1,))
    cache = init(jparams, jcfg, jnp.asarray(xa), P, max_new, g)
    logits, aux, cache = prime(
        jparams, jcfg, jnp.asarray(prompt), cache, jnp.asarray(LENGTHS, jnp.int32),
        jnp.asarray(AUX, jnp.int32))
    steps = []
    for tok in _fed_tokens(g, n_steps, max_new):
        out, cache = step(jparams, jcfg, jnp.asarray(tok), cache)
        steps.append(np.asarray(out))
    return np.asarray(logits), np.asarray(aux), steps


def _port_run(model, xa, prompt, g, n_steps, max_new):
    cfg = model.cfg
    cache = tw.init_decode_cache(model, cfg, torch.from_numpy(xa), P, max_new, beam_size=g)
    logits, aux, cache = tw.prime_decode_cache(
        model, cfg, torch.from_numpy(prompt), cache, torch.tensor(LENGTHS),
        aux_index=torch.tensor(AUX))
    steps = []
    for tok in _fed_tokens(g, n_steps, max_new):
        out, cache = tw.decode_step(model, cfg, torch.from_numpy(tok), cache)
        steps.append(out.numpy())
    assert int(cache["step"]) == n_steps
    return logits.numpy(), aux.numpy(), steps


# (beam rows a sample, steps, preallocated generated slots); the last case
# steps once past the slots, where both write the last slot
CASES = [(1, 5, 5), (5, 5, 5), (1, 5, 4)]


@pytest.fixture(scope="module")
def runs(tiny):
    jcfg, jparams, model, xa, prompt = tiny
    return {case: (_jax_run(jcfg, jparams, xa, prompt, *case),
                   _port_run(model, xa, prompt, *case)) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_prime_and_steps_match_jax(runs, case):
    (j_logits, j_aux, j_steps), (logits, aux, steps) = runs[case]
    assert logits.shape == (B, 64) and logits.dtype == np.float32
    np.testing.assert_allclose(logits, j_logits, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux, j_aux, atol=ATOL, rtol=0)
    for got, want in zip(steps, j_steps):
        assert got.shape == (B * case[0], 64)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("g", [1, 5])
def test_steps_match_teacher_forced_logits(tiny, runs, g):
    """Each row's prime and steps are the teacher-forced decoder's logits of
    its own history: the sample's valid prompt, then the row's tokens."""
    _, _, model, xa, prompt = tiny
    n_steps = 5
    _, (logits, aux, steps) = runs[(g, n_steps, 5)]
    fed = _fed_tokens(g, n_steps, 5)[:, :, 0]                    # [N, B*g]
    for r in range(B * g):
        b = r // g
        seq = list(prompt[b, : LENGTHS[b]]) + list(fed[:, r])
        with torch.no_grad():
            full = model.decoder_logits(torch.tensor([seq]), torch.from_numpy(xa[b: b + 1]))[0]
        full = full.numpy()
        if r % g == 0:
            np.testing.assert_allclose(logits[b], full[LENGTHS[b] - 1], atol=ATOL, rtol=0)
            np.testing.assert_allclose(aux[b], full[AUX[b]], atol=ATOL, rtol=0)
        for s in range(n_steps):
            np.testing.assert_allclose(steps[s][r], full[LENGTHS[b] + s], atol=ATOL, rtol=0)


def test_cross_and_prompt_sections_are_per_sample(tiny):
    _, _, model, xa, prompt = tiny
    cache = tw.init_decode_cache(model, model.cfg, torch.from_numpy(xa), P, 7, beam_size=5)
    blk = cache["blocks"][0]
    assert blk["cross_k"].shape == (B, 50, 4, 16)
    assert blk["prompt_k"].shape == (B, P, 4, 16)
    assert blk["gen_k"].shape == (B * 5, 7, 4, 16)
    gen = blk["gen_k"]
    tw.prime_decode_cache(model, model.cfg, torch.from_numpy(prompt), cache)
    tw.decode_step(model, model.cfg, torch.zeros((B * 5, 1), dtype=torch.int64), cache)
    assert cache["blocks"][0]["gen_k"] is gen          # written in place
    assert cache["length"].tolist() == [P, P]


@pytest.mark.parametrize("prompt_len,max_new", [(4, 20), (4, 21), (1, 24), (0, 25), (24, 0)])
def test_check_context_matches_jax(tiny, prompt_len, max_new):
    jcfg, _, model, _, _ = tiny

    def raises(fn, cfg):
        try:
            fn(cfg, prompt_len, max_new)
        except ValueError as exc:
            return str(exc)
        return None

    assert raises(_check_context, model.cfg) == raises(jax_check_context, jcfg)


def test_int8_cross_kv_is_refused(tiny):
    import dataclasses

    _, _, model, xa, _ = tiny
    cfg = dataclasses.replace(model.cfg, int8_cross_kv=True)
    with pytest.raises(NotImplementedError, match="int8"):
        tw.init_decode_cache(model, cfg, torch.from_numpy(xa), P, 4)


def test_is_multilingual_matches_jax():
    for n_vocab in (51864, 51865, 51866):
        assert (tw.WhisperConfig(n_vocab=n_vocab).is_multilingual
                == jw.WhisperConfig(n_vocab=n_vocab).is_multilingual)
