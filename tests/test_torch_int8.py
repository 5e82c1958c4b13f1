"""The port's int8 inference options (``models/whisper.py``) against the JAX
package's on the same numpy inputs and seeded tiny weights:

* ``_quantize_int8`` equal to JAX's (int8 values and scales, round half to
  even), ``_linear_int8`` within float32 rounding of JAX's (rtol 1e-6);
* the int8 products equal JAX's int32 ones on integer values:
  ``torch._int_mm`` exactly, and the float32 einsums of the cross-attention
  contractions exactly while every partial sum stays below 2^24;
* the int8 encoder (quantised per call, and on ``int8_resident`` weights,
  which equal the per-call path bit for bit) and the int8 cross K/V decode
  path: the port's error against JAX's int8 result at most 1/10 of JAX's own
  int8-against-float32 error on the same inputs, over one encoder block, the
  decode path, and each of two blocks given JAX's own input to it. Run end
  to end, two blocks are held to 1/5: the quantisation is the same, bit for
  bit, but float32 rounding before a round() moves a value of the second
  block's input by one step now and then (counted: a few in a thousand),
  and the block passes that step on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from lyricalignment_tpu.models import whisper as jw
from lyricalignment_tpu_torch.models import whisper as tw
from tests.torch_port_helpers import as_jax, jax_tiny_model, rel_l2, torch_model, with_whisper


def _jax_q(x, axis):
    q, s = jw._quantize_int8(jnp.asarray(x), axis=axis)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_quantize_int8_matches_jax(rng, dim):
    x = (rng.standard_normal((6, 40, 8)) * 3).astype(np.float32)
    x[0, :, 0] = 0.0                              # an all-zero row: the 1e-12 floor
    x[1, 0, :] = np.float32(127.0 / 2)            # halves: round half to even
    q, s = tw._quantize_int8(torch.from_numpy(x), dim)
    jq, js = _jax_q(x, dim)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_int8_matches_jax(rng, bias):
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    w = (rng.standard_normal((24, 32)) * 0.2).astype(np.float32)   # [out, in]
    b = rng.standard_normal(24).astype(np.float32)
    p = {"w": jnp.asarray(w.T)}
    lin = nn.Linear(32, 24, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        if bias:
            p["b"] = jnp.asarray(b)
            lin.bias.copy_(torch.from_numpy(b))
    want = np.asarray(jw._linear_int8(p, jnp.asarray(x)))
    got = tw._linear_int8(lin, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    wq, ws = tw._quantize_int8(lin.weight, 1)
    resident = tw.Int8Linear(wq, ws[:, 0], lin.bias)
    assert torch.equal(tw._linear_int8(resident, torch.from_numpy(x)), got)


def test_int8_products_equal_jax_int32(rng):
    """Integer-valued operands at the int8 extremes: ``_int_mm`` equals
    JAX's int32 dot_general; both cross-attention einsums equal JAX's
    int32 einsums (the T contraction at T = 1000: 1000 x 127^2 < 2^24)."""
    a = rng.integers(-127, 128, (40, 64)).astype(np.int8)
    b = rng.integers(-127, 128, (24, 64)).astype(np.int8)
    a[0], b[0] = 127, -127
    got = tw._int_mm(torch.from_numpy(a), torch.from_numpy(b))
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b).T, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = np.full((2, 3, 1, 4, 64), 127, np.int8)
    k = np.full((2, 1000, 4, 64), 127, np.int8)
    k[1] = rng.integers(-127, 128, k[1].shape)
    w = np.full((2, 3, 1, 4, 1000), 127, np.int8)
    for eq, x, y in (("bgshd,bthd->bgsht", q, k), ("bgsht,bthd->bgshd", w, k)):
        got = tw._int_einsum(eq, torch.from_numpy(x), torch.from_numpy(y))
        want = jnp.einsum(eq, jnp.asarray(x), jnp.asarray(y), preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.float32))


def _mel(rng, batch=2):
    return rng.standard_normal((batch, 80, 3000)).astype(np.float32) * 0.5


def _int8_case(rng, resident, layers):
    """JAX's tiny model with ``layers`` encoder blocks: its float32 and int8
    configs, float params and int8 params (resident or per call), the
    port's int8 model, and a mel batch."""
    cfg, params = jax_tiny_model(seed=3, dims=dict(n_audio_layer=layers))
    jparams = as_jax(params)["whisper"]
    cfg8 = with_whisper(cfg, int8_encoder=True)
    jp8 = jw.int8_resident_params(jparams) if resident else jparams
    model = torch_model(cfg8, params)
    if resident:
        tw.int8_resident(model.whisper_model)
        assert isinstance(model.whisper_model.encoder.blocks[0].mlp[0], tw.Int8Linear)
        assert model.whisper_model.encoder.blocks[0].attn.query.weight_q.dtype == torch.int8
    return cfg.whisper, cfg8.whisper, jparams, jp8, model, _mel(rng)


@pytest.mark.parametrize("resident", [False, True])
def test_int8_encoder_matches_jax(rng, resident):
    """One encoder block end to end: the port within 1/10 of JAX's own
    int8-against-float32 error (measured 0.025-0.074 of it, seeds 3-5)."""
    wcfg, wcfg8, jparams, jp8, model, mel = _int8_case(rng, resident, 1)
    ref32 = np.asarray(jw.encode_audio(jparams, wcfg, jnp.asarray(mel)), np.float64)
    ref8 = np.asarray(jw.encode_audio(jp8, wcfg8, jnp.asarray(mel)), np.float64)
    with torch.inference_mode():
        got = model.whisper_model.embed_audio(torch.from_numpy(mel)).double().numpy()
    jax_err = rel_l2(ref8, ref32)
    assert 1e-4 < jax_err < 0.02
    assert rel_l2(got, ref8) <= 0.1 * jax_err, (rel_l2(got, ref8), jax_err)


def _jax_stem(jparams, wcfg, mel):
    """JAX ``encode_audio``'s stem output, padded to a multiple of 128 frames
    with its key bias, as it feeds the blocks."""
    x = jw._encoder_stem(jparams["encoder"], wcfg, jnp.asarray(mel))
    t = x.shape[1]
    t_pad = -(-t // 128) * 128
    x = jnp.pad(x, ((0, 0), (0, t_pad - t), (0, 0)))
    return x, jnp.where(jnp.arange(t_pad)[None, :] < t, 0.0, -1e9).astype(jnp.float32), t


def _jax_block(params, i, x, wcfg, int8, key_bias):
    return jw._encoder_block(params["encoder"]["blocks"][i], x, wcfg.n_audio_head,
                             wcfg.fast_softmax, wcfg.fast_gelu, int8, key_bias)


@pytest.mark.parametrize("resident", [False, True])
def test_int8_encoder_blocks_match_jax(rng, resident):
    """Two encoder blocks, each given JAX's own int8 input to it: the port's
    block increment (output - input) within 1/10 of JAX's own
    int8-against-float32 error of that block on the same input (measured
    0.013-0.047 over three mel draws)."""
    _, wcfg, jparams, jp8, model, mel = _int8_case(rng, resident, 2)
    x, key_bias, t = _jax_stem(jparams, wcfg, mel)
    for i, block in enumerate(model.whisper_model.encoder.blocks):
        out8 = _jax_block(jp8, i, x, wcfg, True, key_bias)
        out32 = _jax_block(jparams, i, x, wcfg, False, key_bias)
        x_real = np.asarray(x, np.float64)[:, :t]
        inc8 = np.asarray(out8, np.float64)[:, :t] - x_real
        inc32 = np.asarray(out32, np.float64)[:, :t] - x_real
        with torch.inference_mode():
            got = block.encoder_forward(torch.from_numpy(np.array(x[:, :t])),
                                        torch.zeros((1, t)), True).double().numpy()
        jax_err = rel_l2(inc8, inc32)
        assert 1e-4 < jax_err < 0.05, (i, jax_err)
        assert rel_l2(got - x_real, inc8) <= 0.1 * jax_err, (i, rel_l2(got - x_real, inc8),
                                                              jax_err)
        x = out8


def test_int8_two_blocks_carry_flipped_steps(rng):
    """Two encoder blocks end to end: the second block's quantised input
    (its attention LayerNorm's output) equals JAX's but for a few values in
    a thousand, each one step off (float32 rounding of the first block's
    output before a round()), and the output, which carries those steps,
    stays within 1/5 of JAX's own int8-against-float32 error (measured
    0.050-0.140 of it, seeds 3-5)."""
    wcfg32, wcfg, jparams, jp8, model, mel = _int8_case(rng, False, 2)
    ref32 = np.asarray(jw.encode_audio(jparams, wcfg32, jnp.asarray(mel)), np.float64)
    ref8 = np.asarray(jw.encode_audio(jp8, wcfg, jnp.asarray(mel)), np.float64)
    x, key_bias, t = _jax_stem(jparams, wcfg, mel)
    jx1 = _jax_block(jp8, 0, x, wcfg, True, key_bias)[:, :t]
    jq, _ = jw._quantize_int8(jw._layer_norm(jp8["encoder"]["blocks"][1]["attn_ln"], jx1), axis=-1)
    encoder = model.whisper_model.encoder
    with torch.inference_mode():
        x1 = encoder.blocks[0].encoder_forward(encoder._stem(torch.from_numpy(mel)),
                                               torch.zeros((1, t)), True)
        q, _ = tw._quantize_int8(tw._layer_norm(encoder.blocks[1].attn_ln, x1), -1)
        got = model.whisper_model.embed_audio(torch.from_numpy(mel)).double().numpy()
    steps = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert 0 < int((steps > 0).sum()) <= 0.005 * steps.size and int(steps.max()) == 1
    jax_err = rel_l2(ref8, ref32)
    assert rel_l2(got, ref8) <= 0.2 * jax_err, (rel_l2(got, ref8), jax_err)


def test_int8_resident_equals_the_per_call_path(rng):
    """``int8_resident`` stores the pair the per-call path derives: the
    encoder output is bit-equal, the decoder untouched."""
    cfg, params = jax_tiny_model(seed=4, int8_encoder=True)
    mel = torch.from_numpy(_mel(rng, batch=1))
    model = torch_model(cfg, params)
    with torch.inference_mode():
        dynamic = model.whisper_model.embed_audio(mel)
        tw.int8_resident(model.whisper_model)
        resident = model.whisper_model.embed_audio(mel)
    assert torch.equal(dynamic, resident)
    assert isinstance(model.whisper_model.decoder.blocks[0].attn.query, nn.Linear)


DIMS = dict(n_vocab=64, n_audio_ctx=50, n_text_ctx=24, n_text_layer=2)


def test_int8_cross_kv_decode_matches_jax(rng):
    """Prime + 4 steps of 3 beam rows a sample with int8 cross K/V: the
    port's logits against JAX's int8 logits, within 1/10 of JAX's own
    int8-against-float32 distance."""
    cfg, params = jax_tiny_model(seed=5, dims=DIMS)
    xa = (rng.standard_normal((2, 50, 64)) * 0.5).astype(np.float32)
    prompt = rng.integers(0, 64, (2, 5)).astype(np.int32)
    steps = rng.integers(0, 64, (4, 6, 1)).astype(np.int32)
    jparams = as_jax(params)["whisper"]

    def jax_run(jcfg):
        cache = jw.init_decode_cache(jparams, jcfg, jnp.asarray(xa), 5, 6, beam_size=3)
        logits, _, cache = jw.prime_decode_cache(jparams, jcfg, jnp.asarray(prompt), cache)
        seq = [np.asarray(logits, np.float64)]
        for tok in steps:
            out, cache = jw.decode_step(jparams, jcfg, jnp.asarray(tok), cache)
            seq.append(np.asarray(out, np.float64))
        return np.concatenate([s.reshape(-1) for s in seq])

    ref32 = jax_run(cfg.whisper)
    ref8 = jax_run(dataclasses.replace(cfg.whisper, int8_cross_kv=True))
    model = torch_model(with_whisper(cfg, int8_cross_kv=True), params).whisper_model
    cache = tw.init_decode_cache(model, model.cfg, torch.from_numpy(xa), 5, 6, beam_size=3)
    logits, _, cache = tw.prime_decode_cache(model, model.cfg, torch.from_numpy(prompt), cache)
    seq = [logits.double().numpy()]
    for tok in steps:
        out, cache = tw.decode_step(model, model.cfg, torch.from_numpy(tok), cache)
        seq.append(out.double().numpy())
    got = np.concatenate([s.reshape(-1) for s in seq])
    jax_err = rel_l2(ref8, ref32)
    assert 1e-5 < jax_err < 0.05
    assert rel_l2(got, ref8) <= jax_err / 10, (rel_l2(got, ref8), jax_err)
