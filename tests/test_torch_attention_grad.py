"""Gradients of the port's encoder attention against ``jax.vjp`` of the JAX
reference formulations. On the CPU ``self_attention`` and
``onepass_self_attention`` run the autograd Function with the plain
versions of the three kernels: the forward with its row log-sum-exp, then
dK/dV and dQ recomputed from it. float32: outputs and q/k/v gradients within
atol 1e-5 (summation order only); bf16 inputs: rel-L2 2e-2 against the
float32 JAX result (bf16 rounding of the inputs, of P and of dS)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.ops.attention import _einsum_attention, _einsum_bias_attention
from lyricalignment_tpu_torch.ops.attention import (
    attention_fwd_plain,
    onepass_self_attention,
    self_attention,
)
from tests.torch_port_helpers import rel_l2


def _inputs(rng, t, b=2, h=3, dh=64):
    return [(rng.standard_normal((b, t, h, dh)) * 0.4).astype(np.float32) for _ in range(4)]


def _bias(rng, t):
    bias = (rng.standard_normal((1, t)) * 0.5).astype(np.float32)
    bias[0, t - t // 4:] = -1e9  # masked keys, never all of them
    return bias


def _port(fn, arrays, dtype=torch.float32, *extra):
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in arrays)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, *extra)
    out.backward(g)
    return [out.detach().float().numpy()] + [x.grad.float().numpy() for x in leaves]


@pytest.mark.parametrize("t", [1, 40, 130])
@pytest.mark.parametrize("with_bias", [False, True])
def test_forward_and_gradients_match_jax_f32(rng, t, with_bias):
    q, k, v, g = arrays = _inputs(rng, t)
    if with_bias:
        bias = _bias(rng, t)
        ref_fn = lambda q, k, v: _einsum_bias_attention(q, k, v, jnp.asarray(bias))
        got = _port(onepass_self_attention, arrays, torch.float32, torch.from_numpy(bias))
    else:
        ref_fn = lambda q, k, v: _einsum_attention(q, k, v, 1.0)
        got = _port(self_attention, arrays)
    out, vjp = jax.vjp(ref_fn, *map(jnp.asarray, (q, k, v)))
    ref = [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def test_sm_scale_matches_jax(rng):
    q, k, v, g = arrays = _inputs(rng, 33)
    out, vjp = jax.vjp(lambda q, k, v: _einsum_attention(q, k, v, 0.3), *map(jnp.asarray, (q, k, v)))
    ref = [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _port(lambda q, k, v: self_attention(q, k, v, sm_scale=0.3), arrays)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_bf16_gradients(rng):
    q, k, v, g = arrays = _inputs(rng, 70)
    out, vjp = jax.vjp(lambda q, k, v: _einsum_attention(q, k, v, 1.0), *map(jnp.asarray, (q, k, v)))
    ref = [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _port(self_attention, arrays, torch.bfloat16)
    for a, b in zip(got, ref):
        assert rel_l2(a, b) < 2e-2


def test_row_lse_matches_jax(rng):
    q, k, v, _ = _inputs(rng, 50)
    bias = _bias(rng, 50)
    _, lse = attention_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(bias[0]), with_lse=True)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) + bias[0]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               atol=1e-5, rtol=0)


def test_no_statistics_without_grad(rng):
    """Under no_grad the forward takes no autograd record."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _inputs(rng, 9))
    with torch.no_grad():
        out = self_attention(q, k, v)
    assert out.grad_fn is None
    assert self_attention(q, k, v).grad_fn is not None
