"""Port encoder attention (plain version of the CUDA kernel) vs the JAX
einsum formulation and the JAX one-pass entry point, with pad keys masked by
the key bias. float32: atol 1e-5 (summation order only); bfloat16 inputs:
rel-L2 2e-2 against the float32 JAX result (bf16 rounding of q, k, v and the
weights)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.ops.attention import _einsum_bias_attention
from lyricalignment_tpu.ops.attention import onepass_self_attention as jax_onepass
from lyricalignment_tpu_torch.ops.attention import (
    einsum_bias_attention,
    onepass_self_attention,
)
from tests.torch_port_helpers import rel_l2


def _inputs(rng, b=2, t=40, h=4, dh=64, n_pad=8):
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) * 0.3
               for _ in range(3))
    bias = np.where(np.arange(t)[None, :] < t - n_pad, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("jax_fn", [_einsum_bias_attention, jax_onepass])
def test_plain_attention_matches_jax_f32(rng, jax_fn):
    q, k, v, bias = _inputs(rng)
    ref = np.asarray(jax_fn(*(jnp.asarray(x) for x in (q, k, v, bias))))
    got = onepass_self_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_pad_keys_are_ignored(rng):
    """Changing the masked keys' values must not move any output."""
    q, k, v, bias = _inputs(rng)
    k2, v2 = k.copy(), v.copy()
    k2[:, -8:] = 5.0
    v2[:, -8:] = -7.0
    a = einsum_bias_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    b = einsum_bias_attention(*(torch.from_numpy(x) for x in (q, k2, v2, bias)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_plain_attention_bf16(rng):
    q, k, v, bias = _inputs(rng)
    ref = np.asarray(_einsum_bias_attention(*(jnp.asarray(x) for x in (q, k, v, bias))))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = onepass_self_attention(tq, tk, tv, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert rel_l2(got.float().numpy(), ref) < 2e-2
