"""Port align head (nn.GRU -> Mish, + fc) vs the JAX scan head, with ragged
lengths: at valid frames the packed GRU must equal the JAX masked scan to
float32 rounding (atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.align_head import align_head_apply as jax_apply
from lyricalignment_tpu.models.align_head import align_head_hidden as jax_hidden
from lyricalignment_tpu_torch.models.align_head import align_head_apply, align_head_hidden
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model


@pytest.mark.parametrize("lengths", [None, [50, 31, 7]])
def test_align_head_matches_jax(rng, lengths):
    cfg, params = jax_tiny_model()
    x = rng.standard_normal((3, 50, 64)).astype(np.float32)
    head = as_jax(params)["align_head"]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    model = torch_model(cfg, params)
    with torch.inference_mode():
        hid = align_head_hidden(model.align_rnn, torch.from_numpy(x), tl)
        logits = align_head_apply(model.align_rnn, torch.from_numpy(x), tl)
    ref_hid = np.asarray(jax_hidden(head, jnp.asarray(x), lengths=jl))
    ref_logits = np.asarray(jax_apply(head, jnp.asarray(x), lengths=jl))
    assert hid.dtype == torch.float32 and hid.shape == (3, 50, 32)
    for b, n in enumerate(lengths or [50] * 3):
        np.testing.assert_allclose(hid.numpy()[b, :n], ref_hid[b, :n], atol=1e-5, rtol=0)
        np.testing.assert_allclose(logits.numpy()[b, :n], ref_logits[b, :n],
                                   atol=1e-5, rtol=0)
