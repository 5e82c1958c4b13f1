"""The port's optimizer chain (``train/schedule.py``) against the JAX
package's optax chain: schedule values equal to float32 rounding, and three
updates on the same gradients — clipping active, a frozen encoder group, a
bf16 first moment — within rtol 1e-6 (float32 rounding of the same
operations in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lyricalignment_tpu.train.schedule import linear_warmup_decay as jax_schedule
from lyricalignment_tpu.train.schedule import make_optimizer as jax_make_optimizer
from lyricalignment_tpu_torch.train.schedule import (
    linear_warmup_decay,
    make_optimizer,
    param_group_labels,
)

# JAX tree path -> the port's parameter name
LEAVES = {
    ("whisper", "encoder", "w"): "whisper_model.encoder.w",
    ("whisper", "decoder", "w"): "whisper_model.decoder.w",
    ("whisper", "decoder", "b"): "whisper_model.decoder.b",
    ("align_head", "w"): "align_rnn.w",
    ("align_head", "b"): "align_rnn.b",
}
SHAPES = {"w": (6, 5), "b": (5,)}


@pytest.mark.parametrize("warmup,total", [(200, 2000), (0, 10), (3, 3), (5, 2)])
def test_schedule_matches_jax(warmup, total):
    ours = linear_warmup_decay(5e-3, warmup, total)
    ref = jax_schedule(5e-3, warmup, total)
    for step in [0, 1, 2, 3, 4, 100, 200, 1100, 1999, 2000, 2500]:
        assert ours(step) == float(np.float32(ref(step))), step


def _tree(arrays):
    tree = {}
    for path, name in LEAVES.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arrays[name]
    return tree


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("freeze_encoder", [False, True])
def test_three_updates_match_optax(rng, mu_dtype, freeze_encoder):
    params = {name: rng.standard_normal(SHAPES[path[-1]]).astype(np.float32)
              for path, name in LEAVES.items()}
    kw = dict(head_lr=5e-2, backbone_lr=1e-2, weight_decay=1e-2, warmup_steps=1,
              total_steps=6, max_grad_norm=1.0)
    tx = jax_make_optimizer(_tree(params), mu_dtype=getattr(jnp, mu_dtype or "float32")
                            if mu_dtype else None, freeze_encoder=freeze_encoder, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(params))
    jstate = tx.init(jparams)

    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    labels = param_group_labels(tparams.items(), freeze_encoder=freeze_encoder)
    opt = make_optimizer(labels, mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None, **kw)
    state = opt.init(tparams)
    assert set(state.mu) == {n for n, g in labels.items() if g != "frozen"}

    for step in range(3):
        # large gradients: the global norm is far above max_grad_norm
        grads = {n: (rng.standard_normal(p.shape) * (5.0 + step)).astype(np.float32)
                 for n, p in params.items()}
        if freeze_encoder:
            grads["whisper_model.encoder.w"] = np.zeros_like(params["whisper_model.encoder.w"])
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(grads)),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = {n: torch.from_numpy(g) for n, g in grads.items()}
        if freeze_encoder:
            tgrads["whisper_model.encoder.w"] = None  # no_grad encoder: no gradient
        state = opt.update(tparams, tgrads, state)
        for path, name in LEAVES.items():
            np.testing.assert_allclose(tparams[name].numpy(), _leaf(jparams, path),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name} step {step}")
    assert state.count == 3
    if mu_dtype:
        assert all(m.dtype == torch.bfloat16 for m in state.mu.values())
    if freeze_encoder:
        np.testing.assert_array_equal(tparams["whisper_model.encoder.w"].numpy(),
                                      params["whisper_model.encoder.w"])


def test_missing_gradient_still_decays_weights():
    """A trained parameter without a gradient (the decoder when only the
    alignment task trains) gets optax's zero-gradient AdamW step: decoupled
    weight decay only."""
    p = {"whisper_model.decoder.w": torch.ones(3)}
    opt = make_optimizer(param_group_labels(p.items()), backbone_lr=0.1, weight_decay=0.5,
                         warmup_steps=0, total_steps=10)
    opt.update(p, {"whisper_model.decoder.w": None}, opt.init(p))
    torch.testing.assert_close(p["whisper_model.decoder.w"], torch.full((3,), 1 - 0.1 * 0.5))
