"""The port's losses (``train/losses.py``) against the JAX package's on the
same logits and labels (numpy from a seed): every loss value within rtol
1e-5, including the silence head, label rasters shorter and longer than the
logits, a CTC target of length zero and an empty sample group (0). The CE
gradients agree with JAX's within rel-L2 1e-5. The CTC gradient is held
against a float64 computation instead: optax's float32 CTC gradient is
itself ~2e-3 from it over 1500 frames, the port's ``F.ctc_loss`` within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.train import losses as J
from lyricalignment_tpu_torch.train import losses as P
from tests.torch_port_helpers import rel_l2

B, T, V = 3, 1500, 10
C = V + 1  # + the silence channel


@pytest.fixture
def inputs(rng):
    logits = (rng.standard_normal((B, T, C)) * 2).astype(np.float32)
    frames = np.where(rng.random((B, T)) < 0.3, rng.integers(1, V - 1, (B, T)), -100)
    ctc = np.where(np.arange(6)[None, :] < np.array([[3], [0], [5]]),
                   rng.integers(1, V - 1, (B, 6)), -100)  # sample 1: zero-length target
    return logits, frames.astype(np.int32), ctc.astype(np.int32)


def _both(jax_fn, torch_fn, logits, *arrays):
    """(port value, JAX value, port grad, JAX grad) of a loss of logits."""
    ref, ref_grad = jax.value_and_grad(lambda x: jax_fn(x, *map(jnp.asarray, arrays)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = torch_fn(x, *map(torch.from_numpy, arrays))
    got.backward()
    return float(got.detach()), float(ref), x.grad.numpy(), np.asarray(ref_grad)


MASKS = [np.array([True, False, True]), np.array([False, False, False]),
         np.array([True, True, True])]


@pytest.mark.parametrize("mask", MASKS, ids=["some", "empty", "all"])
@pytest.mark.parametrize("silence_head", [False, True])
@pytest.mark.parametrize("label_len", [T, T - 200, T + 50])
def test_frame_ce(inputs, mask, silence_head, label_len):
    logits, frames, _ = inputs
    frames = np.pad(frames, ((0, 0), (0, 50)), constant_values=7)[:, :label_len]
    got, ref, g, rg = _both(
        lambda x, f, m: J.frame_ce_loss_grouped(x, f, m, silence_head, V),
        lambda x, f, m: P.frame_ce_loss_grouped(x, f, m, silence_head, V), logits, frames, mask)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    if mask.any():
        assert rel_l2(g, rg) < 1e-5
    else:
        assert got == 0.0 and not g.any()


def test_masked_and_transcript_ce(inputs):
    logits, frames, _ = inputs
    for jf, pf in ((J.masked_ce, P.masked_ce), (J.transcript_ce_loss, P.transcript_ce_loss),
                   (lambda x, f: J.frame_ce_loss(x, f, True, V),
                    lambda x, f: P.frame_ce_loss(x, f, True, V))):
        got, ref, g, rg = _both(jf, pf, logits, frames)
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        assert rel_l2(g, rg) < 1e-5
    none = np.full_like(frames, -100)
    assert float(P.masked_ce(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("mask", MASKS, ids=["some", "empty", "all"])
def test_ctc(inputs, mask):
    logits, _, ctc = inputs
    got, ref, g, _ = _both(lambda x, lab, m: J.ctc_loss_grouped(x[:, :, :V], lab, m),
                           lambda x, lab, m: P.ctc_loss_grouped(x[:, :, :V], lab, m),
                           logits, ctc, mask)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    x64 = torch.from_numpy(logits).double().requires_grad_()
    P.ctc_loss_grouped(x64[:, :, :V], torch.from_numpy(ctc), torch.from_numpy(mask)).backward()
    if mask.any():
        assert rel_l2(g, x64.grad.numpy()) < 1e-5
    else:
        assert got == 0.0 and not g.any()


def test_ctc_zero_length_target_alone(inputs):
    """A sample with no labels: the NLL of all-blank, divided by 1."""
    logits, _, ctc = inputs
    got = float(P.ctc_loss(torch.from_numpy(logits[1:2, :, :V]), torch.from_numpy(ctc[1:2])))
    ref = float(J.ctc_loss(jnp.asarray(logits[1:2, :, :V]), jnp.asarray(ctc[1:2])))
    blank = -torch.log_softmax(torch.from_numpy(logits[1, :, :V]).double(), -1)[:, 0].sum()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, float(blank), rtol=1e-5)
