"""The port's losses (``train/losses.py``) against the JAX package's on the
same logits and labels (numpy from a seed): every loss value within rtol
1e-5, including the silence head, label rasters shorter and longer than the
logits, a CTC target of length zero and an empty sample group (0). The CE
gradients agree with JAX's within rel-L2 1e-5. The CTC gradient is held
against a float64 computation instead: optax's float32 CTC gradient is
itself ~2e-3 from it over 1500 frames, the port's ``F.ctc_loss`` within
1e-5. A CTC target that cannot fit its frames takes optax's epsilon
recursion in the port too: its loss within rtol 1e-5 and its gradient within
atol 1e-4 of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.train import losses as J
from lyricalignment_tpu_torch.train import losses as P
from lyricalignment_tpu_torch.train.trainer import to_device
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


def _ctc_grouped(logits, labels, mask):
    """The port's grouped CTC, with the frames each target needs counted on
    the host as the trainer counts them."""
    return P.ctc_loss_grouped(logits, labels, mask, P.ctc_frames_needed(labels.numpy()))


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
                           lambda x, lab, m: _ctc_grouped(x[:, :, :V], lab, m),
                           logits, ctc, mask)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    x64 = torch.from_numpy(logits).double().requires_grad_()
    _ctc_grouped(x64[:, :, :V], torch.from_numpy(ctc), torch.from_numpy(mask)).backward()
    if mask.any():
        assert rel_l2(g, x64.grad.numpy()) < 1e-5
    else:
        assert got == 0.0 and not g.any()


def test_ctc_zero_length_target_alone(inputs):
    """A sample with no labels: the NLL of all-blank, divided by 1."""
    logits, _, ctc = inputs
    got = float(P.ctc_loss(torch.from_numpy(logits[1:2, :, :V]), torch.from_numpy(ctc[1:2]),
                           P.ctc_frames_needed(ctc[1:2])))
    ref = float(J.ctc_loss(jnp.asarray(logits[1:2, :, :V]), jnp.asarray(ctc[1:2])))
    blank = -torch.log_softmax(torch.from_numpy(logits[1, :, :V]).double(), -1)[:, 0].sum()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, float(blank), rtol=1e-5)


@pytest.mark.parametrize("labels", [[1, 2, 3, 4, 5], [3, 3, 3], [2, 2, 6, 6]],
                         ids=["too_long", "repeats", "repeated_pairs"])
def test_ctc_infeasible_target(rng, labels):
    """Four frames; sample 0 fits its two labels, sample 1 cannot fit its
    own (too many labels, or repeats that need blanks between). Sample 1
    takes optax's epsilon recursion: the loss equals JAX's to rtol 1e-5 and
    the gradient to atol 1e-4, that path's gradient included (entries up to
    ~0.5 / target length); the feasible sample's gradient is untouched by its
    neighbour."""
    t = 4
    logits = (rng.standard_normal((2, t, V)) * 2).astype(np.float32)
    ctc = np.full((2, 5), -100, np.int32)
    ctc[0, :2] = [4, 7]
    ctc[1, :len(labels)] = labels
    assert P.ctc_frames_needed(ctc).tolist() == [2, len(labels) + sum(
        a == b for a, b in zip(labels, labels[1:]))]
    mask = np.array([True, True])
    got, ref, g, rg = _both(J.ctc_loss_grouped, _ctc_grouped, logits, ctc, mask)
    assert np.isfinite(got) and np.isfinite(g).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(g, rg, rtol=0, atol=1e-4)
    assert got > 0.5 * -P.LOG_EPSILON / len(labels) / 2  # the mean of two samples
    assert 1e-2 < np.abs(g[1]).max() < 1.0               # the epsilon path's gradient

    alone, alone_ref, g_alone, rg_alone = _both(J.ctc_loss_grouped, _ctc_grouped,
                                                logits[:1], ctc[:1], mask[:1])
    np.testing.assert_allclose(alone, alone_ref, rtol=1e-5)
    np.testing.assert_allclose(g[0], g_alone[0] / 2, rtol=1e-6, atol=1e-9)
    assert rel_l2(g[0], rg[0]) < 1e-4 and rel_l2(g_alone, rg_alone) < 1e-4


@pytest.mark.parametrize("host_frames", [False, True], ids=["labels_read_back", "from_host"])
def test_ctc_mixed_batch(rng, host_frames):
    """One batch of five frames with a feasible target, one too long, one
    whose repeats cannot fit, a zero-length one and a masked-out infeasible
    one, through the trainer's route: ``to_device`` counts the frames each
    target needs on the host (from the numpy labels, or from a label tensor
    it reads back), ``ctc_per_example`` runs once and ``group_mean`` takes
    both sample groups from it. Each group's loss (rtol 1e-5) and gradient
    (atol 1e-4) equal JAX's ``ctc_loss_grouped``, as does their sum's; the
    masked-out sample gets no gradient from the first group."""
    t = 5
    logits = (rng.standard_normal((5, t, V)) * 2).astype(np.float32)
    ctc = np.full((5, 7), -100, np.int32)
    for row, labels in enumerate([[4, 7, 2], [1, 2, 3, 4, 5, 6], [3, 3, 3, 4], [],
                                  [2, 2, 6, 6, 1]]):
        ctc[row, :len(labels)] = labels
    mask = np.array([True, True, True, True, False])
    batch = to_device({"ctc_labels": ctc if host_frames else torch.from_numpy(ctc)}, "cpu")
    assert batch["ctc_frames_needed"].tolist() == [3, 6, 6, 0, 7]

    def groups(x, lab, m, both):
        per_example = P.ctc_per_example(x, lab, batch["ctc_frames_needed"])
        return P.group_mean(per_example, m) + (P.group_mean(per_example, ~m) if both else 0.0)

    for both in (False, True):
        got, ref, g, rg = _both(
            lambda x, lab, m: J.ctc_loss_grouped(x, lab, m) + (
                J.ctc_loss_grouped(x, lab, ~m) if both else 0.0),
            lambda x, lab, m: groups(x, lab, m, both), logits, ctc, mask)
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        np.testing.assert_allclose(g, rg, rtol=0, atol=1e-4)
        assert np.abs(g[1:3]).max() > 1e-2 and (np.abs(g[4]).max() > 1e-2) == both
