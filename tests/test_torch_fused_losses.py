"""The port's fused classifier->loss (``train/losses.py`` ``*_fused``, the row
LSE's gradient in ``ops/viterbi.py`` and the reduced CTC in ``ops/ctc.py``)
against the JAX package's fused functions on the same numpy inputs: loss
values within rtol 1e-5, gradients with respect to h, the fc weight and the
fc bias within rel-L2 1e-4 of ``jax.grad`` (float32 reduction order). The
cases of tests/test_losses.py:120-210 and more: the silence head on and off,
sample masks, an empty group, an all-padding target, repeated labels and a
target that cannot fit its frames (NLL ~1e30 over its length and a non-zero
gradient, as JAX gives them). The plain versions the CPU runs,
``row_lse_bwd_plain`` and ``ctc_reduced_{fwd,bwd}_plain``, are held against
``jax.grad`` of ``_chunked_lse`` and of ``_ctc_nll_single`` directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from lyricalignment_tpu.ops.viterbi import _chunked_lse
from lyricalignment_tpu.train import losses as J
from lyricalignment_tpu_torch.ops import ctc as port_ctc
from lyricalignment_tpu_torch.ops.viterbi import row_lse_bwd_plain
from lyricalignment_tpu_torch.train import losses as P
from tests.torch_port_helpers import rel_l2

VOCAB = 16   # head output 17 = vocab + the silence channel


def _setup(rng, b=2, t=12, f=8, c=17):
    h = rng.standard_normal((b, t, f)).astype(np.float32)
    w = rng.standard_normal((f, c)).astype(np.float32)   # JAX layout [F, C]
    bias = rng.standard_normal((c,)).astype(np.float32)
    return h, w, bias


def _port_leaves(h, w, bias):
    ht = torch.tensor(h, requires_grad=True)
    fc = nn.Linear(w.shape[0], w.shape[1])
    with torch.no_grad():
        fc.weight.copy_(torch.from_numpy(w.T.copy()))
        fc.bias.copy_(torch.from_numpy(bias))
    return ht, fc


def _compare(jax_fn, port_fn, h, w, bias, grad_tol=1e-4):
    """Loss and gradients (h, w, b) of the JAX function fn(h, {"w", "b"})
    and of the port's fn(h, fc)."""
    val, grads = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        jnp.asarray(h), {"w": jnp.asarray(w), "b": jnp.asarray(bias)})
    ht, fc = _port_leaves(h, w, bias)
    loss = port_fn(ht, fc)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=1e-5, atol=1e-7)
    want = (np.asarray(grads[0]), np.asarray(grads[1]["w"]).T, np.asarray(grads[1]["b"]))
    got = (ht.grad.numpy(), fc.weight.grad.numpy(), fc.bias.grad.numpy())
    for g, wnt in zip(got, want):
        if np.abs(wnt).max() == 0:
            assert np.abs(g).max() == 0
        else:
            assert rel_l2(g, wnt) <= grad_tol, rel_l2(g, wnt)
    return float(loss.detach()), got


@pytest.mark.parametrize("mask", [[True, True], [True, False], [False, False]])
@pytest.mark.parametrize("silence_head", [False, True])
def test_fused_frame_ce_matches_jax(rng, silence_head, mask):
    h, w, bias = _setup(rng)
    lo = 1 if silence_head else 0
    labels = rng.integers(lo, VOCAB, (2, 12)).astype(np.int32)
    labels[0, 3:5] = -100
    labels[1, 0] = -100
    m = np.asarray(mask)

    def jfn(hh, fc):
        return J.frame_ce_loss_grouped_fused(hh, fc, jnp.asarray(labels), jnp.asarray(m),
                                             with_silence_head=silence_head,
                                             vocab_size=VOCAB, chunk=5)

    def pfn(hh, fc):
        return P.frame_ce_loss_grouped_fused(hh, fc, torch.from_numpy(labels),
                                             torch.from_numpy(m),
                                             with_silence_head=silence_head, vocab_size=VOCAB)

    loss, _ = _compare(jfn, pfn, h, w, bias)
    assert (loss == 0.0) == (not any(mask))


@pytest.mark.parametrize("label_len", [8, 12, 15])
def test_fused_frame_ce_label_lengths(rng, label_len):
    """Label rasters shorter and longer than the frames are padded or cut,
    as the JAX function does."""
    h, w, bias = _setup(rng)
    labels = rng.integers(1, VOCAB, (2, label_len)).astype(np.int32)
    m = np.asarray([True, True])
    _compare(lambda hh, fc: J.frame_ce_loss_grouped_fused(
                 hh, fc, jnp.asarray(labels), jnp.asarray(m), with_silence_head=True,
                 vocab_size=VOCAB, chunk=5),
             lambda hh, fc: P.frame_ce_loss_grouped_fused(
                 hh, fc, torch.from_numpy(labels), torch.from_numpy(m),
                 with_silence_head=True, vocab_size=VOCAB), h, w, bias)


CTC_TARGETS = {
    # repeated labels: the no-skip rule between equal neighbours
    "repeats": [[3, 3, 7, 2, -100], [5, 1, -100, -100, -100]],
    # an all-padding target beside a normal one
    "empty": [[-100, -100, -100, -100, -100], [4, 7, -100, -100, -100]],
    # five labels, three repeats: 8 frames needed of the 6 given
    "infeasible": [[2, 9, -100, -100, -100], [1, 1, 1, 1, 2]],
    "all_infeasible": [[1, 1, 1, 1, 1], [6, 6, 6, 6, 6]],
}


@pytest.mark.parametrize("mask", [[True, True], [False, True], [False, False]])
@pytest.mark.parametrize("case", sorted(CTC_TARGETS))
def test_fused_ctc_matches_jax(rng, case, mask):
    t = 6 if "infeasible" in case else 14
    h, w, bias = _setup(rng, t=t)
    labels = np.asarray(CTC_TARGETS[case], np.int32)
    m = np.asarray(mask)

    def jfn(hh, fc):
        return J.ctc_loss_grouped_fused(hh, fc, jnp.asarray(labels), jnp.asarray(m),
                                        vocab_size=VOCAB, chunk=5)

    def pfn(hh, fc):
        return P.ctc_loss_grouped_fused(hh, fc, torch.from_numpy(labels),
                                        torch.from_numpy(m), vocab_size=VOCAB)

    loss, grads = _compare(jfn, pfn, h, w, bias)
    if "infeasible" in case and mask[1]:
        # the sentinel over the target length, and a gradient all the same
        assert loss > 1e28 and np.abs(grads[0][1]).max() > 0
    if not any(mask):
        assert loss == 0.0


def test_fused_ctc_per_example_matches_unfused_where_targets_fit(rng):
    """Where every target fits, the fused per-sample CTC equals the unfused
    one on the materialised logits (rtol 1e-5)."""
    h, w, bias = _setup(rng, b=3, t=14)
    labels = np.asarray([[3, 3, 7, 2, -100], [5, 1, -100, -100, -100],
                         [-100] * 5], np.int32)
    ht, fc = _port_leaves(h, w, bias)
    with torch.no_grad():
        fused = P.ctc_per_example_fused(ht, fc, torch.from_numpy(labels), VOCAB)
        logits = fc(ht)[:, :, :VOCAB]
        unfused = P.ctc_per_example(logits, torch.from_numpy(labels),
                                    P.ctc_frames_needed(labels))
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-5)


@pytest.mark.parametrize("rows,cols,chunk", [(13, 23, 5), (40, 37, 4224), (1, 3, 2)])
def test_row_lse_bwd_plain_matches_jax_grad(rng, rows, cols, chunk):
    h = rng.standard_normal((rows, 8)).astype(np.float32)
    w = rng.standard_normal((8, cols)).astype(np.float32)
    b = rng.standard_normal(cols).astype(np.float32)
    g = rng.standard_normal(rows).astype(np.float32)
    want = jax.grad(lambda hh, ww, bb: jnp.sum(_chunked_lse(hh[None], ww, bb, 5)[0] * g),
                    argnums=(0, 1, 2))(h, w, b)
    lse = torch.from_numpy(np.array(_chunked_lse(h[None], w, b)[0]))
    got = row_lse_bwd_plain(torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                            torch.from_numpy(b), lse, torch.from_numpy(g), chunk=chunk)
    for a, ref in zip((got[0], got[1].T, got[2]), want):
        assert rel_l2(a.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("t", [1, 2, 9])
def test_ctc_reduced_plain_matches_jax_grad(rng, t):
    """Both plain recursions against ``jax.vmap(_ctc_nll_single)`` and its
    ``jax.grad``: repeats, a partial, a long repeated and an empty target
    (the long one cannot fit at t < 8)."""
    n = 5
    blank = rng.standard_normal((4, t)).astype(np.float32) - 1
    label = rng.standard_normal((4, t, n)).astype(np.float32) - 1
    labels = np.array([[1, 1, 2, 3, 3], [4, 5, 6, 0, 0], [1, 1, 1, 1, 2], [0] * 5], np.int32)
    valid = np.array([[1] * 5, [1, 1, 1, 0, 0], [1] * 5, [0] * 5], bool)
    weights = rng.standard_normal(4).astype(np.float32)

    def f(bl, ll):
        return jax.vmap(J._ctc_nll_single)(bl, ll, jnp.asarray(labels), jnp.asarray(valid))

    want = np.asarray(f(blank, label))
    want_g = jax.grad(lambda a, b: jnp.sum(f(a, b) * weights), argnums=(0, 1))(blank, label)
    nll, alphas = port_ctc.ctc_reduced_fwd_plain(
        torch.from_numpy(blank), torch.from_numpy(label), torch.from_numpy(labels),
        torch.from_numpy(valid))
    np.testing.assert_allclose(nll.numpy(), want, rtol=1e-5)
    got_g = port_ctc.ctc_reduced_bwd_plain(alphas, torch.from_numpy(labels),
                                           torch.from_numpy(valid), torch.from_numpy(weights))
    for a, ref in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)
