"""Port alignment ops vs JAX: the streaming row log-sum-exp (plain version
of the CUDA kernel) vs ``_chunked_lse`` and the Pallas ``_lse_kernel`` in
interpret mode (rtol 1e-6 / atol 1e-5: float32, summation order only); the
fused and unfused CE/CTC emissions (atol 1e-5); and the Viterbi DP, whose
onsets and offsets must EQUAL the JAX scan's and the Pallas kernel's given
identical emissions (the DP only adds and compares float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.ops import viterbi as jv
from lyricalignment_tpu.ops.viterbi_pallas import viterbi_align_pallas
from lyricalignment_tpu_torch.ops import viterbi as tv


@pytest.mark.parametrize("mode,cols", [("ce", 300), ("ctc", 301)])
def test_row_lse_matches_jax(rng, mode, cols):
    h = rng.standard_normal((2, 37, 24)).astype(np.float32)
    w = rng.standard_normal((24, cols)).astype(np.float32) * 0.5   # JAX [F, C]
    b = rng.standard_normal(cols).astype(np.float32)
    if mode == "ctc":  # the syllable slice the CTC normaliser runs over
        w, b = w[:, 1:-1], b[1:-1]
    ref_scan = np.asarray(jv._chunked_lse(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                                          chunk=128))
    ref_pallas = np.asarray(jv._chunked_lse_pallas(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = tv.row_lse(torch.from_numpy(h.reshape(-1, 24)),
                     torch.from_numpy(np.ascontiguousarray(w.T)),
                     torch.from_numpy(b)).numpy().reshape(2, 37)
    np.testing.assert_allclose(got, ref_scan, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got, ref_pallas, rtol=1e-6, atol=1e-5)


def _labels():
    # row 1 repeats labels (skip transitions banned), row 2 is short
    labels = np.array([[3, 7, 9, 4, 12],
                       [5, 5, 8, 8, 5],
                       [9, 2, 9, 0, 0]], np.int32)
    return labels, np.array([5, 5, 3], np.int32), np.array([40, 31, 22], np.int32)


@pytest.mark.parametrize("mode", ["ce", "ctc"])
def test_fused_emissions_match_jax(rng, mode):
    labels, _, _ = _labels()
    h = rng.standard_normal((3, 40, 24)).astype(np.float32)
    w = rng.standard_normal((24, 30)).astype(np.float32)
    b = rng.standard_normal(30).astype(np.float32)
    jax_fn = jv.ce_emissions_fused if mode == "ce" else jv.ctc_emissions_fused
    port_fn = tv.ce_emissions_fused if mode == "ce" else tv.ctc_emissions_fused
    ref = jax_fn(jnp.asarray(h), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                 jnp.asarray(labels), chunk=8)
    got = port_fn(torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T)),
                  torch.from_numpy(b), torch.from_numpy(labels).long())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["ce", "ctc"])
def test_unfused_emissions_match_jax(rng, mode):
    logits = rng.standard_normal((2, 10, 30)).astype(np.float32) * 3
    jax_fn = jv.ce_emissions if mode == "ce" else jv.ctc_emissions
    port_fn = tv.ce_emissions if mode == "ce" else tv.ctc_emissions
    for g, r in zip(port_fn(torch.from_numpy(logits)), jax_fn(jnp.asarray(logits))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["ce", "ctc"])
def test_dp_equals_jax_exactly(rng, mode):
    """Same per-position emissions into the JAX scan (viterbi_align_fused's
    DP), the Pallas kernel and the port: onsets and offsets bit-equal on
    every valid position, with ragged num_frames / num_labels."""
    labels, nl, nf = _labels()
    B, T, C = 3, 40, 16
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * 3
    jax_emit = jv.ce_emissions if mode == "ce" else jv.ctc_emissions
    lab_lp, sil_lp = (np.asarray(x) for x in jax_emit(jnp.asarray(logits)))
    lab_pos = np.take_along_axis(lab_lp, np.broadcast_to(labels[:, None, :], (B, T, 5)), 2)

    import jax
    ref_on, ref_off = jax.vmap(jv._viterbi_single_pos)(
        jnp.asarray(lab_pos), jnp.asarray(sil_lp), jnp.asarray(labels),
        jnp.asarray(nl), jnp.asarray(nf))
    pal_on, pal_off = viterbi_align_pallas(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(nl), jnp.asarray(nf),
        mode=mode, interpret=True)
    on, off = tv.viterbi_dp(*(torch.from_numpy(np.array(x))
                              for x in (lab_pos, sil_lp, labels, nl, nf)))
    for b in range(B):
        n = nl[b]
        for ref in ((ref_on, ref_off), (pal_on, pal_off)):
            np.testing.assert_array_equal(on.numpy()[b, :n], np.asarray(ref[0])[b, :n])
            np.testing.assert_array_equal(off.numpy()[b, :n], np.asarray(ref[1])[b, :n])
    # the unfused entry point gathers the same positions itself
    on2, off2 = tv.viterbi_align(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(nl), torch.from_numpy(nf), mode=mode)
    np.testing.assert_array_equal(on2.numpy(), on.numpy())
    np.testing.assert_array_equal(off2.numpy(), off.numpy())


def test_dp_sentinels_and_padding_rows(rng):
    """Every entry, not just valid positions: states never visited carry
    the JAX sentinels (T + 1 / 0), including a zero-frame row."""
    B, T, L = 3, 12, 4
    lab = np.maximum(rng.standard_normal((B, T, L)).astype(np.float32) * 4, -1000)
    sil = rng.standard_normal((B, T)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4], [2, 2, 2, 2], [4, 3, 0, 0]], np.int32)
    nl = np.array([4, 4, 2], np.int32)
    nf = np.array([T, 5, 0], np.int32)
    import jax
    ref = jax.vmap(jv._viterbi_single_pos)(*(jnp.asarray(x) for x in (lab, sil, labels, nl, nf)))
    got = tv.viterbi_dp(*(torch.from_numpy(x) for x in (lab, sil, labels, nl, nf)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_frames_to_seconds():
    on = np.array([[0, 3, 10]], np.int32)
    off = np.array([[3, 10, 11]], np.int32)
    ref = np.asarray(jv.frames_to_seconds(jnp.asarray(on), jnp.asarray(off)))
    got = tv.frames_to_seconds(torch.from_numpy(on), torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(got, ref)
