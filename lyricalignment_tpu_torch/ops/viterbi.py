"""Forced alignment: CE/CTC emissions, the fused classifier normaliser and
the Viterbi DP.

Port of ``lyricalignment_tpu/ops/viterbi.py``. Two kernels carry it:

* the streaming row log-sum-exp of the classifier logits (``csrc/lse.cu``,
  counterpart of the Pallas ``_lse_kernel``), so the fused path never writes
  the [B, T, C] logits; :func:`row_lse_plain` is the chunked online form of
  ``_chunked_lse``. Its gradient, for the fused training losses, is a pair
  of backward kernels in the same file that recompute the logits a tile at
  a time (the counterpart of ``jax.checkpoint`` over ``_chunked_lse``'s
  scan); :func:`row_lse_bwd_plain` is the chunked plain version of it;
* the DP with backtrace (``csrc/viterbi.cu``, counterpart of the Pallas
  ``viterbi_pallas._kernel``) with ``_viterbi_dp``'s exact transition and
  tie-breaking rules (`viterbi.py:13-18`); :func:`viterbi_dp_plain` is the
  same DP as a loop over frames.

State space: K = 2L+1 interleaved states, even = silence, odd 2i+1 = label
i. Label emissions are given per label *position*: lab[b, t, i] is the
log-prob of label i of sequence b at frame t.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lyricalignment_tpu_torch import HOP_SIZE_SECOND, kernels

NEG_BIG = -1.0e7       # reference's dp initialisation value
NEG_INF = -1.0e30      # padding for shifted neighbours / invalid states
CLIP_MIN = -1000.0     # reference clips log-probs at -1000
LSE_CHUNK = 4224       # columns per step of the plain streaming LSE


# ---------------------------------------------------------------------------
# Emissions from materialised logits
# ---------------------------------------------------------------------------

def ce_emissions(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-CE emissions: logits f32[B, T, C] with class 0 = silence ->
    (label log-prob [B, T, C] indexed by label id, silence [B, T])."""
    clipped = torch.clamp(torch.log_softmax(logits, dim=-1), min=CLIP_MIN)
    return clipped, clipped[..., 0]


def ctc_emissions(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """CTC-head emissions: column 0 is the blank, 1..C-2 the syllables, C-1
    the sigmoid silence detector. A leading NEG_INF column keeps label ids
    usable as indices."""
    word = torch.log_softmax(logits[..., 1:-1], dim=-1)
    sil_logit = logits[..., -1]
    log_sil = -F.softplus(-sil_logit)
    log_voiced = -F.softplus(sil_logit)
    word = torch.clamp(word + log_voiced[..., None], min=CLIP_MIN)
    log_sil = torch.clamp(log_sil, min=CLIP_MIN)
    pad = torch.full(word.shape[:-1] + (1,), NEG_INF, dtype=word.dtype,
                     device=word.device)
    return torch.cat([pad, word], dim=-1), log_sil


# ---------------------------------------------------------------------------
# Kernel 3: streaming row log-sum-exp of h @ w.T + b
# ---------------------------------------------------------------------------

def row_lse_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  chunk: int = LSE_CHUNK) -> torch.Tensor:
    """Plain version: online max/sum over column chunks.
    h f32[N, F], w f32[C, F], b f32[C] -> f32[N]."""
    m = torch.full(h.shape[:1], float("-inf"), dtype=torch.float32, device=h.device)
    s = torch.zeros_like(m)
    for c0 in range(0, w.shape[0], chunk):
        lg = h @ w[c0:c0 + chunk].T + b[c0:c0 + chunk]
        nm = torch.maximum(m, lg.amax(dim=-1))
        s = s * torch.exp(m - nm) + torch.exp(lg - nm[:, None]).sum(dim=-1)
        m = nm
    return m + torch.log(s)


def _row_lse_forward(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not h.is_cuda:
        kernels.plain_or_raise("row_lse", h)
        return row_lse_plain(h, w, b)
    kernels.check_cuda("row_lse h", h, torch.float32, 2)
    kernels.check_cuda("row_lse w", w, torch.float32, 2)
    kernels.check_cuda("row_lse b", b, torch.float32, 1)
    rows, feat = h.shape
    cols = w.shape[0]
    if w.shape[1] != feat or b.shape[0] != cols or cols == 0:
        raise ValueError("row_lse: shapes of h, w, b do not agree")
    if feat % 4 or h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("row_lse: needs feat % 4 == 0 and 16-byte aligned h, w")
    out = torch.empty((rows,), dtype=torch.float32, device=h.device)
    if rows:
        # the low halves of w's split and the column ranges' partial results
        scratch = torch.empty(
            (kernels.library().la_row_lse_scratch_floats(rows, feat, cols),),
            dtype=torch.float32, device=h.device)
        kernels.launch("la_row_lse", h.data_ptr(), w.data_ptr(), b.data_ptr(),
                       out.data_ptr(), scratch.data_ptr(), rows, feat, cols,
                       kernels.stream_of(h))
    return out


def row_lse_bwd_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, lse: torch.Tensor,
                      g: torch.Tensor, chunk: int = LSE_CHUNK):
    """Plain version of the row LSE's gradient, recomputing the logits a
    column chunk at a time: p = g exp(h @ w.T + b - lse) per chunk, then
    dh = p @ w, dw = p.T @ h, db = sum_rows p. h [N, F], w [C, F], b [C],
    lse and g [N] -> (dh [N, F], dw [C, F], db [C]), in h's dtype."""
    dh = torch.zeros_like(h)
    dw = torch.empty_like(w, dtype=h.dtype)
    db = torch.empty_like(b, dtype=h.dtype)
    for c0 in range(0, w.shape[0], chunk):
        wc = w[c0:c0 + chunk].to(h.dtype)
        p = torch.exp(h @ wc.T + b[c0:c0 + chunk].to(h.dtype) - lse[:, None]) * g[:, None]
        dh += p @ wc
        dw[c0:c0 + chunk] = p.T @ h
        db[c0:c0 + chunk] = p.sum(dim=0)
    return dh, dw, db


def row_lse_bwd_dh(h, w, b, lse, g) -> torch.Tensor:
    """dh of :func:`row_lse_bwd_plain`: the CUDA kernel ``la_row_lse_bwd_dh``
    for CUDA tensors, the plain version for CPU ones."""
    if not h.is_cuda:
        kernels.plain_or_raise("row_lse_bwd", h)
        return row_lse_bwd_plain(h, w, b, lse, g)[0]
    rows, feat, cols = _check_bwd(h, w, b, lse, g)
    dh = torch.empty_like(h)
    if rows:
        scratch = torch.empty(
            (kernels.library().la_row_lse_bwd_scratch_floats(rows, feat, cols),),
            dtype=torch.float32, device=h.device)
        kernels.launch("la_row_lse_bwd_dh", h.data_ptr(), w.data_ptr(), b.data_ptr(),
                       lse.data_ptr(), g.data_ptr(), dh.data_ptr(), scratch.data_ptr(),
                       rows, feat, cols, kernels.stream_of(h))
    return dh


def row_lse_bwd_dw(h, w, b, lse, g):
    """(dw, db) of :func:`row_lse_bwd_plain`: the CUDA kernel
    ``la_row_lse_bwd_dw`` for CUDA tensors, the plain version for CPU ones."""
    if not h.is_cuda:
        kernels.plain_or_raise("row_lse_bwd", h)
        return row_lse_bwd_plain(h, w, b, lse, g)[1:]
    rows, feat, cols = _check_bwd(h, w, b, lse, g)
    dw = torch.empty((cols, feat), dtype=torch.float32, device=h.device)
    db = torch.empty((cols,), dtype=torch.float32, device=h.device)
    kernels.launch("la_row_lse_bwd_dw", h.data_ptr(), w.data_ptr(), b.data_ptr(),
                   lse.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
                   rows, feat, cols, kernels.stream_of(h))
    return dw, db


def _check_bwd(h, w, b, lse, g):
    """The backward kernels' conditions."""
    for name, t, ndim in (("h", h, 2), ("w", w, 2), ("b", b, 1), ("lse", lse, 1),
                          ("g", g, 1)):
        kernels.check_cuda(f"row_lse_bwd {name}", t, torch.float32, ndim)
    rows, feat = h.shape
    cols = w.shape[0]
    if (w.shape[1] != feat or b.shape[0] != cols or cols == 0
            or any(t.shape[0] != rows for t in (lse, g))):
        raise ValueError("row_lse_bwd: shapes of h, w, b, lse, g do not agree")
    if feat % 16 or feat > 768 or any(t.data_ptr() % 16 for t in (h, w)):
        raise ValueError("row_lse_bwd: needs feat % 16 == 0, feat <= 768 and 16-byte "
                         "aligned h, w")
    return rows, feat, cols


class _RowLSE(torch.autograd.Function):
    """The row LSE with its gradient: the forward saves (h, w, b, lse); the
    backward recomputes the logits (the backward kernels, or
    :func:`row_lse_bwd_plain` on the CPU), so no [N, C] tensor is kept."""

    @staticmethod
    def forward(ctx, h, w, b):
        lse = _row_lse_forward(h, w, b)
        ctx.save_for_backward(h, w, b, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        h, w, b, lse = ctx.saved_tensors
        g = g.contiguous()
        dh = dw = db = None
        if not h.is_cuda:
            dh, dw, db = row_lse_bwd_plain(h, w, b, lse, g)
        else:
            if ctx.needs_input_grad[0]:
                dh = row_lse_bwd_dh(h, w, b, lse, g)
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                dw, db = row_lse_bwd_dw(h, w, b, lse, g)
        return dh, dw, db


def row_lse(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log sum_c exp(h @ w.T + b) per row, without materialising the logits,
    and its gradient: the kernel ``la_row_lse`` forward and the backward
    pair for CUDA tensors, :func:`row_lse_plain` and
    :func:`row_lse_bwd_plain` for CPU ones. ``w`` may be a row slice of a
    larger weight (the CTC syllable columns in serving; ``fc.weight[1:vocab]``
    of the CE, ``[:vocab]`` of the CTC in training); the gradient reaches
    the slice's rows only. Under ``no_grad`` nothing is saved."""
    return _RowLSE.apply(h, w, b)


# ---------------------------------------------------------------------------
# Fused emissions: only the label columns are materialised
# ---------------------------------------------------------------------------

def gather_label_logits(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-position label logits [B, T, L] from the gathered weight rows."""
    return torch.einsum("btf,blf->btl", h, w[labels]) + b[labels][:, None, :]


def class_lse(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`row_lse` of h [B, T, F] -> [B, T]: the class normaliser of the
    fused emissions and of the fused training losses."""
    bdim, tdim, fdim = h.shape
    return row_lse(h.reshape(bdim * tdim, fdim), w, b).reshape(bdim, tdim)


def ce_emissions_fused(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ce_emissions(h @ w.T + b)`` gathered to label positions without the
    [B, T, C] logits. h f32[B, T, F]; w [C, F], b [C] (the head's fc).
    Returns (label log-prob [B, T, L], silence [B, T])."""
    lse = class_lse(h, w, b)
    gathered = gather_label_logits(h, w, b, labels)
    sil = h @ w[0] + b[0]
    lab_lp = torch.clamp(gathered - lse[..., None], min=CLIP_MIN)
    sil_lp = torch.clamp(sil - lse, min=CLIP_MIN)
    return lab_lp, sil_lp


def ctc_emissions_fused(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ctc_emissions(h @ w.T + b)`` gathered to label positions: the
    normaliser runs over the syllable columns 1..C-2 only; label l reads
    column l."""
    lse = class_lse(h, w[1:-1], b[1:-1])
    gathered = gather_label_logits(h, w, b, labels)
    sil_logit = h @ w[-1] + b[-1]
    log_sil = -F.softplus(-sil_logit)
    log_voiced = -F.softplus(sil_logit)
    word = gathered - lse[..., None] + log_voiced[..., None]
    return torch.clamp(word, min=CLIP_MIN), torch.clamp(log_sil, min=CLIP_MIN)


# ---------------------------------------------------------------------------
# Kernel 4: the Viterbi DP
# ---------------------------------------------------------------------------

def _wrap_clamp(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX dynamic-index semantics: negative indices wrap, others clamp."""
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def viterbi_dp_plain(lab: torch.Tensor, sil: torch.Tensor, labels: torch.Tensor,
                     num_labels: torch.Tensor, num_frames: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the DP, vectorised over batch and states.
    lab f32[B, T, L], sil f32[B, T], labels i32[B, L], num_labels /
    num_frames i32[B] -> (onset, offset) i32[B, L] frames."""
    bdim, t_max, l_max = lab.shape
    k_dim = 2 * l_max + 1
    dev = lab.device
    labels = labels.long()
    state = torch.arange(k_dim, device=dev)
    odd = state % 2 == 1
    char = (state // 2).clamp(max=l_max - 1)
    prev_char = (state // 2 - 1).clamp(0, l_max - 1)
    can_skip = odd & (state >= 3) & (labels[:, char] != labels[:, prev_char])
    em = torch.where(odd, lab[:, :, char], sil[:, :, None])          # [B, T, K]

    dp = torch.full((bdim, k_dim), NEG_BIG, dtype=torch.float32, device=dev)
    dp[:, 0] = sil[:, 0]
    dp[:, 1] = lab[:, 0, 0]
    pad1 = torch.full((bdim, 1), NEG_INF, dtype=torch.float32, device=dev)
    pad2 = torch.full((bdim, 2), NEG_INF, dtype=torch.float32, device=dev)
    nf = num_frames.long()[:, None]
    bts = []
    for t in range(1, t_max):
        p1 = torch.cat([pad1, dp[:, :-1]], dim=1)
        p2 = torch.cat([pad2, dp[:, :-2]], dim=1)
        stay = dp > p1
        val = torch.where(stay, dp, p1)
        bt = torch.where(stay, state, state - 1)
        skip = can_skip & (p2 >= p1) & (p2 >= dp)
        val = torch.where(skip, p2, val)
        bt = torch.where(skip, state - 2, bt)
        live = t < nf
        dp = torch.where(live, val + em[:, t], dp)
        bts.append(torch.where(live, bt, state))

    nl = num_labels.long()
    i_sil, i_lab = _wrap_clamp(2 * nl, k_dim), _wrap_clamp(2 * nl - 1, k_dim)
    end_sil = dp.gather(1, i_sil[:, None])[:, 0]
    end_lab = dp.gather(1, i_lab[:, None])[:, 0]
    cur = torch.where(end_sil > end_lab, i_sil, i_lab)
    path = [cur]
    for bt in reversed(bts):
        cur = bt.gather(1, cur[:, None])[:, 0]
        path.append(cur)
    path = torch.stack(path[::-1], dim=1)                              # [B, T]

    tt = torch.arange(t_max, device=dev)
    valid = tt[None, :] < nf                                           # [B, T]
    target = 2 * torch.arange(l_max, device=dev) + 1
    occ = (path[:, None, :] == target[None, :, None]) & valid[:, None, :]
    onset = torch.where(occ, tt, t_max + 1).amin(dim=-1)
    offset = torch.where(occ, tt, -1).amax(dim=-1) + 1
    return onset.to(torch.int32), offset.to(torch.int32)


def viterbi_dp(lab: torch.Tensor, sil: torch.Tensor, labels: torch.Tensor,
               num_labels: torch.Tensor, num_frames: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DP of :func:`viterbi_dp_plain`: the CUDA kernel for CUDA tensors,
    the plain version for CPU ones. Entries at positions >= num_labels[b]
    are meaningless."""
    if not lab.is_cuda:
        kernels.plain_or_raise("viterbi_dp", lab)
        return viterbi_dp_plain(lab, sil, labels, num_labels, num_frames)
    kernels.check_cuda("viterbi_dp lab", lab, torch.float32, 3)
    kernels.check_cuda("viterbi_dp sil", sil, torch.float32, 2)
    kernels.check_cuda("viterbi_dp labels", labels, torch.int32, 2)
    kernels.check_cuda("viterbi_dp num_labels", num_labels, torch.int32, 1)
    kernels.check_cuda("viterbi_dp num_frames", num_frames, torch.int32, 1)
    bdim, t_max, l_max = lab.shape
    if (sil.shape != (bdim, t_max) or labels.shape != (bdim, l_max)
            or num_labels.shape != (bdim,) or num_frames.shape != (bdim,)):
        raise ValueError("viterbi_dp: shapes do not agree")
    if t_max == 0 or l_max == 0:
        raise ValueError("viterbi_dp: needs at least one frame and one label")
    # packed 2-bit backpointers that do not fit in the kernel's shared
    # memory; 0 words when they all fit, and then it is never touched
    words = kernels.library().la_viterbi_scratch_words(bdim, t_max, l_max)
    bt = torch.empty((max(words, 1),), dtype=torch.int32, device=lab.device)
    onset = torch.empty((bdim, l_max), dtype=torch.int32, device=lab.device)
    offset = torch.empty_like(onset)
    if bdim:
        kernels.launch("la_viterbi", lab.data_ptr(), sil.data_ptr(),
                       labels.data_ptr(), num_labels.data_ptr(),
                       num_frames.data_ptr(), bt.data_ptr(), onset.data_ptr(),
                       offset.data_ptr(), bdim, t_max, l_max,
                       kernels.stream_of(lab))
    return onset, offset


# ---------------------------------------------------------------------------
# Batched forced alignment
# ---------------------------------------------------------------------------

def _dp(lab_pos, sil, labels, num_labels, num_frames):
    as_i32 = lambda x: x.to(device=lab_pos.device, dtype=torch.int32).contiguous()
    return viterbi_dp(lab_pos.contiguous(), sil.contiguous(), as_i32(labels),
                      as_i32(num_labels), as_i32(num_frames))


def viterbi_align(logits: torch.Tensor, labels: torch.Tensor,
                  num_labels: torch.Tensor, num_frames: torch.Tensor,
                  mode: str = "ce") -> Tuple[torch.Tensor, torch.Tensor]:
    """Forced alignment from materialised logits f32[B, T, C]; labels
    i32[B, L] 0-padded. Returns (onset, offset) i32[B, L] frames."""
    if mode == "ce":
        lab_lp, sil_lp = ce_emissions(logits)
    elif mode == "ctc":
        lab_lp, sil_lp = ctc_emissions(logits)
    else:
        raise ValueError(f"unknown mode: {mode}")
    idx = labels.long().to(lab_lp.device)[:, None, :].expand(-1, lab_lp.shape[1], -1)
    return _dp(torch.gather(lab_lp, 2, idx), sil_lp, labels, num_labels, num_frames)


def viterbi_align_fused(h: torch.Tensor, fc_weight: torch.Tensor,
                        fc_bias: torch.Tensor, labels: torch.Tensor,
                        num_labels: torch.Tensor, num_frames: torch.Tensor,
                        mode: str = "ce") -> Tuple[torch.Tensor, torch.Tensor]:
    """``viterbi_align`` fused with the head's fc (weight [C, F], bias [C]):
    takes the pre-fc hidden f32[B, T, F]; the class normaliser is the
    streaming row LSE and only the L label columns are materialised."""
    labels_dev = labels.long().to(h.device)
    if mode == "ce":
        lab_lp, sil_lp = ce_emissions_fused(h, fc_weight, fc_bias, labels_dev)
    elif mode == "ctc":
        lab_lp, sil_lp = ctc_emissions_fused(h, fc_weight, fc_bias, labels_dev)
    else:
        raise ValueError(f"unknown mode: {mode}")
    return _dp(lab_lp, sil_lp, labels, num_labels, num_frames)


def frames_to_seconds(onset_frames: torch.Tensor, offset_frames: torch.Tensor,
                      hop_size_second: float = HOP_SIZE_SECOND) -> torch.Tensor:
    """Stack to [B, L, 2] seconds: [onset * hop, offset * hop]."""
    return torch.stack([onset_frames * hop_size_second,
                        offset_frames * hop_size_second], dim=-1)
