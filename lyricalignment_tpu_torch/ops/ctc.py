"""Reduced CTC: the alpha recursion of the fused CTC loss over blank's and
the target's own label positions' log-probs, with its gradient.

Port of ``lyricalignment_tpu/train/losses.py:_ctc_nll_single`` (a
``lax.scan`` under ``jax.vmap``, differentiated by autodiff). Two kernels
carry it on the card (``csrc/ctc.cu``): ``la_ctc_reduced_fwd`` (the
per-sample NLL, keeping every frame's alphas) and ``la_ctc_reduced_bwd``
(the reverse of the recursion). :func:`ctc_reduced_fwd_plain` and
:func:`ctc_reduced_bwd_plain` are the same two recursions vectorised over
batch and states with a loop over frames; the CPU takes them.

``F.ctc_loss`` is no substitute: its gradient assumes log-probs that came out
of a log-softmax over their columns, and the reduced emissions (a gathered
logit minus the full-vocabulary normaliser) are not normalised over the
N + 1 columns kept. The recursion keeps the JAX function's sentinel
arithmetic, so a target that cannot fit its frames gets an NLL of about 1e30
and the gradient ``jax.grad`` gives it.
"""

from __future__ import annotations

import torch

from lyricalignment_tpu_torch import kernels

CTC_NEG = -1.0e30   # _CTC_NEG: log of a state that cannot be reached


def _states(labels: torch.Tensor, valid: torch.Tensor):
    """(is_label [S], label position [S], can_skip [B, S], emission-valid
    [B, S]) of S = 2N + 1 interleaved states."""
    n = labels.shape[1]
    state = torch.arange(2 * n + 1, device=labels.device)
    is_lab = state % 2 == 1
    pos = (state // 2).clamp(0, n - 1)
    prev = (pos - 1).clamp(0, n - 1)
    can_skip = is_lab & (state >= 3) & (labels[:, pos] != labels[:, prev])
    live = ~is_lab | valid[:, pos]
    return is_lab, pos, can_skip, live


def _shift(v: torch.Tensor, k: int) -> torch.Tensor:
    """v shifted right by k states along the last axis, CTC_NEG in front."""
    return torch.cat([torch.full_like(v[..., :k], CTC_NEG), v[..., :-k]], dim=-1)


def _lse3_parts(alpha: torch.Tensor, can_skip: torch.Tensor):
    """The three inputs of each state's _lse3 and their max."""
    a0, a1 = alpha, _shift(alpha, 1)
    a2 = torch.where(can_skip, _shift(alpha, 2), torch.full_like(alpha, CTC_NEG))
    return a0, a1, a2, torch.maximum(torch.maximum(a0, a1), a2)


def _end_states(alpha_last: torch.Tensor, valid: torch.Tensor):
    """(end label value, end blank value, tlen, end label index, end blank
    index) of the last frame's alphas [B, S]."""
    tlen = valid.sum(dim=1)
    i_lab = (2 * tlen - 1).clamp(min=0)
    i_blank = 2 * tlen
    end_lab = torch.where(tlen > 0, alpha_last.gather(1, i_lab[:, None])[:, 0],
                          torch.full_like(alpha_last[:, 0], CTC_NEG))
    end_blank = alpha_last.gather(1, i_blank[:, None])[:, 0]
    return end_lab, end_blank, tlen, i_lab, i_blank


def ctc_reduced_fwd_plain(blank_lp: torch.Tensor, label_lp: torch.Tensor,
                          labels: torch.Tensor, valid: torch.Tensor):
    """Plain forward: blank_lp [B, T], label_lp [B, T, N], labels int[B, N]
    (padding positions hold any id), valid bool[B, N] -> (nll [B], alphas
    [B, T, 2N + 1])."""
    is_lab, pos, can_skip, live = _states(labels, valid)
    em = torch.where(is_lab, label_lp[:, :, pos], blank_lp[:, :, None])
    em = torch.where(live[:, None, :], em, torch.full_like(em, CTC_NEG))
    alpha = torch.full_like(em[:, 0], CTC_NEG)
    alpha[:, :2] = em[:, 0, :2]
    alphas = [alpha]
    for t in range(1, em.shape[1]):
        a0, a1, a2, m = _lse3_parts(alpha, can_skip)
        alpha = em[:, t] + (m + torch.log(torch.exp(a0 - m) + torch.exp(a1 - m)
                                          + torch.exp(a2 - m)))
        alphas.append(alpha)
    end_lab, end_blank, _, _, _ = _end_states(alpha, valid)
    m = torch.maximum(end_lab, end_blank)
    nll = -(m + torch.log(torch.exp(end_lab - m) + torch.exp(end_blank - m)))
    return nll, torch.stack(alphas, dim=1)


def ctc_reduced_bwd_plain(alphas: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                          g: torch.Tensor):
    """Plain backward, the reverse of the forward recursion: the adjoint of
    alpha_t flows to alpha_{t-1} through each _lse3's weights exp(a - m) /
    sum; the emission at (t, s) takes the adjoint of alpha_t[s]. alphas
    [B, T, S] of the forward, g [B] (the gradient of the NLL) ->
    (d blank_lp [B, T], d label_lp [B, T, N])."""
    bdim, t_max, s_dim = alphas.shape
    n = labels.shape[1]
    is_lab, _, can_skip, live = _states(labels, valid)
    end_lab, end_blank, tlen, i_lab, i_blank = _end_states(alphas[:, -1], valid)
    m = torch.maximum(end_lab, end_blank)
    e_lab, e_blank = torch.exp(end_lab - m), torch.exp(end_blank - m)
    gs = g / (e_lab + e_blank)
    adj = torch.zeros_like(alphas[:, -1])
    adj.scatter_(1, i_blank[:, None], (-gs * e_blank)[:, None])
    lab_adj = torch.where(tlen > 0, -gs * e_lab, torch.zeros_like(gs))
    adj = adj.scatter_add(1, i_lab[:, None], lab_adj[:, None])
    zero1, zero2 = torch.zeros_like(adj[:, :1]), torch.zeros_like(adj[:, :2])
    has_next = torch.arange(s_dim, device=adj.device) < s_dim - 1
    skip_next = torch.cat([can_skip[:, 2:], torch.zeros_like(can_skip[:, :2])], dim=1)
    d_em = torch.zeros_like(alphas)
    for t in range(t_max - 1, 0, -1):
        d_em[:, t] = adj
        a = alphas[:, t - 1]
        a0, a1, a2, mx = _lse3_parts(a, can_skip)
        coef = adj / (torch.exp(a0 - mx) + torch.exp(a1 - mx) + torch.exp(a2 - mx))
        # state s feeds states s (stay), s + 1 and, where it may skip, s + 2
        coef1, mx1 = torch.cat([coef[:, 1:], zero1], 1), torch.cat([mx[:, 1:], zero1], 1)
        coef2, mx2 = torch.cat([coef[:, 2:], zero2], 1), torch.cat([mx[:, 2:], zero2], 1)
        zero = torch.zeros_like(a)
        adj = (coef * torch.exp(a - mx)
               + torch.where(has_next, coef1 * torch.exp(a - mx1), zero)
               + torch.where(skip_next, coef2 * torch.exp(a - mx2), zero))
    d_em[:, 0, :2] = adj[:, :2]
    d_em = torch.where(live[:, None, :], d_em, torch.zeros_like(d_em))
    d_blank = d_em[:, :, ~is_lab].sum(dim=-1)
    d_label = d_em[:, :, 1::2][:, :, :n]
    return d_blank, d_label


def _check(labels, valid, bdim, t_max, n):
    kernels.check_cuda("ctc_reduced labels", labels, torch.int32, 2)
    kernels.check_cuda("ctc_reduced valid", valid, torch.bool, 2)
    if labels.shape != (bdim, n) or valid.shape != (bdim, n):
        raise ValueError("ctc_reduced: shapes do not agree")
    if t_max == 0 or n == 0 or n > kernels.library().la_ctc_max_labels():
        raise ValueError(f"ctc_reduced: needs T >= 1 and 1 <= N <= "
                         f"{kernels.library().la_ctc_max_labels()}")


def ctc_reduced_fwd(blank_lp, label_lp, labels, valid):
    """(nll [B], alphas [B, T, S]): the kernel ``la_ctc_reduced_fwd`` for
    CUDA tensors, :func:`ctc_reduced_fwd_plain` for CPU ones."""
    if not blank_lp.is_cuda:
        kernels.plain_or_raise("ctc_reduced", blank_lp)
        return ctc_reduced_fwd_plain(blank_lp, label_lp, labels, valid)
    kernels.check_cuda("ctc_reduced blank_lp", blank_lp, torch.float32, 2)
    kernels.check_cuda("ctc_reduced label_lp", label_lp, torch.float32, 3)
    bdim, t_max, n = label_lp.shape
    if blank_lp.shape != (bdim, t_max):
        raise ValueError("ctc_reduced: shapes do not agree")
    _check(labels, valid, bdim, t_max, n)
    nll = torch.empty((bdim,), dtype=torch.float32, device=blank_lp.device)
    alphas = torch.empty((bdim, t_max, 2 * n + 1), dtype=torch.float32, device=blank_lp.device)
    if bdim:
        kernels.launch("la_ctc_reduced_fwd", blank_lp.data_ptr(), label_lp.data_ptr(),
                       labels.data_ptr(), valid.data_ptr(), alphas.data_ptr(), nll.data_ptr(),
                       bdim, t_max, n, kernels.stream_of(blank_lp))
    return nll, alphas


def ctc_reduced_bwd(alphas, labels, valid, g):
    """(d blank_lp, d label_lp): the kernel ``la_ctc_reduced_bwd`` for CUDA
    tensors, :func:`ctc_reduced_bwd_plain` for CPU ones."""
    if not alphas.is_cuda:
        kernels.plain_or_raise("ctc_reduced", alphas)
        return ctc_reduced_bwd_plain(alphas, labels, valid, g)
    bdim, t_max, s_dim = alphas.shape
    n = labels.shape[1]
    kernels.check_cuda("ctc_reduced alphas", alphas, torch.float32, 3)
    kernels.check_cuda("ctc_reduced g", g, torch.float32, 1)
    _check(labels, valid, bdim, t_max, n)
    if s_dim != 2 * n + 1 or g.shape != (bdim,):
        raise ValueError("ctc_reduced_bwd: shapes do not agree")
    d_blank = torch.empty((bdim, t_max), dtype=torch.float32, device=alphas.device)
    d_label = torch.empty((bdim, t_max, n), dtype=torch.float32, device=alphas.device)
    scratch = torch.empty_like(alphas)
    if bdim:
        kernels.launch("la_ctc_reduced_bwd", alphas.data_ptr(), labels.data_ptr(),
                       valid.data_ptr(), g.data_ptr(), scratch.data_ptr(), d_blank.data_ptr(),
                       d_label.data_ptr(), bdim, t_max, n, kernels.stream_of(alphas))
    return d_blank, d_label


class _CTCReduced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank_lp, label_lp, labels, valid):
        nll, alphas = ctc_reduced_fwd(blank_lp, label_lp, labels, valid)
        ctx.save_for_backward(alphas, labels, valid)
        return nll

    @staticmethod
    def backward(ctx, g):
        alphas, labels, valid = ctx.saved_tensors
        d_blank, d_label = ctc_reduced_bwd(alphas, labels, valid, g.contiguous())
        return d_blank, d_label, None, None


def ctc_reduced_nll(blank_lp: torch.Tensor, label_lp: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Per-sample CTC NLL over the full input length from reduced emissions:
    blank_lp f32[B, T], label_lp f32[B, T, N] (the log-prob of label
    position n of the sample at each frame), labels int32[B, N] (any id at
    padding positions), valid bool[B, N] -> f32[B]; differentiable in
    blank_lp and label_lp."""
    return _CTCReduced.apply(blank_lp.contiguous(), label_lp.contiguous(),
                             labels.to(torch.int32).contiguous(), valid.contiguous())
