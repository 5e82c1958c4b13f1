"""Multitask losses: frame CE (+ sigmoid silence head), CTC, transcript CE.

Port of ``lyricalignment_tpu/train/losses.py:23-135,295-310``, with the
reference's semantics:

* ``frame_ce_loss``      ≙ ``compute_ce_loss`` (`train_multitask.py:587-614`)
* ``ctc_loss``           ≙ ``compute_ctc_loss`` (`train_multitask.py:616-633`,
  ``F.ctc_loss`` with mean-over-target-length reduction; a target that
  cannot fit its frames takes ``optax.ctc_loss``'s epsilon recursion, as the
  JAX package does)
* ``transcript_ce_loss`` ≙ ``F.cross_entropy(..., ignore_index=-100)``
  (`train_multitask.py:285,308`)

The reference splits each batch into a "multitask" and a "transcript-only"
sub-batch and takes each loss as a mean within its sub-batch
(`train_multitask.py:188-211,250-319`). With fixed shapes the split is a
per-sample mask: each ``*_grouped`` function reproduces one group mean, and
an empty group contributes 0.

Under data parallelism each rank holds some rows of the micro-batch, and a
group mean is a ratio of sums over the whole micro-batch: the ``group``
argument (the data process group) makes each rank divide its own sum by
the *global* count, all-reduced over the group, so that the ranks' losses
(and gradients) sum to the unsharded ones. A rank's local mean averaged
over ranks would differ whenever the groups split unevenly.

The fused classifier->loss variants (`losses.py:138-292`) take the head's
pre-classifier hidden and its fc instead of the [B, T, C] logits: the class
normaliser is the streaming row LSE (``ops.viterbi.row_lse``, with its
backward kernels), only the label columns are gathered, and the CTC alpha
recursion runs on the reduced [T, blank + N] emissions
(``ops.ctc.ctc_reduced_nll``), with the JAX function's sentinel arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lyricalignment_tpu_torch.ops.ctc import ctc_reduced_nll
from lyricalignment_tpu_torch.ops.viterbi import class_lse, gather_label_logits

IGNORE_ID = -100
# optax.ctc_loss's stand-in for log(0)
LOG_EPSILON = -1.0e5


def _group_mean(total: torch.Tensor, count: torch.Tensor, group=None) -> torch.Tensor:
    """total / count, or 0 for an empty group; ``group``: count summed over
    the data group first (see the module docstring)."""
    if group is not None:
        count = count.clone()
        dist.all_reduce(count, group=group)
    return torch.where(count > 0, total / count.clamp(min=1), torch.zeros_like(total))


def _reconcile_label_length(frame_labels: torch.Tensor, t: int) -> torch.Tensor:
    """Truncate or right-pad labels with -100 to the logit length
    (reference `train_multitask.py:595-601`)."""
    cur = frame_labels.shape[1]
    if cur > t:
        return frame_labels[:, :t]
    if cur < t:
        return F.pad(frame_labels, (0, t - cur), value=IGNORE_ID)
    return frame_labels


def masked_ce_grouped(logits: torch.Tensor, labels: torch.Tensor,
                      sample_mask: torch.Tensor, group=None) -> torch.Tensor:
    """CE mean over valid positions (label != -100) of the selected samples
    (= sub-batch ``F.cross_entropy`` with ignore_index). logits f32[B, ...,
    C], labels int[B, ...], sample_mask bool[B]."""
    mask = sample_mask.reshape((-1,) + (1,) * (labels.dim() - 1))
    valid = (labels != IGNORE_ID) & mask
    safe = torch.where(labels == IGNORE_ID, torch.zeros_like(labels), labels).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    return _group_mean(total, valid.sum(), group)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions where label != -100."""
    all_samples = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
    return masked_ce_grouped(logits, labels, all_samples)


def frame_ce_loss_grouped(logits: torch.Tensor, frame_labels: torch.Tensor,
                          sample_mask: torch.Tensor, with_silence_head: bool = False,
                          vocab_size: int = 21128, group=None) -> torch.Tensor:
    """Frame-wise alignment CE of the selected samples.

    Plain mode: CE over all classes incl. silence = class 0, ignoring -100.
    Silence-head mode (the reference's ``compute_sil=True``, used with CTC):
    labels shift down by one, word CE runs over channels [1, vocab_size)
    only, and channel ``vocab_size`` is a sigmoid silence detector trained
    with BCE against (label == -100) on every frame of the selected samples.
    """
    frame_labels = _reconcile_label_length(frame_labels, logits.shape[1])
    if not with_silence_head:
        return masked_ce_grouped(logits, frame_labels, sample_mask, group)

    valid = frame_labels != IGNORE_ID
    shifted = torch.where(valid, frame_labels - 1, torch.full_like(frame_labels, IGNORE_ID))
    word_loss = masked_ce_grouped(logits[:, :, 1:vocab_size], shifted, sample_mask, group)

    silence_label = (~valid).float()
    sil_logit = logits[:, :, vocab_size].float()
    per_elem = F.binary_cross_entropy_with_logits(sil_logit, silence_label, reduction="none")
    m = sample_mask[:, None]
    count = sample_mask.sum() * sil_logit.shape[1]
    sil_loss = _group_mean(torch.where(m, per_elem, torch.zeros_like(per_elem)).sum(), count,
                           group)
    return word_loss + sil_loss


def frame_ce_loss(logits: torch.Tensor, frame_labels: torch.Tensor,
                  with_silence_head: bool = False, vocab_size: int = 21128) -> torch.Tensor:
    all_samples = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
    return frame_ce_loss_grouped(logits, frame_labels, all_samples,
                                 with_silence_head=with_silence_head, vocab_size=vocab_size)


def ctc_frames_needed(labels: np.ndarray) -> np.ndarray:
    """Frames each CTC target needs: its labels plus one blank between each
    repeated pair. labels int[..., N], -100 padded (host numpy) -> int[...]."""
    labels = np.asarray(labels)
    valid = labels != IGNORE_ID
    safe = np.where(valid, labels, 0)
    repeats = ((safe[..., 1:] == safe[..., :-1]) & valid[..., 1:]).sum(axis=-1)
    return valid.sum(axis=-1) + repeats


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with ``jnp.logaddexp``'s gradient, taken against
    the rounded output (g exp(a - out), g exp(b - out)) rather than from the
    inputs. At optax's -1e5 scale float32 rounds the output by up to 4e-3,
    which moves the gradient by ~5e-4 (``test_ctc_infeasible_target``); this
    follows the JAX package's."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _ctc_nll_epsilon(log_probs: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Per-sample NLL of ``optax.ctc_loss_with_forward_probs`` (no logit
    padding): the blank (phi) and label (emit) alphas over N + 1 and N
    states, in which ``LOG_EPSILON`` stands for the log of an impossible
    transition. A target with no path gets -LOG_EPSILON plus the cost of its
    best path through one such transition, and that path's gradient.
    log_probs f32[b, T, K] (log-softmax, blank 0), labels int64[b, N] padded
    with 0, valid bool[b, N] -> f32[b]."""
    b, t, _ = log_probs.shape
    n = labels.shape[1]
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))   # [b, N]
    lp_phi = log_probs[:, :, :1]                                        # [b, T, 1]
    lp_emit = torch.gather(log_probs, 2, labels[:, None, :].expand(b, t, n))
    phi = F.pad(torch.full((b, n), LOG_EPSILON, device=log_probs.device), (1, 0))
    emit = torch.full((b, n), LOG_EPSILON, device=log_probs.device)

    def add_to_phi(phi_, added):  # phi[:, 1:] += added, in log space
        return torch.cat([phi_[:, :1], _LogAddExp.apply(phi_[:, 1:], added)], dim=1)

    for i in range(t):
        # emit -> phi epsilon transition, except where the next label repeats
        phi = add_to_phi(phi, emit + LOG_EPSILON * repeat)
        next_emit = _LogAddExp.apply(phi[:, :-1] + lp_emit[:, i], emit + lp_emit[:, i])
        # self loop; emit -> phi blank transition only where the next label repeats
        phi = add_to_phi(phi + lp_phi[:, i], emit + lp_phi[:, i] + LOG_EPSILON * (1.0 - repeat))
        emit = next_emit
    phi = add_to_phi(phi, emit)  # the last epsilon transition
    return -phi.gather(1, valid.sum(dim=1, keepdim=True))[:, 0]


def ctc_per_example(logits: torch.Tensor, labels: torch.Tensor,
                    frames_needed: np.ndarray) -> torch.Tensor:
    """Each sample's CTC NLL over its full input length, divided by its
    target length (at least 1), as torch's mean reduction weighs it.
    logits f32[B, T, K] (blank at channel 0), labels int[B, N] left-packed
    and -100 padded, frames_needed int[B] on the host
    (:func:`ctc_frames_needed` of the labels, as ``trainer.to_device`` keeps
    it) -> f32[B].

    A target that cannot fit in T frames has no path: ``F.ctc_loss`` would
    give ``inf``. Such samples take ``optax.ctc_loss``'s recursion instead
    (:func:`_ctc_nll_epsilon`), as the JAX package computes every sample.
    ``frames_needed`` picks them on the host, so a batch in which every
    target fits costs no launch and no wait for the device beyond
    ``F.ctc_loss``."""
    b, t, _ = logits.shape
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != IGNORE_ID
    target_len = valid.sum(dim=1)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    input_len = torch.full((b,), t, dtype=torch.long, device=logits.device)
    per_example = F.ctc_loss(log_probs.transpose(0, 1), safe, input_len, target_len,
                             blank=0, reduction="none", zero_infinity=True)
    infeasible = np.flatnonzero(np.asarray(frames_needed) > t)
    if infeasible.size:
        rows = torch.from_numpy(infeasible).to(logits.device)
        per_example = per_example.index_put(
            (rows,), _ctc_nll_epsilon(log_probs[rows], safe[rows], valid[rows]))
    return per_example / target_len.clamp(min=1)


def group_mean(per_example: torch.Tensor, sample_mask: torch.Tensor,
               group=None) -> torch.Tensor:
    """Mean of the selected samples' values, 0 for an empty group."""
    total = torch.where(sample_mask, per_example, torch.zeros_like(per_example)).sum()
    return _group_mean(total, sample_mask.sum(), group)


def ctc_loss_grouped(logits: torch.Tensor, labels: torch.Tensor, sample_mask: torch.Tensor,
                     frames_needed: np.ndarray) -> torch.Tensor:
    """CTC of the selected samples with torch mean semantics: the group's
    mean of :func:`ctc_per_example`."""
    return group_mean(ctc_per_example(logits, labels, frames_needed), sample_mask)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             frames_needed: np.ndarray) -> torch.Tensor:
    all_samples = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
    return ctc_loss_grouped(logits, labels, all_samples, frames_needed)


# ---------------------------------------------------------------------------
# Fused classifier->loss: the hidden and the fc instead of the logits
# ---------------------------------------------------------------------------

def _frame_logits(h: torch.Tensor, fc: nn.Linear, cols: torch.Tensor) -> torch.Tensor:
    """The logit of one fc column a frame (cols int[B, T]) from gathered
    weight rows -> [B, T]."""
    return (h * fc.weight[cols]).sum(dim=-1) + fc.bias[cols]


def frame_ce_loss_grouped_fused(h: torch.Tensor, fc: nn.Linear, frame_labels: torch.Tensor,
                                sample_mask: torch.Tensor, with_silence_head: bool = False,
                                vocab_size: int = 21128, group=None) -> torch.Tensor:
    """``frame_ce_loss_grouped(fc(h), ...)`` without the logits. h f32[B, T,
    F] (the head's pre-classifier hidden), fc the head's Linear [C, F]."""
    h = h.contiguous()
    frame_labels = _reconcile_label_length(frame_labels, h.shape[1])
    valid = frame_labels != IGNORE_ID
    w, b = fc.weight, fc.bias
    if not with_silence_head:
        safe = torch.where(valid, frame_labels, torch.zeros_like(frame_labels)).long()
        lse = class_lse(h, w, b)
    else:
        # word CE over channels [1, vocab): a label's column is the label
        # (the unfused path slices [:, :, 1:vocab] and indexes label - 1)
        safe = torch.where(valid, frame_labels, torch.ones_like(frame_labels))
        safe = safe.clamp(1, vocab_size - 1).long()
        lse = class_lse(h, w[1:vocab_size], b[1:vocab_size])
    nll = lse - _frame_logits(h, fc, safe)
    m = valid & sample_mask[:, None]
    word_loss = _group_mean(torch.where(m, nll, torch.zeros_like(nll)).sum(), m.sum(), group)
    if not with_silence_head:
        return word_loss

    silence_label = (~valid).float()
    sil_logit = h @ w[vocab_size] + b[vocab_size]
    per_elem = F.binary_cross_entropy_with_logits(sil_logit, silence_label, reduction="none")
    sm = sample_mask[:, None]
    count = sample_mask.sum() * sil_logit.shape[1]
    sil_loss = _group_mean(torch.where(sm, per_elem, torch.zeros_like(per_elem)).sum(), count,
                           group)
    return word_loss + sil_loss


def ctc_per_example_fused(h: torch.Tensor, fc: nn.Linear, labels: torch.Tensor,
                          vocab_size: int = 21128) -> torch.Tensor:
    """Each sample's CTC NLL divided by its target length (at least 1), from
    the hidden: log-probs are the gathered column logits minus the row LSE
    over the vocabulary's columns, and the alpha recursion runs on the
    reduced emissions (blank and the N label positions). h f32[B, T, F],
    labels int[B, N] left-packed and -100 padded -> f32[B]. A target that
    cannot fit its frames gets about 1e30 / its length, as the JAX fused
    loss gives it (the unfused loss gives ~1e5 there)."""
    h = h.contiguous()
    valid = labels != IGNORE_ID
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    w, b = fc.weight, fc.bias
    lse = class_lse(h, w[:vocab_size], b[:vocab_size])
    blank_lp = (h @ w[0] + b[0]) - lse
    label_lp = gather_label_logits(h, w, b, safe) - lse[..., None]
    nll = ctc_reduced_nll(blank_lp, label_lp, safe, valid)
    return nll / valid.sum(dim=1).clamp(min=1)


def ctc_loss_grouped_fused(h: torch.Tensor, fc: nn.Linear, labels: torch.Tensor,
                           sample_mask: torch.Tensor, vocab_size: int = 21128) -> torch.Tensor:
    """``ctc_loss_grouped(fc(h)[..., :vocab_size], ...)`` without the
    logits: the group's mean of :func:`ctc_per_example_fused`."""
    return group_mean(ctc_per_example_fused(h, fc, labels, vocab_size), sample_mask)


def transcript_ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder CE, ignore_index=-100."""
    return masked_ce(logits, targets)
