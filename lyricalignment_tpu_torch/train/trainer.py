"""Multitask trainer: one update = accumulated micro-batches, global-norm
clip, AdamW.

Port of ``lyricalignment_tpu/train/trainer.py:42-258`` (the reference's
``train_multitask.py:215-342,345-458``): each step runs
``accum_grad_steps`` micro-batches of ``align_CE (+ align_CTC) +
transcript_CE`` with the multitask / transcript-only group split as
per-sample masks, accumulates the gradients in ``grad_accum_dtype``, takes
their mean, clips the global norm and applies one AdamW step with the
two-group schedule (``train/schedule.py``). PyTorch runs eagerly: the JAX
package's one jitted step and its ``lax.scan`` over micro-batches become a
Python loop, and the parameters live in the model and update in place.
Each micro-batch draws the align head's dropout from its own
``torch.Generator``, seeded from (seed, step, micro-batch index).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from lyricalignment_tpu_torch.models.align_model import AlignModel, forward_from_audio
from lyricalignment_tpu_torch.train.losses import (
    ctc_frames_needed,
    ctc_per_example,
    frame_ce_loss_grouped,
    group_mean,
    masked_ce_grouped,
)
from lyricalignment_tpu_torch.train.schedule import (
    AdamWChain,
    OptState,
    make_optimizer,
    param_group_labels,
)

LOSS_KEYS = ("total", "align_ce", "align_ctc", "trans_ce", "trans_ctc")


@dataclass(frozen=True)
class TrainConfig:
    head_lr: float = 5e-3
    backbone_lr: float = 5e-6
    weight_decay: float = 1e-5
    warmup_steps: int = 200
    total_steps: int = 2000
    max_grad_norm: float = 1.0
    accum_grad_steps: int = 8
    use_ctc: bool = False
    vocab_size: int = 21128          # BERT vocab; the silence channel sits at this index
    remat: bool = False
    seed: int = 114514
    # memory knobs: torch.bfloat16 accumulates the micro-batch gradients in
    # bf16 (they are averaged anyway) and stores Adam's first moment in bf16
    grad_accum_dtype: Optional[torch.dtype] = None   # None = float32
    adam_mu_dtype: Optional[torch.dtype] = None      # None = float32
    # the fused classifier->loss variants are not ported yet; True raises
    fused_losses: bool = False
    # as AlignModelConfig.freeze_encoder: the encoder gets no gradient, no
    # optimizer state and no update
    freeze_encoder: bool = False


@dataclass
class TrainState:
    """The model (its parameters update in place), the optimizer state and
    the number of updates taken."""

    model: AlignModel
    opt_state: OptState
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def _no_fused(tcfg: TrainConfig) -> None:
    if tcfg.fused_losses:
        raise NotImplementedError(
            "fused_losses: the fused classifier->loss variants are not ported yet")


def init_train_state(model: AlignModel, tcfg: TrainConfig) -> Tuple[TrainState, AdamWChain]:
    _no_fused(tcfg)
    labels = param_group_labels(model.named_parameters(), freeze_encoder=tcfg.freeze_encoder)
    tx = make_optimizer(labels, head_lr=tcfg.head_lr, backbone_lr=tcfg.backbone_lr,
                        weight_decay=tcfg.weight_decay, warmup_steps=tcfg.warmup_steps,
                        total_steps=tcfg.total_steps, max_grad_norm=tcfg.max_grad_norm,
                        mu_dtype=tcfg.adam_mu_dtype)
    return TrainState(model, tx.init(dict(model.named_parameters()))), tx


def to_device(batch: Dict, device) -> Dict:
    """numpy arrays (or tensors) -> tensors on ``device``, and beside
    ``ctc_labels`` the frames each CTC target needs as a host array
    (``ctc_frames_needed``, kept as it is when the batch has it already):
    the CTC loss picks the targets that cannot fit from it without waiting
    on the device."""
    out = {k: v if k == "ctc_frames_needed" else torch.as_tensor(v).to(device)
           for k, v in batch.items()}
    if "ctc_labels" in batch and "ctc_frames_needed" not in batch:
        out["ctc_frames_needed"] = ctc_frames_needed(
            torch.as_tensor(batch["ctc_labels"]).cpu().numpy())
    return out


def multitask_losses(model: AlignModel, tcfg: TrainConfig, batch: Dict,
                     generator: Optional[torch.Generator]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss composition of the reference's ``train_step`` body
    (`train_multitask.py:250-325`) on one batch of tensors on the model's
    device, as ``to_device`` gives it. ``generator`` draws the head's
    dropout (None: no dropout)."""
    _no_fused(tcfg)
    mcfg = model.cfg
    align_out, trans_logits = forward_from_audio(
        model, batch["audio"],
        y_in=batch["decoder_input"] if mcfg.train_transcript else None,
        trim_to_input_length=False, generator=generator, remat=tcfg.remat,
        align_head_output="logits")

    align_mask = batch["has_alignment"].bool()
    trans_mask = ~align_mask
    zero = torch.zeros((), dtype=torch.float32, device=batch["audio"].device)
    align_ce = align_ctc = trans_ce = trans_ctc = zero
    if mcfg.train_alignment:
        align_ce = frame_ce_loss_grouped(align_out, batch["frame_labels"], align_mask,
                                         with_silence_head=tcfg.use_ctc,
                                         vocab_size=tcfg.vocab_size)
        if tcfg.use_ctc:
            per_example = ctc_per_example(align_out[:, :, : tcfg.vocab_size],
                                          batch["ctc_labels"], batch["ctc_frames_needed"])
            align_ctc = group_mean(per_example, align_mask)
            # the reference also applies CTC to transcript-only samples
            # (`train_multitask.py:312-315`)
            trans_ctc = group_mean(per_example, trans_mask)
    if trans_logits is not None:
        # two group means, summed: the reference's separate multitask and
        # transcript F.cross_entropy calls (`:285,308`)
        trans_ce = (masked_ce_grouped(trans_logits, batch["decoder_output"], align_mask)
                    + masked_ce_grouped(trans_logits, batch["decoder_output"], trans_mask))

    total = align_ce + align_ctc + trans_ce + trans_ctc
    return total, dict(zip(LOSS_KEYS, (total, align_ce, align_ctc, trans_ce, trans_ctc)))


def micro_seed(seed: int, step: int, index: int) -> int:
    """Dropout seed of micro-batch ``index`` of update ``step``."""
    return int(np.random.SeedSequence([seed, step, index]).generate_state(1)[0])


def make_train_step(tcfg: TrainConfig, tx: AdamWChain) -> Callable:
    """The update. ``stacked`` leaves are [accum, B, ...] (numpy or
    tensors); returns (state, mean losses over the micro-batches as 0-d
    tensors)."""
    accum = tcfg.accum_grad_steps
    acc_dtype = tcfg.grad_accum_dtype
    explicit = acc_dtype not in (None, torch.float32)

    def train_step(state: TrainState, stacked: Dict, seed: int = tcfg.seed):
        model = state.model
        params = state.params()
        device = next(model.parameters()).device
        for p in params.values():
            p.grad = None
        acc: Dict[str, torch.Tensor] = {}
        sums = {k: torch.zeros((), device=device) for k in LOSS_KEYS}
        for i in range(accum):
            micro = to_device({k: v[i] for k, v in stacked.items()}, device)
            gen = torch.Generator(device=device).manual_seed(micro_seed(seed, state.step, i))
            total, losses = multitask_losses(model, tcfg, micro, gen)
            total.backward()
            if explicit:
                # a + g.astype(acc_dtype), as the JAX scan accumulates
                for name, p in params.items():
                    if p.grad is not None:
                        g = p.grad.to(acc_dtype)
                        acc[name] = acc[name].add_(g) if name in acc else g
                        p.grad = None
            for k in LOSS_KEYS:
                sums[k] += losses[k].detach()
        if explicit:
            grads = {n: (acc[n] / accum).float() if n in acc else None for n in params}
        else:
            grads = {n: None if p.grad is None else p.grad / accum for n, p in params.items()}
        for p in params.values():
            p.grad = None
        state.opt_state = tx.update(params, grads, state.opt_state)
        state.step += 1
        return state, {k: v / accum for k, v in sums.items()}

    return train_step


def make_eval_step(tcfg: TrainConfig) -> Callable:
    """Losses of one batch without dropout and without gradients."""

    @torch.no_grad()
    def eval_step(model: AlignModel, batch: Dict) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        return multitask_losses(model, tcfg, to_device(batch, device), generator=None)[1]

    return eval_step


def evaluate(eval_step: Callable, model: AlignModel, batches: Iterable) -> Dict[str, float]:
    """Average eval losses over a loader (reference ``evaluate``,
    `train_multitask.py:345-458`)."""
    sums: Dict[str, float] = {}
    n = 0
    for batch in batches:
        for k, v in eval_step(model, batch.device_arrays()).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def stack_microbatches(batches) -> Dict[str, np.ndarray]:
    """accum list of MultitaskBatch -> leaves [accum, B, ...]."""
    arrays = [b.device_arrays() for b in batches]
    return {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}
