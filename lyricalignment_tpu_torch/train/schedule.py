"""Optimizer and learning-rate schedule.

Port of ``lyricalignment_tpu/train/schedule.py``: the reference's AdamW with
two parameter groups — the alignment head at ``head_lr`` (default 5e-3) and
the Whisper backbone at ``backbone_lr`` (default 5e-6) — weight decay 1e-5,
global-norm gradient clipping at 1.0 across all parameters before the step,
and HF's ``get_linear_schedule_with_warmup`` (`train_multitask.py:683-690,
337`). The JAX package builds it as the optax chain
``clip_by_global_norm -> multi_transform({head: adamw, backbone: adamw,
frozen: set_to_zero})``; :class:`AdamWChain` reproduces that chain step for
step on tensors, where ``torch.optim.AdamW`` + ``clip_grad_norm_`` +
``LambdaLR`` would differ:

* the clip multiplies by ``max_norm / ||g||`` only when ``||g|| >= max_norm``
  (optax: ``g / ||g|| * max_norm``), with no ``+1e-6``;
* the schedule is read at the 0-based update count, so the first update
  during warmup has learning rate 0;
* Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected
  moments; the first moment is stored in ``mu_dtype`` but the update uses
  it before that rounding, as optax does;
* weight decay is decoupled (``lr * wd * p``) and applies to every
  parameter of a trained group, whether or not it received a gradient (a
  missing gradient counts as zero, as JAX differentiates every leaf);
* the frozen group holds no state and gets no update.

The arithmetic runs in float32 with ``torch._foreach_*`` ops, one list per
group. Under tensor parallelism (``parallel.mesh``) each rank updates its
own shard; the clip's norm is the full gradient's: the sharded parameters'
squared sums are all-reduced over the model group and the replicated ones
(LayerNorms, row-parallel biases, the GRU head) counted once. Under
pipeline parallelism each rank updates its stage's blocks and the
replicated rest, and the stage-owned parameters count as sharded: each is
whole on one rank of the group.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

B1, B2, EPS = 0.9, 0.999, 1e-8


def linear_warmup_decay(base_lr: float, warmup_steps: int, total_steps: int):
    """HF ``get_linear_schedule_with_warmup`` as a function of the update
    count, in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        warm = step / f32(max(1.0, warmup_steps))
        decay = (f32(total_steps) - step) / f32(max(1.0, total_steps - warmup_steps))
        frac = warm if step < warmup_steps else decay
        return float(f32(base_lr) * max(f32(0.0), frac))

    return schedule


def param_group_labels(named_params, freeze_encoder: bool = False) -> Dict[str, str]:
    """Parameter name -> "head" (``align_rnn.*``), "backbone"
    (``whisper_model.*``) or, with ``freeze_encoder``, "frozen" for
    ``whisper_model.encoder.*`` — the reference's two AdamW groups, and
    torch AdamW's skipping of parameters that never receive a gradient."""
    labels = {}
    for name, _ in named_params:
        if name.startswith("align_rnn."):
            labels[name] = "head"
        elif freeze_encoder and name.startswith("whisper_model.encoder."):
            labels[name] = "frozen"
        else:
            labels[name] = "backbone"
    return labels


@dataclass
class OptState:
    """Adam moments of the trained parameters (by name) and the update
    count (optax's ``count``, shared by the moments and the schedule)."""

    count: int = 0
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @classmethod
    def from_state_dict(cls, d: Dict, device=None) -> "OptState":
        # a pipelined model's other stages keep their moments on ``meta``
        to = lambda m: {k: v if v.is_meta else v.to(device) for k, v in m.items()}
        return cls(count=int(d["count"]), mu=to(d["mu"]), nu=to(d["nu"]))


class AdamWChain:
    """clip_by_global_norm -> per-group AdamW with a linear warmup/decay
    schedule -> frozen group untouched."""

    def __init__(self, labels: Dict[str, str], lrs: Dict[str, float],
                 weight_decay: float = 1e-5, warmup_steps: int = 200,
                 total_steps: int = 2000, max_grad_norm: float = 1.0,
                 mu_dtype: Optional[torch.dtype] = None, norm_group=None,
                 sharded: Iterable[str] = ()):
        self.labels = labels
        self.schedules = {g: linear_warmup_decay(lr, warmup_steps, total_steps)
                          for g, lr in lrs.items()}
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.mu_dtype = mu_dtype
        # tensor or pipeline parallelism: the model group and the names of
        # the parameters sharded (or stage-owned) over it
        self.norm_group = norm_group
        self.sharded = frozenset(sharded)

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        state = OptState()
        for name, p in params.items():
            if self.labels[name] != "frozen":
                state.mu[name] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                state.nu[name] = torch.zeros_like(p)
        return state

    def global_norm(self, grads: Dict[str, Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
        """sqrt of the sum of squares of every gradient (None: no gradient),
        of the full gradient under tensor parallelism."""
        present = {n: g for n, g in grads.items() if g is not None}
        if not present:
            return None
        if self.norm_group is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(present.values()))))
        squares = []
        for shard in (True, False):
            gs = [g for n, g in present.items() if (n in self.sharded) == shard]
            sq = (torch.stack(torch._foreach_norm(gs)).square().sum() if gs
                  else torch.zeros((), device=next(iter(present.values())).device))
            if shard:
                dist.all_reduce(sq, group=self.norm_group)
            squares.append(sq)
        return torch.sqrt(squares[0] + squares[1])

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, Optional[torch.Tensor]], state: OptState) -> OptState:
        """Apply one update to ``params`` in place (float32 parameters and
        gradients); returns the state, its moments updated in place."""
        norm = self.global_norm(grads)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(count))
        bc2 = float(f32(1) - f32(B2) ** f32(count))
        for group, schedule in self.schedules.items():
            names = [n for n in params if self.labels[n] == group]
            if not names:
                continue
            lr = schedule(state.count)
            p = [params[n] for n in names]
            g = [grads[n] if grads.get(n) is not None else torch.zeros_like(params[n])
                 for n in names]
            if norm is not None:
                # optax: select(||g|| < max_norm, g, g / ||g|| * max_norm),
                # decided on the device (no host sync)
                keep = norm < self.max_grad_norm
                g = [torch.where(keep, x, x / norm * self.max_grad_norm) for x in g]
            mu_old = [state.mu[n] for n in names]
            nu = [state.nu[n] for n in names]
            # mu = (1 - b1) g + b1 mu, with b1 mu in the stored dtype and b1
            # rounded to it, as JAX multiplies a bf16 array by a Python float
            b1 = float(torch.tensor(B1, dtype=mu_old[0].dtype))
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                                    torch._foreach_mul(mu_old, b1))
            torch._foreach_mul_(nu, B2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2))
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, EPS)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(p, upd)
            for n, m_new, m_old in zip(names, mu, mu_old):
                m_old.copy_(m_new)  # rounds to mu_dtype
        state.count = count
        return state


def make_optimizer(labels: Dict[str, str], head_lr: float = 5e-3,
                   backbone_lr: float = 5e-6, weight_decay: float = 1e-5,
                   warmup_steps: int = 200, total_steps: int = 2000,
                   max_grad_norm: float = 1.0,
                   mu_dtype: Optional[torch.dtype] = None, norm_group=None,
                   sharded: Iterable[str] = ()) -> AdamWChain:
    return AdamWChain(labels, {"head": head_lr, "backbone": backbone_lr},
                      weight_decay=weight_decay, warmup_steps=warmup_steps,
                      total_steps=total_steps, max_grad_norm=max_grad_norm,
                      mu_dtype=mu_dtype, norm_group=norm_group, sharded=sharded)
