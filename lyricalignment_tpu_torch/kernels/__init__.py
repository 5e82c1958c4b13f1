"""Kernel build, binding and launch accounting (see ``build.py``)."""

from __future__ import annotations

import torch

from lyricalignment_tpu_torch.kernels.build import (  # noqa: F401
    build_info,
    launch,
    launches,
    library,
    reset_launch_counts,
)


def check_cuda(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim``: the kernels read raw pointers with fixed strides."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def plain_or_raise(name: str, t: torch.Tensor) -> None:
    """The plain versions run only for CPU tensors; anything else that is
    not CUDA is refused rather than silently computed elsewhere."""
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {t.device}")
