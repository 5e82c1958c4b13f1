"""Encoder self-attention with an additive key bias.

Port of ``lyricalignment_tpu/ops/attention.py:99-197`` (the one-pass encoder
attention). :func:`onepass_self_attention` keeps the JAX signature — q, k, v
``[B, T, H, Dh]`` with q and k prescaled, ``key_bias`` f32 ``[1, T]`` — and
runs the CUDA kernel ``csrc/attention.cu`` for CUDA tensors (forward only)
and :func:`einsum_bias_attention`, the counterpart of
``_einsum_bias_attention``, for CPU tensors.
"""

from __future__ import annotations

import torch

from lyricalignment_tpu_torch import kernels

HEAD_DIM = 64  # the kernel's template constant: d_h of every Whisper size


def einsum_bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_bias: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, T, H, Dh] attention, f32 softmax over
    ``q k^T + key_bias``, weights cast to the input dtype before P V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits + key_bias[0][None, None, None, :]
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def onepass_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_bias: torch.Tensor) -> torch.Tensor:
    """Non-causal self-attention, q/k/v [B, T, H, Dh] -> [B, T, H, Dh] in the
    input dtype. ``key_bias`` [1, T] f32 is added to every score row (e.g.
    -1e9 on keys to ignore); callers prescale q and k."""
    if not q.is_cuda:
        kernels.plain_or_raise("onepass_self_attention", q)
        return einsum_bias_attention(q, k, v, key_bias)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"onepass_self_attention: dtype {q.dtype} not taken")
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_cuda(f"onepass_self_attention {name}", t, q.dtype, 4)
        if t.shape != q.shape:
            raise ValueError("onepass_self_attention: q, k, v shapes differ")
    batch, seq, heads, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"onepass_self_attention: head dim {dh} != {HEAD_DIM}")
    if batch * heads > 65535:
        raise ValueError("onepass_self_attention: batch x heads > 65535")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("onepass_self_attention: q, k, v must be 16-byte aligned")
    bias = key_bias.reshape(-1)
    kernels.check_cuda("onepass_self_attention key_bias", bias, torch.float32, 1)
    if bias.shape[0] != seq:
        raise ValueError("onepass_self_attention: key_bias length != T")
    out = torch.empty_like(q)
    if out.numel():
        kernels.launch("la_bias_attention", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), bias.data_ptr(), out.data_ptr(), batch,
                       seq, heads, int(q.dtype == torch.bfloat16),
                       kernels.stream_of(q))
    return out
