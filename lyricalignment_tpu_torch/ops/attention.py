"""Encoder self-attention, forward and backward.

Port of ``lyricalignment_tpu/ops/attention.py``: :func:`self_attention`
(`attention.py:47-96`, the library flash attention the JAX training path
runs) and :func:`onepass_self_attention` (`attention.py:172-197`, the
pad-once serving path with an additive key bias). Both keep the JAX
signatures — q, k, v ``[B, T, H, Dh]``, callers prescale q and k — and go
through one ``torch.autograd.Function``:

* forward: ``csrc/attention.cu`` (launcher ``la_attention_fwd``, which
  also writes the float32 row log-sum-exp, when autograd records the call
  and q, k or v needs a gradient; ``la_bias_attention``, without row
  statistics, otherwise);
* backward: ``csrc/attention_bwd.cu`` (``la_attention_dkdv`` and
  ``la_attention_dq``), which recompute the probabilities from the saved
  log-sum-exp.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (the ``*_plain`` functions, the same arithmetic in einsums)
for CPU tensors. :func:`einsum_attention` and :func:`einsum_bias_attention`
are the counterparts of the JAX reference formulations; autograd through
them is the plain gradient the kernels are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from lyricalignment_tpu_torch import kernels

HEAD_DIM = 64  # the kernels' template constant: d_h of every Whisper size


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float = 1.0) -> torch.Tensor:
    """Plain version of ``_einsum_attention``: [B, T, H, Dh], logits in the
    input dtype, f32 softmax, weights cast back before P V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q * sm_scale, k)
    weights = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def einsum_bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_bias: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_einsum_bias_attention``: [B, T, H, Dh] attention,
    f32 softmax over ``q k^T + key_bias``, weights cast to the input dtype
    before P V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits + key_bias[0][None, None, None, :]
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

def _scores(q, k, bias):
    """float32 [B, H, Tq, Tk] scores (+ key bias) from [B, T, H, Dh]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s if bias is None else s + bias[None, None, None, :]


def attention_fwd_plain(q, k, v, bias: Optional[torch.Tensor] = None,
                        with_lse: bool = False):
    """(out [B, T, H, Dh] in the input dtype, row log-sum-exp f32[B, H, T]
    or None); ``bias`` f32[T] or None."""
    b = torch.zeros(q.shape[1], device=q.device) if bias is None else bias
    out = einsum_bias_attention(q, k, v, b[None])
    return out, (torch.logsumexp(_scores(q, k, bias), dim=-1) if with_lse else None)


def _probs_and_dscores(q, k, v, dout, lse, delta, bias):
    """P and dS = P * (dP - delta), float32 [B, H, Tq, Tk], each rounded to
    the input dtype before the products that use it (the kernels' and the
    library's bf16 rounding)."""
    p = torch.exp(_scores(q, k, bias) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def attention_dkdv_plain(q, k, v, dout, lse, delta, bias=None):
    p, ds = _probs_and_dscores(q, k, v, dout, lse, delta, bias)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def attention_dq_plain(q, k, v, dout, lse, delta, bias=None):
    _, ds = _probs_and_dscores(q, k, v, dout, lse, delta, bias)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(O * dO) in float32, [B, H, T]: a plain reduction, as
    the JAX library computes it in XLA outside its kernels."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, tensors, bias):
    q = tensors[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {q.dtype} not taken")
    for i, t in enumerate(tensors):
        kernels.check_cuda(f"{name} input {i}", t, q.dtype, 4)
        if t.shape != q.shape:
            raise ValueError(f"{name}: q, k, v (dO) shapes differ")
        if t.numel() and t.data_ptr() % 16:  # an empty call launches nothing
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    batch, seq, heads, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} != {HEAD_DIM}")
    if batch * heads > 65535:
        raise ValueError(f"{name}: batch x heads > 65535")
    if bias is not None:
        kernels.check_cuda(f"{name} key_bias", bias, torch.float32, 1)
        if bias.shape[0] != seq:
            raise ValueError(f"{name}: key_bias length != T")
        if bias.data_ptr() % 16:  # the bf16 forward and dQ kernels read it with TMA
            raise ValueError(f"{name}: key_bias must be 16-byte aligned")
    return batch, seq, heads, int(q.dtype == torch.bfloat16)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_stats(name, seq_shape, *stats):
    for t in stats:
        kernels.check_cuda(f"{name} row statistics", t, torch.float32, 3)
        if t.shape != seq_shape:
            raise ValueError(f"{name}: row statistics must be [B, H, T]")


def attention_forward(q, k, v, bias: Optional[torch.Tensor] = None,
                      with_lse: bool = False):
    """Forward kernel: (out, f32[B, H, T] row log-sum-exp or None).
    ``bias`` f32[T] or None."""
    if not q.is_cuda:
        kernels.plain_or_raise("attention_forward", q)
        return attention_fwd_plain(q, k, v, bias, with_lse)
    batch, seq, heads, is_bf16 = _check("attention_forward", (q, k, v), bias)
    out = torch.empty_like(q)
    lse = (torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), out.data_ptr())
        if with_lse:
            kernels.launch("la_attention_fwd", *args, lse.data_ptr(), batch, seq, heads,
                           is_bf16, kernels.stream_of(q))
        else:
            kernels.launch("la_bias_attention", *args, batch, seq, heads, is_bf16,
                           kernels.stream_of(q))
    return out, lse


def attention_dkdv(q, k, v, dout, lse, delta, bias=None):
    """dK/dV kernel: (dk, dv) in the input dtype."""
    if not q.is_cuda:
        kernels.plain_or_raise("attention_dkdv", q)
        return attention_dkdv_plain(q, k, v, dout, lse, delta, bias)
    batch, seq, heads, is_bf16 = _check("attention_dkdv", (q, k, v, dout), bias)
    _check_stats("attention_dkdv", (batch, heads, seq), lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        kernels.launch("la_attention_dkdv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(bias),
                       dk.data_ptr(), dv.data_ptr(), batch, seq, heads, is_bf16,
                       kernels.stream_of(q))
    return dk, dv


def attention_dq(q, k, v, dout, lse, delta, bias=None):
    """dQ kernel: dq in the input dtype."""
    if not q.is_cuda:
        kernels.plain_or_raise("attention_dq", q)
        return attention_dq_plain(q, k, v, dout, lse, delta, bias)
    batch, seq, heads, is_bf16 = _check("attention_dq", (q, k, v, dout), bias)
    _check_stats("attention_dq", (batch, heads, seq), lse, delta)
    dq = torch.empty_like(q)
    if dq.numel():
        kernels.launch("la_attention_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(bias),
                       dq.data_ptr(), batch, seq, heads, is_bf16, kernels.stream_of(q))
    return dq


class _Attention(torch.autograd.Function):
    """Forward kernel with the row log-sum-exp, then the dK/dV and dQ
    kernels. Saves q, k, v, out, the log-sum-exp and the key bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = attention_forward(q, k, v, bias, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bias = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        dk, dv = attention_dkdv(q, k, v, dout, lse, delta, bias)
        dq = attention_dq(q, k, v, dout, lse, delta, bias)
        return dq, dk, dv, None


def _apply(q, k, v, bias):
    if bias is not None and bias.requires_grad:
        raise ValueError("attention: no kernel computes the key bias gradient")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, bias)
    return attention_forward(q, k, v, bias)[0]  # nothing to save for a backward


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float = 1.0) -> torch.Tensor:
    """Non-causal multi-head self-attention, q/k/v [B, T, H, Dh] -> [B, T,
    H, Dh] in the input dtype, T unpadded. ``sm_scale`` multiplies the
    logits (callers that prescale q and k by d_h^-0.25 pass 1.0).
    Differentiable through the backward kernels."""
    if sm_scale != 1.0:
        q = q * sm_scale
    return _apply(q, k, v, None)


def onepass_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_bias: torch.Tensor) -> torch.Tensor:
    """As :func:`self_attention` with ``key_bias`` [1, T] f32 added to every
    score row (e.g. -1e9 on keys to ignore); callers prescale q and k.
    Differentiable in q, k and v, as its JAX ``custom_vjp`` is."""
    return _apply(q, k, v, key_bias.reshape(-1))
