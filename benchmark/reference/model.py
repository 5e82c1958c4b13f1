"""Whisper's encoder and the bi-GRU alignment head, plainly in
float32 on a ``{name: tensor}`` weight dict (Whisper's ``state_dict``
names under ``whisper_model.``, the head's under ``align_rnn.``).

Whisper (Radford et al. 2022, ``openai/whisper`` ``model.py``): a stem of
two 3-tap convolutions (the second of stride 2) with GELU, fixed sinusoid
positions, pre-LayerNorm blocks of multi-head attention (no bias on the
key) and a 4x GELU MLP, a final LayerNorm. GELU is the tanh form where the configuration says
``fast_gelu``. The head: a stacked bi-GRU (PyTorch's gate order r, z, n),
Mish, then the classifier.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

W = "whisper_model"
# the products every Whisper linear and convolution goes through (the
# controls swap in FP8 versions: :func:`fp8_matmuls`)
OPS = {"linear": F.linear, "conv1d": F.conv1d}


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to FP8 e4m3 under one scale (its absmax to 448)."""
    scale = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@contextlib.contextmanager
def fp8_matmuls(enabled: bool):
    """Within the block the reference's Whisper linears and convolutions
    take FP8 inputs (both operands)."""
    if not enabled:
        yield
        return
    saved = dict(OPS)
    OPS["linear"] = lambda x, w, b=None: saved["linear"](_round_fp8(x), _round_fp8(w), b)
    OPS["conv1d"] = lambda x, w, b=None, **k: saved["conv1d"](_round_fp8(x), _round_fp8(w), b, **k)
    try:
        yield
    finally:
        OPS.update(saved)


class Weights:
    """float32 views of the weights on one device."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        self.w = weights

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.w[name].float()


def gelu(x: torch.Tensor, fast: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if fast else "none")


def layer_norm(p: Weights, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}.weight"], p[f"{prefix}.bias"], 1e-5)


def linear(p: Weights, prefix: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    return OPS["linear"](x, p[f"{prefix}.weight"], p[f"{prefix}.bias"] if bias else None)


def attention(p: Weights, prefix: str, x: torch.Tensor, src: torch.Tensor, n_head: int,
              causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(d_h) [+ causal mask]) v, heads of ``n_head``."""
    b, s, d = x.shape
    t = src.shape[1]
    q = linear(p, f"{prefix}.query", x).view(b, s, n_head, -1).transpose(1, 2)
    k = linear(p, f"{prefix}.key", src, bias=False).view(b, t, n_head, -1).transpose(1, 2)
    v = linear(p, f"{prefix}.value", src).view(b, t, n_head, -1).transpose(1, 2)
    scores = q @ k.transpose(-1, -2) / (q.shape[-1] ** 0.5)
    if causal:
        scores = scores + torch.full((s, t), float("-inf"), device=x.device).triu(1 + t - s)
    out = torch.softmax(scores, dim=-1) @ v
    return linear(p, f"{prefix}.out", out.transpose(1, 2).reshape(b, s, d))


def mlp(p: Weights, prefix: str, x: torch.Tensor, fast: bool) -> torch.Tensor:
    return linear(p, f"{prefix}.mlp.2", gelu(linear(p, f"{prefix}.mlp.0", x), fast))


def encode(p: Weights, cfg: Dict, mel: torch.Tensor, fast: bool) -> torch.Tensor:
    """mel f32[B, n_mels, 3000] -> audio features f32[B, 1500, D]."""
    conv = OPS["conv1d"]
    x = gelu(conv(mel, p[f"{W}.encoder.conv1.weight"], p[f"{W}.encoder.conv1.bias"],
                  padding=1), fast)
    x = gelu(conv(x, p[f"{W}.encoder.conv2.weight"], p[f"{W}.encoder.conv2.bias"],
                  stride=2, padding=1), fast)
    x = x.transpose(1, 2) + p[f"{W}.encoder.positional_embedding"][: x.shape[-1]]
    for i in range(cfg["n_audio_layer"]):
        pre = f"{W}.encoder.blocks.{i}"
        h = layer_norm(p, f"{pre}.attn_ln", x)
        x = x + attention(p, f"{pre}.attn", h, h, cfg["n_audio_head"])
        x = x + mlp(p, pre, layer_norm(p, f"{pre}.mlp_ln", x), fast)
    return layer_norm(p, f"{W}.encoder.ln_post", x)


def gru_layer(p: Weights, layer: int, x: torch.Tensor, lengths: List[int],
              bidirectional: bool) -> torch.Tensor:
    """One bi-GRU layer over x f32[B, T, In], each sequence to its own
    length (the reverse direction starts at its last true frame); outputs
    past a length are zero. r, z, n gates:
    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr), z likewise,
    n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n + z h."""
    b, t, _ = x.shape
    idx = torch.arange(t, device=x.device)
    lens = torch.tensor(lengths, device=x.device)
    valid = idx[None, :] < lens[:, None]                                     # [B, T]
    # each sequence reversed within its length
    rev = torch.where(valid, lens[:, None] - 1 - idx[None, :], idx[None, :])
    outs = []
    for sfx, order in (("", None), ("_reverse", rev))[: 2 if bidirectional else 1]:
        w_ih, w_hh = p[f"align_rnn.rnn.weight_ih_l{layer}{sfx}"], p[f"align_rnn.rnn.weight_hh_l{layer}{sfx}"]
        b_ih, b_hh = p[f"align_rnn.rnn.bias_ih_l{layer}{sfx}"], p[f"align_rnn.rnn.bias_hh_l{layer}{sfx}"]
        seq = x if order is None else x.gather(1, order[:, :, None].expand_as(x))
        gi = F.linear(seq, w_ih, b_ih)                                       # [B, T, 3H]
        h = torch.zeros(b, w_hh.shape[1], device=x.device)
        ys = []
        for step in range(t):
            gh = F.linear(h, w_hh, b_hh)
            i_r, i_z, i_n = gi[:, step].chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1 - z) * n + z * h
            ys.append(h)
        y = torch.stack(ys, dim=1)
        if order is not None:
            y = y.gather(1, order[:, :, None].expand_as(y))
        outs.append(torch.where(valid[:, :, None], y, torch.zeros((), device=x.device)))
    return torch.cat(outs, dim=-1)


def head_hidden(p: Weights, cfg: Dict, x: torch.Tensor, lengths: List[int]) -> torch.Tensor:
    """x f32[B, T, D] -> Mish(bi-GRU(x)) f32[B, T, 2H] (inference: no
    dropout)."""
    head = cfg["head"]
    h = x
    for layer in range(head["num_rnn_layers"]):
        h = gru_layer(p, layer, h, lengths, head["bidirectional"])
    return h * torch.tanh(F.softplus(h))
