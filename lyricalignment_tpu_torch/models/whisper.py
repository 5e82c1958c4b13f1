"""Whisper backbone: the audio encoder and the teacher-forced decoder.

Port of ``lyricalignment_tpu/models/whisper.py:37-123,169-175,282-534``.
Module and parameter names are the reference's ``state_dict`` names
(``encoder.blocks.{i}.attn.query.weight``, ``decoder.token_embedding.weight``
...), so a reference checkpoint loads with ``load_state_dict(strict=True)``.

Numerics follow the JAX model: pre-LN blocks, q and k each scaled by
d_h^-0.25, no bias on k, LayerNorm statistics in float32 whatever the compute
dtype, exact or tanh GELU, and every matmul weight cast to the compute dtype
(a no-op once :func:`bf16_resident` stored them in bfloat16). Encoder
self-attention runs on the attention kernels over the true 1500 frames (the
kernels mask their ragged last tile themselves, so the residual stream is
not padded to a multiple of 128): ``ops.attention.self_attention`` by
default, as the JAX training path runs the library flash kernel, or
``onepass_self_attention`` with a zero key bias under
``WhisperConfig.onepass_encoder``. The decoder's causal self-attention and
cross-attention are plain matmuls, as JAX computes them with einsum outside
any kernel; its unembedding runs in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from lyricalignment_tpu_torch.ops.attention import onepass_self_attention, self_attention


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    compute_dtype: torch.dtype = torch.float32
    # tanh-approximate GELU in the conv stem and every MLP (the bench's
    # bf16 setting; exact erf GELU otherwise)
    fast_gelu: bool = False
    # encoder self-attention through onepass_self_attention (key bias) rather
    # than self_attention; the same kernels either way, off as in JAX
    onepass_encoder: bool = False


def _cfg(state: int, head: int, layer: int, **kw) -> WhisperConfig:
    return WhisperConfig(
        n_audio_state=state, n_audio_head=head, n_audio_layer=layer,
        n_text_state=state, n_text_head=head, n_text_layer=layer, **kw,
    )


WHISPER_CONFIGS: Dict[str, WhisperConfig] = {
    "tiny": _cfg(384, 6, 4),
    "base": _cfg(512, 8, 6),
    "small": _cfg(768, 12, 12),
    "medium": _cfg(1024, 16, 24),
    "large": _cfg(1280, 20, 32),
    "large-v2": _cfg(1280, 20, 32),
    "large-v3": _cfg(1280, 20, 32, n_mels=128, n_vocab=51866),
    "large-v3-turbo": WhisperConfig(
        n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
        n_text_state=1280, n_text_head=20, n_text_layer=4,
        n_mels=128, n_vocab=51866),
}


def sinusoid_position_embedding(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder positional embedding (log-spaced sinusoids)."""
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    # float32 statistics regardless of compute dtype
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        b, t, d = y.shape
        return y.view(b, t, self.n_head, d // self.n_head)

    def self_attention(self, x: torch.Tensor,
                       key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder self-attention of x [B, T, D] through the attention
        kernels: ``self_attention``, or ``onepass_self_attention`` when a
        ``key_bias`` [1, T] is given."""
        b, t, d = x.shape
        scale = (d // self.n_head) ** -0.25
        q = self._split(_linear(self.query, x)) * scale
        k = self._split(_linear(self.key, x)) * scale
        v = self._split(_linear(self.value, x)).contiguous()
        out = (self_attention(q, k, v) if key_bias is None
               else onepass_self_attention(q, k, v, key_bias))
        return _linear(self.out, out.reshape(b, t, d))

    def attend(self, x: torch.Tensor, xa: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decoder attention as plain matmuls (``_attention``'s einsum
        path): causal self-attention with ``mask`` [S, S], or
        cross-attention to ``xa`` [B, T, D]."""
        b, s, d = x.shape
        scale = (d // self.n_head) ** -0.25
        src = x if xa is None else xa
        q = self._split(_linear(self.query, x)) * scale
        k = self._split(_linear(self.key, src))
        v = self._split(_linear(self.value, src))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k * scale)
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return _linear(self.out, out.reshape(b, s, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False,
                 fast_gelu: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state)
        if cross_attention:
            self.cross_attn = MultiHeadAttention(n_state, n_head)
            self.cross_attn_ln = nn.LayerNorm(n_state)
        self.mlp = nn.Sequential(
            nn.Linear(n_state, 4 * n_state),
            nn.GELU(approximate="tanh" if fast_gelu else "none"),
            nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(self.mlp_ln, x)
        return x + _linear(self.mlp[2], self.mlp[1](_linear(self.mlp[0], h)))

    def encoder_forward(self, x: torch.Tensor,
                        key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn.self_attention(_layer_norm(self.attn_ln, x), key_bias)
        return self._mlp(x)

    def decoder_forward(self, x: torch.Tensor, xa: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn.attend(_layer_norm(self.attn_ln, x), mask=mask)
        x = x + self.cross_attn.attend(_layer_norm(self.cross_attn_ln, x), xa)
        return self._mlp(x)


def _run_block(fn, remat: bool, *args):
    """``fn(*args)``, under ``remat`` as a non-reentrant activation
    checkpoint (the block's forward runs again in the backward; only when
    autograd records)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.n_audio_state
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.n_mels, d, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        self.register_buffer("positional_embedding", torch.from_numpy(
            sinusoid_position_embedding(cfg.n_audio_ctx, d)))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cfg.n_audio_head, fast_gelu=cfg.fast_gelu)
            for _ in range(cfg.n_audio_layer))
        self.ln_post = nn.LayerNorm(d)

    def _stem(self, mel: torch.Tensor) -> torch.Tensor:
        dtype = self.cfg.compute_dtype
        gelu = lambda y: F.gelu(y, approximate="tanh" if self.cfg.fast_gelu else "none")
        x = mel.to(dtype)
        # cuDNN runs float32 convolutions in TF32 unless told otherwise
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = gelu(F.conv1d(x, self.conv1.weight.to(dtype), self.conv1.bias.to(dtype),
                              padding=1))
            x = gelu(F.conv1d(x, self.conv2.weight.to(dtype), self.conv2.bias.to(dtype),
                              stride=2, padding=1))
        x = x.transpose(1, 2)
        return x + self.positional_embedding[: x.shape[1]].to(dtype)

    def forward(self, mel: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """mel f32[B, n_mels, 3000] -> audio features [B, 1500, D] in the
        compute dtype. ``remat`` checkpoints each block."""
        x = self._stem(mel)
        key_bias = None
        if self.cfg.onepass_encoder:
            key_bias = torch.zeros((1, x.shape[1]), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x = _run_block(block.encoder_forward, remat, x, key_bias)
        return _layer_norm(self.ln_post, x)


class TextDecoder(nn.Module):
    """Whisper's text decoder (reference names); :meth:`forward` is the
    teacher-forced ``decoder_logits``. KV-cached decoding is a later
    slice."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.n_text_state
        self.token_embedding = nn.Embedding(cfg.n_vocab, d)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.n_text_ctx, d))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cfg.n_text_head, cross_attention=True,
                                   fast_gelu=cfg.fast_gelu)
            for _ in range(cfg.n_text_layer))
        self.ln = nn.LayerNorm(d)
        self.compute_dtype = cfg.compute_dtype

    def forward(self, tokens: torch.Tensor, audio_features: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        """tokens int[B, S], audio_features [B, T, D] -> logits f32[B, S,
        n_vocab]: pre-LN blocks of causal self-attention, cross-attention
        and MLP, then the float32 unembedding by the token embedding."""
        dtype = self.compute_dtype
        xa = audio_features.to(dtype)
        s = tokens.shape[1]
        x = (self.token_embedding.weight[tokens.long()].to(dtype)
             + self.positional_embedding[:s].to(dtype)[None])
        mask = torch.full((s, s), torch.finfo(torch.float32).min, device=x.device)
        mask = torch.triu(mask, diagonal=1).to(dtype)
        for block in self.blocks:
            x = _run_block(block.decoder_forward, remat, x, xa, mask)
        x = _layer_norm(self.ln, x)
        return x.float() @ self.token_embedding.weight.float().T


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = TextDecoder(cfg)

    def embed_audio(self, mel: torch.Tensor, remat: bool = False) -> torch.Tensor:
        return self.encoder(mel, remat=remat)

    def decoder_logits(self, tokens: torch.Tensor, audio_features: torch.Tensor,
                       remat: bool = False) -> torch.Tensor:
        """The reference's ``whisper_model.logits(tokens, audio_features)``."""
        return self.decoder(tokens, audio_features, remat=remat)


def bf16_resident(whisper: Whisper) -> Whisper:
    """Store the whisper matmul/conv weights (rank >= 2) in bfloat16, in
    place: numerically identical to the per-op cast of the bf16 compute
    path and half the weight bytes. The decoder's token and positional
    embeddings stay float32, as ``bf16_resident_params`` keeps them; the
    encoder's positional buffer is not a parameter and stays float32."""
    keep = {"decoder.token_embedding.weight", "decoder.positional_embedding"}
    for name, p in whisper.named_parameters():
        if p.dim() >= 2 and name not in keep:
            p.data = p.data.to(torch.bfloat16)
    return whisper
