"""Whisper backbone: the audio encoder, the teacher-forced decoder and
KV-cached decoding.

Port of ``lyricalignment_tpu/models/whisper.py:37-123,169-175,282-800``.
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

KV-cached decoding (``init_decode_cache``, ``prime_decode_cache``,
``decode_step``) keeps the JAX split cache: cross K/V and the prompt's K/V
one row per sample, the generated K/V one row per beam row, preallocated at
``[B * beam, max_new, H, Dh]`` and written at ``step`` in place. Every
shape is fixed from step to step and the step counter lives on the device,
so a step reads nothing back to the host.
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
    # int8 cross-attention K/V in the decode cache: not ported
    # (init_decode_cache raises; ROADMAP.md queue 1, int8)
    int8_cross_kv: bool = False

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865


# the ten architecture ints of WhisperConfig (OpenAI's ModelDimensions)
WHISPER_DIMS = ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
                "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head",
                "n_text_layer")


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


def _split_heads(y: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = y.shape
    return y.view(b, t, n_head, d // n_head)


def _causal_mask(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    mask = torch.full((n, n), torch.finfo(torch.float32).min, device=device)
    return torch.triu(mask, diagonal=1).to(dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def self_attention(self, x: torch.Tensor,
                       key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder self-attention of x [B, T, D] through the attention
        kernels: ``self_attention``, or ``onepass_self_attention`` when a
        ``key_bias`` [1, T] is given."""
        b, t, d = x.shape
        scale = (d // self.n_head) ** -0.25
        q = _split_heads(_linear(self.query, x), self.n_head) * scale
        k = _split_heads(_linear(self.key, x), self.n_head) * scale
        v = _split_heads(_linear(self.value, x), self.n_head).contiguous()
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
        q = _split_heads(_linear(self.query, x), self.n_head) * scale
        k = _split_heads(_linear(self.key, src), self.n_head)
        v = _split_heads(_linear(self.value, src), self.n_head)
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
    teacher-forced ``decoder_logits``, :func:`decode_step` the KV-cached
    step."""

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
        mask = _causal_mask(s, dtype, x.device)
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


# ---------------------------------------------------------------------------
# KV-cached incremental decoding
# ---------------------------------------------------------------------------

def _per_sample(value, default: int, b: int, device) -> torch.Tensor:
    """An int, a scalar or a [B] vector as an int64 [B] tensor on ``device``."""
    value = default if value is None else value
    return torch.as_tensor(value, dtype=torch.int64).to(device).broadcast_to((b,)).clone()


@torch.no_grad()
def init_decode_cache(model: Whisper, cfg: WhisperConfig, audio_features: torch.Tensor,
                      prompt_len: int, max_new_tokens: int, beam_size: int = 1) -> Dict:
    """Precompute cross-attention K/V and allocate the split self-attention
    cache (``lyricalignment_tpu/models/whisper.py:init_decode_cache``):

    - ``cross_k/v`` [B, T, H, Dh] and ``prompt_k/v`` [B, prompt_len, H, Dh]:
      one row per sample, shared by the sample's beams;
    - ``gen_k/v`` [B * beam_size, max_new_tokens, H, Dh]: one row per beam
      row, written at ``step`` by :func:`decode_step`;
    - ``step`` (int64 scalar tensor) and ``length`` (int64 [B], the valid
      prompt length a sample; zero until :func:`prime_decode_cache`).
    """
    if cfg.int8_cross_kv:
        raise NotImplementedError(
            "int8 cross-attention K/V is not ported (ROADMAP.md queue 1, int8)")
    dtype = cfg.compute_dtype
    b = audio_features.shape[0]
    dev = audio_features.device
    xa = audio_features.to(dtype)
    d_h = cfg.n_text_state // cfg.n_text_head
    cache = {"blocks": [], "step": torch.zeros((), dtype=torch.int64, device=dev),
             "length": torch.zeros((b,), dtype=torch.int64, device=dev)}
    for block in model.decoder.blocks:
        cache["blocks"].append({
            "cross_k": _split_heads(_linear(block.cross_attn.key, xa), cfg.n_text_head),
            "cross_v": _split_heads(_linear(block.cross_attn.value, xa), cfg.n_text_head),
            "prompt_k": torch.zeros((b, prompt_len, cfg.n_text_head, d_h), dtype=dtype, device=dev),
            "prompt_v": torch.zeros((b, prompt_len, cfg.n_text_head, d_h), dtype=dtype, device=dev),
            "gen_k": torch.zeros((b * beam_size, max_new_tokens, cfg.n_text_head, d_h),
                                 dtype=dtype, device=dev),
            "gen_v": torch.zeros((b * beam_size, max_new_tokens, cfg.n_text_head, d_h),
                                 dtype=dtype, device=dev),
        })
    return cache


def _grouped_cross_attention(p: MultiHeadAttention, x: torch.Tensor, ck: torch.Tensor,
                             cv: torch.Tensor, n_head: int) -> torch.Tensor:
    """Cross-attention of x [B*g, S, D] (post-LN) to the precomputed K/V
    [B, T, H, Dh], where g query rows (beams) share each audio row."""
    bg, s, d = x.shape
    b = ck.shape[0]
    g = bg // b
    scale = (d // n_head) ** -0.25
    q = _split_heads(_linear(p.query, x), n_head).reshape(b, g, s, n_head, d // n_head)
    logits = torch.einsum("bgshd,bthd->bgsht", q * scale, ck * scale)
    w = torch.softmax(logits.to(torch.float32), -1).to(x.dtype)
    out = torch.einsum("bgsht,bthd->bgshd", w, cv)
    return _linear(p.out, out.reshape(bg, s, d))


def _unembed(dec: TextDecoder, h: torch.Tensor) -> torch.Tensor:
    return h.to(torch.float32) @ dec.token_embedding.weight.to(torch.float32).T


@torch.no_grad()
def prime_decode_cache(model: Whisper, cfg: WhisperConfig, tokens: torch.Tensor, cache: Dict,
                       length=None, aux_index=None):
    """Prime the cache with a whole prompt in one forward pass.

    ``tokens`` int[B, P], left-aligned, one row per sample; ``length`` (an
    int, a scalar or [B]; default P) is the valid prompt length a sample,
    and positions past it may hold padding that stays masked. Returns
    (logits f32[B, V] at position length - 1, logits at ``aux_index``
    (default 0; the <|startoftranscript|> position gives the no-speech
    probability), the cache with ``step`` 0 and ``length`` set). The
    prompt's K/V are written into the cache in place.
    """
    dec = model.decoder
    dtype = cfg.compute_dtype
    n_head = cfg.n_text_head
    b, p = tokens.shape
    dev = tokens.device
    length = _per_sample(length, p, b, dev)
    aux_index = _per_sample(aux_index, 0, b, dev)

    x = dec.token_embedding.weight[tokens.long()].to(dtype)
    x = x + dec.positional_embedding[:p].to(dtype)[None]
    mask = _causal_mask(p, dtype, dev)
    scale = (cfg.n_text_state // n_head) ** -0.25
    for block, bc in zip(dec.blocks, cache["blocks"]):
        h = _layer_norm(block.attn_ln, x)
        q = _split_heads(_linear(block.attn.query, h), n_head)
        k = _split_heads(_linear(block.attn.key, h), n_head)
        v = _split_heads(_linear(block.attn.value, h), n_head)
        att = torch.einsum("bqhd,bkhd->bhqk", q * scale, k * scale) + mask
        w = torch.softmax(att.to(torch.float32), -1).to(dtype)
        attn_out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        x = x + _linear(block.attn.out, attn_out.reshape(x.shape))
        x = x + _grouped_cross_attention(block.cross_attn, _layer_norm(block.cross_attn_ln, x),
                                         bc["cross_k"], bc["cross_v"], n_head)
        x = block._mlp(x)
        bc["prompt_k"].copy_(k)
        bc["prompt_v"].copy_(v)

    x = _layer_norm(dec.ln, x)
    rows = torch.arange(b, device=dev)
    last_h = x[rows, (length - 1).clamp(0, p - 1)]
    aux_h = x[rows, aux_index.clamp(0, p - 1)]
    cache["step"].zero_()
    cache["length"] = length
    return _unembed(dec, last_h), _unembed(dec, aux_h), cache


@torch.no_grad()
def decode_step(model: Whisper, cfg: WhisperConfig, tokens: torch.Tensor, cache: Dict):
    """One autoregressive step: tokens int[R, 1] -> (logits f32[R, V], the
    cache, updated in place).

    ``R = B * g`` rows share ``B`` samples' prompt and cross sections (g
    beams a sample). Row r of sample b sits at position ``length[b] +
    step``; its self-attention reads the prompt slots ``< length[b]`` and
    the generated slots ``<= step``. The new K/V are written at slot
    ``step`` (the last slot once ``step`` passes the end, as JAX's
    ``dynamic_update_slice`` clamps), and ``step`` advances on the device.
    Callers keep ``length + step < n_text_ctx`` (``decode.beam
    ._check_context``); past it the last positional row repeats, as in JAX.
    """
    dec = model.decoder
    dtype = cfg.compute_dtype
    n_head = cfg.n_text_head
    step, length = cache["step"], cache["length"]
    r, b = tokens.shape[0], length.shape[0]
    g = r // b
    p = cache["blocks"][0]["prompt_k"].shape[1]
    g_max = cache["blocks"][0]["gen_k"].shape[1]
    dev = tokens.device
    neg = torch.finfo(torch.float32).min

    pe = dec.positional_embedding.to(dtype)
    pos = (length.repeat_interleave(g) + step).clamp(0, pe.shape[0] - 1)
    x = dec.token_embedding.weight[tokens.long()].to(dtype) + pe[pos][:, None]

    mask_p = torch.where(torch.arange(p, device=dev)[None] < length[:, None], 0.0, neg).to(dtype)
    mask_g = torch.where(torch.arange(g_max, device=dev) <= step, 0.0, neg).to(dtype)
    slot = step.clamp(max=g_max - 1).reshape(1)
    scale = (cfg.n_text_state // n_head) ** -0.25
    for block, bc in zip(dec.blocks, cache["blocks"]):
        h = _layer_norm(block.attn_ln, x)
        q = _split_heads(_linear(block.attn.query, h), n_head)
        bc["gen_k"].index_copy_(1, slot, _split_heads(_linear(block.attn.key, h), n_head))
        bc["gen_v"].index_copy_(1, slot, _split_heads(_linear(block.attn.value, h), n_head))

        qs = (q * scale)[:, 0]                                              # [R, H, Dh]
        att_p = torch.einsum("bghd,bphd->bghp", qs.reshape(b, g, n_head, -1),
                             bc["prompt_k"] * scale) + mask_p[:, None, None, :]
        att_g = torch.einsum("rhd,rkhd->rhk", qs, bc["gen_k"] * scale) + mask_g[None, None, :]
        att = torch.cat([att_p.reshape(r, n_head, p), att_g], dim=-1)
        w = torch.softmax(att.to(torch.float32), -1).to(dtype)
        out_p = torch.einsum("bghp,bphd->bghd", w[..., :p].reshape(b, g, n_head, p),
                             bc["prompt_v"])
        out_g = torch.einsum("rhk,rkhd->rhd", w[..., p:], bc["gen_v"])
        attn_out = out_p.reshape(r, n_head, -1) + out_g                     # [R, H, Dh]
        x = x + _linear(block.attn.out, attn_out.reshape(r, 1, -1))
        x = x + _grouped_cross_attention(block.cross_attn, _layer_norm(block.cross_attn_ln, x),
                                         bc["cross_k"], bc["cross_v"], n_head)
        x = block._mlp(x)

    logits = _unembed(dec, _layer_norm(dec.ln, x))
    step.add_(1)
    return logits[:, 0], cache
