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

Two inference options quantise to int8 as the JAX model does
(``whisper.py:60-90,244-331,582-645``): ``int8_encoder`` runs the encoder
blocks' q/k/v/out and MLP linears W8A8 (per-token activation scales,
per-output-channel weight scales, an int8 x int8 -> int32 product through
``torch._int_mm``), on weights made int8-resident by :func:`int8_resident`
or quantised per call; ``int8_cross_kv`` keeps the decode cache's cross K
(scale per key over Dh) and V (scale per head and channel over T) in int8
with both cross contractions on integer values.

Sharded by ``parallel.mesh`` (tensor parallelism), each attention holds
its rank's heads and each MLP its rank's hidden columns; the row-parallel
linears sum their partial products over the model group and add the bias
after the sum, the token embedding may be vocab-sharded (the logits are
gathered), and the decode cache holds the rank's heads. The
sequence-parallel encode (``encode_audio(sequence_sharding=...)``) keeps a
rank's frames through the blocks and lets the attention kernels see every
frame of a rank's heads by an all-to-all. Pipelined (``parallel.pipeline``),
a rank holds its stage's blocks, the other stages' on the ``meta`` device,
and the pipeline takes the place of the loop over the blocks (the forwards'
``run_blocks``), each stage running :func:`encoder_blocks` /
:func:`decoder_blocks` on its own.

KV-cached decoding (``init_decode_cache``, ``prime_decode_cache``,
``decode_step``) keeps the JAX split cache: cross K/V and the prompt's K/V
one row per sample, the generated K/V one row per beam row, preallocated at
``[B * beam, max_new, H, Dh]`` and written at ``step`` in place. Every
shape is fixed from step to step and the step counter lives on the device,
so a step reads nothing back to the host.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from lyricalignment_tpu_torch.ops.attention import onepass_self_attention, self_attention
from lyricalignment_tpu_torch.parallel.mesh import (
    all_reduce_max,
    copy_to_model,
    gather_dim,
    heads_to_seq,
    reduce_from_model,
    seq_to_heads,
)


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
    # W8A8 dynamic int8 quantisation of the encoder blocks' matmuls (q/k/v/out
    # and both MLP linears); inference only (round has no gradient), the
    # stem, LayerNorms, attention kernels and decoder keep compute_dtype
    int8_encoder: bool = False
    # int8 cross-attention K/V in the decode cache (K per key over Dh, V per
    # head and channel over T) with integer-valued cross contractions;
    # inference only
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


class Int8Linear(nn.Module):
    """An encoder linear made int8-resident (:func:`int8_resident`): the
    int8 weight [out, in], its per-output-channel scale f32[out] and the
    bias, exactly the pair :func:`_linear_int8` would derive per call."""

    def __init__(self, weight_q: torch.Tensor, weight_s: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_s", weight_s)
        self.register_buffer("bias", None if bias is None else bias.detach())


def _quantize_int8(x: torch.Tensor, dim: int, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantisation along ``dim``: (q int8, scale f32
    with ``dim`` kept as 1), q * scale ~= x; round half to even, as
    ``jnp.round``. ``group``: ``dim`` is split over the model group, whose
    absmax is the max of every rank's (GSPMD's over the whole dim)."""
    x32 = x.float()
    absmax = all_reduce_max(x32.abs().amax(dim=dim, keepdim=True), group)
    scale = absmax.clamp(min=1e-12) / 127.0
    return torch.clamp(torch.round(x32 / scale), -127.0, 127.0).to(torch.int8), scale


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a int8[M, K] @ b_t int8[N, K].T -> int32[M, N] by ``torch._int_mm``,
    with the second operand the transpose of a contiguous [N, K] tensor (the
    layout cuBLASLt takes for an int8 product). On the card it needs
    M > 16 and K, N multiples of 8: the encoder's M is B x 1500."""
    return torch._int_mm(a.contiguous(), b_t.contiguous().t())


def _linear_int8(lin: nn.Module, x: torch.Tensor, group=None) -> torch.Tensor:
    """W8A8 linear (JAX ``_linear_int8``): x quantised per token, the weight
    per output channel (``Int8Linear``'s resident pair, else quantised
    here), the int8 x int8 -> int32 product, then ``y * (xs * ws) + b`` in
    float32, cast to x's dtype. Inference only. ``group``: a row-parallel
    linear, whose input dim is split over the model group: both absmaxes
    are all-reduced (MAX) over it, and the int32 partial products summed
    (exact) before the rescale and the bias."""
    xq, xs = _quantize_int8(x, -1, group)                # [..., in], [..., 1]
    if isinstance(lin, Int8Linear):
        wq, ws = lin.weight_q, lin.weight_s
    else:
        wq, ws = _quantize_int8(lin.weight, 1, group)
        ws = ws[:, 0]
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*x.shape[:-1], wq.shape[0])
    y = reduce_from_model(y, group).float() * (xs * ws)
    if lin.bias is not None:
        y = y + lin.bias.float()
    return y.to(x.dtype)


@contextlib.contextmanager
def _full_float32_matmul():
    """float32 matmuls without TF32 inside the block (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _int_einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of two int8 tensors as a float32 einsum of their integer
    values, TF32 off (PyTorch has no batched int8 product). Exact where every
    partial sum stays below 2^24: always for the Dh = 64 contraction
    (64 x 127^2), and to 1 ulp at worst for the T = 1500 one."""
    with _full_float32_matmul():
        return torch.einsum(equation, a.float(), b.float())


def _row_linear(lin: nn.Module, x: torch.Tensor, group, int8: bool = False) -> torch.Tensor:
    """A linear that is row-parallel under tensor parallelism (attention
    out, fc2): x holds this rank's input columns, the partial products are
    summed over ``group`` ("g") and the bias is added once, after the sum.
    Unsharded (``group`` None) it is the plain linear."""
    if int8:
        return _linear_int8(lin, x, group)
    if group is None:
        return _linear(lin, x)
    y = reduce_from_model(F.linear(x, lin.weight.to(x.dtype)), group)
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def _split_heads(y: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = y.shape
    return y.view(b, t, n_head, d // n_head)


def _causal_mask(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    mask = torch.full((n, n), torch.finfo(torch.float32).min, device=device)
    return torch.triu(mask, diagonal=1).to(dtype)


class MultiHeadAttention(nn.Module):
    """q / k / v / out projections. Sharded by ``parallel.mesh``, it holds
    ``n_head`` of the model's heads (q / k / v column-parallel, out
    row-parallel) and the model ``group`` its partial outputs are summed
    over; the head dim (64 for every Whisper size) and the q / k scale
    d_h^-0.25 come from the local projection width over the local heads."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.group = None
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def self_attention(self, x: torch.Tensor, key_bias: Optional[torch.Tensor] = None,
                       int8: bool = False, seq_group=None) -> torch.Tensor:
        """Encoder self-attention of x [B, T, D] through the attention
        kernels: ``self_attention``, or ``onepass_self_attention`` when a
        ``key_bias`` [1, T] is given. ``int8`` runs the four projections
        W8A8. ``seq_group``: x holds this rank's T / m frames of the
        sequence-parallel encode; q, k and v go through the sequence ->
        heads all-to-all, so the kernels see every frame of H / m heads,
        and the output comes back by the inverse all-to-all."""
        b, t, _ = x.shape
        lin = _linear_int8 if int8 else _linear
        x = copy_to_model(x, self.group)
        q = _split_heads(lin(self.query, x), self.n_head)
        scale = q.shape[-1] ** -0.25
        q = q * scale
        k = _split_heads(lin(self.key, x), self.n_head) * scale
        v = _split_heads(lin(self.value, x), self.n_head).contiguous()
        if seq_group is not None:
            q, k, v = (seq_to_heads(y, seq_group) for y in (q, k, v))
        out = (self_attention(q, k, v) if key_bias is None
               else onepass_self_attention(q, k, v, key_bias))
        if seq_group is not None:
            out = heads_to_seq(out, seq_group)
        return _row_linear(self.out, out.reshape(b, t, -1), self.group, int8)

    def attend(self, x: torch.Tensor, xa: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decoder attention as plain matmuls (``_attention``'s einsum
        path): causal self-attention with ``mask`` [S, S], or
        cross-attention to ``xa`` [B, T, D]."""
        b, s, _ = x.shape
        x = copy_to_model(x, self.group)
        src = x if xa is None else copy_to_model(xa, self.group)
        q = _split_heads(_linear(self.query, x), self.n_head)
        scale = q.shape[-1] ** -0.25
        q = q * scale
        k = _split_heads(_linear(self.key, src), self.n_head)
        v = _split_heads(_linear(self.value, src), self.n_head)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k * scale)
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return _row_linear(self.out, out.reshape(b, s, -1), self.group)


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
        # the model group once parallel.mesh shards the MLP (fc1
        # column-parallel, fc2 row-parallel)
        self.mlp_group = None

    def _mlp(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        lin = _linear_int8 if int8 else _linear
        h = copy_to_model(_layer_norm(self.mlp_ln, x), self.mlp_group)
        return x + _row_linear(self.mlp[2], self.mlp[1](lin(self.mlp[0], h)),
                               self.mlp_group, int8)

    def encoder_forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor] = None,
                        int8: bool = False, seq_group=None) -> torch.Tensor:
        x = x + self.attn.self_attention(_layer_norm(self.attn_ln, x), key_bias, int8,
                                         seq_group)
        return self._mlp(x, int8)

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


def encoder_blocks(blocks, cfg: WhisperConfig, x: torch.Tensor, remat: bool = False,
                   seq=None) -> torch.Tensor:
    """Encoder ``blocks`` in order on the post-stem x [B, T, D], with the
    one-pass route's zero key bias unless sequence-sharded over ``seq``:
    the loop of :meth:`AudioEncoder.forward` and a pipeline stage's body."""
    key_bias = (torch.zeros((1, x.shape[1]), dtype=torch.float32, device=x.device)
                if cfg.onepass_encoder and seq is None else None)
    for block in blocks:
        x = _run_block(block.encoder_forward, remat, x, key_bias, cfg.int8_encoder, seq)
    return x


def decoder_blocks(blocks, x: torch.Tensor, xa: torch.Tensor,
                   remat: bool = False) -> torch.Tensor:
    """Decoder ``blocks`` in order on the token activations x [B, S, D]
    under the causal mask, attending to xa [B, T, D]: the loop of
    :meth:`TextDecoder.forward` and a pipeline stage's body."""
    mask = _causal_mask(x.shape[1], x.dtype, x.device)
    for block in blocks:
        x = _run_block(block.decoder_forward, remat, x, xa, mask)
    return x


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

    def forward(self, mel: torch.Tensor, remat: bool = False,
                sequence_sharding=None, run_blocks=None) -> torch.Tensor:
        """mel f32[B, n_mels, 3000] -> audio features [B, 1500, D] in the
        compute dtype. ``remat`` checkpoints each block.

        ``sequence_sharding`` (``parallel.mesh.sequence_sharding``'s group
        of m ranks) runs the sequence-parallel encode: the stem runs
        replicated, each rank keeps its T / m frames through the blocks
        (attention by the Ulysses all-to-all, which needs T and the heads
        divisible by m; the one-pass key-bias route is off, as in JAX), and
        the features are gathered back to every rank. An inference path:
        no gradient is summed over the group, so it refuses autograd.

        ``run_blocks(x, remat)`` replaces the loop over the blocks
        (:func:`encoder_blocks`); ``parallel.pipeline`` pipelines them."""
        x = self._stem(mel)
        seq = sequence_sharding
        if seq is not None:
            x = self._sequence_shard(x, seq)
        run_blocks = run_blocks or functools.partial(encoder_blocks, self.blocks, self.cfg,
                                                     seq=seq)
        x = _layer_norm(self.ln_post, run_blocks(x, remat))
        return x if seq is None else gather_dim(x, 1, seq)

    def _sequence_shard(self, x: torch.Tensor, group) -> torch.Tensor:
        m, r = dist.get_world_size(group), dist.get_rank(group)
        t, heads = x.shape[1], self.cfg.n_audio_head
        if t % m or heads % m:
            raise ValueError(f"the sequence-parallel encode needs the frames ({t}) and the "
                             f"heads ({heads}) divisible by the group's {m} ranks")
        if any(block.attn.group is not None for block in self.blocks):
            raise ValueError("the sequence-parallel encode takes a replicated encoder, "
                             "not a tensor-parallel one")
        if any(p.is_meta for p in self.blocks.parameters()):
            raise ValueError("the sequence-parallel encode takes a replicated encoder, "
                             "not a pipelined one")
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            raise ValueError("the sequence-parallel encode is an inference path; run it "
                             "under torch.no_grad()")
        return x[:, r * (t // m):(r + 1) * (t // m)]


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
        # vocab-sharded by parallel.mesh: this rank holds the embedding rows
        # [vocab_start, vocab_start + rows) and sums lookups over the group
        self.vocab_group = None
        self.vocab_start = 0

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embedding rows f32[..., D] of int ``tokens``; vocab-sharded,
        the lookup is masked to this rank's rows, then summed over the
        group (exact: one row and zeros)."""
        w = self.token_embedding.weight
        tokens = tokens.long()
        if self.vocab_group is None:
            return w[tokens]
        local = tokens - self.vocab_start
        mine = (local >= 0) & (local < w.shape[0])
        rows = w[local.clamp(0, w.shape[0] - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=w.dtype, device=w.device))
        return reduce_from_model(rows, self.vocab_group)

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        """The tied float32 unembedding, h [..., D] -> logits f32[...,
        n_vocab]; vocab-sharded, each rank's columns are gathered so that
        beam selection, the timestamp rules and the transcript CE see the
        whole vocabulary."""
        h = copy_to_model(h.to(torch.float32), self.vocab_group)
        logits = h @ self.token_embedding.weight.to(torch.float32).T
        return gather_dim(logits, -1, self.vocab_group)

    def forward(self, tokens: torch.Tensor, audio_features: torch.Tensor,
                remat: bool = False, run_blocks=None) -> torch.Tensor:
        """tokens int[B, S], audio_features [B, T, D] -> logits f32[B, S,
        n_vocab]: pre-LN blocks of causal self-attention, cross-attention
        and MLP, then the float32 unembedding by the token embedding.
        ``run_blocks(x, xa, remat)`` replaces the loop over the blocks
        (:func:`decoder_blocks`); ``parallel.pipeline`` pipelines them."""
        dtype = self.compute_dtype
        s = tokens.shape[1]
        x = self.embed(tokens).to(dtype) + self.positional_embedding[:s].to(dtype)[None]
        run_blocks = run_blocks or functools.partial(decoder_blocks, self.blocks)
        x = run_blocks(x, audio_features.to(dtype), remat)
        return self.unembed(_layer_norm(self.ln, x))


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = TextDecoder(cfg)

    def embed_audio(self, mel: torch.Tensor, remat: bool = False,
                    sequence_sharding=None) -> torch.Tensor:
        return self.encoder(mel, remat=remat, sequence_sharding=sequence_sharding)

    def decoder_logits(self, tokens: torch.Tensor, audio_features: torch.Tensor,
                       remat: bool = False) -> torch.Tensor:
        """The reference's ``whisper_model.logits(tokens, audio_features)``."""
        return self.decoder(tokens, audio_features, remat=remat)


def encode_audio(whisper: Whisper, mel: torch.Tensor, remat: bool = False,
                 sequence_sharding=None) -> torch.Tensor:
    """mel f32[B, n_mels, 3000] -> audio features [B, 1500, D] (JAX
    ``encode_audio``; ``sequence_sharding`` as :meth:`AudioEncoder.forward`)."""
    return whisper.embed_audio(mel, remat=remat, sequence_sharding=sequence_sharding)


def decoder_logits(whisper: Whisper, tokens: torch.Tensor, audio_features: torch.Tensor,
                   remat: bool = False) -> torch.Tensor:
    """Teacher-forced logits f32[B, S, n_vocab] (JAX ``decoder_logits``)."""
    return whisper.decoder_logits(tokens, audio_features, remat=remat)


@torch.no_grad()
def init_whisper_weights(whisper: Whisper, generator: torch.Generator) -> Whisper:
    """Random init of a Whisper module in place, with the JAX package's
    distributions drawn from ``generator`` (on the parameters' device):
    linear and conv weights U(+-1/sqrt(fan_in)) with zero biases, LayerNorm
    ones / zeros, token embedding N(0, 0.02), decoder positions zero."""
    for name, p in whisper.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("token_embedding.weight"):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("decoder.positional_embedding"):
            p.zero_()
        elif "_ln." in name or name.split(".")[-2] in ("ln_post", "ln"):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        else:  # linear [out, in] or conv [out, in, k]
            fan_in = p.shape[1] * (p.shape[2] if p.dim() == 3 else 1)
            p.uniform_(-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in), generator=generator)
    return whisper


def init_whisper_params(cfg: WhisperConfig, generator: torch.Generator,
                        device=None) -> Whisper:
    """What stands for JAX's ``init_whisper_params`` in the module-based
    port: a :class:`Whisper` (its parameters are the module's, not a
    returned tree) on ``device``, initialised by :func:`init_whisper_weights`
    from ``generator``."""
    with torch.device(device or "cpu"):
        whisper = Whisper(cfg)
    whisper.to(device or "cpu")  # the sinusoid buffer is made from numpy, on the CPU
    return init_whisper_weights(whisper, generator)


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


@torch.no_grad()
def int8_resident(whisper: Whisper) -> Whisper:
    """Quantise the encoder blocks' linears (q/k/v/out and both MLP layers)
    once, in place: each becomes an :class:`Int8Linear` holding the exact
    (q, scale) pair :func:`_linear_int8` would derive per call (JAX
    ``int8_resident_params``). Apply after :func:`bf16_resident`, so the
    quantisation grid is the one the dynamic path sees; meaningful only with
    ``WhisperConfig.int8_encoder``. The stem, LayerNorms and decoder stay."""
    for block in whisper.encoder.blocks:
        for parent, name in ((block.attn, "query"), (block.attn, "key"), (block.attn, "value"),
                             (block.attn, "out"), (block.mlp, "0"), (block.mlp, "2")):
            lin = getattr(parent, name)
            wq, ws = _quantize_int8(lin.weight, 1)
            setattr(parent, name, Int8Linear(wq, ws[:, 0], lin.bias))
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

    Under ``cfg.int8_cross_kv`` the cross K/V are int8 with their scales
    beside them: ``cross_k_s`` [B, T, H, 1] (per key vector, over Dh; it
    scales the key's whole logit column) and ``cross_v_s`` [B, 1, H, Dh]
    (per head and channel, over T; it factors out of the weights @ V sum).
    Under tensor parallelism H is this rank's heads (``attn.n_head``).
    """
    dtype = cfg.compute_dtype
    b = audio_features.shape[0]
    dev = audio_features.device
    xa = audio_features.to(dtype)
    cache = {"blocks": [], "step": torch.zeros((), dtype=torch.int64, device=dev),
             "length": torch.zeros((b,), dtype=torch.int64, device=dev)}
    for block in model.decoder.blocks:
        n_head = block.attn.n_head
        d_h = block.attn.query.weight.shape[0] // n_head
        ck = _split_heads(_linear(block.cross_attn.key, xa), block.cross_attn.n_head)
        cv = _split_heads(_linear(block.cross_attn.value, xa), block.cross_attn.n_head)
        extra = {}
        if cfg.int8_cross_kv:
            ck, ck_s = _quantize_int8(ck, -1)
            cv, cv_s = _quantize_int8(cv, 1)
            extra = {"cross_k_s": ck_s, "cross_v_s": cv_s}
        cache["blocks"].append({
            **extra,
            "cross_k": ck,
            "cross_v": cv,
            "prompt_k": torch.zeros((b, prompt_len, n_head, d_h), dtype=dtype, device=dev),
            "prompt_v": torch.zeros((b, prompt_len, n_head, d_h), dtype=dtype, device=dev),
            "gen_k": torch.zeros((b * beam_size, max_new_tokens, n_head, d_h),
                                 dtype=dtype, device=dev),
            "gen_v": torch.zeros((b * beam_size, max_new_tokens, n_head, d_h),
                                 dtype=dtype, device=dev),
        })
    return cache


def _grouped_cross_attention(p: MultiHeadAttention, x: torch.Tensor, bc: Dict) -> torch.Tensor:
    """Cross-attention of x [B*g, S, D] (post-LN) to a cache block's
    precomputed K/V [B, T, H, Dh], where g query rows (beams) share each
    audio row.

    With int8 K/V (``cross_k_s``/``cross_v_s`` in the block) both
    contractions run on integer values: the query quantised per query
    vector (its scale and K's per-key scales multiply the logits), the
    float32 softmax weights per (query, head) row (V's per-channel scales
    factor out of the weights @ V sum). They run as float32 einsums of those
    values (:func:`_int_einsum`), equal to JAX's int32 products, so the cache
    holds half the bytes but each step reads them widened to float32."""
    ck, cv = bc["cross_k"], bc["cross_v"]
    bg, s, _ = x.shape
    b = ck.shape[0]
    g = bg // b
    q = _split_heads(_linear(p.query, x), p.n_head)
    scale = q.shape[-1] ** -0.25
    q = q.reshape(b, g, s, p.n_head, q.shape[-1])
    if "cross_k_s" in bc:
        qq, qs = _quantize_int8(q, -1)                                # qs [b, g, s, h, 1]
        logits = _int_einsum("bgshd,bthd->bgsht", qq, ck)
        ks = bc["cross_k_s"][..., 0].permute(0, 2, 1)                 # [b, h, t]
        logits = logits * qs * ks[:, None, None] * (scale * scale)
        wq, ws = _quantize_int8(torch.softmax(logits, -1), -1)        # ws [b, g, s, h, 1]
        out = _int_einsum("bgsht,bthd->bgshd", wq, cv)
        out = (out * ws * bc["cross_v_s"][:, None]).to(x.dtype)
    else:
        logits = torch.einsum("bgshd,bthd->bgsht", q * scale, ck * scale)
        w = torch.softmax(logits.to(torch.float32), -1).to(x.dtype)
        out = torch.einsum("bgsht,bthd->bgshd", w, cv)
    return _row_linear(p.out, out.reshape(bg, s, -1), p.group)


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
    b, p = tokens.shape
    dev = tokens.device
    length = _per_sample(length, p, b, dev)
    aux_index = _per_sample(aux_index, 0, b, dev)

    x = dec.embed(tokens).to(dtype)
    x = x + dec.positional_embedding[:p].to(dtype)[None]
    mask = _causal_mask(p, dtype, dev)
    for block, bc in zip(dec.blocks, cache["blocks"]):
        n_head = block.attn.n_head
        h = _layer_norm(block.attn_ln, x)
        q = _split_heads(_linear(block.attn.query, h), n_head)
        k = _split_heads(_linear(block.attn.key, h), n_head)
        v = _split_heads(_linear(block.attn.value, h), n_head)
        scale = q.shape[-1] ** -0.25
        att = torch.einsum("bqhd,bkhd->bhqk", q * scale, k * scale) + mask
        w = torch.softmax(att.to(torch.float32), -1).to(dtype)
        attn_out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        x = x + _row_linear(block.attn.out, attn_out.reshape(b, p, -1), block.attn.group)
        x = x + _grouped_cross_attention(block.cross_attn, _layer_norm(block.cross_attn_ln, x),
                                         bc)
        x = block._mlp(x)
        bc["prompt_k"].copy_(k)
        bc["prompt_v"].copy_(v)

    x = _layer_norm(dec.ln, x)
    rows = torch.arange(b, device=dev)
    last_h = x[rows, (length - 1).clamp(0, p - 1)]
    aux_h = x[rows, aux_index.clamp(0, p - 1)]
    cache["step"].zero_()
    cache["length"] = length
    return dec.unembed(last_h), dec.unembed(aux_h), cache


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
    step, length = cache["step"], cache["length"]
    r, b = tokens.shape[0], length.shape[0]
    g = r // b
    p = cache["blocks"][0]["prompt_k"].shape[1]
    g_max = cache["blocks"][0]["gen_k"].shape[1]
    dev = tokens.device
    neg = torch.finfo(torch.float32).min

    pe = dec.positional_embedding.to(dtype)
    pos = (length.repeat_interleave(g) + step).clamp(0, pe.shape[0] - 1)
    x = dec.embed(tokens).to(dtype) + pe[pos][:, None]

    mask_p = torch.where(torch.arange(p, device=dev)[None] < length[:, None], 0.0, neg).to(dtype)
    mask_g = torch.where(torch.arange(g_max, device=dev) <= step, 0.0, neg).to(dtype)
    slot = step.clamp(max=g_max - 1).reshape(1)
    for block, bc in zip(dec.blocks, cache["blocks"]):
        n_head = block.attn.n_head
        h = _layer_norm(block.attn_ln, x)
        q = _split_heads(_linear(block.attn.query, h), n_head)
        scale = q.shape[-1] ** -0.25
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
        x = x + _row_linear(block.attn.out, attn_out.reshape(r, 1, -1), block.attn.group)
        x = x + _grouped_cross_attention(block.cross_attn, _layer_norm(block.cross_attn_ln, x),
                                         bc)
        x = block._mlp(x)

    logits = dec.unembed(_layer_norm(dec.ln, x))
    step.add_(1)
    return logits[:, 0], cache
