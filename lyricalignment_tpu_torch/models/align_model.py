"""AlignModel: Whisper backbone + frame-wise alignment head.

Port of ``lyricalignment_tpu/models/align_model.py:43-223`` for inference.
:func:`forward_from_audio` is the reference's ``frame_manual_forward``
(`module/align_model.py:84-105`): raw audio -> log-mel -> encoder, trimmed
to round(mel_len / 2) frames, with audio longer than 30 s encoded as a
batch of 30 s windows whose features are concatenated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from lyricalignment_tpu_torch import EMBED_FRAMES, N_FRAMES
from lyricalignment_tpu_torch.models.align_head import (
    AlignHead,
    align_head_apply,
    align_head_hidden,
)
from lyricalignment_tpu_torch.models.whisper import Whisper, WhisperConfig
from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim


@dataclass(frozen=True)
class AlignModelConfig:
    whisper: WhisperConfig
    hidden_dim: int = 384
    output_dim: int = 21128
    num_rnn_layers: int = 2
    bidirectional: bool = True

    @property
    def embed_dim(self) -> int:
        return self.whisper.n_audio_state


class AlignModel(nn.Module):
    """``whisper_model`` + ``align_rnn``, the reference's module names."""

    def __init__(self, cfg: AlignModelConfig):
        super().__init__()
        self.cfg = cfg
        self.whisper_model = Whisper(cfg.whisper)
        self.align_rnn = AlignHead(cfg.embed_dim, cfg.hidden_dim, cfg.output_dim,
                                   cfg.num_rnn_layers, cfg.bidirectional)


@torch.no_grad()
def init_weights(model: AlignModel, generator: torch.Generator) -> AlignModel:
    """Random init with the JAX package's distributions, drawn from
    ``generator`` (which must live on the parameters' device): linear and
    conv weights U(+-1/sqrt(fan_in)) with zero biases (the fc bias is
    uniform too), LayerNorm ones/zeros, GRU U(+-1/sqrt(H)), token embedding
    N(0, 0.02), decoder positions zero."""
    uniform = lambda p, s: p.uniform_(-s, s, generator=generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("align_rnn.rnn."):
            uniform(p, 1.0 / math.sqrt(model.cfg.hidden_dim))
        elif name == "align_rnn.fc.weight" or name == "align_rnn.fc.bias":
            uniform(p, 1.0 / math.sqrt(model.align_rnn.fc.in_features))
        elif name.endswith("token_embedding.weight"):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("decoder.positional_embedding"):
            p.zero_()
        elif "_ln." in name or name.split(".")[-2] in ("ln_post", "ln"):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        else:  # linear [out, in] or conv [out, in, k]
            fan_in = p.shape[1] * (p.shape[2] if p.dim() == 3 else 1)
            uniform(p, 1.0 / math.sqrt(fan_in))
    return model


def _half(n: int) -> int:
    """round(n / 2) with Python's banker's rounding, as the reference's
    ``int(round(mel.shape[-1] / 2.0))`` (`module/align_model.py:88,98`)."""
    return int(round(n / 2.0))


def forward_from_audio(model: AlignModel, audio: torch.Tensor,
                       frame_lengths: Optional[torch.Tensor] = None,
                       mel_lengths: Optional[torch.Tensor] = None,
                       head_output: str = "hidden") -> torch.Tensor:
    """Raw padded audio f32[B, samples] -> the align head's output at each
    encoder frame: the pre-classifier hidden f32[B, T', 2H]
    (``head_output="hidden"``, for ``viterbi_align_fused``) or the logits
    f32[B, T', C] (``"logits"``).

    ``frame_lengths`` (int[B]) masks the GRU to each sample's true encoder
    frame count; ``mel_lengths`` (int[B], default ``2 * frame_lengths``)
    zeroes the mel past each sample's true length, as the reference computes
    the mel on exact-length audio and zero-pads the mel.
    """
    cfg = model.cfg
    mel = log_mel(audio, n_mels=cfg.whisper.n_mels)         # [B, n_mels, T_mel]
    if frame_lengths is not None:
        if mel_lengths is None:
            mel_lengths = 2 * frame_lengths
        t_idx = torch.arange(mel.shape[-1], device=mel.device)
        keep = t_idx[None, None, :] < mel_lengths.to(mel.device)[:, None, None]
        mel = torch.where(keep, mel, torch.zeros((), dtype=mel.dtype, device=mel.device))
    t_mel = mel.shape[-1]
    encoder = model.whisper_model.encoder

    if t_mel <= N_FRAMES:
        embed = encoder(pad_or_trim(mel, N_FRAMES))
        align_embed = embed[:, : _half(t_mel)]
    else:
        # >30 s: every window goes through the encoder in one batch
        b, n_mels = mel.shape[:2]
        n_chunks = -(-t_mel // N_FRAMES)
        windows = pad_or_trim(mel, n_chunks * N_FRAMES).reshape(b, n_mels, n_chunks, N_FRAMES)
        windows = windows.permute(0, 2, 1, 3).reshape(b * n_chunks, n_mels, N_FRAMES)
        embeds = encoder(windows).reshape(b, n_chunks, EMBED_FRAMES, -1)
        # full windows keep all 1500 frames, the last round(remainder / 2)
        last_len = _half(t_mel - (n_chunks - 1) * N_FRAMES)
        parts = [embeds[:, i] for i in range(n_chunks - 1)] + [embeds[:, -1, :last_len]]
        align_embed = torch.cat(parts, dim=1)

    head_fn = {"hidden": align_head_hidden, "logits": align_head_apply}[head_output]
    return head_fn(model.align_rnn, align_embed, frame_lengths)
