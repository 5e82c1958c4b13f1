"""AlignModel: Whisper backbone + frame-wise alignment head.

Port of ``lyricalignment_tpu/models/align_model.py:43-223``.
:func:`forward_from_audio` is the reference's ``frame_manual_forward``
(`module/align_model.py:84-121`): raw audio -> log-mel -> encoder, trimmed
to round(mel_len / 2) frames, with audio longer than 30 s encoded as a
batch of 30 s windows whose features are concatenated; or, for training
(``trim_to_input_length=False``), one 30 s window with all 1500 frames.
The align head and the teacher-forced decoder read the encoder features.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from lyricalignment_tpu_torch import EMBED_FRAMES, N_FRAMES
from lyricalignment_tpu_torch.models.align_head import (
    AlignHead,
    align_head_apply,
    align_head_hidden,
)
from lyricalignment_tpu_torch.models.whisper import (
    Whisper,
    WhisperConfig,
    decoder_logits,
    encode_audio,
    init_whisper_weights,
)
from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim


@dataclass(frozen=True)
class AlignModelConfig:
    whisper: WhisperConfig
    hidden_dim: int = 384
    output_dim: int = 21128
    num_rnn_layers: int = 2
    bidirectional: bool = True
    dropout: float = 0.1
    freeze_encoder: bool = False
    train_alignment: bool = True
    train_transcript: bool = False

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
def init_head_weights(head: AlignHead, generator: torch.Generator) -> AlignHead:
    """The head's part of :func:`init_weights`: GRU U(+-1/sqrt(H)), fc
    weight and bias U(+-1/sqrt(fan_in)), drawn from ``generator`` in
    parameter order."""
    for name, p in head.named_parameters():
        fan = head.rnn.hidden_size if name.startswith("rnn.") else head.fc.in_features
        p.uniform_(-1.0 / math.sqrt(fan), 1.0 / math.sqrt(fan), generator=generator)
    return head


@torch.no_grad()
def init_weights(model: AlignModel, generator: torch.Generator) -> AlignModel:
    """Random init with the JAX package's distributions, drawn from
    ``generator`` (which must live on the parameters' device): the backbone
    (:func:`~lyricalignment_tpu_torch.models.whisper.init_whisper_weights`),
    then the head (:func:`init_head_weights`)."""
    init_whisper_weights(model.whisper_model, generator)
    init_head_weights(model.align_rnn, generator)
    return model


def _half(n: int) -> int:
    """round(n / 2) with Python's banker's rounding, as the reference's
    ``int(round(mel.shape[-1] / 2.0))`` (`module/align_model.py:88,98`)."""
    return int(round(n / 2.0))


def forward_from_audio(
    model: AlignModel,
    audio: torch.Tensor,
    y_in: Optional[torch.Tensor] = None,
    trim_to_input_length: bool = True,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
    frame_lengths: Optional[torch.Tensor] = None,
    mel_lengths: Optional[torch.Tensor] = None,
    align_head_output: str = "logits",
    dropout_rows: Optional[Tuple[int, int]] = None,
    encode_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Raw padded audio f32[B, samples] (+ decoder input tokens ``y_in``
    int[B, S]) -> ``(align_out, transcribe_logits)``.

    ``align_out`` (when ``cfg.train_alignment``) is the align head's output
    at each encoder frame: the logits f32[B, T', C]
    (``align_head_output="logits"``) or the pre-classifier hidden
    f32[B, T', 2H] (``"hidden"``, for ``viterbi_align_fused``).
    ``transcribe_logits`` f32[B, S, n_vocab] comes from the teacher-forced
    decoder when ``cfg.train_transcript`` and ``y_in`` is given.

    ``trim_to_input_length=False`` is training: one 30 s window, all 1500
    frames. ``frame_lengths`` (int[B]) masks the GRU to each sample's true
    encoder frame count; ``mel_lengths`` (int[B], default
    ``2 * frame_lengths``) zeroes the mel past each sample's true length, as
    the reference computes the mel on exact-length audio and zero-pads the
    mel. ``generator`` draws the head's dropout (none without one), of
    rows ``dropout_rows`` (start, total) of a sharded batch's mask if given;
    ``remat`` checkpoints every transformer block. Under
    ``cfg.freeze_encoder`` the encoder runs under ``torch.no_grad()``, so
    its backward never runs.

    ``encode_fn`` replaces the encoder on every branch, with
    ``encode_audio``'s calling convention ``(whisper, mel, remat=...)``, and
    ``decode_fn`` the teacher-forced decoder, with ``decoder_logits``'
    ``(whisper, tokens, audio_features, remat=...)``: the pipelined ones of
    ``parallel.pipeline.make_pipeline_encode_fn`` / ``make_pipeline_logits_fn``.
    """
    cfg = model.cfg
    whisper = model.whisper_model
    encode_fn = encode_fn or encode_audio
    decode_fn = decode_fn or decoder_logits
    frozen = torch.no_grad() if cfg.freeze_encoder else contextlib.nullcontext()
    with frozen:
        mel = log_mel(audio, n_mels=cfg.whisper.n_mels)         # [B, n_mels, T_mel]
        if frame_lengths is not None:
            if mel_lengths is None:
                mel_lengths = 2 * frame_lengths
            t_idx = torch.arange(mel.shape[-1], device=mel.device)
            keep = t_idx[None, None, :] < mel_lengths.to(mel.device)[:, None, None]
            mel = torch.where(keep, mel, torch.zeros((), dtype=mel.dtype, device=mel.device))
        t_mel = mel.shape[-1]

        if not trim_to_input_length or t_mel <= N_FRAMES:
            embed = encode_fn(whisper, pad_or_trim(mel, N_FRAMES), remat=remat)
            embed_for_decoder = embed
            align_embed = embed[:, : _half(t_mel)] if trim_to_input_length else embed
        else:
            # >30 s: every window goes through the encoder in one batch
            b, n_mels = mel.shape[:2]
            n_chunks = -(-t_mel // N_FRAMES)
            windows = pad_or_trim(mel, n_chunks * N_FRAMES).reshape(b, n_mels, n_chunks, N_FRAMES)
            windows = windows.permute(0, 2, 1, 3).reshape(b * n_chunks, n_mels, N_FRAMES)
            embeds = encode_fn(whisper, windows, remat=remat).reshape(b, n_chunks, EMBED_FRAMES, -1)
            # full windows keep all 1500 frames, the last round(remainder / 2)
            last_len = _half(t_mel - (n_chunks - 1) * N_FRAMES)
            parts = [embeds[:, i] for i in range(n_chunks - 1)] + [embeds[:, -1, :last_len]]
            align_embed = torch.cat(parts, dim=1)
            embed_for_decoder = align_embed[:, :EMBED_FRAMES]

    align_out = None
    if cfg.train_alignment:
        head_fn = {"hidden": align_head_hidden, "logits": align_head_apply}[align_head_output]
        align_out = head_fn(model.align_rnn, align_embed, frame_lengths, cfg.dropout, generator,
                            dropout_rows)
    transcribe_logits = None
    if cfg.train_transcript and y_in is not None:
        transcribe_logits = decode_fn(whisper, y_in, embed_for_decoder, remat=remat)
    return align_out, transcribe_logits
