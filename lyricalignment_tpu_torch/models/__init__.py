"""Whisper backbone under the JAX package's names. The port's Whisper is a
module, so ``init_whisper_params`` returns an initialised ``Whisper`` (its
parameters are the module's) where JAX returns a parameter tree;
``encode_audio`` and ``decoder_logits`` take the module in place of
(params, cfg)."""

from lyricalignment_tpu_torch.models.whisper import (
    WHISPER_CONFIGS,
    WhisperConfig,
    decoder_logits,
    encode_audio,
    init_whisper_params,
)

__all__ = [
    "WhisperConfig",
    "WHISPER_CONFIGS",
    "init_whisper_params",
    "encode_audio",
    "decoder_logits",
]
