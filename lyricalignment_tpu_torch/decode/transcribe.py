"""Transcription quality battery: sampling, temperature fallback, no-speech.

Port of ``lyricalignment_tpu/decode/transcribe.py``. The reference relies
on whisper's ``model.transcribe`` defaults (`inference_transcript.py:88-91`),
which wrap the core decoder in quality gates: decode with beam search at
temperature 0, and if the result is degenerate (compression ratio > 2.4 or
average logprob < -1.0), retry with sampling at increasing temperatures
(0.2 ... 1.0); segments whose <|nospeech|> probability exceeds 0.6 while the
logprob is poor are emitted empty. The retry ladder runs on the host, each
rung is one decode on the device, and each sampled rung draws from a
``torch.Generator`` seeded ``seed + int(temperature * 10)``, as JAX keys it.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import torch

from lyricalignment_tpu_torch.decode.beam import beam_search, make_processor, sample_loop
from lyricalignment_tpu_torch.models.whisper import (
    Whisper,
    WhisperConfig,
    decode_step,
    init_decode_cache,
    prime_decode_cache,
)

COMPRESSION_RATIO_THRESHOLD = 2.4
LOGPROB_THRESHOLD = -1.0
NO_SPEECH_THRESHOLD = 0.6
TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def sample_decode(
    model: Whisper,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,
    prompt: torch.Tensor,
    generator: torch.Generator,
    temperature: float = 1.0,
    max_new_tokens: int = 224,
    eot: int = 50257,
    suppress_ids: tuple = (),
    begin_suppress_ids: tuple = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature sampling; returns (tokens [B, max_new], sum_logprob [B])."""
    cache = init_decode_cache(model, cfg, audio_features, prompt.shape[1], max_new_tokens)
    logits, _, cache = prime_decode_cache(model, cfg, prompt, cache)
    process = make_processor(cfg, eot, suppress_ids, begin_suppress_ids,
                             device=audio_features.device)
    return sample_loop(model, cfg, logits, cache, process, generator, temperature,
                       max_new_tokens, eot)


def no_speech_probs(
    model: Whisper,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,
    sot: int,
    no_speech: int,
) -> torch.Tensor:
    """P(<|nospeech|>) at the sot position (whisper's no-speech detector)."""
    cache = init_decode_cache(model, cfg, audio_features, 0, 1)
    sot_tok = torch.full((audio_features.shape[0], 1), sot, dtype=torch.int64,
                         device=audio_features.device)
    logits, _ = decode_step(model, cfg, sot_tok, cache)
    return torch.softmax(logits, dim=-1)[:, no_speech]


def decode_with_fallback(
    model: Whisper,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,
    prompt: torch.Tensor,
    tokenizer,
    beam_size: int = 5,
    max_new_tokens: int = 224,
    temperatures: Tuple[float, ...] = TEMPERATURES,
    seed: int = 0,
    suppress_ids: tuple = (),
    begin_suppress_ids: tuple = (),
    group: int = 1,
) -> List[Dict]:
    """whisper's DecodingOptions fallback ladder over a batch.

    Returns per-sample dicts: {tokens, text, avg_logprob, no_speech_prob,
    compression_ratio, temperature}.
    """
    b = audio_features.shape[0]
    eot = tokenizer.eot
    dev = audio_features.device
    ns_prob = no_speech_probs(model, cfg, audio_features, tokenizer.sot,
                              tokenizer.no_speech).cpu().numpy()

    results: List[Optional[Dict]] = [None] * b
    pending = list(range(b))

    for temperature in temperatures:
        if not pending:
            break
        rows = torch.tensor(pending, device=dev)
        xa = audio_features.index_select(0, rows)
        pr = prompt.index_select(0, rows)
        if temperature == 0.0:
            tokens, scores = beam_search(model, cfg, xa, pr, beam_size=beam_size,
                                         max_new_tokens=max_new_tokens, eot=eot,
                                         suppress_ids=suppress_ids,
                                         begin_suppress_ids=begin_suppress_ids,
                                         group=group)
            tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
        else:
            generator = torch.Generator(device=dev).manual_seed(seed + int(temperature * 10))
            tokens, sum_lp = sample_decode(
                model, cfg, xa, pr, generator, temperature=temperature,
                max_new_tokens=max_new_tokens, eot=eot, suppress_ids=suppress_ids,
                begin_suppress_ids=begin_suppress_ids)
            tokens, sum_lp = tokens.cpu().numpy(), sum_lp.cpu().numpy()
            lengths = (tokens != eot).sum(axis=1) + 1
            scores = sum_lp / lengths

        still_pending = []
        for row, sample in enumerate(pending):
            toks = [int(t) for t in tokens[row] if int(t) != eot]
            text = tokenizer.decode(toks) if tokenizer.has_bpe else " ".join(map(str, toks))
            cr = compression_ratio(text)
            ok = cr <= COMPRESSION_RATIO_THRESHOLD and scores[row] >= LOGPROB_THRESHOLD
            # whisper: confidently-silent samples do not retry (the
            # no-speech gate silences them below)
            ok = ok or ns_prob[sample] > NO_SPEECH_THRESHOLD
            results[sample] = {
                "tokens": toks, "text": text, "avg_logprob": float(scores[row]),
                "no_speech_prob": float(ns_prob[sample]),
                "compression_ratio": cr, "temperature": temperature,
            }
            if not ok and temperature != temperatures[-1]:
                still_pending.append(sample)  # best so far; may be overwritten
        pending = still_pending

    # whisper: silence segments with high no-speech prob AND poor logprob
    for entry in results:
        if (entry["no_speech_prob"] > NO_SPEECH_THRESHOLD
                and entry["avg_logprob"] < LOGPROB_THRESHOLD):
            entry["text"] = ""
            entry["tokens"] = []
    return results
