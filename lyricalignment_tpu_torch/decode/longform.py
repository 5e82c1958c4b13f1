"""Long-form transcription: whisper's seek loop around the decode loops.

Port of ``lyricalignment_tpu/decode/longform.py``. The reference
transcribes every song with ``model.transcribe(..., beam_size=5)``
(`inference_transcript.py:88-91`): audio of any length is walked 30 s
window by 30 s window, each window decoded with timestamp rules, each next
window conditioned on the previous text through a ``<|startofprev|>``
prompt, and the seek offset advanced to the last complete timestamp pair.

- the host drives only the seek loop (inherently sequential);
- the song's log-mel is computed once on the device, over the whole song
  padded to whole 30 s windows plus one (``_prep_mel``), and each window is
  a device slice of it (``_gather_window``);
- each window is one decode: the conditioned prompt is primed in a single
  batched forward (``prime_decode_cache``) into a fixed ``P_MAX``-slot
  buffer, then the beam, greedy or sampling loop runs with timestamp rules
  (``decode.timestamps``);
- whisper's quality gates (temperature fallback on compression ratio /
  avg-logprob, no-speech skip) run per window on the host, as
  ``decode.transcribe`` does for the 30 s path.

Deviations from whisper, as in the JAX package (both strictly safer):
- generation is capped at ``n_text_ctx - P_MAX`` new tokens (221 at the
  standard 448 context) instead of 224, so a full-length conditioning
  prompt can never overflow the positional-embedding table;
- a window whose parsed seek advance is <= 0 (possible with a degenerate
  zero-duration timestamp pair) advances by the full window instead of
  hanging.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lyricalignment_tpu_torch import HOP_LENGTH, N_FRAMES, N_SAMPLES
from lyricalignment_tpu_torch.decode.beam import (
    beam_loop,
    greedy_loop,
    make_processor,
    sample_loop,
)
from lyricalignment_tpu_torch.decode.timestamps import parse_segments
from lyricalignment_tpu_torch.decode.transcribe import (
    COMPRESSION_RATIO_THRESHOLD,
    LOGPROB_THRESHOLD,
    NO_SPEECH_THRESHOLD,
    TEMPERATURES,
    compression_ratio,
)
from lyricalignment_tpu_torch.models.whisper import (
    Whisper,
    WhisperConfig,
    init_decode_cache,
    prime_decode_cache,
)
from lyricalignment_tpu_torch.ops.mel import log_mel


def _device(model: Whisper) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _encode(model: Whisper, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    return model.embed_audio(mel)


def _primed(model, cfg, xa, prompt, length, sot_index, max_new_tokens, no_speech,
            eot, suppress_ids, begin_suppress_ids, ts_begin, beam_size=1):
    """Cache primed with the conditioned prompts, first-position logits,
    the no-speech probability read at each sample's sot, and the
    timestamp-rule processor."""
    cache = init_decode_cache(model, cfg, xa, prompt.shape[1], max_new_tokens,
                              beam_size=beam_size)
    logits, aux, cache = prime_decode_cache(model, cfg, prompt, cache, length,
                                            aux_index=sot_index)
    ns_prob = torch.softmax(aux, dim=-1)[:, no_speech]
    process = make_processor(cfg, eot, suppress_ids, begin_suppress_ids,
                             timestamp_rules=True, ts_begin=ts_begin, device=xa.device)
    return cache, logits, ns_prob, process


def _beam_window(model, cfg, xa, prompt, length, sot_index,
                 beam_size, max_new_tokens, eot, no_speech,
                 suppress_ids, begin_suppress_ids, ts_begin,
                 length_penalty=None, patience=None, group=1):
    """One window: prime the conditioned prompt, then beam search with
    timestamp rules.

    ``prompt`` is [B, P] (one row per sample, shared by its beams);
    ``length``/``sot_index`` are ints or int[B] (per-row conditioned
    prompts: the lockstep batched path). Returns (tokens [B, max_new],
    score [B], no_speech_prob [B])."""
    cache, logits, ns_prob, process = _primed(
        model, cfg, xa, prompt, length, sot_index, max_new_tokens, no_speech, eot,
        suppress_ids, begin_suppress_ids, ts_begin, beam_size=beam_size)
    tokens, score = beam_loop(model, cfg, logits.repeat_interleave(beam_size, dim=0), cache,
                              process, beam_size, max_new_tokens, eot, length_penalty,
                              patience, group=group)
    return tokens, score, ns_prob


def _greedy_window(model, cfg, xa, prompt, length, sot_index,
                   max_new_tokens, eot, no_speech,
                   suppress_ids, begin_suppress_ids, ts_begin):
    cache, logits, ns_prob, process = _primed(
        model, cfg, xa, prompt, length, sot_index, max_new_tokens, no_speech, eot,
        suppress_ids, begin_suppress_ids, ts_begin)
    tokens, sum_lp = greedy_loop(model, cfg, logits, cache, process, max_new_tokens, eot)
    return tokens, sum_lp, ns_prob


def _sample_window(model, cfg, xa, prompt, length, sot_index, generator,
                   temperature, max_new_tokens, eot, no_speech,
                   suppress_ids, begin_suppress_ids, ts_begin):
    cache, logits, ns_prob, process = _primed(
        model, cfg, xa, prompt, length, sot_index, max_new_tokens, no_speech, eot,
        suppress_ids, begin_suppress_ids, ts_begin)
    tokens, sum_lp = sample_loop(model, cfg, logits, cache, process, generator,
                                 temperature, max_new_tokens, eot)
    return tokens, sum_lp, ns_prob


def _fetch(*tensors) -> Tuple[np.ndarray, ...]:
    return tuple(t.cpu().numpy() for t in tensors)


def _render(tokenizer, toks: Sequence[int]) -> str:
    text_toks = [int(t) for t in toks if int(t) < tokenizer.eot]
    if tokenizer.has_bpe:
        return tokenizer.decode(text_toks)
    return " ".join(map(str, text_toks))


# ---------------------------------------------------------------------------
# Per-window bookkeeping shared by the single-song and lockstep-batched
# loops (the gate evaluation, prompt construction and seek/segment updates
# live here once, so the two loops cannot drift apart)
# ---------------------------------------------------------------------------


def _context_budget(cfg, sot_seq, condition_on_previous_text,
                    max_new_tokens) -> Tuple[int, int, int]:
    """(max_prev, p_max, max_new_tokens): static prompt buffer size and the
    clamped generation budget — prompt + generation never indexes past the
    positional-embedding table."""
    max_prev = max(cfg.n_text_ctx // 2 - 1, 0)
    p_max = (1 + max_prev + len(sot_seq) if condition_on_previous_text
             else len(sot_seq))
    ctx_cap = min(cfg.n_text_ctx // 2, cfg.n_text_ctx - p_max)
    max_new_tokens = (ctx_cap if max_new_tokens is None
                      else min(max_new_tokens, ctx_cap))
    if max_new_tokens < 1:
        raise ValueError(
            f"decoder context {cfg.n_text_ctx} too small for conditioned "
            f"prompts ({p_max} slots)")
    return max_prev, p_max, max_new_tokens


def _new_song_state(ri: int, mel, frames: int) -> Dict:
    return {"ri": ri, "mel": mel, "frames": frames, "seek": 0,
            "tokens": [], "reset_since": 0, "segments": []}


def _conditioned_prompt(tokenizer, sot_seq, st: Dict,
                        condition_on_previous_text: bool,
                        max_prev: int) -> List[int]:
    """<|startofprev|> + tail of the un-reset history + sot sequence."""
    prev = st["tokens"][st["reset_since"]:]
    if condition_on_previous_text and prev:
        return [tokenizer.sot_prev] + prev[-max_prev:] + sot_seq
    return list(sot_seq)


def _candidate(tokenizer, tok_row, score: float, temperature: float,
               eot: int) -> Dict:
    """One decoded window as a quality-gateable candidate."""
    toks = [int(t) for t in tok_row if int(t) != eot]
    return {
        "tokens": toks,
        "avg_logprob": score,
        "compression_ratio": compression_ratio(_render(tokenizer, toks)),
        "temperature": temperature,
    }


def _settles(result: Dict, ns_prob: Optional[float],
             compression_ratio_threshold: float, logprob_threshold: float,
             no_speech_threshold: float) -> bool:
    """whisper's temperature-fallback stop rule: accept when both quality
    gates pass, or when the window is confidently silent (the no-speech
    gate will skip it — no retry)."""
    if (result["compression_ratio"] <= compression_ratio_threshold
            and result["avg_logprob"] >= logprob_threshold):
        return True
    return ns_prob is not None and ns_prob > no_speech_threshold


def _apply_window_result(st: Dict, result: Dict, ns_prob: Optional[float],
                         segment_size: int, tokenizer, ts_begin: int,
                         eot: int, logprob_threshold: float,
                         no_speech_threshold: float,
                         condition_on_previous_text: bool,
                         verbose: bool, tag: str = "") -> None:
    """whisper's post-decode bookkeeping for one window: no-speech skip,
    timestamp parsing, segment annotation, history/prompt-reset update,
    seek advance. Mutates ``st``."""
    should_skip = ns_prob is not None and ns_prob > no_speech_threshold
    if result["avg_logprob"] > logprob_threshold:
        should_skip = False  # confident decode overrides the silence gate
    if should_skip:
        st["seek"] += segment_size
        return
    segs, advance = parse_segments(
        result["tokens"], st["seek"], segment_size, ts_begin=ts_begin)
    if advance <= 0:
        advance = segment_size
    for s in segs:
        s["text"] = _render(tokenizer, s["tokens"])
        s["temperature"] = result["temperature"]
        s["avg_logprob"] = result["avg_logprob"]
        s["no_speech_prob"] = ns_prob
        s["compression_ratio"] = result["compression_ratio"]
    st["segments"].extend(segs)
    st["tokens"].extend(t for s in segs for t in s["tokens"] if t < eot)
    if not condition_on_previous_text or result["temperature"] > 0.5:
        st["reset_since"] = len(st["tokens"])
    if verbose:
        for s in segs:
            print(f"{tag}[{s['start']:7.2f} -> {s['end']:7.2f}] {s['text']}")
    st["seek"] += advance


def _final_result(st: Dict, tokenizer) -> Dict:
    return {
        "text": "".join(s["text"] for s in st["segments"]),
        "segments": st["segments"],
        "language": tokenizer.language,
    }


def _window_decode(model, cfg, xa, prompt, length, sot_index, temperature, generator,
                   beam_size, max_new_tokens, eot, no_speech, suppress_ids,
                   begin_suppress_ids, ts_begin, length_penalty, patience, decode_group):
    """One temperature attempt over a batch of windows: (tokens [B, T],
    scores f64[B], no-speech probabilities [B]) on the host. Beam scores
    are whisper's avg_logprob; greedy and sampled ones are sum_logprob over
    the generated length plus one."""
    if temperature == 0.0 and beam_size > 1:
        tokens, score, ns = _beam_window(
            model, cfg, xa, prompt, length, sot_index, beam_size, max_new_tokens, eot,
            no_speech, suppress_ids, begin_suppress_ids, ts_begin,
            length_penalty, patience, group=decode_group)
        tok_np, score_np, ns_np = _fetch(tokens, score, ns)
        return tok_np, np.asarray(score_np, np.float64), ns_np
    if temperature == 0.0:
        tokens, sum_lp, ns = _greedy_window(
            model, cfg, xa, prompt, length, sot_index, max_new_tokens, eot, no_speech,
            suppress_ids, begin_suppress_ids, ts_begin)
    else:
        tokens, sum_lp, ns = _sample_window(
            model, cfg, xa, prompt, length, sot_index, generator, temperature,
            max_new_tokens, eot, no_speech, suppress_ids, begin_suppress_ids, ts_begin)
    tok_np, sum_lp_np, ns_np = _fetch(tokens, sum_lp, ns)
    n_gen = np.maximum((tok_np != eot).sum(axis=1) + 1, 1)
    return tok_np, np.asarray(sum_lp_np, np.float64) / n_gen, ns_np


def transcribe_longform(
    model: Whisper,
    cfg: WhisperConfig,
    audio: np.ndarray,
    tokenizer,
    *,
    beam_size: int = 5,
    temperatures: Tuple[float, ...] = TEMPERATURES,
    condition_on_previous_text: bool = True,
    suppress_ids: tuple = (),
    begin_suppress_ids: tuple = (),
    length_penalty: Optional[float] = None,
    patience: Optional[float] = None,
    max_new_tokens: Optional[int] = None,
    compression_ratio_threshold: float = COMPRESSION_RATIO_THRESHOLD,
    logprob_threshold: float = LOGPROB_THRESHOLD,
    no_speech_threshold: float = NO_SPEECH_THRESHOLD,
    seed: int = 0,
    verbose: bool = False,
    decode_group: int = 1,
) -> Dict:
    """Transcribe audio of arbitrary length with whisper's sequential seek,
    on the model's device.

    Returns {"text", "segments": [{start, end, text, tokens, temperature,
    avg_logprob, no_speech_prob, compression_ratio}], "language"}.
    """
    eot = tokenizer.eot
    ts_begin = tokenizer.timestamp_begin
    no_speech = tokenizer.no_speech
    sot_seq = list(tokenizer.sot_sequence)  # timestamp mode: no <|notimestamps|>
    dev = _device(model)

    max_prev, p_max, max_new_tokens = _context_budget(
        cfg, sot_seq, condition_on_previous_text, max_new_tokens)

    mel, content_frames = _prep_mel(audio, cfg.n_mels, dev)   # device f32[M, T']
    st = _new_song_state(0, mel, content_frames)

    while st["seek"] < content_frames:
        segment_size = min(N_FRAMES, content_frames - st["seek"])
        # whole-window padding guarantees the slice never runs short
        xa = _encode(model, cfg, _gather_window(mel, st["seek"])[None])

        ptoks = _conditioned_prompt(tokenizer, sot_seq, st,
                                    condition_on_previous_text, max_prev)
        buf = np.full((1, p_max), eot, np.int64)
        buf[0, : len(ptoks)] = ptoks
        prompt = torch.from_numpy(buf).to(dev)
        length, sot_index = len(ptoks), len(ptoks) - len(sot_seq)

        ns_prob = None
        result = None
        for temperature in temperatures:
            generator = None
            if temperature > 0.0:
                generator = torch.Generator(device=dev).manual_seed(
                    seed + int(temperature * 10) + st["seek"])
            tok_np, scores, ns_np = _window_decode(
                model, cfg, xa, prompt, length, sot_index, temperature, generator,
                beam_size, max_new_tokens, eot, no_speech, suppress_ids,
                begin_suppress_ids, ts_begin, length_penalty, patience, decode_group)
            if ns_prob is None:
                ns_prob = float(ns_np[0])
            result = _candidate(tokenizer, tok_np[0], float(scores[0]), temperature, eot)
            if _settles(result, ns_prob, compression_ratio_threshold,
                        logprob_threshold, no_speech_threshold):
                break

        _apply_window_result(
            st, result, ns_prob, segment_size, tokenizer, ts_begin, eot,
            logprob_threshold, no_speech_threshold,
            condition_on_previous_text, verbose)

    return _final_result(st, tokenizer)


def _gather_window(mel: torch.Tensor, seek: int) -> torch.Tensor:
    """The 30 s window at mel frame ``seek``: a slice of the song's mel
    f32[M, T'] on its device -> f32[M, N_FRAMES]."""
    return mel[:, seek: seek + N_FRAMES]


@torch.no_grad()
def _prep_mel(audio, n_mels: int = 80, device=None) -> Tuple[torch.Tensor, int]:
    """Whole-window-bucketed log-mel for one song: (mel f32[n_mels, T'] on
    ``device``, content frames). The audio is padded to whole 30 s windows
    plus one, so T' >= content_frames + N_FRAMES and a window slice never
    runs short; a 70 s song is a 120 s (12,000-frame) log-mel.

    ``audio`` may already be a prepared ``(mel, content_frames)`` pair from
    ``prepare_longform_audio``: returned as-is."""
    if isinstance(audio, tuple):
        return audio
    audio = np.asarray(audio, np.float32).reshape(-1)
    content_frames = len(audio) // HOP_LENGTH
    padded_len = ((len(audio) + N_SAMPLES) + N_SAMPLES - 1) // N_SAMPLES * N_SAMPLES
    padded = np.zeros((padded_len,), np.float32)
    padded[: len(audio)] = audio
    host = torch.from_numpy(padded)
    if device is not None and torch.device(device).type == "cuda":
        host = host.pin_memory()   # an asynchronous upload on the current stream
    return (log_mel(host.to(device, non_blocking=True), n_mels=n_mels),
            content_frames)


def prepare_longform_audio(audio: np.ndarray, n_mels: int = 80,
                           device="cuda") -> Tuple[torch.Tensor, int]:
    """Stage one song for ``transcribe_longform_batched``: its log-mel on
    ``device``, as an opaque ``(mel, content_frames)`` pair accepted
    anywhere an audio array is. Pass the model's ``cfg.n_mels`` for
    128-band (large-v3 family) backbones."""
    return _prep_mel(audio, n_mels, torch.device(device))


class _Turns:
    """Round-robin turns of the live groups of the batched loop, in group
    order: JAX's host loop (``process`` of each group with a pending attempt
    in turn). Whatever touches the shared song state (the queue, the
    prefetch pool, the results) runs in the group's turn, so songs reach
    slots in JAX's order whatever the threads' timing; the decodes between
    turns run at once. A failed group stops every other at its next turn."""

    def __init__(self, n: int):
        self._cond = threading.Condition()
        self._order = list(range(n))
        self._at = 0
        self.error: Optional[BaseException] = None

    def wait(self, gi: int) -> None:
        with self._cond:
            self._cond.wait_for(lambda: self.error is not None
                                or self._order[self._at] == gi)
            if self.error is not None:
                raise _Stopped

    def pass_on(self, stay: bool) -> None:
        """End the current turn; ``stay`` False takes its group out."""
        with self._cond:
            if stay:
                self._at += 1
            else:
                self._order.pop(self._at)
            self._at = self._at % len(self._order) if self._order else 0
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cond:
            if self.error is None:
                self.error = exc
            self._cond.notify_all()


class _Stopped(Exception):
    """Raised in a group whose call failed in another group."""


def _stream_scope(dev: torch.device, stream) -> contextlib.ExitStack:
    """Gradients off and, on CUDA, ``dev`` and ``stream`` current: each is
    per thread, and the kernels launch on the thread's current stream."""
    scope = contextlib.ExitStack()
    scope.enter_context(torch.no_grad())
    if dev.type == "cuda":
        scope.enter_context(torch.cuda.device(dev))
        scope.enter_context(torch.cuda.stream(stream))
    return scope


def transcribe_longform_batched(
    model: Whisper,
    cfg: WhisperConfig,
    audios: Sequence[np.ndarray],
    tokenizer,
    *,
    batch_size: Optional[int] = None,
    beam_size: int = 5,
    temperatures: Tuple[float, ...] = TEMPERATURES,
    condition_on_previous_text: bool = True,
    suppress_ids: tuple = (),
    begin_suppress_ids: tuple = (),
    length_penalty: Optional[float] = None,
    patience: Optional[float] = None,
    max_new_tokens: Optional[int] = None,
    compression_ratio_threshold: float = COMPRESSION_RATIO_THRESHOLD,
    logprob_threshold: float = LOGPROB_THRESHOLD,
    no_speech_threshold: float = NO_SPEECH_THRESHOLD,
    seed: int = 0,
    verbose: bool = False,
    overlap_groups: int = 1,
    decode_group: int = 1,
) -> List[Dict]:
    """Transcribe many long songs in lockstep: one batched decode per round.

    B songs advance their seek loops together: each round gathers one 30 s
    window per active song (each at its own seek offset, with its own
    conditioned-prompt length: per-row positions in the KV cache), encodes
    and decodes them as one batch, then applies whisper's seek, timestamp
    and quality-gate bookkeeping per row on the host. A song that finishes
    hands its slot to the next queued song (continuous batching).

    ``overlap_groups=G`` runs G independent lockstep groups of
    ``batch_size`` slots each, every group in a thread of its own with a
    CUDA stream of its own: while one group waits on its decode, the others
    launch theirs and do their host bookkeeping (each decode loop reads a
    flag back every few steps, so one host thread would run the groups one
    after another). Songs reach the groups in JAX's round-robin order
    (:class:`_Turns`), and a pool loads the next ``2 G`` queued songs'
    log-mels ahead, on a side stream from pinned memory. Per-song results
    are identical for any G at the deterministic temperatures (rows are
    batch-independent); G = 1 is the same code with one group.

    Per-row semantics are token-for-token those of ``transcribe_longform``
    for the deterministic temperatures; sampled retries (temperature > 0)
    draw from a batch-shared generator seeded on (seed, temperature, round
    x G + group), JAX's key, instead of the single-song (seed, temperature,
    seek), so individual sampled retries may differ.

    An error in any group fails the call, after every group has stopped.
    Returns one result dict per input song, in input order.
    """
    eot = tokenizer.eot
    ts_begin = tokenizer.timestamp_begin
    no_speech = tokenizer.no_speech
    sot_seq = list(tokenizer.sot_sequence)
    dev = _device(model)

    max_prev, p_max, max_new_tokens = _context_budget(
        cfg, sot_seq, condition_on_previous_text, max_new_tokens)

    n_songs = len(audios)
    bsz = batch_size if batch_size is not None else min(8, max(n_songs, 1))
    n_groups = max(1, overlap_groups)
    results: List[Optional[Dict]] = [None] * n_songs
    queue = list(range(n_songs))
    cuda = dev.type == "cuda"
    caller = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(device=dev) if cuda else None

    # the prefetch pool: idx -> (mel, content frames, event the mel is
    # ready at); read and written in the groups' turns only
    prefetched: Dict[int, tuple] = {}
    n_prefetch = 2 * n_groups

    def _load(idx: int) -> tuple:
        with _stream_scope(dev, side):
            mel, frames = _prep_mel(audios[idx], cfg.n_mels, dev)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(side)
        return mel, frames, ready

    def _prefetch() -> None:
        for idx in queue[:n_prefetch]:
            if idx not in prefetched:
                prefetched[idx] = _load(idx)

    def _take_next() -> Optional[Dict]:
        if not queue:
            return None
        idx = queue.pop(0)
        mel, frames, ready = prefetched.pop(idx, None) or _load(idx)
        if ready is not None:   # made on the side stream, used on this one
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            mel.record_stream(stream)
        return _new_song_state(idx, mel, frames)

    turns = _Turns(n_groups)

    def _group(gi: int, stream) -> None:
        """One lockstep group of ``bsz`` slots, from its first songs to its
        last; its fallback ladder runs one temperature a turn."""
        with _stream_scope(dev, stream):
            if cuda:   # the model and any staged mels come from the caller's stream
                stream.wait_stream(caller)
            zero_win = torch.zeros((cfg.n_mels, N_FRAMES), dtype=torch.float32, device=dev)
            turns.wait(gi)
            slots: List[Optional[Dict]] = [_take_next() for _ in range(bsz)]
            _prefetch()
            round_idx = 0
            turns.pass_on(any(st is not None for st in slots))
            while any(st is not None for st in slots):
                # Prepare the round: windows, conditioned prompts, one encode.
                wins: List[torch.Tensor] = [zero_win] * bsz
                seg_sizes = [0] * bsz
                buf = np.full((bsz, p_max), eot, np.int64)
                lengths = np.full((bsz,), len(sot_seq), np.int64)
                sots = np.zeros((bsz,), np.int64)
                for i, st in enumerate(slots):
                    if st is None:
                        buf[i, : len(sot_seq)] = sot_seq
                        continue
                    seg_sizes[i] = min(N_FRAMES, st["frames"] - st["seek"])
                    wins[i] = _gather_window(st["mel"], st["seek"])
                    ptoks = _conditioned_prompt(tokenizer, sot_seq, st,
                                                condition_on_previous_text, max_prev)
                    buf[i, : len(ptoks)] = ptoks
                    lengths[i] = len(ptoks)
                    sots[i] = len(ptoks) - len(sot_seq)
                xa = _encode(model, cfg, torch.stack(wins))
                prompt = torch.from_numpy(buf).to(dev)
                length = torch.from_numpy(lengths).to(dev)
                sot_index = torch.from_numpy(sots).to(dev)

                # The fallback ladder: each temperature decodes the whole
                # batch; a row keeps the first candidate that passes the gates.
                row_result: List[Optional[Dict]] = [None] * bsz
                row_ns: List[Optional[float]] = [None] * bsz
                settled = [st is None for st in slots]
                for ti, temperature in enumerate(temperatures):
                    generator = None
                    if temperature > 0.0:
                        generator = torch.Generator(device=dev).manual_seed(
                            seed + int(temperature * 10) + round_idx * n_groups + gi)
                    tok_np, scores, ns_np = _window_decode(
                        model, cfg, xa, prompt, length, sot_index, temperature, generator,
                        beam_size, max_new_tokens, eot, no_speech, suppress_ids,
                        begin_suppress_ids, ts_begin, length_penalty, patience, decode_group)
                    for i, st in enumerate(slots):
                        if st is None or settled[i]:
                            continue
                        if row_ns[i] is None:
                            row_ns[i] = float(ns_np[i])
                        row_result[i] = _candidate(
                            tokenizer, tok_np[i], float(scores[i]), temperature, eot)
                        settled[i] = _settles(
                            row_result[i], row_ns[i], compression_ratio_threshold,
                            logprob_threshold, no_speech_threshold)
                    if all(settled) or ti + 1 == len(temperatures):
                        break
                    turns.wait(gi)
                    turns.pass_on(True)

                # Bookkeeping, in this group's turn; a finished song hands
                # its slot to the next queued one.
                turns.wait(gi)
                for i, st in enumerate(slots):
                    if st is None:
                        continue
                    _apply_window_result(
                        st, row_result[i], row_ns[i], seg_sizes[i], tokenizer, ts_begin,
                        eot, logprob_threshold, no_speech_threshold,
                        condition_on_previous_text, verbose, tag=f"[song {st['ri']}] ")
                    if st["seek"] >= st["frames"]:
                        results[st["ri"]] = _final_result(st, tokenizer)
                        slots[i] = _take_next()
                _prefetch()
                round_idx += 1
                turns.pass_on(any(st is not None for st in slots))

    def _run(gi: int, stream) -> None:
        try:
            _group(gi, stream)
        except _Stopped:
            pass
        except BaseException as exc:  # noqa: B902 (handed to the caller below)
            turns.fail(exc)

    streams = [torch.cuda.Stream(device=dev) if cuda else None for _ in range(n_groups)]
    threads = [threading.Thread(target=_run, args=(gi, streams[gi]),
                                name=f"longform-group-{gi}", daemon=True)
               for gi in range(n_groups)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if cuda:
        for stream in streams + [side]:
            caller.wait_stream(stream)
    if turns.error is not None:
        raise turns.error
    return results
