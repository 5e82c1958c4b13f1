"""KV-cached autoregressive decoding: batched greedy, beam search and
temperature sampling.

Port of ``lyricalignment_tpu/decode/beam.py``. The JAX ``lax.while_loop``
becomes a Python loop over :func:`models.whisper.decode_step`; everything a
step decides stays on the device as tensors (the picks, the beam pool's
ranking, the finished buffers, each sample's completion step), and the host
reads one flag, "every row done", once per ``group`` steps. Beams live as
an extra batch dimension; after each selection the per-row generated K/V
are re-gathered in place, while the per-sample prompt and cross sections
are never moved.

Scoring follows whisper's MaximumLikelihoodRanker: with the default
``length_penalty=None`` finished candidates are ranked by
``sum_logprob / num_generated_tokens``; with a float penalty by the Google
NMT formula ``sum_logprob / ((5 + length) / 6) ** penalty``.

Logit processing per step mirrors whisper's LogitFilters: the special and
non-speech suppress mask, SuppressBlank at the first sampled position
(``begin_suppress_ids``), and optionally ApplyTimestampRules
(``timestamp_rules=True``, ``decode.timestamps``).

Ties: JAX's ``lax.top_k`` returns the lower index first among equal
values, and suppressed logits (``NEG_INF``) tie often. ``torch.topk``
promises no order for ties, so every ranking here is a stable descending
sort (:func:`_top`). A sampled pick is ``argmax(logits / T + Gumbel
noise)``, the form of ``jax.random.categorical``, with the noise drawn from
a ``torch.Generator`` (:func:`gumbel_noise`).

The ``*_loop`` helpers start from an already-primed cache and the prompt's
last-position logits, so long-form decoding (``decode.longform``) primes
conditioned prompts in one batched forward and reuses the same loops.

Spans (``utils.observability.trace``; a shared no-op outside a profiler):
``decode.init`` (the processor, cross K/V and the cache's allocation),
``decode.prime``, ``decode.step`` around each :func:`decode_step`,
``decode.select`` (the processor, log-softmax and the pick or beam update),
``decode.sync`` (the host's read of "every row done", once a group). Each
loop adds the token positions it decided (the first from the prime's
logits, each later one by a step) to the counter ``decode.steps``.

On a card each loop runs its first step as it is and captures the second
in a CUDA graph (:class:`_Stepper`), which every later step of the loop
replays: a step's shapes and its cache's addresses are fixed and its
position lives on the device, so one graph launch a step takes the place of
the decoder's thousands of kernel launches (~75 a layer), and the step's
time no longer follows the host's. Inside a profiler the replay is the op
``decode.graph``, which the graph's kernels are linked to.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from lyricalignment_tpu_torch.decode.timestamps import (
    MAX_INITIAL_TIMESTAMP_INDEX,
    apply_timestamp_rules,
)
from lyricalignment_tpu_torch.models.whisper import (
    Whisper,
    WhisperConfig,
    decode_step,
    init_decode_cache,
    prime_decode_cache,
)
from lyricalignment_tpu_torch.utils.observability import add_counts, op_span, trace

NEG_INF = -1.0e30

Processor = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def _suppress_mask(cfg: WhisperConfig, eot: int, n_special_start: int,
                   extra_ids: tuple = (),
                   allow_timestamps_from: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """Additive f32[n_vocab] mask suppressing every special token except
    <|endoftext|>: every id from ``n_special_start`` (= eot) on, and the
    non-speech ``extra_ids``; with ``allow_timestamps_from`` (=
    timestamp_begin) the timestamp ids stay allowed."""
    ids = torch.arange(cfg.n_vocab, device=device)
    suppressed = ids >= n_special_start
    if allow_timestamps_from is not None:
        suppressed = suppressed & (ids < allow_timestamps_from)
    mask = torch.where(suppressed, NEG_INF, 0.0)
    if extra_ids:
        mask[torch.tensor([int(i) for i in extra_ids], device=device)] = NEG_INF
    mask[eot] = 0.0
    return mask


def make_processor(
    cfg: WhisperConfig,
    eot: int,
    suppress_ids: tuple = (),
    begin_suppress_ids: tuple = (),
    timestamp_rules: bool = False,
    ts_begin: Optional[int] = None,
    max_initial_ts_index: int = MAX_INITIAL_TIMESTAMP_INDEX,
    device=None,
) -> Processor:
    """Build the per-step logit processor ``(logits[N, V], gen[N, T], i) ->
    logits``. ``gen`` is the generated-token buffer (positions < i valid);
    the masks live on ``device``."""
    suppress = _suppress_mask(
        cfg, eot, eot, suppress_ids,
        allow_timestamps_from=ts_begin if timestamp_rules else None, device=device)
    begin = None
    if begin_suppress_ids:
        begin = torch.zeros((cfg.n_vocab,), dtype=torch.float32, device=device)
        begin[torch.tensor(list(begin_suppress_ids), device=device)] = NEG_INF

    def process(logits, gen, i):
        logits = logits + suppress[None, :]
        if begin is not None and i == 0:
            logits = logits + begin[None, :]
        if timestamp_rules:
            logits = apply_timestamp_rules(
                logits, gen, i, ts_begin=ts_begin, eot=eot,
                max_initial_index=max_initial_ts_index)
        return logits

    return process


def _top(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``n`` largest entries of each row, in descending order, the lower
    index first among equal values (``lax.top_k``'s order)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :n], index[..., :n]


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1), drawn
    from ``generator`` (the draw of ``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _check_group(group: int) -> None:
    if group < 1:
        # group <= 0 would run no step between two reads of the done flag
        raise ValueError(f"decode group must be >= 1, got {group}")


def _all_done(done: torch.Tensor) -> bool:
    """The host's read of ``done.all()``: the one sync of a group of steps."""
    with trace("decode.sync"):
        return bool(done.all())


def _graphable(model, tokens: torch.Tensor) -> bool:
    """Whether a loop may replay its steps from a CUDA graph: a Whisper on a
    card with no model group (a sharded decoder's collectives stay out of
    any graph)."""
    if not (tokens.is_cuda and isinstance(model, Whisper)):
        return False
    dec = model.decoder
    return dec.vocab_group is None and all(
        getattr(m, name, None) is None for m in dec.modules() for name in ("group", "mlp_group"))


# one capture stream and graph memory pool a thread and device: a loop's graph
# is captured into the pool its thread's previous graph used (which no loop
# replays any more), so the pool's memory is reused rather than left behind
_graph_state = threading.local()


class _Stepper:
    """:func:`decode_step` on one loop's cache: called as
    ``step(tokens) -> (logits, cache)``. The first call runs the step as it
    is (which also warms its library handles and workspaces) and decides,
    by :func:`_graphable`, whether the second captures the step in a CUDA
    graph on a side stream; from then on each call copies ``tokens`` into
    the graph's input and replays it. A replay's logits are the graph's
    output, overwritten by the next call; the cache is updated in place as
    :func:`decode_step` updates it."""

    def __init__(self, model, cfg: WhisperConfig, cache: Dict):
        self.model, self.cfg, self.cache = model, cfg, cache
        self.capture = self.graph = self.tokens = self.logits = None

    def __call__(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        if self.graph is not None:
            self.tokens.copy_(tokens)
        elif self.capture:
            self._capture(tokens)
        else:
            if self.capture is None:
                self.capture = _graphable(self.model, tokens)
            logits, self.cache = decode_step(self.model, self.cfg, tokens, self.cache)
            return logits, self.cache
        with op_span("decode.graph"):
            self.graph.replay()
        return self.logits, self.cache

    def _capture(self, tokens: torch.Tensor) -> None:
        dev = tokens.device
        slots = _graph_state.__dict__.setdefault("by_device", {})
        stream, last = slots.get(dev.index) or (torch.cuda.Stream(dev), None)
        self.tokens = tokens.clone()
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=None if last is None else last.pool(),
                                capture_error_mode="thread_local")
            try:
                self.logits, self.cache = decode_step(self.model, self.cfg, self.tokens,
                                                      self.cache)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        slots[dev.index] = (stream, graph)
        self.graph = graph


# ---------------------------------------------------------------------------
# core loops (start from a primed cache + the prompt's last-position logits)
# ---------------------------------------------------------------------------

@torch.no_grad()
def greedy_loop(
    model: Whisper,
    cfg: WhisperConfig,
    logits0: torch.Tensor,       # f32[B, V] at the last prompt position
    cache: Dict,                 # primed; pos = prompt length
    process: Processor,
    max_new_tokens: int,
    eot: int,
    group: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode from a primed cache.

    The host reads "every row done" once per ``group`` steps; rows that are
    done emit eot with logprob 0, so the tokens do not depend on ``group``.

    Returns (tokens int64[B, max_new_tokens] eot-padded, sum_logprob f32[B]).
    """
    _check_group(group)
    b = logits0.shape[0]
    t = max_new_tokens
    out = torch.full((b, t), eot, dtype=torch.int64, device=logits0.device)

    def pick(logits, i, done):
        l = process(logits, out, i)
        tok = torch.argmax(l, dim=-1)
        lp = torch.log_softmax(l, dim=-1).gather(1, tok[:, None])[:, 0]
        return torch.where(done, eot, tok), torch.where(done, 0.0, lp)

    with trace("decode.select"):
        first, sum_lp = pick(logits0, 0, torch.zeros((b,), dtype=torch.bool, device=out.device))
        out[:, 0] = first
        done = first == eot
    tok, i = first[:, None], 1
    step = _Stepper(model, cfg, cache)
    while i < t and not _all_done(done):
        for _ in range(min(group, t - i)):
            with trace("decode.step"):
                logits, cache = step(tok)
            with trace("decode.select"):
                nxt, lp = pick(logits, i, done)
                out[:, i] = nxt
                done = done | (nxt == eot)
                sum_lp = sum_lp + lp
            tok, i = nxt[:, None], i + 1
    add_counts({"decode.steps": i})
    return out, sum_lp


def _gather_cache(cache: Dict, idx: torch.Tensor) -> Dict:
    """Re-select the per-row cache sections (the generated K/V) to the beam
    rows ``idx`` int64[B*beam], in place. The per-sample sections
    (``cross_*``, ``prompt_*``) are shared by a sample's beams and never
    move; ``step`` and ``length`` pass through."""
    for blk in cache["blocks"]:
        for key, value in blk.items():
            if not key.startswith(("cross_", "prompt_")):
                value.copy_(value.index_select(0, idx))
    return cache


@torch.no_grad()
def beam_loop(
    model: Whisper,
    cfg: WhisperConfig,
    logits0: torch.Tensor,       # f32[B*k, V] (rows of a sample identical)
    cache: Dict,                 # primed for B*k rows
    process: Processor,
    beam_size: int,
    max_new_tokens: int,
    eot: int,
    length_penalty: Optional[float] = None,
    patience: Optional[float] = None,
    group: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search from a primed cache, token-for-token whisper's
    BeamSearchDecoder + MaximumLikelihoodRanker (the semantics of the JAX
    ``beam_loop``, pinned by ``tests/test_beam_oracle.py``):

    - each live beam proposes its top ``k+1`` continuations; the sample's
      candidate pool is ranked best-first (ties in beam-major, per-beam-rank
      order);
    - a candidate ending in eot moves to the finished set; live slots are
      refilled by the best non-eot candidates;
    - the finished set keeps the first ``round(k * patience)`` sequences to
      finish, and a sample completes when it has that many; a completed
      sample's live state freezes at its completion step;
    - if the budget runs out first, unfinished beams are appended by
      descending sum-logprob (ties: higher beam index first) up to ``k``;
    - ranking normalises by the text length excluding eot.

    The host reads "every sample complete" once per ``group`` steps; the
    freeze makes the tokens independent of ``group``.

    Returns (tokens int64[B, max_new_tokens] of the best candidate,
    eot-padded, and its average logprob f32[B] = sum_logprob / (n_text + 1),
    whisper's ``avg_logprob``).
    """
    _check_group(group)
    bk = logits0.shape[0]
    k = beam_size
    b = bk // k
    t = max_new_tokens
    dev = logits0.device
    n_cand = int(round((patience if patience is not None else 1.0) * k))
    if n_cand < 1:
        raise ValueError(
            f"Invalid beam size ({k}) or patience ({patience}): "
            f"round(beam_size * patience) must be > 0")
    # finalize pads with unfinished beams up to k entries
    n_buf = max(n_cand, k)
    slots = torch.arange(n_buf, device=dev)
    beams = torch.arange(k, device=dev)

    def write_slots(write, slot, values, rows, fin_score, fin_tok):
        """Write ``values`` [B, k] and ``rows`` [B, k, T] to the finished
        buffers at ``slot`` [B, k] where ``write``; returns the slots
        written [B, C] and the new buffers."""
        onehot = write[:, :, None] & (slot.clamp(0, n_buf - 1)[:, :, None] == slots)
        any_w = onehot.any(dim=1)                                   # [B, C]
        src = onehot.to(torch.int64).argmax(dim=1)                  # [B, C]
        fin_score = torch.where(any_w, values.gather(1, src), fin_score)
        fin_tok = torch.where(any_w[:, :, None],
                              rows.gather(1, src[:, :, None].expand(-1, -1, t)), fin_tok)
        return any_w, fin_score, fin_tok

    def select(i, cand_lp, cand_tok, cand_src, live_tokens,
               fin_tok, fin_score, fin_ntext, fin_cnt):
        """One BeamSearchDecoder.update: walk the pool best-first, routing
        eot candidates to the finished buffers and the best k others to
        the live slots. ``cand_*`` are [B, M] in beam-major order;
        ``live_tokens`` [B, k_src, T] is what ``cand_src`` points into."""
        m = cand_lp.shape[1]
        order_lp, order = _top(cand_lp, m)
        tok_s = cand_tok.gather(1, order)
        src_s = cand_src.gather(1, order)
        is_eot = tok_s == eot
        live_rank = torch.cumsum((~is_eot).to(torch.int64), dim=1)      # 1-based
        pos = torch.arange(m, device=dev)[None, :]
        # the reference breaks after saving the k-th live candidate; eot
        # candidates ranked above that point finish, later ones are dropped
        pos_k = (live_rank >= k).to(torch.int64).argmax(dim=1)         # [B]
        new_fin = is_eot & (pos < pos_k[:, None])
        live_sel = ~is_eot & (live_rank <= k)

        live_pos = torch.where(live_sel, pos, m).sort(dim=1).values[:, :k]
        new_lp = order_lp.gather(1, live_pos)                           # [B, k]
        new_tok = tok_s.gather(1, live_pos)
        new_src = src_s.gather(1, live_pos)

        # append the newly finished (score order) until the buffer holds
        # n_cand sequences; first come, first kept
        fin_pos = torch.where(new_fin, pos, m).sort(dim=1).values[:, :k]
        fin_valid = fin_pos < m
        safe = fin_pos.clamp(max=m - 1)
        f_lp = order_lp.gather(1, safe)                                 # [B, k]
        f_src = src_s.gather(1, safe)
        slot = fin_cnt[:, None] + torch.cumsum(fin_valid.to(torch.int64), dim=1) - 1
        f_rows = live_tokens.gather(1, f_src[:, :, None].expand(-1, -1, t))   # [B, k, T]
        any_w, fin_score, fin_tok = write_slots(
            fin_valid & (slot < n_cand), slot, f_lp, f_rows, fin_score, fin_tok)
        fin_ntext = torch.where(any_w, i, fin_ntext)
        fin_cnt = torch.clamp(fin_cnt + fin_valid.sum(dim=1), max=n_cand)
        return new_lp, new_tok, new_src, fin_tok, fin_score, fin_ntext, fin_cnt

    tokens = torch.full((bk, t), eot, dtype=torch.int64, device=dev)
    fin_tok = torch.full((b, n_buf, t), eot, dtype=torch.int64, device=dev)
    fin_score = torch.full((b, n_buf), NEG_INF, dtype=torch.float32, device=dev)
    fin_ntext = torch.ones((b, n_buf), dtype=torch.int64, device=dev)  # 1: no 0/0
    fin_cnt = torch.zeros((b,), dtype=torch.int64, device=dev)

    with trace("decode.select"):
        # first expansion: all beams of a sample are identical, so the
        # reference's dict dedups the pool to beam 0's top (k+1) candidates
        logp0 = torch.log_softmax(process(logits0, tokens, 0), dim=-1)
        row_lp, row_tok = _top(logp0.reshape(b, k, -1)[:, 0], k + 1)    # [B, k+1]
        (sum_lp, new_tok, _, fin_tok, fin_score, fin_ntext, fin_cnt) = select(
            0, row_lp, row_tok, torch.zeros_like(row_tok), tokens.reshape(b, k, t),
            fin_tok, fin_score, fin_ntext, fin_cnt)
        # cache rows of a sample are identical after priming: no gather needed
        tokens[:, 0] = new_tok.reshape(-1)
        sum_lp = sum_lp.reshape(-1)                                      # [B*k]
        # each sample's completion step: with patience < 1 the finalize pad
        # draws live beams, frozen at the sample's own completion
        i_done = torch.where(fin_cnt >= n_cand, 1, t)
        cand_src = beams.repeat_interleave(k + 1)[None, :].expand(b, -1)
        sample_row = torch.arange(b, device=dev)[:, None] * k

    tok, i = tokens[:, 0:1], 1
    step = _Stepper(model, cfg, cache)
    while i < t and not _all_done(fin_cnt >= n_cand):
        for _ in range(min(group, t - i)):
            was_done = fin_cnt >= n_cand                                 # [B]
            with trace("decode.step"):
                logits, cache = step(tok)
            with trace("decode.select"):
                logp = torch.log_softmax(process(logits, tokens, i), dim=-1)    # [B*k, V]
                row_lp, row_tok = _top(logp, k + 1)                     # [B*k, k+1]
                (new_lp, new_tok, new_src, fin_tok, fin_score, fin_ntext, fin_cnt) = select(
                    i, (sum_lp[:, None] + row_lp).reshape(b, k * (k + 1)),
                    row_tok.reshape(b, k * (k + 1)), cand_src, tokens.reshape(b, k, t),
                    fin_tok, fin_score, fin_ntext, fin_cnt)
                # freeze completed samples: live scores, tokens and cache rows
                # keep the state they had when the sample completed
                new_lp = torch.where(was_done[:, None], sum_lp.reshape(b, k), new_lp)
                new_tok = torch.where(was_done[:, None], eot, new_tok)
                new_src = torch.where(was_done[:, None], beams[None, :], new_src)
                i_done = torch.where(~was_done & (fin_cnt >= n_cand), i + 1, i_done)

                src = (sample_row + new_src).reshape(-1)                # [B*k]
                _gather_cache(cache, src)
                tokens = tokens.index_select(0, src)
                tokens[:, i] = new_tok.reshape(-1)
            tok, sum_lp, i = new_tok.reshape(-1, 1), new_lp.reshape(-1), i + 1
    add_counts({"decode.steps": i})
    with trace("decode.select"):
        # finalize: pad a sample short of k finished sequences with its
        # unfinished beams by descending sum-logprob (ties: higher beam first)
        sum_lp_b = sum_lp.reshape(b, k)
        order = torch.sort(sum_lp_b, dim=1, stable=True).indices.flip(1)    # [B, k]
        pad_rows = tokens.reshape(b, k, t).gather(1, order[:, :, None].expand(-1, -1, t))
        slot = fin_cnt[:, None] + beams[None, :]
        any_w, fin_score, fin_tok = write_slots(
            slot < k, slot, sum_lp_b.gather(1, order), pad_rows, fin_score, fin_tok)
        fin_ntext = torch.where(any_w, i_done[:, None], fin_ntext)

        # rank: whisper MaximumLikelihoodRanker over text length excluding eot
        lengths_f = fin_ntext.to(torch.float32)                             # [B, C]
        norm = lengths_f if length_penalty is None else ((5.0 + lengths_f) / 6.0) ** length_penalty
        best = (fin_score / norm).argmax(dim=1)
        rows = torch.arange(b, device=dev)
        avg = fin_score[rows, best] / (fin_ntext[rows, best].to(torch.float32) + 1.0)
        return fin_tok[rows, best], avg


@torch.no_grad()
def sample_loop(
    model: Whisper,
    cfg: WhisperConfig,
    logits0: torch.Tensor,       # f32[B, V]
    cache: Dict,
    process: Processor,
    generator: torch.Generator,
    temperature: float,
    max_new_tokens: int,
    eot: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature sampling from a primed cache: each pick is
    ``argmax(logits / temperature + gumbel_noise)``, one draw of
    ``generator`` a step.

    Returns (tokens int64[B, max_new_tokens], sum_logprob f32[B])."""
    b = logits0.shape[0]
    out = torch.full((b, max_new_tokens), eot, dtype=torch.int64, device=logits0.device)

    def pick(logits, i, done):
        l = process(logits, out, i)
        noise = gumbel_noise(l.shape, generator, l.device)
        tok = torch.argmax(noise + l / temperature, dim=-1)
        lp = torch.log_softmax(l, dim=-1).gather(1, tok[:, None])[:, 0]
        return torch.where(done, eot, tok), torch.where(done, 0.0, lp)

    with trace("decode.select"):
        first, sum_lp = pick(logits0, 0, torch.zeros((b,), dtype=torch.bool, device=out.device))
        out[:, 0] = first
        done = first == eot
    tok, i = first[:, None], 1
    step = _Stepper(model, cfg, cache)
    while i < max_new_tokens and not _all_done(done):
        with trace("decode.step"):
            logits, cache = step(tok)
        with trace("decode.select"):
            nxt, lp = pick(logits, i, done)
            out[:, i] = nxt
            sum_lp = sum_lp + lp
            done = done | (nxt == eot)
        tok, i = nxt[:, None], i + 1
    add_counts({"decode.steps": i})
    return out, sum_lp


# ---------------------------------------------------------------------------
# entry points (prompt-of-specials priming, 30 s windows)
# ---------------------------------------------------------------------------

def _check_context(cfg: WhisperConfig, prompt_len: int, max_new_tokens: int):
    if prompt_len + max_new_tokens > cfg.n_text_ctx:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the decoder context ({cfg.n_text_ctx})"
        )


def greedy_search(
    model: Whisper,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,  # [B, 1500, D]
    prompt: torch.Tensor,          # int[B, P] (sot sequence)
    max_new_tokens: int = 224,
    eot: int = 50257,
    suppress_ids: tuple = (),
    begin_suppress_ids: tuple = (),
    group: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (int64[B, max_new_tokens], eot-padded after completion, and
    whisper's avg_logprob f32[B] = sum_logprob / (n_text + 1), eot's
    logprob in the sum where it was picked)."""
    _check_context(cfg, prompt.shape[1], max_new_tokens)
    with trace("decode.init"):
        cache = init_decode_cache(model, cfg, audio_features, prompt.shape[1], max_new_tokens)
        process = make_processor(cfg, eot, suppress_ids, begin_suppress_ids,
                                 device=audio_features.device)
    with trace("decode.prime"):
        logits, _, cache = prime_decode_cache(model, cfg, prompt, cache)
    out, sum_lp = greedy_loop(model, cfg, logits, cache, process, max_new_tokens, eot,
                              group=group)
    return out, sum_lp / ((out != eot).sum(dim=1) + 1).to(torch.float32)


def greedy_decode(*args, **kwargs) -> torch.Tensor:
    """:func:`greedy_search`'s tokens: int64[B, max_new_tokens],
    eot-padded after completion."""
    return greedy_search(*args, **kwargs)[0]


def beam_search(
    model: Whisper,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,  # [B, 1500, D]
    prompt: torch.Tensor,          # int[B, P]
    beam_size: int = 5,
    max_new_tokens: int = 224,
    eot: int = 50257,
    suppress_ids: tuple = (),
    begin_suppress_ids: tuple = (),
    length_penalty: Optional[float] = None,
    patience: Optional[float] = None,
    group: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search.

    Returns (tokens int64[B, max_new_tokens] of the best beam, its average
    logprob f32[B]); selection follows whisper's MaximumLikelihoodRanker
    (Google-NMT normalization when ``length_penalty`` is given). Cross and
    prompt K/V are computed once a sample; only generated K/V live per
    beam row.
    """
    k = beam_size
    _check_context(cfg, prompt.shape[1], max_new_tokens)
    with trace("decode.init"):
        cache = init_decode_cache(model, cfg, audio_features, prompt.shape[1], max_new_tokens,
                                  beam_size=k)
        process = make_processor(cfg, eot, suppress_ids, begin_suppress_ids,
                                 device=audio_features.device)
    with trace("decode.prime"):
        logits, _, cache = prime_decode_cache(model, cfg, prompt, cache)
    return beam_loop(model, cfg, logits.repeat_interleave(k, dim=0), cache, process, k,
                     max_new_tokens, eot, length_penalty, patience, group=group)
