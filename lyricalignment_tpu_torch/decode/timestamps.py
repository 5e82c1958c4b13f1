"""Whisper timestamp-rule decoding: the logit mask on tensors, and segment
parsing on the host.

Port of ``lyricalignment_tpu/decode/timestamps.py``. Its rule set (the
behavioral spec is whisper.decoding.ApplyTimestampRules):
1. after a timestamp pair, a timestamp cannot immediately repeat;
2. after a single timestamp, only a timestamp (or <|endoftext|>) may follow;
3. timestamps are monotonically non-decreasing, and each segment must have
   nonzero duration (floor = last timestamp + 1 unless the decode is mid
   timestamp-pair);
4. the first sampled token must be a timestamp, at most
   ``max_initial_index`` (default 1.0 s = index 50);
5. if the total probability mass on timestamps exceeds the most likely
   text token, text is suppressed.

``apply_timestamp_rules`` reads only the generated-token buffer the decode
loops already carry, so a beam reorder needs no extra bookkeeping.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from lyricalignment_tpu_torch import FRAMES_PER_SECOND

NEG_INF = -1.0e30

# mel frames per decoder timestamp position: N_FRAMES / n_audio_ctx = 2
INPUT_STRIDE = 2
TIME_PRECISION = 0.02  # seconds per timestamp index
MAX_INITIAL_TIMESTAMP_INDEX = 50  # whisper default max_initial_timestamp=1.0 s


def apply_timestamp_rules(
    logits: torch.Tensor,      # f32[N, V] (suppress mask already added)
    gen: torch.Tensor,         # int[N, T] generated-token buffer
    i: int,                    # current sample index (0-based)
    *,
    ts_begin: int,
    eot: int,
    max_initial_index: int = MAX_INITIAL_TIMESTAMP_INDEX,
) -> torch.Tensor:
    """Return logits with whisper's timestamp rules applied.

    Only positions < i of ``gen`` are read, so the buffer's initial fill
    value is irrelevant. The host knows ``i``; everything else stays on
    the logits' device.
    """
    n, v = logits.shape
    t = gen.shape[1]
    dev = logits.device
    ids = torch.arange(v, device=dev)
    is_ts_id = ids >= ts_begin           # [V]
    is_text_id = ids < eot

    valid = torch.arange(t, device=dev) < i                       # [T]
    gen_v = torch.where(valid[None, :], gen, -1)
    tok_is_ts = gen_v >= ts_begin        # [N, T]

    last = gen[:, min(max(i - 1, 0), t - 1)]
    penult = gen[:, min(max(i - 2, 0), t - 1)]
    last_was_ts = (last >= ts_begin) & (i >= 1)
    penult_was_ts = (penult >= ts_begin) | (i < 2)

    mask = torch.zeros_like(logits)
    # 1. timestamp pair complete -> next cannot be a timestamp
    sup_ts = last_was_ts & penult_was_ts
    mask = torch.where(sup_ts[:, None] & is_ts_id[None, :], NEG_INF, mask)
    # 2. mid-pair -> only a timestamp (or eot) may follow
    mid_pair = last_was_ts & ~penult_was_ts
    mask = torch.where(mid_pair[:, None] & is_text_id[None, :], NEG_INF, mask)
    # 3. monotonic, nonzero-duration segments
    have_ts = tok_is_ts.any(dim=1)
    max_ts = torch.where(tok_is_ts, gen_v, -1).amax(dim=1)
    floor = max_ts + torch.where(mid_pair, 0, 1)
    mask = torch.where(
        have_ts[:, None] & is_ts_id[None, :] & (ids[None, :] < floor[:, None]),
        NEG_INF, mask,
    )
    # 4. first sampled token: a timestamp within the initial window
    if i == 0:
        begin = (torch.where(ids < ts_begin, NEG_INF, 0.0)
                 + torch.where(ids > ts_begin + max_initial_index, NEG_INF, 0.0))
        mask = mask + begin[None, :]

    logits = logits + mask
    # 5. timestamp mass beats the best non-timestamp token -> force a
    # timestamp. whisper compares against max over ALL ids < timestamp_begin
    # (eot included), not just text ids.
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(torch.where(is_ts_id[None, :], logprobs, NEG_INF), dim=-1)
    max_non_ts = torch.where(is_ts_id[None, :], NEG_INF, logprobs).amax(dim=-1)
    force_ts = ts_lp > max_non_ts
    return torch.where(force_ts[:, None] & (ids < ts_begin)[None, :], NEG_INF, logits)


def parse_segments(
    tokens: Sequence[int],
    seek: int,
    segment_size: int,
    *,
    ts_begin: int,
    precision: float = TIME_PRECISION,
    input_stride: int = INPUT_STRIDE,
    frames_per_second: int = FRAMES_PER_SECOND,
) -> Tuple[List[Dict], int]:
    """Split one window's decoded tokens into timed segments.

    ``tokens``: the window's generated tokens with eot already stripped.
    ``seek``: absolute mel-frame offset of the window; ``segment_size``:
    number of content frames in the window (<= 3000).

    Returns (segments, seek_advance_in_mel_frames). Each segment dict has
    absolute ``start``/``end`` seconds and its ``tokens`` (timestamps
    included; text rendering filters ``< eot`` upstream).
    """
    toks = [int(x) for x in tokens]
    time_offset = seek / frames_per_second
    is_ts = [x >= ts_begin for x in toks]

    consecutive = [j + 1 for j in range(len(toks) - 1) if is_ts[j] and is_ts[j + 1]]
    single_ending = len(toks) >= 2 and is_ts[-1] and not is_ts[-2]

    segments: List[Dict] = []
    if consecutive:
        slices = list(consecutive)
        if single_ending:
            slices.append(len(toks))
        last = 0
        for cur in slices:
            seg = toks[last:cur]
            start_pos = seg[0] - ts_begin
            end_pos = seg[-1] - ts_begin
            segments.append({
                "start": time_offset + start_pos * precision,
                "end": time_offset + end_pos * precision,
                "tokens": seg,
            })
            last = cur
        if single_ending:
            advance = segment_size
        else:
            # seek to the end of the last complete timestamp pair
            last_ts_pos = toks[last - 1] - ts_begin
            advance = last_ts_pos * input_stride
    else:
        # no complete pair: one segment spanning the window (trimmed to the
        # final timestamp if one was produced)
        duration = segment_size / frames_per_second
        ts = [x for x in toks if x >= ts_begin]
        if ts and ts[-1] != ts_begin:
            duration = (ts[-1] - ts_begin) * precision
        segments.append({
            "start": time_offset,
            "end": time_offset + duration,
            "tokens": toks,
        })
        advance = segment_size
    return segments, int(advance)
