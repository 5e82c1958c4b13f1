"""The transcription service's answer, judged plainly.

For a call's WAVs the reference cuts each into 30 s windows and batches
them as the service does (``batch_size`` windows at a time, in request
order; the log-mel clamped against its batch's peak), then runs the
float32 encoder and the teacher-forced decoder (``decoder.py``) over each
window's answer: its token ids (the text, a JSON list of ids a window when
no BPE file is given; eot is left out of it) and its ``avg_logprob``.

Each answer's tokens are scored under the same processing and normaliser
as the service's: the sum of the processed log-probabilities of the text
tokens, and of eot where the text is shorter than the budget (it ended
there), over the text length plus one. An answer is judged three ways:

- invalid: a window whose ids are not a list of ints of the vocabulary,
  hold a suppressed id or outnumber the budget, or that has no score;
- its score's gap to the reference's (nats): the cached decode at the
  configuration's precision against the full forward pass in float32;
- its beam shortfall (nats): the most any of its tokens' reference
  log-probability lies below the reference's (beam + 1)-th best at that
  prefix. Every token of a beam hypothesis was among its parent's best
  beam + 1 proposals, so the exact arithmetic reads 0; a greedy, garbled
  or lower-precision answer does not.

(The text leaves eot out, so a token after an eot reads as part of the
answer; its score then disagrees with the reference's.)
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import full_float32
from benchmark.reference.audio import N_SAMPLES, log_mel, read_mono_16k
from benchmark.reference.decoder import EOT, beam_search, log_probs, prompt_ids, suppress_mask
from benchmark.reference.model import Weights, encode, fp8_matmuls

INF = float("inf")


def parse_ids(text: str) -> List[object]:
    """The JSON lists of a record's text, one a window, concatenated."""
    dec, out, at = json.JSONDecoder(), [], 0
    while at < len(text):
        value, at = dec.raw_decode(text, at)
        out.append(value)
    return out


def windows(paths: List[str]) -> List[np.ndarray]:
    """Every request's 30 s windows, zero-padded, in request order."""
    out = []
    for path in paths:
        a = read_mono_16k(path)
        for w in range(max(1, -(-len(a) // N_SAMPLES))):
            win = np.zeros(N_SAMPLES, np.float32)
            seg = a[w * N_SAMPLES:(w + 1) * N_SAMPLES]
            win[:len(seg)] = seg
            out.append(win)
    return out


def answers(texts: List[str], scores: List[object]) -> List[tuple]:
    """(ids or None, score or None) of every window, in request order."""
    out = []
    for text, score in zip(texts, scores):
        try:
            ids = parse_ids(text)
        except ValueError:
            ids = []
        n = max(len(ids), len(score) if isinstance(score, list) else 1)
        for w in range(n):
            s = score[w] if isinstance(score, list) and w < len(score) else None
            out.append((ids[w] if w < len(ids) else None, s))
    return out


def is_valid(ids, score, mask: torch.Tensor, max_new: int) -> bool:
    if not isinstance(ids, list) or not isinstance(score, float) or len(ids) > max_new:
        return False
    if not all(isinstance(t, int) and 0 <= t < mask.shape[0] for t in ids):
        return False
    return not any(mask[t] < 0 for t in ids)


@torch.no_grad()
def judge_calls(weights: Dict[str, torch.Tensor], cfg: Dict, calls: List[Dict], language: str,
                beam: int, max_new: int, batch_size: int, control: bool = False) -> Dict[str, list]:
    """{"invalid": [0 or 1 a window], "gap": [nats], "shortfall": [nats]}
    over every window of ``calls``: each a dict of the call's ``paths`` and
    the service's ``texts`` and ``scores`` (``avg_logprob``) a request.
    ``control``: the answers judged are the reference's own beam search
    with the Whisper linears and convolutions in FP8 (the precision below
    the configuration's bf16), not the service's."""
    p = Weights(weights)
    dev = next(iter(weights.values())).device
    fast = cfg["precision"]["fast_gelu"]
    prompt = prompt_ids(cfg["n_vocab"], language)
    mask = suppress_mask(cfg["n_vocab"], device=dev)
    mask_host = mask.cpu()
    out = {"invalid": [], "gap": [], "shortfall": []}
    with full_float32():
        for call in calls:
            wins = windows(call["paths"])
            given = answers(call["texts"], call["scores"])
            for s in range(0, len(wins), batch_size):
                mel = log_mel(torch.from_numpy(np.stack(wins[s:s + batch_size])).to(dev),
                              cfg["n_mels"])
                feats = encode(p, cfg, mel, fast)
                got = given[s:s + batch_size]
                if control:
                    with fp8_matmuls(True):
                        low = encode(p, cfg, mel, fast)

                        def step(seqs):
                            toks = torch.tensor(seqs, dtype=torch.int64, device=dev)
                            toks = torch.cat([toks, toks.new_zeros((len(seqs), 1))], dim=1)
                            return log_probs(p, cfg, prompt, toks, low, mask,
                                             rows_per_audio=beam)[:, -1]
                        got = beam_search(step, len(low), beam, max_new)
                for j, (ids, score) in enumerate(got):
                    if not is_valid(ids, score, mask_host, max_new):
                        out["invalid"].append(1)
                        out["gap"].append(INF)
                        out["shortfall"].append(INF)
                        continue
                    seq = ids + [EOT] if len(ids) < max_new else ids
                    lp = log_probs(p, cfg, prompt, torch.tensor([seq], device=dev),
                                   feats[j:j + 1], mask)[0]
                    tok_lp = lp.gather(1, torch.tensor(seq, device=dev)[:, None])[:, 0].double()
                    kth = lp.topk(beam + 1, dim=-1).values[:, -1].double()
                    out["invalid"].append(0)
                    out["gap"].append(abs(score - float(tok_lp.sum()) / (len(ids) + 1)))
                    out["shortfall"].append(max(0.0, float((kth - tok_lp).max())))
    return out
