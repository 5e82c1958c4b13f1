"""The alignment service's answer, judged plainly.

For a batch of (WAV, lyric) requests the reference works out the labels
(each lyric character's BERT token, then its syllable class from the
pronunciation table), the padded batch (5 s buckets, the true length of
each request), the log-mel, the float32 encoder and head, the CTC emissions
and the best score of the forced-alignment DP over each request's frames.
A program's answer, onsets and offsets in seconds a character, is the path
it chose; its score under the reference's emissions, below the best, is the
gap judged (in nats): a correct program finds the best path of its own
emissions, which differ from these by its precision.

The DP (CTC topology with a silence state between labels): states 0..2L,
even states silence, state 2i+1 label i; a path starts in state 0 or 1,
each frame stays, moves one state on, or skips the silence between two
labels that differ; it ends in state 2L or 2L-1. CTC emissions: the blank
column 0 and the silence column C-1 (a sigmoid detector) apart, a label's
log-probability is log_softmax over columns 1..C-2 plus log(1 - silence),
a silence frame's log(silence); both clipped at -1000.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import full_float32
from benchmark.reference.audio import HOP, bucket_len, log_mel, read_mono_16k
from benchmark.reference.model import Weights, encode, fp8_matmuls, head_hidden

CLIP = -1000.0
NEG = float("-inf")


def load_labels(vocab_path: str, table_path: str):
    """lyric -> class ids: a CJK character is its own BERT token (its line
    in vocab.txt); the table's third element maps its pinyin to a class."""
    with open(vocab_path, encoding="utf-8") as f:
        token_id = {line.rstrip("\n"): i for i, line in enumerate(f)}
    with open(table_path, encoding="utf-8") as f:
        token_pinyin, _, pinyin_class = json.load(f)

    def classes(lyric: str) -> List[int]:
        return [int(pinyin_class[token_pinyin[token_id[ch]]]) for ch in lyric]
    return classes


def batches(lengths: Sequence[int], bucket_seconds: float, batch_size: int):
    """The service's batches: requests grouped by padded length (shortest
    bucket first), in input order, ``batch_size`` at a time; each batch
    padded to the next power of two rows. Yields (padded_len, rows, idxs)."""
    groups: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        groups.setdefault(bucket_len(n, bucket_seconds), []).append(i)
    for padded in sorted(groups):
        idxs = groups[padded]
        for s in range(0, len(idxs), batch_size):
            part = idxs[s:s + batch_size]
            yield padded, min(1 << (len(part) - 1).bit_length(), batch_size), part


def emissions(p: Weights, h: torch.Tensor, labels: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """h f32[T, F] of one request -> (label log-probs [T, L], silence
    [T]) from the classifier's full logits."""
    logits = F.linear(h, p["align_rnn.fc.weight"], p["align_rnn.fc.bias"])
    word = torch.log_softmax(logits[:, 1:-1], dim=-1)
    sil = logits[:, -1]
    lab = word[:, torch.tensor(labels, device=h.device) - 1] + F.logsigmoid(-sil)[:, None]
    return lab.clamp(min=CLIP), F.logsigmoid(sil).clamp(min=CLIP)


def best_scores(lab: List[torch.Tensor], sil: List[torch.Tensor],
                labels: List[Sequence[int]], paths: bool = False):
    """The DP's best path score of each request (float64), all requests of
    a batch at once: request b's emissions lab[b] [T_b, L_b], sil[b] [T_b];
    its states past 2 L_b and its frames past T_b are held out. With
    ``paths`` also each best path's frame onsets and offsets a label
    (ties broken toward staying, then toward the nearer state)."""
    dev = lab[0].device
    n_b = len(lab)
    t_max = max(x.shape[0] for x in lab)
    k = 2 * max(len(q) for q in labels) + 1
    em = torch.full((n_b, t_max, k), NEG, dtype=torch.float64, device=dev)
    skip = torch.zeros((n_b, k), dtype=torch.bool, device=dev)
    for b, (lb, sb, q) in enumerate(zip(lab, sil, labels)):
        t, n = lb.shape
        em[b, :t, 0:2 * n + 1:2] = sb.double()[:, None]
        em[b, :t, 1:2 * n:2] = lb.double()
        q = torch.tensor(q, device=dev)
        skip[b, 3:2 * n:2] = q[1:] != q[:-1]
    frames = torch.tensor([x.shape[0] for x in lab], device=dev)
    dp = torch.full((n_b, k), NEG, dtype=torch.float64, device=dev)
    dp[:, :2] = em[:, 0, :2]
    pad = torch.full((n_b, 2), NEG, dtype=torch.float64, device=dev)
    back = []
    for f in range(1, t_max):
        shifted = torch.cat([pad, dp], dim=1)
        one, two = shifted[:, 1:-1], shifted[:, :-2]
        two = torch.where(skip, two, torch.full_like(two, NEG))
        cand = torch.stack([dp, one, two])                           # stay, +1, +2
        best, arg = cand.max(dim=0)
        live = (f < frames)[:, None]
        dp = torch.where(live, best + em[:, f], dp)
        if paths:
            back.append(torch.where(live, arg, torch.zeros_like(arg)).to(torch.int8))
    ends = torch.tensor([[2 * len(q), 2 * len(q) - 1] for q in labels], device=dev)
    end_val, end_at = dp.gather(1, ends).max(dim=1)
    if not paths:
        return end_val.tolist()
    state = ends.gather(1, end_at[:, None])[:, 0]
    states = [state]
    for arg in reversed(back):
        state = state - arg.gather(1, state[:, None])[:, 0].long()
        states.append(state)
    states = torch.stack(states[::-1], dim=1).cpu().numpy()          # [B, T]
    segs = []
    for b, q in enumerate(labels):
        s_b = states[b, : lab[b].shape[0]]
        segs.append([(int(np.flatnonzero(s_b == 2 * i + 1)[0]),
                      int(np.flatnonzero(s_b == 2 * i + 1)[-1]) + 1) for i in range(len(q))])
    return end_val.tolist(), segs


def path_score(lab: torch.Tensor, sil: torch.Tensor, labels: Sequence[int],
               segments: Sequence[Sequence[int]]) -> float:
    """Score of the path that frame onsets and offsets a label describe
    (label i on frames [on_i, off_i), silence between), or +inf below the
    best when it is no path of the DP."""
    t, n = lab.shape
    if len(segments) != n:
        return -np.inf
    prev_off = 0
    total = 0.0
    lab64, sil64 = lab.double().cpu().numpy(), sil.double().cpu().numpy()
    for i, (on, off) in enumerate(segments):
        if not (prev_off <= on < off <= t):
            return -np.inf
        if i and on == prev_off and labels[i] == labels[i - 1]:
            return -np.inf                      # no skip between equal labels
        total += sil64[prev_off:on].sum() + lab64[on:off, i].sum()
        prev_off = off
    return total + sil64[prev_off:t].sum()


@torch.no_grad()
def judge_calls(weights: Dict[str, torch.Tensor], cfg: Dict, calls: List[Dict],
                classes, bucket_seconds: float, batch_size: int,
                control: bool = False) -> List[float]:
    """Gaps (nats) of every request of ``calls``: each a dict of the call's
    ``paths``, ``lyrics`` and the program's ``segments`` (seconds). The
    batches are rebuilt as the service built them (the log-mel is clamped
    against its batch's peak). ``control``: the answers judged are the
    reference's own with the encoder's matmuls in FP8 (the control, the
    precision below the configuration's bf16), not the program's."""
    p = Weights(weights)
    dev = next(iter(weights.values())).device
    fast = cfg["precision"]["fast_gelu"]
    n_mels = cfg["n_mels"]
    gaps = []
    with full_float32():
        for call in calls:
            audio = [read_mono_16k(path) for path in call["paths"]]
            for padded, rows, idxs in batches([len(a) for a in audio], bucket_seconds, batch_size):
                a = np.zeros((rows, padded), np.float32)
                mel_len = np.ones(rows, np.int64)
                for j, i in enumerate(idxs):
                    n = min(len(audio[i]), padded)
                    a[j, :n] = audio[i][:n]
                    mel_len[j] = n // HOP
                mel = log_mel(torch.from_numpy(a).to(dev), n_mels)
                keep = torch.arange(mel.shape[-1], device=dev)[None] < torch.from_numpy(mel_len).to(dev)[:, None]
                mel = torch.where(keep[:, None, :], mel, torch.zeros((), device=dev))
                mel = F.pad(mel, (0, 3000 - mel.shape[-1])) if mel.shape[-1] < 3000 else mel[..., :3000]
                frames = [int(round(int(mel_len[j]) / 2.0)) for j in range(len(idxs))]
                labels = [classes(call["lyrics"][i])[:128] for i in idxs]

                def lattice(low_precision=False):
                    with fp8_matmuls(low_precision):
                        feats = encode(p, cfg, mel, fast)
                    h = head_hidden(p, cfg, feats[: len(idxs)], frames)
                    return [emissions(p, h[j, :frames[j]], labels[j]) for j in range(len(idxs))]
                em = lattice()
                best = best_scores([e[0] for e in em], [e[1] for e in em], labels)
                if control:
                    low = lattice(low_precision=True)
                    answers = best_scores([e[0] for e in low], [e[1] for e in low], labels,
                                          paths=True)[1]
                else:
                    answers = [[(int(round(on / 0.02)), int(round(off / 0.02)))
                                for on, off in call["segments"][i]] for i in idxs]
                for j in range(len(idxs)):
                    gaps.append(best[j] - path_score(*em[j], labels[j], answers[j]))
    return gaps
