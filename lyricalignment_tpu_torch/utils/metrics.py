"""Evaluation metrics: CER, PER, alignment MAE.

The port's own copy of ``lyricalignment_tpu/utils/metrics.py``, whose
behavioral parity targets in the reference are:
  * CER / edit-distance with op counts — `utils/CER.py:4-77`
  * PER via initial/final phonemization     — `utils/CER.py:79-100`
  * alignment MAE over char on/offsets      — `utils/alignment.py:190-199`

The CER error rate is ``edit_distance(hyp, ref) / len(ref)``; the op counts
{C,S,I,D} come from a backtrace whose tie-breaking (substitution preferred
over insertion over deletion) and boundary handling are preserved exactly,
since the reference prints these counts in its transcript evaluation CLI.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from lyricalignment_tpu_torch.text.pinyin import split_syllable

# Backtrace op codes. 0 doubles as "match" and as the untouched border of the
# ops matrix, which the reference's backtrace walks through diagonally — that
# quirk is load-bearing for its printed op counts, so it is kept.
_MATCH, _SUB, _INS, _DEL = 0, 1, 2, 3


def edit_ops(hypothesis: Sequence, reference: Sequence) -> Tuple[int, Dict[str, int]]:
    """Levenshtein distance plus {N,C,W,I,D,S} op counts.

    Insertions are hypothesis-extra symbols, deletions are reference symbols
    missing from the hypothesis (standard ASR convention, matching the
    reference's actual behavior — its inline comments disagree with its code).
    """
    h, r = len(hypothesis), len(reference)
    cost = np.zeros((h + 1, r + 1), dtype=np.int32)
    ops = np.zeros((h + 1, r + 1), dtype=np.int8)
    cost[:, 0] = np.arange(h + 1)
    cost[0, :] = np.arange(r + 1)

    for i in range(1, h + 1):
        hi = hypothesis[i - 1]
        for j in range(1, r + 1):
            if hi == reference[j - 1]:
                cost[i, j] = cost[i - 1, j - 1]
            else:
                sub = cost[i - 1, j - 1] + 1
                ins = cost[i - 1, j] + 1
                dele = cost[i, j - 1] + 1
                best = min(sub, ins, dele)
                cost[i, j] = best
                # tie preference: substitution, then insertion, then deletion
                if best == sub:
                    ops[i, j] = _SUB
                elif best == ins:
                    ops[i, j] = _INS
                else:
                    ops[i, j] = _DEL

    counts = {"N": r, "C": 0, "W": 0, "I": 0, "D": 0, "S": 0}
    i, j = h, r
    while i >= 0 or j >= 0:
        op = ops[max(0, i), max(0, j)]
        if op == _MATCH:
            if i - 1 >= 0 and j - 1 >= 0:
                counts["C"] += 1
            i -= 1
            j -= 1
        elif op == _INS:
            counts["I"] += 1
            i -= 1
        elif op == _DEL:
            counts["D"] += 1
            j -= 1
        else:  # _SUB
            counts["S"] += 1
            i -= 1
            j -= 1
        # once one side is exhausted the remaining symbols on the other side
        # are pure deletions/insertions (reference `utils/CER.py:62-65`)
        if i < 0 and j >= 0:
            counts["D"] += 1
        elif j < 0 and i >= 0:
            counts["I"] += 1

    counts["W"] = int(cost[h, r])
    return int(cost[h, r]), counts


def cer(hypothesis: Sequence, reference: Sequence) -> Tuple[float, Dict[str, int]]:
    """Character error rate = edit_distance / len(reference)."""
    dist, counts = edit_ops(hypothesis, reference)
    return dist / len(reference), counts


def per(
    hypothesis: str,
    reference: str,
    phonemize: Callable[[str], List[str]],
) -> Tuple[float, Dict[str, int]]:
    """Phoneme error rate: phonemize both sides into interleaved
    [initial, final] sequences, then run CER over phonemes.

    ``phonemize(text)`` must return one toneless pinyin syllable per char
    (non-Chinese chars pass through), e.g. ``text.pinyin.CharPhonemizer``.
    """
    def expand(text: str) -> List[str]:
        seq: List[str] = []
        for syl in phonemize(text):
            ini, fin = split_syllable(syl)
            seq.append(ini)
            seq.append(fin)
        return seq

    return cer(expand(hypothesis), expand(reference))


def mae(
    ground_truth: Sequence[Sequence[Sequence[float]]],
    predicted: Sequence[Sequence[Sequence[float]]],
) -> float:
    """Mean absolute error over all char onsets and offsets (seconds).

    Inputs are nested per-sample lists of [onset, offset] pairs
    (reference `utils/alignment.py:190-199`).
    """
    error = 0.0
    count = 0
    for gt_sample, pred_sample in zip(ground_truth, predicted):
        for (gt_on, gt_off), (p_on, p_off) in zip(gt_sample, pred_sample):
            error += abs(gt_on - p_on) + abs(gt_off - p_off)
            count += 2
    return error / count
