"""Alignment MAE (the port's own copy of ``mae`` from
``lyricalignment_tpu/utils/metrics.py``; CER/PER wait for the transcription
slice)."""

from __future__ import annotations

from typing import Sequence


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
