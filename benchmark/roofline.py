"""Peaks of one H100 and the work of each kernel's function and of a whole
step, counted from the shapes of the call, whatever implements it.

A kernel's least time is the larger of its operations at the peak of the
type its function needs and its bytes at the HBM rate, counting each input
byte read once and each output byte written once. Model FLOPs count the
multiply-adds of the model's matrix products (2 a multiply-add), its
attention products and its recurrences at the configuration's shapes.
"""

from __future__ import annotations

import math
from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 494.5e12
PEAK_BF16 = 989e12
N_FFT, N_BINS = 400, 201


def least_s(work) -> float:
    """The least time of ``work`` = (operations, peak rate, bytes)."""
    ops, peak, nbytes = work
    return max(ops / peak, nbytes / PEAK_BYTES)


# --- kernels -----------------------------------------------------------------

def log10_mel_work(batch: int, padded_len: int, n_frames: int, n_mels: int, fb_nonzero: int) -> tuple:
    """The log-mel's framing, real FFT (5/2 N log2 N a frame), power (3 a
    bin) and the filterbank's nonzero weights, float32; bytes of the padded
    audio in, the weights and the log-mel out."""
    ops = batch * n_frames * (2.5 * N_FFT * math.log2(N_FFT) + 3 * N_BINS + 2 * fb_nonzero)
    nbytes = 4 * (batch * padded_len + fb_nonzero + batch * n_mels * n_frames)
    return ops, PEAK_F32, nbytes


def attention_forward_work(batch: int, seq: int, heads: int, head_dim: int = 64) -> tuple:
    """softmax(q k^T) v over bf16 [B, T, H, d]: two T x T x d products;
    q, k, v in and the output out."""
    ops = 2 * 2 * batch * heads * seq * seq * head_dim
    nbytes = 4 * 2 * batch * seq * heads * head_dim
    return ops, PEAK_BF16, nbytes


def row_lse_work(rows: int, feat: int, cols: int) -> tuple:
    """log sum exp(h @ w.T + b) per row in float32 accuracy, by its fastest
    accurate route, three TF32 products (the split of each factor into a
    high and a low half); h, w, b in, one float32 a row out."""
    ops = 3 * 2 * rows * feat * cols
    nbytes = 4 * (rows * feat + cols * feat + cols + rows)
    return ops, PEAK_TF32, nbytes


def viterbi_work(batch: int, frames: int, labels: int) -> tuple:
    """The forced-alignment DP: 2L + 1 states a frame, a compare, a select
    and an add each; the emissions in, onsets and offsets out."""
    ops = 3 * batch * frames * (2 * labels + 1)
    nbytes = 4 * (batch * frames * (labels + 1) + 2 * batch * labels + batch * labels)
    return ops, PEAK_F32, nbytes


def log10_mel(*a) -> float:
    return least_s(log10_mel_work(*a))


def attention_forward(*a) -> float:
    return least_s(attention_forward_work(*a))


def row_lse(*a) -> float:
    return least_s(row_lse_work(*a))


def viterbi(*a) -> float:
    return least_s(viterbi_work(*a))


# --- whole steps (model FLOPs) ------------------------------------------------

def _linears(d: int) -> float:
    """Multiply-adds of one block's q, k, v, out and MLP per token."""
    return 4 * d * d + 8 * d * d


def encoder_flops(cfg: Dict, windows: int) -> float:
    d, t, layers = cfg["n_audio_state"], cfg["n_audio_ctx"], cfg["n_audio_layer"]
    t_mel = 2 * t
    stem = 2 * (t_mel * cfg["n_mels"] * d * 3 + t * d * d * 3)
    blocks = layers * (2 * t * _linears(d) + 2 * 2 * t * t * d)
    return windows * (stem + blocks)


def head_flops(cfg: Dict, rows: int, frames: int, lse_cols: int) -> float:
    """The bi-GRU (input and recurrent products, 3 gates, both directions,
    every layer) and the classifier's normaliser over ``lse_cols``."""
    head = cfg["head"]
    h, dirs = head["hidden_dim"], 2 if head["bidirectional"] else 1
    gru = 0.0
    for layer in range(head["num_rnn_layers"]):
        n_in = cfg["n_audio_state"] if layer == 0 else h * dirs
        gru += dirs * 2 * 3 * h * (n_in + h)
    return rows * frames * (gru + 2 * h * dirs * lse_cols)


def mfu(flops: float, seconds: float) -> float:
    """The share of the bf16 dense peak, in %."""
    return 100.0 * flops / (seconds * PEAK_BF16)
