"""The work of the decoder's cached beam search, counted from the shapes of
the call, whatever implements it (``roofline.py``'s conventions: each
input byte read once and each output byte written once; model FLOPs the
multiply-adds of the matrix and attention products, 2 a multiply-add).

A step runs ``rows`` = windows x beam tokens, one a row, through every
decoder block and the unembedding. Its least bytes: the block matrices
once (self q, k, v, out; cross q, out; the MLP's 8 d^2: 14 d^2 at the
resident precision; the cross K and V projections ran once in the cache's
set-up), the cross K/V of each window (shared by its beams), the prompt's
K/V of each window, each row's generated K/V up to and including the
step's own (read, and the new slot written), the float32 unembedding
(the token embedding, tied), and the float32 logits out.
"""

from __future__ import annotations

from typing import Dict

from benchmark.roofline import PEAK_BYTES

F32 = 4


def _dims(cfg: Dict):
    return cfg["n_text_state"], cfg["n_text_layer"], cfg["n_audio_ctx"], cfg["n_vocab"]


def step_bytes(cfg: Dict, windows: int, beam: int, prompt: int, step: int,
               elem: int = 2) -> float:
    """Least bytes of decode step ``step`` (0-based: the cache holds
    ``step`` generated tokens a row before it) at ``elem`` bytes an element
    of the weights and the cache."""
    d, layers, frames, vocab = _dims(cfg)
    rows = windows * beam
    per_layer = (14 * d * d + 2 * windows * frames * d + 2 * windows * prompt * d
                 + 2 * rows * (step + 1) * d) * elem
    return layers * per_layer + vocab * d * F32 + rows * vocab * F32


def steps_least_s(cfg: Dict, windows: int, beam: int, prompt: int, steps: int,
                  elem: int = 2) -> float:
    """The least time of steps 0 .. steps - 1 of one batch, at the HBM rate."""
    return sum(step_bytes(cfg, windows, beam, prompt, s, elem) for s in range(steps)) / PEAK_BYTES


def decoder_flops(cfg: Dict, windows: int, beam: int, prompt: int, steps: int) -> float:
    """Model FLOPs of one batch's decode: the cross K/V projections of each
    window, the prompt's forward (one row a window, its logits at two
    positions: the last and the no-speech one), then ``steps`` cached steps
    of ``windows * beam`` rows, the step at position ``prompt + s``
    attending to ``prompt + s + 1`` keys and every frame."""
    d, layers, frames, vocab = _dims(cfg)
    rows = windows * beam
    cross_kv = windows * frames * 2 * d * d
    block = 14 * d * d                           # q, k, v, out; cross q, out; MLP
    prime = windows * prompt * (block + 2 * frames * d) + 2 * windows * prompt * prompt * d
    total = layers * (cross_kv + prime) + 2 * windows * d * vocab
    for s in range(steps):
        keys = prompt + s + 1
        total += rows * (layers * (block + 2 * keys * d + 2 * frames * d) + d * vocab)
    return 2.0 * total
