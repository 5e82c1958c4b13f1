"""Stacked bi-GRU over encoder frames, masked to true lengths, with
inverted dropout between layers.

Port of ``lyricalignment_tpu/ops/gru.py:36-88,183-209``. The recurrence is
``torch.nn.GRU`` (cuDNN on the card; the JAX package has no Pallas kernel
here), which uses the same r/z/n gate order as the JAX scan. The layers run
one at a time on the stacked module's own ``weight_ih_l{i}`` ...
parameters (``torch.func.functional_call`` on a one-layer template), so
dropout between layers is drawn from an explicit ``torch.Generator``:
``nn.GRU(dropout=...)`` would draw from cuDNN's own random state.

With ``lengths`` the sequences are packed, so each one's reverse direction
starts from a zero state at its last true frame: outputs at positions
``< length`` equal a run on the exactly trimmed sequence, as the JAX scan's
hold-the-state masking guarantees (`gru.py:43-51`). Positions past a length
are zero here (the JAX scan leaves the held state there); nothing reads them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

_NAMES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


@functools.lru_cache(maxsize=None)
def _one_layer(input_size: int, hidden_size: int, bidirectional: bool) -> nn.GRU:
    """Parameter-free template of one GRU layer (its meta-device parameters
    are replaced on every call)."""
    return nn.GRU(input_size, hidden_size, num_layers=1, bidirectional=bidirectional,
                  batch_first=True, device="meta")


def _layer(rnn: nn.GRU, i: int, seq):
    suffixes = ("", "_reverse") if rnn.bidirectional else ("",)
    params = {f"{n}_l0{s}": getattr(rnn, f"{n}_l{i}{s}") for n in _NAMES for s in suffixes}
    in_size = rnn.input_size if i == 0 else rnn.hidden_size * len(suffixes)
    layer = _one_layer(in_size, rnn.hidden_size, rnn.bidirectional)
    layer.training = torch.is_grad_enabled()  # cuDNN keeps backward state only then
    return functional_call(layer, params, (seq,))[0]


def inverted_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
                     rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Keep each element with probability 1 - rate and scale it by
    1 / (1 - rate) (``jax.random.bernoulli`` + ``where`` in the JAX scan);
    the mask comes from ``generator``, which lives on ``x``'s device.
    ``rows`` (start, total): x holds rows [start, start + B) of a batch of
    ``total`` (a data rank's shard); the whole batch's mask is drawn and
    these rows taken, so the shards together draw the unsharded mask."""
    shape = x.shape if rows is None else (rows[1],) + tuple(x.shape[1:])
    draw = torch.rand(shape, generator=generator, device=x.device)
    if rows is not None:
        draw = draw[rows[0]:rows[0] + x.shape[0]]
    keep = draw < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def bigru_apply(rnn: nn.GRU, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                dropout_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [B, T, In] -> [B, T, H * directions] (``rnn`` is batch-first).
    Dropout applies to the outputs of every layer but the last, and only
    when a ``generator`` is given; ``dropout_rows`` as
    :func:`inverted_dropout`'s ``rows`` (unpacked sequences only)."""
    t = x.shape[1]
    seq = x
    if lengths is not None:
        if dropout_rows is not None:
            raise ValueError("dropout_rows needs unpacked sequences (no lengths)")
        lens = lengths.detach().to("cpu", torch.int64).clamp(1, t)
        seq = pack_padded_sequence(x, lens, batch_first=True, enforce_sorted=False)
    for i in range(rnn.num_layers):
        seq = _layer(rnn, i, seq)
        if dropout > 0.0 and generator is not None and i < rnn.num_layers - 1:
            if isinstance(seq, PackedSequence):
                seq = seq._replace(data=inverted_dropout(seq.data, dropout, generator))
            else:
                seq = inverted_dropout(seq, dropout, generator, dropout_rows)
    if lengths is None:
        return seq
    return pad_packed_sequence(seq, batch_first=True, total_length=t)[0]
