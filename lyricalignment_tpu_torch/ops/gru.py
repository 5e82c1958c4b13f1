"""Stacked bi-GRU over encoder frames, masked to true lengths.

Port of ``lyricalignment_tpu/ops/gru.py:36-88,183-209``. The recurrence is
``torch.nn.GRU`` (cuDNN on the card; the JAX package has no Pallas kernel
here), which uses the same r/z/n gate order as the JAX scan.

With ``lengths`` the sequences are packed, so each one's reverse direction
starts from a zero state at its last true frame: outputs at positions
``< length`` equal a run on the exactly trimmed sequence, as the JAX scan's
hold-the-state masking guarantees (`gru.py:43-51`). Positions past a length
are zero here (the JAX scan leaves the held state there); nothing reads them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


def bigru_apply(rnn: nn.GRU, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, In] -> [B, T, H * directions] (``rnn`` is batch-first)."""
    if lengths is None:
        return rnn(x)[0]
    t = x.shape[1]
    lens = lengths.detach().to("cpu", torch.int64).clamp(1, t)
    packed = pack_padded_sequence(x, lens, batch_first=True, enforce_sorted=False)
    out, _ = pad_packed_sequence(rnn(packed)[0], batch_first=True, total_length=t)
    return out
