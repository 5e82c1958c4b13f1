"""Frame-wise alignment head: stacked bi-GRU -> Mish -> Linear.

Port of ``lyricalignment_tpu/models/align_head.py`` (the reference's ``RNN``
module, `module/align_model.py:11-40`); parameter names are the reference's
``align_rnn.rnn.*`` / ``align_rnn.fc.*``. The head computes in float32
whatever the encoder's compute dtype: its input is upcast before the GRU,
which is ``nn.GRU`` with grad enabled and the recurrence kernel with grad
disabled (``ops/gru.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyricalignment_tpu_torch.models.whisper import no_tf32
from lyricalignment_tpu_torch.ops.gru import bigru_apply


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class AlignHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, bidirectional: bool = True):
        super().__init__()
        self.rnn = nn.GRU(input_dim, hidden_dim, num_layers=num_layers,
                          bidirectional=bidirectional, batch_first=True)
        self.fc = nn.Linear(hidden_dim * (2 if bidirectional else 1), output_dim)


def align_head_hidden(head: AlignHead, x: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None, dropout: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      dropout_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [B, T, D] encoder frames -> pre-classifier hidden f32[B, T, fc_in]
    (bi-GRU -> Mish, before the fc). ``lengths`` (int[B]) masks the
    recurrences to true frame counts: valid frames equal an exact-trim run.
    ``dropout`` between the GRU layers is active only with a ``generator``;
    ``dropout_rows`` (start, total) draws a data shard's rows of the whole
    batch's mask (``ops.gru.inverted_dropout``)."""
    # cuDNN runs float32 RNN matmuls in TF32 unless told otherwise; the
    # kernel route's input products are float32 matmuls
    with no_tf32(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        h = bigru_apply(head.rnn, x.float(), lengths, dropout, generator, dropout_rows)
    return mish(h)


def align_head_apply(head: AlignHead, x: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None, dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     dropout_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [B, T, D] -> logits f32[B, T, output_dim]."""
    return head.fc(align_head_hidden(head, x, lengths, dropout, generator, dropout_rows))
