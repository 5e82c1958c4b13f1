"""Stacked bi-GRU over encoder frames, masked to true lengths, with
inverted dropout between layers.

Port of ``lyricalignment_tpu/ops/gru.py:36-88,183-209``. Two routes, by
what the caller's grad mode says (:func:`kernel_route`):

* grad disabled (inference: ``align_records`` under
  ``torch.inference_mode()``, evaluation): each layer is one float32 matmul
  for both directions' input products (the JAX scan's hoisted projection)
  and then the recurrence, ``csrc/gru.cu``'s ``la_gru_recurrence`` for CUDA
  tensors and :func:`gru_recurrence_plain`, the same arithmetic as a masked
  loop over time, for CPU ones. The lengths stay on the device.
* grad enabled (training): ``torch.nn.GRU`` (cuDNN on the card), whose
  backward the step needs. The layers run one at a time on the stacked
  module's own ``weight_ih_l{i}`` ... parameters
  (``torch.func.functional_call`` on a one-layer template), so dropout
  between layers is drawn from an explicit ``torch.Generator``:
  ``nn.GRU(dropout=...)`` would draw from cuDNN's own random state. With
  ``lengths`` the sequences are packed.

Either way each sequence's reverse direction starts from a zero state at
its last true frame: outputs at positions ``< length`` equal a run on the
exactly trimmed sequence, as the JAX scan's hold-the-state masking
guarantees (`gru.py:43-51`). Positions past a length are zero here (the
JAX scan leaves the held state there); nothing reads them. Both routes use
the same r/z/n gate order as the JAX scan.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

from lyricalignment_tpu_torch import kernels

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


def kernel_route() -> bool:
    """Whether :func:`bigru_apply` takes the recurrence kernel (grad
    disabled) rather than ``nn.GRU`` (grad enabled)."""
    return not torch.is_grad_enabled()


@contextlib.contextmanager
def _one_cpu_thread():
    """PyTorch's CPU ops on one thread inside the block: a loop of ops this
    small gains nothing from the pool, and on a loaded CPU a pooled batched
    matmul or tanh of this size waits milliseconds for its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def gru_recurrence_plain(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """What ``la_gru_recurrence`` computes, as a loop over time: gi
    f32[B, T, D * 3H] (each direction's input products with b_ih, gates r,
    z, n), w_hh f32[D, 3H, H], b_hh f32[D, 3H], lengths int[B] in [1, T] ->
    f32[B, T, D * H]. Step s runs t = s forward and t = T - 1 - s in
    reverse, the directions as one batch; a row is active at t < length
    and outputs zero elsewhere. An inactive row's state is zeroed: the
    reverse direction's is zero until its last true frame, as the kernel's
    held zero state, and the forward direction's is never read again (the
    kernel holds it). h' = (1 - z) n + z h is a lerp."""
    b, t = gi.shape[:2]
    dirs, h = w_hh.shape[0], w_hh.shape[2]
    gi = gi.reshape(b, t, dirs, 3 * h).permute(2, 1, 0, 3)              # [D, T, B, 3H]
    steps = torch.arange(t, device=gi.device)
    if dirs == 2:  # the reverse direction in its own order of steps
        gi = torch.stack([gi[0], gi[1].flip(0)])
        steps = torch.stack([steps, steps.flip(0)])
    else:
        steps = steps[None]
    gi = gi.contiguous()
    mask = (steps[:, :, None] < lengths.to(gi.device)).to(gi.dtype)[..., None]  # [D, T, B, 1]
    w_t, bias = w_hh.transpose(1, 2), b_hh[:, None]
    state = gi.new_zeros(dirs, b, h)
    out = gi.new_empty(dirs, t, b, h)
    with _one_cpu_thread():
        for s in range(t):
            x = gi[:, s]
            gh = torch.baddbmm(bias, state, w_t)                           # [D, B, 3H]
            rz = torch.sigmoid(x[..., :2 * h] + gh[..., :2 * h])
            n = torch.tanh(x[..., 2 * h:] + rz[..., :h] * gh[..., 2 * h:])
            state = torch.lerp(n, state, rz[..., h:]) * mask[:, s]
            out[:, s] = state
    if dirs == 2:
        out = torch.stack([out[0], out[1].flip(0)])
    return out.permute(2, 1, 0, 3).reshape(b, t, dirs * h)


def gru_plan(batch: int, steps: int, hidden: int, dirs: int) -> dict:
    """The kernel's launch layout at this shape (``la_gru_plan``); raises
    where no launch takes it (a hidden size above 384)."""
    out = (ctypes.c_int * 8)()
    rc = kernels.library().la_gru_plan(batch, steps, hidden, dirs, ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"la_gru_recurrence: no launch takes batch {batch}, {steps} steps, "
                         f"hidden {hidden}, {dirs} directions (the kernel takes hidden "
                         f"sizes up to 384; code {rc})")
    keys = ("cluster", "units", "groups", "rows", "nk4", "active_clusters", "threads",
            "smem_bytes")
    return dict(zip(keys, out))


def gru_recurrence(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """:func:`gru_recurrence_plain`'s function: ``la_gru_recurrence`` for
    CUDA tensors (one launch, both directions), the plain version for CPU
    ones. ``lengths`` is int32 on ``gi``'s device for the kernel, which
    reads it there."""
    if not gi.is_cuda:
        kernels.plain_or_raise("gru_recurrence", gi)
        return gru_recurrence_plain(gi, w_hh, b_hh, lengths)
    kernels.check_cuda("gru_recurrence gi", gi, torch.float32, 3)
    kernels.check_cuda("gru_recurrence w_hh", w_hh, torch.float32, 3)
    kernels.check_cuda("gru_recurrence b_hh", b_hh, torch.float32, 2)
    kernels.check_cuda("gru_recurrence lengths", lengths, torch.int32, 1)
    b, t = gi.shape[:2]
    dirs, h = w_hh.shape[0], w_hh.shape[2]
    if (w_hh.shape[1] != 3 * h or b_hh.shape != (dirs, 3 * h) or gi.shape[2] != dirs * 3 * h
            or lengths.shape != (b,) or dirs not in (1, 2)):
        raise ValueError("gru_recurrence: shapes do not agree")
    out = torch.empty((b, t, dirs * h), dtype=torch.float32, device=gi.device)
    if b and t:
        gru_plan(b, t, h, dirs)  # raises where no launch takes the shape
        kernels.launch("la_gru_recurrence", gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), b, t, h, dirs,
                       kernels.stream_of(gi))
    return out


def _bigru_recurrence(rnn: nn.GRU, x: torch.Tensor, lengths: Optional[torch.Tensor],
                      dropout: float, generator: Optional[torch.Generator],
                      dropout_rows: Optional[Tuple[int, int]]) -> torch.Tensor:
    """The grad-disabled route: per layer, both directions' input products
    in one matmul, then :func:`gru_recurrence`."""
    b, t = x.shape[:2]
    if lengths is None:
        lens = torch.full((b,), t, dtype=torch.int32, device=x.device)
    else:
        lens = lengths.to(device=x.device, dtype=torch.int32).clamp(1, max(t, 1))
    suffixes = ("", "_reverse") if rnn.bidirectional else ("",)
    seq = x
    for i in range(rnn.num_layers):
        p = {n: [getattr(rnn, f"{n}_l{i}{s}") for s in suffixes] for n in _NAMES}
        gi = F.linear(seq, torch.cat(p["weight_ih"]), torch.cat(p["bias_ih"]))
        seq = gru_recurrence(gi, torch.stack(p["weight_hh"]), torch.stack(p["bias_hh"]), lens)
        if dropout > 0.0 and generator is not None and i < rnn.num_layers - 1:
            seq = inverted_dropout(seq, dropout, generator, dropout_rows)
    return seq


def bigru_apply(rnn: nn.GRU, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                dropout_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [B, T, In] -> [B, T, H * directions] (``rnn`` is batch-first).
    Dropout applies to the outputs of every layer but the last, and only
    when a ``generator`` is given; ``dropout_rows`` as
    :func:`inverted_dropout`'s ``rows`` (with grad enabled, unpacked
    sequences only). Grad disabled takes the recurrence kernel
    (:func:`kernel_route`)."""
    if kernel_route():
        return _bigru_recurrence(rnn, x, lengths, dropout, generator, dropout_rows)
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
