"""GPipe pipeline parallelism for the Whisper encoder and the teacher-forced
decoder, on ``torch.distributed``.

Port of ``lyricalignment_tpu/parallel/pipeline.py``. The pipe stages take
the model axis of the ("data", "model") mesh (``parallel.mesh.make_mesh``),
as JAX's ``--mesh-pipe`` does: stage ``s`` of S owns blocks ``[s * L / S,
(s + 1) * L / S)``, and each rank keeps only its stage's blocks
(:func:`place_pipeline_params` moves every other stage's to the ``meta``
device: their shapes stay for the gathers of ``parallel.mesh``, their bytes
are freed). The conv stem, the final LayerNorm, the token embedding and the
float32 unembedding run replicated outside the loop, as in JAX.

JAX writes the schedule as a ``lax.scan`` over ``n_micro + S - 1`` ticks in
one ``shard_map`` and lets XLA transpose it for the backward. Here the
forward runs the same schedule without its idle fill and drain ticks (JAX
computes and discards them; the results are the same): stage ``s`` takes
micro-batch ``m`` from stage ``s - 1``, runs its blocks and hands the result
to ``s + 1``, so each stage launches its blocks ``n_micro`` times. The last
stage's outputs go to every pipe member. A ``torch.autograd.Function`` keeps
each micro-batch's (input, output) pair with autograd on, and its backward
runs the reverse schedule itself: it takes dy from ``s + 1`` (the last stage
its own copy of the output's gradient, since every member runs the same
replicated tail on the same outputs), calls ``torch.autograd.backward`` on
the kept output (which also accumulates the stage's parameter gradients)
and hands dx to ``s - 1``. Stage 0's dx goes to every pipe member, so the
replicated stem or token embedding gets the same gradient everywhere; the
decoder's cross-attention memory ``xa`` is resident on every stage, so its
gradient is summed over the pipe group. No point-to-point op is left for
the autograd engine to order.

Transport: every send is a ``dist.broadcast`` from the sender over the
group of the two neighbouring stages (every backend takes it, gloo on CUDA
tensors too, where its send and recv take none: two stages sharing one
card, where NCCL refuses two ranks); the output and stage 0's dx go to the
whole pipe group by ``dist.broadcast`` as well.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from lyricalignment_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    STAGE,
    axis_size,
    whisper_param_specs,
)

log = logging.getLogger(__name__)


def stack_encoder_blocks(blocks: Sequence[nn.Module], n_stages: int,
                         kind: str = "encoder") -> List[List[nn.Module]]:
    """The blocks cut stage-major: ``n_stages`` lists of ``L / n_stages``
    consecutive blocks (JAX stacks their leaves ``[n_stages, L / n_stages,
    ...]``). A layer count the stages do not divide raises ``ValueError``."""
    n_layers = len(blocks)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} {kind} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return [list(blocks[s * per:(s + 1) * per]) for s in range(n_stages)]


def stack_decoder_blocks(blocks: Sequence[nn.Module], n_stages: int) -> List[List[nn.Module]]:
    """:func:`stack_encoder_blocks` of the decoder's blocks."""
    return stack_encoder_blocks(blocks, n_stages, kind="decoder")


def _stage_blocks(stacked, mesh, pipe_axis):
    """This rank's stage's blocks of ``stacked``."""
    if len(stacked) != axis_size(mesh, pipe_axis):
        raise ValueError(f"{len(stacked)} stages on a pipe axis of {axis_size(mesh, pipe_axis)}")
    return stacked[mesh.get_local_rank(pipe_axis)]


def place_pipeline_params(stacked: List[List[nn.Module]], mesh,
                          pipe_axis: str = MODEL_AXIS) -> List[List[nn.Module]]:
    """Keep this rank's stage's blocks and move every other stage's to the
    ``meta`` device, in place; returns ``stacked``."""
    own = _stage_blocks(stacked, mesh, pipe_axis)
    for blocks in stacked:
        if blocks is not own:
            for block in blocks:
                block.to("meta")
    return stacked


def stage_whisper(whisper: nn.Module, mesh, sides: Sequence[str] = ("encoder",),
                  pipe_axis: str = MODEL_AXIS) -> nn.Module:
    """Cut a Whisper to this rank's pipeline stage in place: the blocks of
    ``sides`` ("encoder", "decoder") of the other stages go to the ``meta``
    device. Records ``mesh`` and adds the staged leaves to the module's
    ``shard_specs`` as ``STAGE``, so that ``parallel.mesh``'s gathers, its
    model group and the clip's norm take them."""
    n = axis_size(mesh, pipe_axis)
    sides = tuple(sides)
    stacks = [stack_encoder_blocks(getattr(whisper, side).blocks, n, kind=side)
              for side in sides]
    for stacked in stacks:
        place_pipeline_params(stacked, mesh, pipe_axis)
    whisper.mesh = mesh
    staged = {k: v for k, v in whisper_param_specs(whisper, n, pipe=sides).items() if v == STAGE}
    whisper.shard_specs = {**getattr(whisper, "shard_specs", {}), **staged}
    return whisper


def stage_align_params(model: nn.Module, mesh, sides: Sequence[str] = ("encoder",),
                       pipe_axis: str = MODEL_AXIS) -> nn.Module:
    """:func:`stage_whisper` of an AlignModel's backbone; ``model.mesh`` and
    ``model.shard_specs`` (full names) record the result."""
    whisper = stage_whisper(model.whisper_model, mesh, sides, pipe_axis)
    model.mesh = mesh
    model.shard_specs = {f"whisper_model.{k}": v for k, v in whisper.shard_specs.items()}
    return model


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

class PipeLinks:
    """A rank's links within its pipe group: its stage, its neighbours'
    global ranks and the group of each pair of neighbouring stages (every
    rank of the world builds every pair's group, in one order, as
    ``new_group`` requires)."""

    def __init__(self, mesh, pipe_axis: str = MODEL_AXIS):
        self.group = mesh.get_group(pipe_axis)
        self.stage = mesh.get_local_rank(pipe_axis)
        self.n_stages = axis_size(mesh, pipe_axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.pairs = {}
        layout = mesh.mesh.transpose(mesh.mesh_dim_names.index(pipe_axis), -1)
        for row in layout.reshape(-1, self.n_stages).tolist():
            for s in range(self.n_stages - 1):
                group = dist.new_group(row[s:s + 2])
                if row == self.ranks:
                    self.pairs[s] = group
        log.info("pipeline stage %d of %d, sends by broadcast over pairs of stages (%s)",
                 self.stage, self.n_stages, dist.get_backend(self.group))

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1

    def send(self, t: torch.Tensor, to: int) -> None:
        """Send ``t`` to stage ``to`` (a neighbour)."""
        dist.broadcast(t.contiguous(), self.ranks[self.stage],
                       group=self.pairs[min(to, self.stage)])

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        """A tensor shaped like ``like`` from stage ``frm`` (a neighbour)."""
        buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.broadcast(buf, self.ranks[frm], group=self.pairs[min(frm, self.stage)])
        return buf

    def broadcast(self, t: Optional[torch.Tensor], like: torch.Tensor, src: int) -> torch.Tensor:
        """Stage ``src``'s ``t`` on every pipe member (``like`` gives the
        shape and dtype elsewhere)."""
        if self.stage == src:
            out = t.contiguous()
        else:
            out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.broadcast(out, self.ranks[src], group=self.group)
        return out


def pipe_links(mesh, pipe_axis: str = MODEL_AXIS) -> PipeLinks:
    """The mesh's :class:`PipeLinks` over ``pipe_axis``, built once and kept
    on the mesh (with the process groups they use)."""
    cache = mesh.__dict__.setdefault("_pipe_links", {})
    if pipe_axis not in cache:
        cache[pipe_axis] = PipeLinks(mesh, pipe_axis)
    return cache[pipe_axis]


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

class _Schedule:
    """One pipelined call on one rank: ``stage_fn(h, xa_micro)`` runs this
    stage's blocks on a micro-batch."""

    def __init__(self, links: PipeLinks, n_micro: int, stage_fn: Callable):
        self.links, self.n_micro, self.stage_fn = links, n_micro, stage_fn
        self.kept = []

    def forward(self, x: torch.Tensor, xa: Optional[torch.Tensor], grad: bool) -> torch.Tensor:
        links = self.links
        xs = x.chunk(self.n_micro)
        xas = [None] * self.n_micro if xa is None else xa.chunk(self.n_micro)
        outs = []
        for m in range(self.n_micro):
            h = xs[m] if links.stage == 0 else links.recv(xs[m], links.stage - 1)
            a = xas[m]
            if grad:
                h = h.detach().requires_grad_()
                a = None if a is None else a.detach().requires_grad_()
            y = self.stage_fn(h, a)
            if grad:
                self.kept.append((h, a, y))
            if links.last:
                outs.append(y.detach())
            else:
                links.send(y.detach(), links.stage + 1)
        return links.broadcast(torch.cat(outs) if links.last else None, x,
                               links.n_stages - 1)

    def backward(self, dy: torch.Tensor):
        links = self.links
        dys = dy.contiguous().chunk(self.n_micro)
        dxs, dxas = [None] * self.n_micro, [None] * self.n_micro
        for m in reversed(range(self.n_micro)):
            h, a, y = self.kept[m]
            g = dys[m] if links.last else links.recv(y, links.stage + 1)
            torch.autograd.backward(y, g)
            if links.stage == 0:
                dxs[m] = h.grad
            else:
                links.send(h.grad, links.stage - 1)
            if a is not None:
                dxas[m] = a.grad if a.grad is not None else torch.zeros_like(a)
        self.kept = []
        dx = links.broadcast(torch.cat(dxs) if links.stage == 0 else None, dy, 0)
        dxa = None
        if dxas[0] is not None:
            dxa = torch.cat(dxas)
            dist.all_reduce(dxa, group=links.group)
        return dx, dxa


class _Pipeline(torch.autograd.Function):
    """The schedule under autograd: the stage's parameters are inputs so
    that the output needs a gradient whenever they do; their gradients are
    accumulated by the backward's ``torch.autograd.backward``, so the
    Function returns none for them."""

    @staticmethod
    def forward(ctx, schedule, x, xa, *params):
        ctx.schedule, ctx.n_params = schedule, len(params)
        with torch.enable_grad():
            return schedule.forward(x, xa, grad=True)

    @staticmethod
    def backward(ctx, dy):
        dx, dxa = ctx.schedule.backward(dy)
        return (None, dx, dxa) + (None,) * ctx.n_params


def _run_pipeline(mesh, pipe_axis, n_micro, blocks, x, xa, stage_fn):
    """``stage_fn`` pipelined over the pipe axis, differentiable when
    autograd records and anything it reads needs a gradient."""
    if x.shape[0] % n_micro:
        raise ValueError(f"per-shard batch {x.shape[0]} not divisible by n_micro={n_micro}")
    schedule = _Schedule(pipe_links(mesh, pipe_axis), n_micro, stage_fn)
    params = [p for block in blocks for p in block.parameters() if p.requires_grad]
    inputs = [x] + ([] if xa is None else [xa]) + params
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Pipeline.apply(schedule, x, xa, *params)
    return schedule.forward(x, xa, grad=False)


def pipeline_blocks(stacked: List[List[nn.Module]], x: torch.Tensor, cfg, mesh,
                    n_micro: int = 2, pipe_axis: str = MODEL_AXIS,
                    remat: bool = False) -> torch.Tensor:
    """The encoder blocks of ``stacked`` (:func:`stack_encoder_blocks`) as
    an S-stage pipeline over ``pipe_axis`` with ``n_micro`` micro-batches
    of this rank's rows ``x`` [B, T, D] (the post-stem activations); each
    stage runs ``models.whisper.encoder_blocks``, so ``cfg``'s one-pass
    key-bias route and int8 encoder, and ``remat``, apply as in the
    unpipelined encoder. Returns [B, T, D] on every pipe member."""
    from lyricalignment_tpu_torch.models.whisper import encoder_blocks

    blocks = _stage_blocks(stacked, mesh, pipe_axis)
    return _run_pipeline(mesh, pipe_axis, n_micro, blocks, x, None,
                         lambda h, _a: encoder_blocks(blocks, cfg, h, remat))


def pipeline_decoder_blocks(stacked: List[List[nn.Module]], x: torch.Tensor,
                            xa: torch.Tensor, cfg, mesh, n_micro: int = 2,
                            pipe_axis: str = MODEL_AXIS, remat: bool = False) -> torch.Tensor:
    """The decoder blocks of ``stacked`` as a pipeline (the teacher-forced
    full-sequence pass of training; KV-cached decoding stays single-stage):
    x [B, S, D] the token activations, xa [B, Ta, D] the cross-attention
    memory, resident on every stage, which attends to the memory of the
    micro-batch it is running."""
    from lyricalignment_tpu_torch.models.whisper import decoder_blocks

    blocks = _stage_blocks(stacked, mesh, pipe_axis)
    return _run_pipeline(mesh, pipe_axis, n_micro, blocks, x, xa,
                         lambda h, a: decoder_blocks(blocks, h, a, remat))


def pipeline_encode_audio(whisper: nn.Module, mel: torch.Tensor, mesh, n_micro: int = 2,
                          pipe_axis: str = MODEL_AXIS, remat: bool = False,
                          stacked: Optional[List[List[nn.Module]]] = None) -> torch.Tensor:
    """``models.whisper.encode_audio`` with the encoder blocks pipelined over
    ``pipe_axis``: the same result as one process. ``stacked`` (from
    :func:`stack_encoder_blocks` and :func:`place_pipeline_params`) gives
    the blocks; by default they are the whisper's own, cut by stage (this
    rank's stage must be resident)."""
    enc = whisper.encoder
    if stacked is None:
        stacked = stack_encoder_blocks(enc.blocks, axis_size(mesh, pipe_axis))
    return enc(mel, remat=remat, run_blocks=lambda x, remat: pipeline_blocks(
        stacked, x, enc.cfg, mesh, n_micro=n_micro, pipe_axis=pipe_axis, remat=remat))


def pipeline_decoder_logits(whisper: nn.Module, tokens: torch.Tensor,
                            audio_features: torch.Tensor, mesh, n_micro: int = 2,
                            pipe_axis: str = MODEL_AXIS, remat: bool = False,
                            stacked: Optional[List[List[nn.Module]]] = None) -> torch.Tensor:
    """``models.whisper.decoder_logits`` with the decoder blocks pipelined
    over ``pipe_axis``; the embeddings and the float32 unembedding run
    replicated."""
    dec = whisper.decoder
    if stacked is None:
        stacked = stack_decoder_blocks(dec.blocks, axis_size(mesh, pipe_axis))
    return dec(tokens, audio_features, remat=remat, run_blocks=lambda x, xa, remat: (
        pipeline_decoder_blocks(stacked, x, xa, whisper.cfg, mesh, n_micro=n_micro,
                                pipe_axis=pipe_axis, remat=remat)))


def make_pipeline_encode_fn(mesh, n_micro: int = 2, pipe_axis: str = MODEL_AXIS) -> Callable:
    """The encoder for ``forward_from_audio(encode_fn=...)`` /
    ``make_train_step(encode_fn=...)``, with ``encode_audio``'s calling
    convention ``(whisper, mel, remat=False)``."""

    def encode_fn(whisper, mel, remat=False):
        return pipeline_encode_audio(whisper, mel, mesh, n_micro=n_micro, pipe_axis=pipe_axis,
                                     remat=remat)

    return encode_fn


def make_pipeline_logits_fn(mesh, n_micro: int = 2, pipe_axis: str = MODEL_AXIS) -> Callable:
    """The teacher-forced decoder for ``forward_from_audio(decode_fn=...)`` /
    ``make_train_step(decode_fn=...)``, with ``decoder_logits``' calling
    convention ``(whisper, tokens, audio_features, remat=False)``."""

    def decode_fn(whisper, tokens, audio_features, remat=False):
        return pipeline_decoder_logits(whisper, tokens, audio_features, mesh, n_micro=n_micro,
                                       pipe_axis=pipe_axis, remat=remat)

    return decode_fn
