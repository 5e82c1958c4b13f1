"""Process mesh and sharding rules (data parallel x tensor parallel, and the
sequence-parallel encode), on ``torch.distributed``.

Port of ``lyricalignment_tpu/parallel/mesh.py``. The JAX package places
parameters with ``NamedSharding``s and lets GSPMD insert every collective;
PyTorch has no such compiler, so here each collective is written out where
XLA would put it, as Megatron-LM writes them:

* a 2-D ``("data", "model")`` mesh (:func:`make_mesh`) is a ``DeviceMesh``;
  rank ``r`` sits at ``(r // model, r % model)``, as JAX's
  ``devices.reshape(data, model)``; the process groups of each axis come
  from it (``mesh.get_group("model")``);
* the spec table (:func:`align_param_specs`) says which parameters are
  column-parallel (q / k / v and fc1: output rows split over the model
  axis), row-parallel (out and fc2: input columns split, the bias added once
  after the all-reduce), vocab-sharded (``decoder.token_embedding``),
  stage-owned (a pipelined side's blocks, ``parallel.pipeline``: whole on
  the rank of their stage, on the ``meta`` device elsewhere) or replicated
  (the conv stem, every LayerNorm, the positional embeddings and the GRU
  head). The conv stem stays replicated where JAX shards its output
  channels: that changes where bytes sit, not what is computed. An
  attention whose head count, or an MLP whose 4 * D, does not divide the
  model axis stays replicated, as JAX replicates an indivisible leaf
  (``mesh.py:148-157``); results are equal either way;
* :func:`shard_align_params` cuts a full model into its rank's shard in
  place, and :func:`gather_state_dict` puts the full state dict back
  together (checkpoints are written full, in the reference key layout; a
  stage-owned tensor is all-reduced from its owner into zeros);
* the Megatron operators :func:`copy_to_model` ("f": identity forward,
  all-reduce backward, before a column-parallel linear) and
  :func:`reduce_from_model` ("g": all-reduce forward, identity backward,
  after a row-parallel linear), and :func:`gather_dim` (an all-gather whose
  backward takes this rank's slice), are ``torch.autograd.Function``s on
  plain local tensors: the kernel wrappers take raw pointers, the AdamW
  chain runs ``torch._foreach_*`` and the converters read plain state
  dicts, so no DTensor is unwrapped anywhere;
* :func:`sequence_sharding` is the group of the sequence-parallel encode
  (``models.whisper.encode_audio(sequence_sharding=...)``): rank r holds a
  contiguous run of the T frames, GSPMD's split (:func:`frame_split`:
  ceil(T / m) each, the last ranks the rest), and a sequence -> heads
  all-to-all (Ulysses, with uneven splits) gives the attention kernels
  every frame of its share of the H heads (:func:`head_split`: sizes that
  differ by at most one, 0 where H < m), so any T and H take any m.

The all-gathers are all-reduces into a zero-filled buffer into which each
rank wrote its slice: exact (a value plus zeros), and possible on every
backend (gloo reduces CUDA tensors but does not gather them).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

COLUMN, ROW, VOCAB, STAGE, REPLICATED = "column", "row", "vocab", "stage", "replicated"
# the dimension of a parameter that each kind splits over the model axis
SHARD_DIM = {COLUMN: 0, ROW: 1, VOCAB: 0}


def mesh_shape(data: int, model: int, n: int) -> Tuple[int, int]:
    """The (data, model) shape of a mesh over ``n`` ranks; ``data=-1``
    takes the rest (JAX ``make_mesh``'s rule and errors)."""
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


def make_mesh(data: int = -1, model: int = 1, device_type: str = "cpu"):
    """A 2-D ("data", "model") ``DeviceMesh`` over the initialised world
    (``cli.common.init_distributed`` or the caller's own
    ``init_process_group``); ``data=-1`` takes the rest of the world."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(data, model, dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh[axis].size()


@dataclass(frozen=True)
class BatchSharding:
    """A data rank's rows of a global batch: rows ``[rank * n / size,
    (rank + 1) * n / size)`` of n (JAX ``P("data")``)."""

    rank: int
    size: int

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"batch of {n} not divisible by the data axis ({self.size})")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x):
        """This rank's rows of ``x`` (a numpy array or a tensor)."""
        return x[self.rows(x.shape[0])]


def batch_sharding(mesh) -> BatchSharding:
    return BatchSharding(mesh.get_local_rank(DATA_AXIS), axis_size(mesh, DATA_AXIS))


def sequence_sharding(mesh):
    """The process group over which the sequence-parallel encode splits
    frames: the model axis (JAX ``P("data", "model", None)``)."""
    return mesh.get_group(MODEL_AXIS)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Before a column-parallel linear (``group`` None: unsharded, x)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """After a row-parallel linear: the sum of every rank's partial x."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over ``group`` (no gradient)."""
    return x if group is None else _all_reduce(x.clone(), group, dist.ReduceOp.MAX)


def _gather(x: torch.Tensor, dim: int, group, sizes=None) -> torch.Tensor:
    """``sizes``: every rank's extent along ``dim`` (None: all equal)."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    sizes = sizes or [x.shape[dim]] * m
    shape = list(x.shape)
    shape[dim] = sum(sizes)
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, sum(sizes[:r]), sizes[r]).copy_(x)
    return _all_reduce(full, group)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` whose backward takes this rank's slice (the
    consumers of the gathered tensor run replicated over the group)."""

    @staticmethod
    def forward(ctx, x, dim, group, sizes):
        r = dist.get_rank(group)
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.start = sum(sizes[:r]) if sizes else r * ctx.n
        return _gather(x, dim, group, sizes)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


def gather_dim(x: torch.Tensor, dim: int, group, sizes=None) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order; ``sizes``
    lists the ranks' extents along ``dim`` where they differ."""
    return x if group is None else _GatherDim.apply(x, dim, group, sizes)


def frame_split(t: int, m: int) -> list:
    """GSPMD's split of t frames over m ranks: ceil(t / m) each in rank
    order, the last ranks the rest (0 once the frames run out)."""
    per = -(-t // m)
    return [max(0, min(per, t - r * per)) for r in range(m)]


def head_split(h: int, m: int) -> list:
    """h heads over m ranks, sizes differing by at most one (the first
    h % m ranks take one more; 0 where h < m)."""
    return [h // m + (r < h % m) for r in range(m)]


def _all_to_all(chunks, recv_shapes, group) -> list:
    """Send ``chunks[j]`` to rank j and return what each rank j sent here,
    shaped ``recv_shapes[j]``: one ``all_to_all_single`` over the chunks
    flattened, with uneven split sizes."""
    send = torch.cat([c.reshape(-1) for c in chunks])
    sizes = [math.prod(s) for s in recv_shapes]
    recv = send.new_empty(sum(sizes))
    dist.all_to_all_single(recv, send, output_split_sizes=sizes,
                           input_split_sizes=[c.numel() for c in chunks], group=group)
    return [part.view(s) for part, s in zip(recv.split(sizes), recv_shapes)]


def seq_to_heads(x: torch.Tensor, t: int, group) -> torch.Tensor:
    """Ulysses all-to-all of the sequence-parallel encode: [B, T_r, H, Dh]
    (this rank's run of the ``t`` frames, every head) -> [B, t, H_r, Dh]
    (every frame, this rank's heads), with :func:`frame_split`'s runs and
    :func:`head_split`'s heads."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    b, _, h, d = x.shape
    heads = head_split(h, m)
    parts = _all_to_all(x.split(heads, dim=2),
                        [(b, tj, heads[r], d) for tj in frame_split(t, m)], group)
    return torch.cat(parts, dim=1)


def heads_to_seq(y: torch.Tensor, h: int, group) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`: [B, T, H_r, Dh] -> [B, T_r, h,
    Dh]."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    b, t, _, d = y.shape
    runs = frame_split(t, m)
    parts = _all_to_all(y.split(runs, dim=1),
                        [(b, runs[r], hj, d) for hj in head_split(h, m)], group)
    return torch.cat(parts, dim=2)


def gather_objects(obj, group=None) -> list:
    """Every rank's ``obj`` of ``group`` (None: the world), in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------------------
# The spec table
# ---------------------------------------------------------------------------

_LINEAR_LEAVES = ("weight", "bias", "weight_q", "weight_s")


def _linear_specs(prefix: str, kind: str, names, out: Dict[str, str]) -> None:
    """A column- or row-parallel linear's leaves (``Int8Linear``'s too: the
    int8 weight as the weight; its per-output-channel scale with the output
    rows, so global for a row-parallel one; a row-parallel bias is added
    once after the all-reduce and stays replicated)."""
    for leaf in _LINEAR_LEAVES:
        name = f"{prefix}.{leaf}"
        if name not in names:
            continue
        if leaf in ("weight", "weight_q"):
            out[name] = kind
        elif kind == COLUMN:
            out[name] = COLUMN


def whisper_param_specs(whisper: nn.Module, model_size: int = 1,
                        pipe: Tuple[str, ...] = ()) -> Dict[str, str]:
    """``{state_dict name: column | row | vocab | stage | replicated}`` of a
    Whisper over a model axis of ``model_size`` (JAX ``whisper_param_specs``,
    with the indivisible-module rule above). ``pipe`` names the sides
    ("encoder", "decoder") whose blocks are pipeline stages over the model
    axis instead: every leaf of their blocks is ``stage``, and nothing is
    tensor-parallel."""
    cfg = whisper.cfg
    names = set(whisper.state_dict())
    specs = {name: REPLICATED for name in names}
    if pipe:
        specs.update({name: STAGE for name in names
                      if name.split(".")[0] in pipe and name.split(".")[1] == "blocks"})
        return specs
    sides = (("encoder", cfg.n_audio_layer, cfg.n_audio_head, cfg.n_audio_state, ("attn",)),
             ("decoder", cfg.n_text_layer, cfg.n_text_head, cfg.n_text_state,
              ("attn", "cross_attn")))
    for side, n_layer, n_head, d, attns in sides:
        for i in range(n_layer):
            block = f"{side}.blocks.{i}"
            if n_head % model_size == 0:
                for attn in attns:
                    for lin in ("query", "key", "value"):
                        _linear_specs(f"{block}.{attn}.{lin}", COLUMN, names, specs)
                    _linear_specs(f"{block}.{attn}.out", ROW, names, specs)
            if (4 * d) % model_size == 0:
                _linear_specs(f"{block}.mlp.0", COLUMN, names, specs)
                _linear_specs(f"{block}.mlp.2", ROW, names, specs)
    if cfg.n_vocab % model_size == 0:
        specs["decoder.token_embedding.weight"] = VOCAB
    return specs


def align_param_specs(model: nn.Module, model_size: int = 1) -> Dict[str, str]:
    """The table of a full AlignModel: the backbone's (prefixed
    ``whisper_model.``) and the GRU head's, replicated."""
    specs = {f"whisper_model.{k}": v
             for k, v in whisper_param_specs(model.whisper_model, model_size).items()}
    specs.update({f"align_rnn.{k}": REPLICATED for k in model.align_rnn.state_dict()})
    return specs


def shard_tensor(t: torch.Tensor, kind: str, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of a full tensor of ``kind`` (a copy; a
    stage-owned tensor is whole on its owner, see :func:`shard_tensors`)."""
    if kind in (REPLICATED, STAGE):
        return t
    dim = SHARD_DIM[kind]
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).clone()


def _model_axis(mesh) -> Tuple[object, int, int]:
    return (mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS),
            axis_size(mesh, MODEL_AXIS))


def _replace(root: nn.Module, name: str, value: torch.Tensor) -> None:
    """Swap the parameter or buffer ``name`` of ``root`` for ``value``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = root.get_submodule(owner_name)
    if leaf in owner._parameters:
        old = owner._parameters[leaf]
        owner._parameters[leaf] = nn.Parameter(value, requires_grad=old.requires_grad)
    else:
        owner._buffers[leaf] = value


@torch.no_grad()
def shard_whisper(whisper: nn.Module, mesh, tp: bool = True) -> nn.Module:
    """Cut a full Whisper into this rank's tensor-parallel shard, in place
    (``tp`` False: replicated, the mesh only recorded). Each sharded
    attention keeps H / m heads and the model group; each sharded MLP its
    group; a vocab-sharded decoder its group and first row. The module
    records ``mesh`` and the table of what it sharded (``shard_specs``). The
    one-pass key-bias route is turned off, as the JAX CLIs turn it off
    under any mesh: the encoder attention takes the same kernel entry
    without a bias."""
    whisper.mesh = mesh
    whisper.shard_specs = {}
    whisper.cfg = whisper.encoder.cfg = dataclasses.replace(whisper.cfg, onepass_encoder=False)
    if not tp:
        return whisper
    group, rank, size = _model_axis(mesh)
    specs = {k: v for k, v in whisper_param_specs(whisper, size).items() if v != REPLICATED}
    sd = whisper.state_dict()
    for name, kind in specs.items():
        _replace(whisper, name, shard_tensor(sd[name], kind, rank, size))
    for side in ("encoder", "decoder"):
        for i, block in enumerate(getattr(whisper, side).blocks):
            for attn_name in ("attn", "cross_attn"):
                attn = getattr(block, attn_name, None)
                if attn is not None and f"{side}.blocks.{i}.{attn_name}.out.{_weight(attn.out)}" in specs:
                    attn.n_head //= size
                    attn.group = group
            if f"{side}.blocks.{i}.mlp.2.{_weight(block.mlp[2])}" in specs:
                block.mlp_group = group
    if "decoder.token_embedding.weight" in specs:
        whisper.decoder.vocab_group = group
        whisper.decoder.vocab_start = rank * (whisper.cfg.n_vocab // size)
    whisper.shard_specs = specs
    return whisper


def _weight(lin: nn.Module) -> str:
    return "weight_q" if hasattr(lin, "weight_q") else "weight"


def shard_align_params(model: nn.Module, mesh, tp: bool = True) -> nn.Module:
    """Cut a full AlignModel into this rank's shard in place (the backbone
    by :func:`shard_whisper`; the GRU head replicated). ``model.mesh`` and
    ``model.shard_specs`` (full names) record the result."""
    shard_whisper(model.whisper_model, mesh, tp)
    model.cfg = dataclasses.replace(model.cfg, whisper=model.whisper_model.cfg)
    model.mesh = mesh
    model.shard_specs = {f"whisper_model.{k}": v
                         for k, v in model.whisper_model.shard_specs.items()}
    return model


def model_group(module: nn.Module):
    """The model group of a sharded module (None: neither tensor-parallel
    nor pipelined)."""
    mesh = getattr(module, "mesh", None)
    if mesh is None or not module.shard_specs:
        return None
    return mesh.get_group(MODEL_AXIS)


def _from_owner(t: torch.Tensor, device, group) -> torch.Tensor:
    """A stage-owned tensor on every rank: its owner's copy all-reduced
    into zeros (``t`` is on the ``meta`` device except on the owner)."""
    full = torch.zeros(t.shape, dtype=t.dtype, device=device) if t.is_meta else t.clone()
    return _all_reduce(full, group)


def gather_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full tensors of a sharded module's ``{name: local tensor}`` (its
    state or anything keyed like it: gradients, Adam moments), gathered
    over the model group on every rank; unsharded names pass through. Every
    rank passes the same names in the same order, a stage-owned one on the
    ``meta`` device where it is not resident."""
    specs = getattr(module, "shard_specs", {})
    group = model_group(module)
    device = next(p.device for p in module.parameters() if not p.is_meta)
    out = {}
    for name, t in tensors.items():
        kind = specs.get(name, REPLICATED)
        if kind == REPLICATED or t is None:
            out[name] = t
        elif kind == STAGE:
            out[name] = _from_owner(t, device, group)
        else:
            out[name] = _gather(t, SHARD_DIM[kind], group)
    return out


def shard_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`gather_tensors`: this rank's slices of full
    tensors keyed like the sharded module's state; a stage-owned tensor
    whole where the module holds it, on the ``meta`` device elsewhere."""
    specs = getattr(module, "shard_specs", {})
    if not specs:
        return dict(tensors)
    _, rank, size = _model_axis(module.mesh)
    resident = {name for name, t in module.state_dict().items() if not t.is_meta}
    out = {}
    for name, t in tensors.items():
        kind = specs.get(name, REPLICATED)
        if kind == STAGE and name not in resident:
            out[name] = torch.empty(t.shape, dtype=t.dtype, device="meta")
        else:
            out[name] = shard_tensor(t, kind, rank, size)
    return out


@torch.no_grad()
def gather_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state dict of a (possibly) sharded module, in the reference
    key layout, on every rank: a collective over the model group."""
    return gather_tensors(module, module.state_dict())


def is_primary() -> bool:
    """Whether this process writes output: rank 0 of the world, or any
    process outside a distributed run."""
    return not dist.is_initialized() or dist.get_rank() == 0
