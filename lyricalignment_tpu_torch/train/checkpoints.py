"""Checkpoints: the reference's best/last policy over reference-named files,
and the JAX package's orbax checkpoints read back.

Port of ``lyricalignment_tpu/train/checkpoints.py``. The reference saves
four named checkpoints by distinct criteria (`train_multitask.py:567-585`):
``best_model`` (min total dev loss), ``best_align_model`` (min align_ce +
align_ctc), ``best_trans_model`` (min trans_ce) and ``last_model`` every
eval, plus optional per-step ones. The port writes each as the reference
writes it, ``{name}_model.pt`` = ``AlignModel.state_dict()`` (what
``cli.common.load_model_dir`` and the reference read), beside
``{name}_state.pt`` with the optimizer state and the step, so ``--resume``
continues the learning-rate schedule where it left off (the reference
restarts it).

It also reads what the JAX package writes: an orbax directory
``{name}_model/`` (``save_pytree``; the JAX ``BestCheckpointPolicy``'s full
train state of params, optax state and step). :func:`restore_pytree` is
the JAX package's entry of that name, over ``train/orbax.py`` (no orbax,
tensorstore or JAX needed); :func:`restore_train_state` takes such a
directory as well as the port's own files, mapping the optax chain's
``count`` and Adam ``mu`` / ``nu`` onto the port's :class:`OptState` by
parameter name.

Under a mesh (``parallel.mesh``) the full state dict and the full Adam
moments are gathered from the tensor-parallel shards and rank 0 alone
writes them, so a model dir written under any mesh loads unsharded with
``strict=True`` (JAX's checkpoints are portable between meshes,
``train/checkpoints.py:34-36``); restoring onto a sharded model cuts each
full tensor to the rank's shard, from either kind of checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from lyricalignment_tpu_torch.parallel.mesh import (
    gather_state_dict,
    gather_tensors,
    is_primary,
    shard_tensors,
)
from lyricalignment_tpu_torch.train.orbax import restore_pytree  # the JAX package's name
from lyricalignment_tpu_torch.train.schedule import OptState


def save_json(path: str, obj: Dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=4, ensure_ascii=False)


def load_json(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def export_reference_pt(model: torch.nn.Module, path: str) -> None:
    """Write the model's full state dict (reference names, CPU tensors);
    a sharded model's is gathered over its model group (every rank takes
    part) and written by rank 0."""
    sd = {k: v.detach().cpu() for k, v in gather_state_dict(model).items()}
    if is_primary():
        torch.save(sd, path)


def _prefix(path: str) -> str:
    """``dir/last_model`` or ``dir/last_model.pt`` -> ``dir/last``."""
    path = path[:-3] if path.endswith(".pt") else path
    return path[: -len("_model")] if path.endswith("_model") else path


def save_train_state(path: str, state) -> None:
    """``{name}_model.pt`` and ``{name}_state.pt`` for ``path`` =
    ``dir/{name}_model``."""
    prefix = _prefix(path)
    export_reference_pt(state.model, prefix + "_model.pt")
    opt = {k: ({n: t.cpu() for n, t in gather_tensors(state.model, v).items()}
               if isinstance(v, dict) else v)
           for k, v in state.opt_state.state_dict().items()}
    if is_primary():
        torch.save({"opt_state": opt, "step": state.step}, prefix + "_state.pt")


def _float32(leaf) -> np.ndarray:
    """A restored leaf as float32 numpy (exact from bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def _merged(param, trees):
    """The tree of ``param`` with each leaf the first of ``trees``' leaves
    that is not None (a group's Adam moments hold None outside the group),
    as float32 numpy, or zeros where none is (a frozen parameter)."""
    if isinstance(param, dict):
        return {k: _merged(v, [t[k] for t in trees]) for k, v in param.items()}
    if isinstance(param, list):
        return [_merged(v, [t[i] for t in trees]) for i, v in enumerate(param)]
    got = next((t for t in trees if t is not None), None)
    return _float32(got) if got is not None else np.zeros(tuple(param.shape), np.float32)


def params_state_dict(params, n_audio_ctx: int) -> Dict[str, torch.Tensor]:
    """The port's state dict of a JAX parameter tree restored from orbax."""
    return state_dict_from_jax_params(_merged(params, [params]), n_audio_ctx=n_audio_ctx)


def _orbax_opt_state(opt, params, n_audio_ctx: int, like: OptState) -> Dict:
    """The optax chain ``clip_by_global_norm -> multi_transform({head,
    backbone: adamw, frozen: set_to_zero})`` (``lyricalignment_tpu/train/
    schedule.py:54-75``) as the JAX trainer saves it: ``opt[1]
    ["inner_states"][group]["inner_state"][0]`` holds the group's Adam
    ``count``, ``mu`` and ``nu`` over the whole parameter tree, None outside
    the group. The groups' moments are merged, mapped by parameter name as
    the weights are, and cast to ``like``'s dtypes."""
    adams = [g["inner_state"][0] for g in opt[1]["inner_states"].values()
             if isinstance(g["inner_state"], list)]
    if not adams:
        raise ValueError("the checkpoint's optimizer state holds no Adam state")
    counts = {int(np.asarray(a["count"])) for a in adams}
    if len(counts) != 1:
        raise ValueError(f"the Adam groups' counts differ: {sorted(counts)}")
    out = {"count": counts.pop()}
    for key in ("mu", "nu"):
        sd = state_dict_from_jax_params(_merged(params, [a[key] for a in adams]),
                                        n_audio_ctx=n_audio_ctx)
        out[key] = {n: sd[n].to(t.dtype) for n, t in getattr(like, key).items()}
    return out


def restore_train_state(path: str, state) -> None:
    """Load weights, optimizer state and step into ``state`` (in place),
    from the files :func:`save_train_state` writes or from a JAX full-state
    orbax dir (``path`` a directory, e.g. ``result/last_model``); a sharded
    model takes its rank's slices of the full tensors."""
    model = state.model
    device = next(model.parameters()).device
    if os.path.isdir(path):
        tree = restore_pytree(path)
        n_ctx = model.cfg.whisper.n_audio_ctx
        full = params_state_dict(tree["params"], n_ctx)
        opt = _orbax_opt_state(tree["opt_state"], tree["params"], n_ctx, state.opt_state)
        step = int(np.asarray(tree["step"]))
    else:
        prefix = _prefix(path)
        full = torch.load(prefix + "_model.pt", map_location="cpu", weights_only=True)
        saved = torch.load(prefix + "_state.pt", map_location="cpu", weights_only=True)
        opt, step = saved["opt_state"], int(saved["step"])
    model.load_state_dict(shard_tensors(model, full), strict=True)
    opt = {k: shard_tensors(model, v) if isinstance(v, dict) else v for k, v in opt.items()}
    state.opt_state = OptState.from_state_dict(opt, device=device)
    state.step = step


class BestCheckpointPolicy:
    """Tracks the reference's four best/last criteria and writes
    checkpoints under ``save_dir``."""

    def __init__(self, save_dir: str, initial_losses: Dict[str, float]):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.min_total = initial_losses["total"]
        self.min_align = initial_losses["align_ce"] + initial_losses.get("align_ctc", 0.0)
        self.min_trans = initial_losses["trans_ce"]

    def _save(self, name: str, state) -> None:
        save_train_state(os.path.join(self.save_dir, name), state)

    def update(self, eval_losses: Dict[str, float], state,
               save_all: bool = False) -> Dict[str, bool]:
        """Save whichever checkpoints improved; always save last_model.
        Returns which criteria fired."""
        saved = {"best": False, "best_align": False, "best_trans": False}
        if eval_losses["total"] < self.min_total:
            self.min_total = eval_losses["total"]
            self._save("best_model", state)
            saved["best"] = True
        align = eval_losses["align_ce"] + eval_losses.get("align_ctc", 0.0)
        if align < self.min_align:
            self.min_align = align
            self._save("best_align_model", state)
            saved["best_align"] = True
        if eval_losses["trans_ce"] < self.min_trans:
            self.min_trans = eval_losses["trans_ce"]
            self._save("best_trans_model", state)
            saved["best_trans"] = True
        if save_all:
            self._save(f"step{state.step}_model", state)
        self._save("last_model", state)
        return saved
