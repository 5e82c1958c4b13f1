#!/usr/bin/env python3
"""Write the orbax fixtures of the port's checkpoint reader with the JAX
package (needs JAX, orbax-checkpoint and torch; runs on the CPU):

    JAX_PLATFORMS=cpu python3 scripts/torch_orbax_fixtures.py [OUT_DIR]

OUT_DIR defaults to ``tests/data/torch_orbax``. It writes:

* ``tiny/``: a model dir of a ``"custom"`` backbone (the ``whisper_dims`` of
  ``TINY``, head output 420) in the form the JAX trainer leaves:
  ``args.json``, ``model_args.json`` and ``best_model/`` plus ``last_model/``,
  each the full train state ``{"params", "opt_state", "step"}`` written by
  the JAX ``BestCheckpointPolicy`` from ``init_train_state`` with a
  bfloat16 Adam ``mu`` (``--bf16-adam-mu``). The parameters start from
  ``init_align_model``; its leaves of at most ``RANDOM_MAX`` values that are
  not matrices (LayerNorms, biases, convolutions) are redrawn as seeded
  float32 noise (Huffman-coded literals in the checkpoint), the others are
  replaced by a seeded 64-value block tiled to their shape. The Adam moments
  hold tiled blocks too (``nu`` positive); the Adam and schedule counts and
  the step are ``STEP``. Beside it:
  ``best_model.pt.xz``, the same weights as JAX's ``export_reference_pt``
  writes them, xz-compressed (``lzma``); ``tiny.json``: the count, the step
  and the SHA-256 of every leaf as JAX's ``restore_pytree`` returns it.
* ``medium/``: a model dir exactly as JAX's ``la-convert import`` writes it
  (``cli.convert_checkpoint._write_model_dir``: whisper-medium, CTC head,
  ``best_model/`` = ``{"params", "step": 0}``). Every leaf is a seeded
  64-value block tiled to the leaf's shape and scaled as
  ``init_align_model`` scales that leaf (uniform linears and convolutions
  at 1 / sqrt(fan-in), the token embedding at 0.02 x a normal block);
  leaves that JAX initialises to zeros or ones get 0.01 x a block (plus 1:
  LayerNorm scales), so a forward stays finite. The whole dir compresses to
  a few hundred KB. Beside it, ``medium.json``: every leaf's SHA-256 as
  JAX's ``restore_pytree`` returns it, its shape and dtype.

The SHA-256 of a leaf is that of its C-order bytes (bfloat16 as its bits).
"""

from __future__ import annotations

import hashlib
import json
import lzma
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(n_mels=80, n_vocab=64, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=16, n_text_state=64, n_text_head=4, n_text_layer=1)
TINY_OUTPUT_DIM = 420
RANDOM_MAX = 20_000
STEP = 3
SEED = 20261018


def _block(rng, normal: bool = False):
    import numpy as np

    return (rng.standard_normal(64) if normal else rng.uniform(-1.0, 1.0, 64)).astype(np.float32)


def _tiled(block, shape):
    import numpy as np

    return np.resize(block, shape).astype(np.float32)


def _path_names(path):
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]


def leaf_hashes(tree):
    """``{dotted key path: {"sha256", "shape", "dtype"}}`` of a restored
    tree's array leaves."""
    import jax
    import numpy as np

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.ascontiguousarray(np.asarray(leaf))
        raw = arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr
        out[".".join(_path_names(path))] = {
            "sha256": hashlib.sha256(raw.tobytes()).hexdigest(),
            "shape": list(arr.shape), "dtype": arr.dtype.name}
    return out


def _medium_scale(names, shape):
    """(scale, offset) of a whisper-medium leaf as ``init_align_model``
    draws it; zero- or one-initialised leaves get 0.01 (offset 1 for a
    LayerNorm scale)."""
    import numpy as np

    leaf = names[-1]
    if leaf == "token_embedding":
        return 0.02, 0.0
    if "gru" in names:
        return 1.0 / np.sqrt(shape[-1] // 3), 0.0
    if names[-2:] == ["fc", "w"] or names[-2:] == ["fc", "b"]:
        return 1.0 / np.sqrt(768), 0.0
    if leaf == "w" and len(shape) == 3:  # convolution [out, in, 3]
        return 1.0 / np.sqrt(shape[1] * 3), 0.0
    if leaf == "w":
        return 1.0 / np.sqrt(shape[0]), 0.0
    return 0.01, 1.0 if leaf == "scale" else 0.0


def write_medium(out_dir):
    import jax
    import numpy as np

    from lyricalignment_tpu.cli.common import build_model_config
    from lyricalignment_tpu.cli.convert_checkpoint import _write_model_dir
    from lyricalignment_tpu.models.align_model import init_align_model
    from lyricalignment_tpu.train.checkpoints import restore_pytree

    mcfg = build_model_config("medium", output_dim=21129)
    shapes = jax.eval_shape(lambda: init_align_model(jax.random.PRNGKey(0), mcfg))
    rng = np.random.default_rng(SEED + 1)

    def leaf(path, s):
        names = _path_names(path)
        scale, offset = _medium_scale(names, s.shape)
        block = _block(rng, normal=names[-1] == "token_embedding")
        return _tiled(block * np.float32(scale) + np.float32(offset), s.shape)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    _write_model_dir(out_dir, "medium", True, params, "best")
    del params
    hashes = leaf_hashes(restore_pytree(os.path.join(out_dir, "best_model")))
    return {"model_name": "best", "leaves": hashes}


def write_tiny(out_dir):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lyricalignment_tpu.models.align_model import AlignModelConfig, init_align_model
    from lyricalignment_tpu.models.whisper import WhisperConfig
    from lyricalignment_tpu.train.checkpoints import (
        BestCheckpointPolicy,
        export_reference_pt,
        restore_pytree,
        save_json,
    )
    from lyricalignment_tpu.train.trainer import TrainConfig, init_train_state

    mcfg = AlignModelConfig(whisper=WhisperConfig(**TINY), hidden_dim=384,
                            output_dim=TINY_OUTPUT_DIM)
    rng = np.random.default_rng(SEED)

    def fill(x, noise=True, positive=False):
        x = np.asarray(x)
        if noise and x.ndim != 2 and x.size <= RANDOM_MAX:
            v = rng.standard_normal(x.shape).astype(np.float32) * np.float32(0.05)
        else:
            v = _tiled(_block(rng) * np.float32(0.05), x.shape)
        v = np.abs(v) if positive else v
        return jnp.asarray(v, x.dtype)

    params = jax.tree_util.tree_map(fill, init_align_model(jax.random.PRNGKey(SEED), mcfg))
    state, _ = init_train_state(params, TrainConfig(adam_mu_dtype=jnp.bfloat16))

    fields = lambda n: getattr(n, "_fields", ())

    def moments(node):
        if "mu" in fields(node):  # ScaleByAdamState
            mu = jax.tree_util.tree_map(lambda x: fill(x, noise=False), node.mu)
            nu = jax.tree_util.tree_map(lambda x: fill(x, noise=False, positive=True), node.nu)
            return node._replace(count=jnp.asarray(STEP, jnp.int32), mu=mu, nu=nu)
        if "count" in fields(node):  # ScaleByScheduleState
            return node._replace(count=jnp.asarray(STEP, jnp.int32))
        return node

    opt_state = jax.tree_util.tree_map(
        moments, state.opt_state,
        is_leaf=lambda n: "count" in fields(n))
    full = {"params": params, "opt_state": opt_state, "step": jnp.asarray(STEP, jnp.int32)}

    os.makedirs(out_dir, exist_ok=True)
    save_json(os.path.join(out_dir, "args.json"),
              {"whisper_model": "custom", "whisper_dims": TINY, "use_ctc_loss": False,
               "bf16_adam_mu": True, "train_steps": 10, "warmup_steps": 0})
    save_json(os.path.join(out_dir, "model_args.json"), {
        "embed_dim": TINY["n_audio_state"], "hidden_dim": 384, "output_dim": TINY_OUTPUT_DIM,
        "bidirectional": True, "freeze_encoder": False, "train_alignment": True,
        "train_transcript": False})
    losses = {"total": 1.0, "align_ce": 1.0, "align_ctc": 0.0, "trans_ce": 1.0}
    with BestCheckpointPolicy(out_dir, {**losses, "total": 2.0}, use_async=False) as policy:
        policy.update(losses, params, STEP, full_state=full)
    with tempfile.TemporaryDirectory() as tmp:
        pt = os.path.join(tmp, "best_model.pt")
        export_reference_pt(params, pt, n_audio_ctx=TINY["n_audio_ctx"])
        with open(pt, "rb") as f, lzma.open(os.path.join(out_dir, "best_model.pt.xz"), "wb") as g:
            shutil.copyfileobj(f, g)
    return {"model_name": "best", "count": STEP, "step": STEP,
            "leaves": leaf_hashes(restore_pytree(os.path.join(out_dir, "best_model")))}


def main() -> int:
    sys.path.insert(0, REPO)
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "tests", "data", "torch_orbax")
    for name, write in (("tiny", write_tiny), ("medium", write_medium)):
        target = os.path.join(out, name)
        shutil.rmtree(target, ignore_errors=True)
        record = write(target)
        with open(os.path.join(out, f"{name}.json"), "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
