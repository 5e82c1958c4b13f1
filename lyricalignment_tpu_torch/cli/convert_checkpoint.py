"""Checkpoint converter CLI (``la-convert``): reference / OpenAI / HF
checkpoints <-> model dirs.

Port of ``lyricalignment_tpu/cli/convert_checkpoint.py``, host only (no
device code runs):

    # reference AlignModel .pt (e.g. the published Zenodo checkpoints) ->
    # model dir
    python -m lyricalignment_tpu_torch.cli.convert_checkpoint import \\
        --pt best_model.pt --whisper-model medium --output-dir converted --use-ctc-loss

    # OpenAI whisper .pt -> model dir (random head)
    ... import-openai --pt medium.pt --output-dir pretrained

    # HF transformers Whisper save directory -> model dir (random head)
    ... import-hf --hf-dir whisper-medium --output-dir pretrained

    # model dir -> HF transformers save directory (the whisper backbone,
    # loadable by WhisperForConditionalGeneration.from_pretrained)
    ... export-hf --model-dir result --output-dir hf_out

    # model dir -> reference-named .pt
    ... export --model-dir result --model-name best --pt out.pt

``export`` and ``export-hf`` read a model dir of either package: the
port's ``{name}_model.pt`` or the JAX package's orbax ``{name}_model/``
(``la-convert import``'s or the trainer's full state), through
``cli.common.load_model_dir``. Two differences from the JAX tool:

* model dirs are written as ``{name}_model.pt`` in the reference's naming
  (what both packages' ``load_model_dir`` read), not as orbax checkpoints;
  ``args.json`` is the same, with ``whisper_model: "custom"`` and
  ``whisper_dims`` for a backbone that matches no size name;
* ``import-openai`` and ``import-hf`` draw only the align head, from
  ``--seed`` with ``init_weights``' distributions (torch's generator, so
  not the JAX tool's head); the backbone is the checkpoint's.
"""

from __future__ import annotations

import argparse
import os

import torch

from lyricalignment_tpu_torch.cli.common import build_model_config, load_model_dir
from lyricalignment_tpu_torch.models.align_head import AlignHead
from lyricalignment_tpu_torch.models.align_model import AlignModel, init_head_weights
from lyricalignment_tpu_torch.models.convert import (
    load_hf_checkpoint,
    load_openai_checkpoint,
    load_reference_checkpoint,
    save_hf_checkpoint,
)
from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, WHISPER_DIMS
from lyricalignment_tpu_torch.train.checkpoints import export_reference_pt, save_json

MODEL_NAMES = ["best", "best_align", "best_trans", "last"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    imp = sub.add_parser("import", help="reference AlignModel .pt -> model dir")
    imp.add_argument("--pt", required=True)
    imp.add_argument("--whisper-model", required=True,
                     choices=["tiny", "base", "small", "medium", "large", "large-v2"])
    imp.add_argument("--output-dir", required=True)
    imp.add_argument("--use-ctc-loss", action="store_true",
                     help="head output dim 21129 (21128 + CTC blank/silence)")
    imp.add_argument("--model-name", default="best", choices=MODEL_NAMES)

    impo = sub.add_parser("import-openai", help="OpenAI whisper .pt -> model dir (random head)")
    impo.add_argument("--pt", required=True)
    impo.add_argument("--output-dir", required=True)
    impo.add_argument("--use-ctc-loss", action="store_true")
    impo.add_argument("--seed", type=int, default=114514)

    imph = sub.add_parser("import-hf",
                          help="HF transformers Whisper save dir -> model dir (random head)")
    imph.add_argument("--hf-dir", required=True,
                      help="directory from save_pretrained(): config.json + "
                           "model.safetensors / pytorch_model.bin")
    imph.add_argument("--output-dir", required=True)
    imph.add_argument("--use-ctc-loss", action="store_true")
    imph.add_argument("--seed", type=int, default=114514)

    exp = sub.add_parser("export", help="model dir -> reference-named .pt")
    exp.add_argument("--model-dir", required=True)
    exp.add_argument("--model-name", default="best", choices=MODEL_NAMES)
    exp.add_argument("--pt", required=True)

    exph = sub.add_parser("export-hf",
                          help="model dir (whisper backbone) -> HF transformers save dir")
    exph.add_argument("--model-dir", required=True)
    exph.add_argument("--model-name", default="best", choices=MODEL_NAMES)
    exph.add_argument("--output-dir", required=True)

    return p.parse_args(argv)


def _arch_dims(c):
    return (c.n_audio_state, c.n_audio_layer, c.n_audio_head,
            c.n_text_state, c.n_text_layer, c.n_text_head,
            c.n_vocab, c.n_mels)


def match_whisper_size(ckpt_cfg):
    """Name of the WHISPER_CONFIGS entry whose full architecture matches,
    or None. Encoder dims alone are not enough: distil-whisper keeps the
    full encoder over 2 decoder layers and ``*.en`` models use vocab 51864,
    and a size name would rebuild the wrong decoder and vocabulary."""
    return next((n for n, c in WHISPER_CONFIGS.items()
                 if _arch_dims(c) == _arch_dims(ckpt_cfg)), None)


def _size_aliases(name):
    """Other WHISPER_CONFIGS names with the identical architecture (large
    and large-v2 share every dim: a large-v2 checkpoint is stored under the
    first match, "large", and the import message says so)."""
    dims = _arch_dims(WHISPER_CONFIGS[name])
    return [n for n, c in WHISPER_CONFIGS.items() if n != name and _arch_dims(c) == dims]


def _write_model_dir(out_dir, whisper_model, use_ctc, state_dict, model_name,
                     whisper_dims=None):
    """``args.json``, ``model_args.json`` and ``{model_name}_model.pt``.
    ``whisper_model`` is a WHISPER_CONFIGS name, or "custom" with
    ``whisper_dims`` carrying the full architecture. The state dict is
    checked against the model's own names and shapes (extra keys, as the
    JAX reader ignores them, are dropped) and written float32."""
    output_dim = 21128 + (1 if use_ctc else 0)
    mcfg = build_model_config(whisper_model, output_dim=output_dim, whisper_dims=whisper_dims)
    with torch.device("meta"):
        want = AlignModel(mcfg).state_dict()
    missing = sorted(set(want) - set(state_dict))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors of the model, e.g. {missing[:3]}")
    for name, t in want.items():
        if tuple(state_dict[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(state_dict[name].shape)} in the "
                             f"checkpoint, {tuple(t.shape)} in the model")

    os.makedirs(out_dir, exist_ok=True)
    args_json = {"whisper_model": whisper_model, "use_ctc_loss": use_ctc}
    if whisper_dims is not None:
        args_json["whisper_dims"] = dict(whisper_dims)
    save_json(os.path.join(out_dir, "args.json"), args_json)
    save_json(os.path.join(out_dir, "model_args.json"), {
        "embed_dim": mcfg.embed_dim, "hidden_dim": mcfg.hidden_dim,
        "output_dim": output_dim, "bidirectional": True, "freeze_encoder": False,
        "train_alignment": True, "train_transcript": False})
    torch.save({name: state_dict[name].detach().to("cpu", torch.float32).contiguous()
                for name in want},
               os.path.join(out_dir, f"{model_name}_model.pt"))


def _import_backbone(args) -> str:
    """``import-openai`` / ``import-hf``: the checkpoint's backbone and a
    head drawn from ``--seed``, written as ``best``; the message printed."""
    if args.cmd == "import-hf":
        src = args.hf_dir
        ckpt_cfg, whisper_sd = load_hf_checkpoint(src)
    else:
        src = args.pt
        ckpt_cfg, whisper_sd = load_openai_checkpoint(src)
    name = match_whisper_size(ckpt_cfg)
    dims = None
    if name is None:
        # an asymmetric variant: args.json keeps the architecture itself
        name = "custom"
        dims = {k: getattr(ckpt_cfg, k) for k in WHISPER_DIMS}
    mcfg = build_model_config(name, output_dim=21128 + (1 if args.use_ctc_loss else 0),
                              whisper_dims=dims)
    head = AlignHead(mcfg.embed_dim, mcfg.hidden_dim, mcfg.output_dim,
                     mcfg.num_rnn_layers, mcfg.bidirectional)
    init_head_weights(head, torch.Generator().manual_seed(args.seed))
    state_dict = {f"whisper_model.{k}": v for k, v in whisper_sd.items()}
    state_dict.update({f"align_rnn.{k}": v for k, v in head.state_dict().items()})
    _write_model_dir(args.output_dir, name, args.use_ctc_loss, state_dict, "best",
                     whisper_dims=dims)
    aliases = _size_aliases(name) if name != "custom" else []
    note = (f" (architecture identical to {'/'.join(aliases)}; stored as {name!r})"
            if aliases else "")
    return f"imported {name} {src} -> {args.output_dir}/best_model{note}"


def main(argv=None):
    args = parse_args(argv)

    if args.cmd == "import":
        _write_model_dir(args.output_dir, args.whisper_model, args.use_ctc_loss,
                         load_reference_checkpoint(args.pt), args.model_name)
        print(f"imported {args.pt} -> {args.output_dir}/{args.model_name}_model")
        return 0

    if args.cmd in ("import-openai", "import-hf"):
        print(_import_backbone(args))
        return 0

    mcfg, model, _ = load_model_dir(args.model_dir, args.model_name, device="cpu")
    if args.cmd == "export-hf":
        save_hf_checkpoint(model.whisper_model.state_dict(), mcfg.whisper, args.output_dir)
        print(f"exported {args.model_dir}/{args.model_name}_model whisper backbone -> "
              f"{args.output_dir} (HF transformers format)")
        return 0

    os.makedirs(os.path.dirname(os.path.abspath(args.pt)), exist_ok=True)
    export_reference_pt(model, args.pt)
    print(f"exported {args.model_dir}/{args.model_name}_model -> {args.pt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
