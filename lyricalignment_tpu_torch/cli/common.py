"""Shared CLI plumbing: device choice, process start under a mesh,
seeding, tokenizers, model config, initialisation and model-dir loading.

Port of ``lyricalignment_tpu/cli/common.py:29-204``. A model dir holds
``args.json`` + ``model_args.json`` + reference checkpoints
``{name}_model.pt`` (``AlignModel.state_dict()``), which load directly with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lyricalignment_tpu_torch.models.align_model import (
    AlignModel,
    AlignModelConfig,
    init_weights,
)
from lyricalignment_tpu_torch.models.convert import (
    load_openai_checkpoint,
    load_reference_checkpoint,
)
from lyricalignment_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, make_mesh
from lyricalignment_tpu_torch.parallel.pipeline import stage_align_params
from lyricalignment_tpu_torch.models.whisper import (
    WHISPER_CONFIGS,
    WHISPER_DIMS,
    WhisperConfig,
    bf16_resident,
    int8_resident,
)
from lyricalignment_tpu_torch.text.bert_tokenizer import (
    BertWordPieceTokenizer,
    make_synthetic_vocab,
)
from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
from lyricalignment_tpu_torch.train.checkpoints import (
    load_json,
    params_state_dict,
    restore_pytree,
)

def resolve_device(device: str = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU, and an error (not a quiet CPU run) when CUDA is absent. On CUDA
    the float32 matmuls and convolutions are pinned to full float32 (no
    TF32): the mel clamp and the class normaliser see matmul error."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: lyricalignment_tpu_torch runs on an "
                "NVIDIA GPU; pass device='cpu' (--device cpu) to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the run's process group and return this rank's device: torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (and ``MASTER_ADDR`` /
    ``MASTER_PORT``) from the environment, ``nccl`` on ``cuda`` and ``gloo``
    on ``cpu``; a process started without torchrun is a world of one. On
    ``cuda`` the rank's card is ``LOCAL_RANK`` and :func:`resolve_device`'s
    rule holds per rank: no CUDA is an error, never a quiet CPU run. A
    process group the caller already started is joined as it is."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def add_mesh_args(parser: argparse.ArgumentParser, what: str, pipe: bool = False) -> None:
    """``--mesh-data`` / ``--mesh-model`` (JAX's flags and semantics: 0 =
    single device, -1 = the rest of the world), and ``--mesh-pipe`` for the
    CLIs that JAX gives it (``pipe``)."""
    parser.add_argument("--mesh-data", type=int, default=0,
                        help=f"shard {what} over N ranks (data parallel; 0 = single "
                             f"device, -1 = the rest of the world); the batch size must "
                             f"be divisible by N")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="tensor-shard the whisper backbone over N ranks "
                             "(Megatron TP; combine with --mesh-data)")
    if pipe:
        parser.add_argument("--mesh-pipe", type=int, default=1,
                            help="GPipe pipeline stages over the model mesh axis: encoder "
                                 "blocks, plus the teacher-forced decoder blocks when "
                                 "training the transcript task (exclusive with "
                                 "--mesh-model > 1; the layers must divide evenly)")


def model_mesh(model, args, device: torch.device, shard, batch_size: int):
    """The mesh ``model`` runs on for ``args.mesh_data`` / ``args.mesh_model``
    / ``args.mesh_pipe`` (None: one device, ``--mesh-data 0 --mesh-model 1
    --mesh-pipe 1``): the one it was sharded on, or a new ("data", "model")
    mesh over the process group that :func:`init_distributed` joins, which
    ``shard`` (``parallel.mesh.shard_align_params`` or ``shard_whisper``)
    cuts it for here, tensor-parallel when ``mesh_model`` is above 1. Under
    ``mesh_pipe`` the model axis holds the pipe stages
    (``model=max(mesh_model, mesh_pipe)``, as JAX builds it) and the
    AlignModel is cut to its rank's stage (``parallel.pipeline
    .stage_align_params``: the encoder's blocks, and the decoder's when it
    trains the transcript task); ``mesh_pipe`` with ``mesh_model`` exits.
    The world must hold ``mesh_data * max(mesh_model, mesh_pipe)`` ranks
    (``-1`` takes the rest), or it raises; a ``batch_size`` that the data
    axis does not divide exits, as in JAX."""
    mesh_data, mesh_model = getattr(args, "mesh_data", 0), getattr(args, "mesh_model", 1)
    mesh_pipe = getattr(args, "mesh_pipe", 1)
    if mesh_pipe > 1 and mesh_model > 1:
        raise SystemExit("--mesh-pipe and --mesh-model both use the model mesh axis; pick one")
    if not mesh_data and mesh_model <= 1 and mesh_pipe <= 1:
        return None
    if getattr(model, "mesh", None) is None:
        dev = init_distributed(device.type)
        mesh = make_mesh(data=mesh_data or -1, model=max(mesh_model, mesh_pipe),
                         device_type=dev.type)
        shard(model, mesh, tp=mesh_model > 1)
        if mesh_pipe > 1:
            sides = ("encoder", "decoder") if model.cfg.train_transcript else ("encoder",)
            stage_align_params(model, mesh, sides)
    data = axis_size(model.mesh, DATA_AXIS)
    if batch_size % data:
        raise SystemExit(f"batch size {batch_size} not divisible by the data axis ({data})")
    return model.mesh


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def add_asset_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--bert-vocab", type=str, default=None,
        help="Path to bert-base-chinese vocab.txt (required for id parity; "
             "omit with --synthetic-vocab for offline smoke runs)")
    parser.add_argument(
        "--synthetic-vocab", action="store_true",
        help="Use a tiny synthetic vocabulary (smoke tests only)")
    parser.add_argument(
        "--whisper-bpe", type=str, default=None,
        help="Path to whisper multilingual.tiktoken ranks file (enables "
             "text encode/decode for the transcript task)")
    parser.add_argument(
        "--whisper-checkpoint", type=str, default=None,
        help="Path to an OpenAI whisper .pt checkpoint to initialise the "
             "backbone (random init otherwise)")


def build_tokenizers(args, num_languages: int = 99
                     ) -> Tuple[BertWordPieceTokenizer, WhisperTokenizer]:
    """BERT tokenizer from ``--bert-vocab`` (or the synthetic vocabulary)
    and the whisper special-token layout (``num_languages=100`` for the v3
    family)."""
    if args.bert_vocab:
        bert = BertWordPieceTokenizer(vocab_path=args.bert_vocab)
    elif getattr(args, "synthetic_vocab", False):
        bert = BertWordPieceTokenizer(vocab=make_synthetic_vocab(size=21128))
    else:
        raise SystemExit("Provide --bert-vocab vocab.txt (bert-base-chinese) or pass "
                         "--synthetic-vocab for an offline smoke run.")
    whisper_tok = WhisperTokenizer(
        multilingual=True, language=getattr(args, "language", "zh"), task="transcribe",
        bpe_path=getattr(args, "whisper_bpe", None), num_languages=num_languages)
    return bert, whisper_tok


def build_model_config(
    whisper_model: str,
    output_dim: int,
    use_bf16: bool = False,
    freeze_encoder: bool = False,
    train_alignment: bool = True,
    train_transcript: bool = False,
    fast_gelu: bool = False,
    int8_encoder: bool = False,
    onepass_encoder: bool = False,
    int8_cross_kv: bool = False,
    whisper_dims: Optional[dict] = None,
) -> AlignModelConfig:
    """``whisper_dims`` (the ten architecture ints of ``WhisperConfig``)
    overrides the name lookup, as ``whisper_model: "custom"`` model dirs
    store them."""
    wcfg = (WhisperConfig(**whisper_dims) if whisper_dims is not None
            else WHISPER_CONFIGS[whisper_model])
    wcfg = dataclasses.replace(
        wcfg, compute_dtype=torch.bfloat16 if use_bf16 else torch.float32,
        fast_gelu=fast_gelu, int8_encoder=int8_encoder, onepass_encoder=onepass_encoder,
        int8_cross_kv=int8_cross_kv)
    return AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=output_dim,
                            freeze_encoder=freeze_encoder, train_alignment=train_alignment,
                            train_transcript=train_transcript)


def init_model(args, mcfg: AlignModelConfig, seed: int, device: torch.device) -> AlignModel:
    """Random init from ``seed`` (``init_weights``' distributions, drawn on
    ``device``), the backbone optionally overwritten from
    ``args.whisper_checkpoint``."""
    with torch.device(device):
        model = AlignModel(mcfg)
    model.to(device)  # the sinusoid buffer is made from numpy, on the CPU
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    if getattr(args, "whisper_checkpoint", None):
        ckpt_cfg, sd = load_openai_checkpoint(args.whisper_checkpoint)
        want = {k: getattr(mcfg.whisper, k) for k in WHISPER_DIMS}
        got = {k: getattr(ckpt_cfg, k) for k in WHISPER_DIMS}
        if got != want:
            raise SystemExit(f"--whisper-checkpoint dims {got} do not match the model's {want}")
        model.whisper_model.load_state_dict(sd, strict=True)
    return model


def load_model_dir(
    model_dir: str, model_name: str = "best", use_bf16: bool = False,
    fast_gelu: bool = False, int8_encoder: bool = False, onepass_encoder: bool = True,
    int8_cross_kv: bool = False, device: str = "cuda",
) -> Tuple[AlignModelConfig, AlignModel, Dict]:
    """Load a model dir into an ``AlignModel`` in eval mode on ``device``.
    The checkpoint is ``{model_name}_model.pt`` (a reference state dict, as
    the port writes) or the JAX package's orbax dir ``{model_name}_model/``
    (``la-convert import``'s ``{"params", "step"}`` or the trainer's full
    state: only its ``params`` are read), read with ``train.orbax`` and
    mapped by ``models.convert.state_dict_from_jax_params``; either loads
    with ``strict=True``. Under ``use_bf16`` the whisper weights are made
    bf16-resident, then under ``int8_encoder`` the encoder blocks' linears int8-resident (after
    the bf16 cast, so the grid is the dynamic path's); the model dir on disk
    stays full precision. ``onepass_encoder`` defaults on for inference, as
    in the JAX package; ``int8_cross_kv`` quantises the decode cache's cross
    K/V."""
    dev = resolve_device(device)
    train_args = load_json(os.path.join(model_dir, "args.json"))
    model_args = load_json(os.path.join(model_dir, "model_args.json"))
    mcfg = build_model_config(
        train_args["whisper_model"], output_dim=model_args["output_dim"],
        use_bf16=use_bf16, fast_gelu=fast_gelu, int8_encoder=int8_encoder,
        onepass_encoder=onepass_encoder, int8_cross_kv=int8_cross_kv,
        freeze_encoder=model_args.get("freeze_encoder", False),
        train_alignment=model_args.get("train_alignment", True),
        train_transcript=model_args.get("train_transcript", False),
        whisper_dims=train_args.get("whisper_dims"))

    base = os.path.join(model_dir, f"{model_name}_model")
    if os.path.isdir(base):
        tree = restore_pytree(base, top="params")  # may be a full train state
        params = tree["params"] if isinstance(tree, dict) and "params" in tree else tree
        state_dict = params_state_dict(params, mcfg.whisper.n_audio_ctx)
        del tree, params
    elif os.path.exists(base + ".pt"):
        state_dict = load_reference_checkpoint(base + ".pt")
    else:
        raise FileNotFoundError(f"No checkpoint {base}[.pt]")
    model = AlignModel(mcfg)
    model.load_state_dict(state_dict, strict=True)
    del state_dict
    if use_bf16:
        bf16_resident(model.whisper_model)
    if int8_encoder:
        int8_resident(model.whisper_model)
    return mcfg, model.to(dev).eval(), train_args
