"""Shared CLI plumbing: device choice, model config and model-dir loading.

Port of ``lyricalignment_tpu/cli/common.py:79-204``. A model dir holds
``args.json`` + ``model_args.json`` + reference checkpoints
``{name}_model.pt`` (``AlignModel.state_dict()``), which load directly with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from lyricalignment_tpu_torch.models.align_model import AlignModel, AlignModelConfig
from lyricalignment_tpu_torch.models.convert import load_reference_checkpoint
from lyricalignment_tpu_torch.models.whisper import (
    WHISPER_CONFIGS,
    WhisperConfig,
    bf16_resident,
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


def load_json(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def build_model_config(
    whisper_model: str,
    output_dim: int,
    use_bf16: bool = False,
    fast_gelu: bool = False,
    whisper_dims: Optional[dict] = None,
) -> AlignModelConfig:
    """``whisper_dims`` (the ten architecture ints of ``WhisperConfig``)
    overrides the name lookup, as ``whisper_model: "custom"`` model dirs
    store them."""
    wcfg = (WhisperConfig(**whisper_dims) if whisper_dims is not None
            else WHISPER_CONFIGS[whisper_model])
    wcfg = dataclasses.replace(
        wcfg, compute_dtype=torch.bfloat16 if use_bf16 else torch.float32,
        fast_gelu=fast_gelu)
    return AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=output_dim)


def load_model_dir(
    model_dir: str, model_name: str = "best", use_bf16: bool = False,
    fast_gelu: bool = False, device: str = "cuda",
) -> Tuple[AlignModelConfig, AlignModel, Dict]:
    """Load a model dir into an ``AlignModel`` in eval mode on ``device``.
    Under ``use_bf16`` the whisper weights are made bf16-resident."""
    dev = resolve_device(device)
    train_args = load_json(os.path.join(model_dir, "args.json"))
    model_args = load_json(os.path.join(model_dir, "model_args.json"))
    mcfg = build_model_config(
        train_args["whisper_model"], output_dim=model_args["output_dim"],
        use_bf16=use_bf16, fast_gelu=fast_gelu,
        whisper_dims=train_args.get("whisper_dims"))

    base = os.path.join(model_dir, f"{model_name}_model")
    if os.path.isdir(base):
        raise ValueError(
            f"{base} is an orbax checkpoint of the JAX package; export it to "
            f"a reference .pt first: la-convert export --model-dir {model_dir} "
            f"--model-name {model_name} --pt {base}.pt")
    if not os.path.exists(base + ".pt"):
        raise FileNotFoundError(f"No checkpoint {base}.pt")
    model = AlignModel(mcfg)
    model.load_state_dict(load_reference_checkpoint(base + ".pt"), strict=True)
    if use_bf16:
        bf16_resident(model.whisper_model)
    return mcfg, model.to(dev).eval(), train_args
