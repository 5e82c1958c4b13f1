"""Shared CLI plumbing: device choice, seeding, tokenizers, model config,
initialisation and model-dir loading.

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

from lyricalignment_tpu_torch.models.align_model import (
    AlignModel,
    AlignModelConfig,
    init_weights,
)
from lyricalignment_tpu_torch.models.convert import (
    load_openai_checkpoint,
    load_reference_checkpoint,
)
from lyricalignment_tpu_torch.models.whisper import (
    WHISPER_CONFIGS,
    WHISPER_DIMS,
    WhisperConfig,
    bf16_resident,
)
from lyricalignment_tpu_torch.text.bert_tokenizer import (
    BertWordPieceTokenizer,
    make_synthetic_vocab,
)
from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
from lyricalignment_tpu_torch.train.checkpoints import load_json

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
    onepass_encoder: bool = False,
    whisper_dims: Optional[dict] = None,
) -> AlignModelConfig:
    """``whisper_dims`` (the ten architecture ints of ``WhisperConfig``)
    overrides the name lookup, as ``whisper_model: "custom"`` model dirs
    store them."""
    wcfg = (WhisperConfig(**whisper_dims) if whisper_dims is not None
            else WHISPER_CONFIGS[whisper_model])
    wcfg = dataclasses.replace(
        wcfg, compute_dtype=torch.bfloat16 if use_bf16 else torch.float32,
        fast_gelu=fast_gelu, onepass_encoder=onepass_encoder)
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
    fast_gelu: bool = False, onepass_encoder: bool = True, device: str = "cuda",
) -> Tuple[AlignModelConfig, AlignModel, Dict]:
    """Load a model dir into an ``AlignModel`` in eval mode on ``device``.
    Under ``use_bf16`` the whisper weights are made bf16-resident.
    ``onepass_encoder`` defaults on for inference, as in the JAX package."""
    dev = resolve_device(device)
    train_args = load_json(os.path.join(model_dir, "args.json"))
    model_args = load_json(os.path.join(model_dir, "model_args.json"))
    mcfg = build_model_config(
        train_args["whisper_model"], output_dim=model_args["output_dim"],
        use_bf16=use_bf16, fast_gelu=fast_gelu, onepass_encoder=onepass_encoder,
        freeze_encoder=model_args.get("freeze_encoder", False),
        train_alignment=model_args.get("train_alignment", True),
        train_transcript=model_args.get("train_transcript", False),
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
