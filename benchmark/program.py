"""The system under test, built from the benchmark's weights: the port's
own model classes and its entry points' steps, nothing else of it.

A served model is built as ``cli.common.load_model_dir`` builds one after
reading a checkpoint (``build_model_config``, ``load_state_dict(strict=
True)``, bf16 residency, then int8 residency for the int8 encoder, eval
mode), on the card at once instead of on the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch

WHISPER_DIMS = ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
                "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")


def device(kind: str) -> torch.device:
    """The port's device rule (float32 without TF32 on the card)."""
    from lyricalignment_tpu_torch.cli.common import resolve_device

    return resolve_device(kind)


def model_config(cfg: Dict, serving: bool, int8_encoder: bool = False):
    from lyricalignment_tpu_torch.cli.common import build_model_config

    prec = cfg["precision"]
    return build_model_config(
        "custom", output_dim=cfg["head"]["output_dim"],
        use_bf16=prec["compute"] == "bfloat16", fast_gelu=prec["fast_gelu"],
        int8_encoder=int8_encoder, onepass_encoder=serving,
        whisper_dims={k: cfg[k] for k in WHISPER_DIMS})


def build(cfg: Dict, weights: Dict[str, torch.Tensor], dev: torch.device, serving: bool,
          int8_encoder: bool = False):
    """An ``AlignModel`` on ``dev`` holding ``weights``."""
    from lyricalignment_tpu_torch.models.align_model import AlignModel
    from lyricalignment_tpu_torch.models.whisper import bf16_resident, int8_resident

    mcfg = model_config(cfg, serving, int8_encoder)
    with torch.device(dev):
        model = AlignModel(mcfg)
    model.load_state_dict(weights, strict=True)
    model.to(dev)
    if serving:
        if cfg["precision"]["resident"] == "bfloat16":
            bf16_resident(model.whisper_model)
        if int8_encoder:
            int8_resident(model.whisper_model)
        model.eval()
    return model


def narrow_tensors(model: torch.nn.Module, resident: str) -> int:
    """The model's parameters and buffers held in fewer bytes an element
    than the configuration's resident type (int8, fp8 and the like): 0 for
    a model served at the precision the configuration states."""
    size = getattr(torch, resident).itemsize
    return sum(t.dtype.itemsize < size for t in list(model.parameters()) + list(model.buffers()))
