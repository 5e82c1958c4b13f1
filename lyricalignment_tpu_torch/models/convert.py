"""Weights into the port: the JAX parameter tree and reference checkpoints.

:func:`state_dict_from_jax_params` is the counterpart of
``lyricalignment_tpu/models/convert.py:align_params_to_state_dict``
(`convert.py:503-574`): it takes the JAX package's align-model parameter
tree (``init_align_model``'s layout, as nested dicts and lists of numpy
arrays) and returns the port's state_dict, in the reference's names:

* linear ``w`` [in, out] -> ``weight`` [out, in]; ``b`` -> ``bias``;
* conv weights are already torch-style [out, in, k];
* GRU ``w_ih`` / ``w_hh`` [in, 3H] are transposed (gate order r, z, n is
  shared);
* LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
* the encoder's ``positional_embedding`` buffer is synthesised (the JAX
  tree computes the sinusoids in-model).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from lyricalignment_tpu_torch.models.whisper import sinusoid_position_embedding

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(p: Mapping, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])


def _ln(p: Mapping, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _attn(p: Mapping, prefix: str, out: StateDict) -> None:
    for jax_name, name in (("q", "query"), ("k", "key"), ("v", "value"), ("out", "out")):
        _linear(p[jax_name], f"{prefix}.{name}", out)


def _block(p: Mapping, prefix: str, out: StateDict) -> None:
    _ln(p["attn_ln"], f"{prefix}.attn_ln", out)
    _attn(p["attn"], f"{prefix}.attn", out)
    if "cross_attn" in p:
        _ln(p["cross_attn_ln"], f"{prefix}.cross_attn_ln", out)
        _attn(p["cross_attn"], f"{prefix}.cross_attn", out)
    _ln(p["mlp_ln"], f"{prefix}.mlp_ln", out)
    _linear(p["mlp_fc1"], f"{prefix}.mlp.0", out)
    _linear(p["mlp_fc2"], f"{prefix}.mlp.2", out)


def state_dict_from_jax_params(tree: Mapping[str, Any],
                               n_audio_ctx: int = 1500) -> StateDict:
    """JAX align-model parameters (numpy leaves) -> the port's state_dict."""
    out: StateDict = {}
    enc, dec = tree["whisper"]["encoder"], tree["whisper"]["decoder"]
    for conv in ("conv1", "conv2"):
        out[f"whisper_model.encoder.{conv}.weight"] = _t(enc[conv]["w"])
        out[f"whisper_model.encoder.{conv}.bias"] = _t(enc[conv]["b"])
    d_audio = int(np.asarray(enc["conv2"]["w"]).shape[0])
    out["whisper_model.encoder.positional_embedding"] = torch.from_numpy(
        sinusoid_position_embedding(n_audio_ctx, d_audio))
    for i, block in enumerate(enc["blocks"]):
        _block(block, f"whisper_model.encoder.blocks.{i}", out)
    _ln(enc["ln_post"], "whisper_model.encoder.ln_post", out)
    out["whisper_model.decoder.token_embedding.weight"] = _t(dec["token_embedding"])
    out["whisper_model.decoder.positional_embedding"] = _t(dec["positional_embedding"])
    for i, block in enumerate(dec["blocks"]):
        _block(block, f"whisper_model.decoder.blocks.{i}", out)
    _ln(dec["ln"], "whisper_model.decoder.ln", out)

    head = tree["align_head"]
    for layer, lp in enumerate(head["gru"]["layers"]):
        for d, cell in enumerate(lp["dirs"]):
            sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
            out[f"align_rnn.rnn.weight_ih{sfx}"] = _t(np.asarray(cell["w_ih"]).T)
            out[f"align_rnn.rnn.weight_hh{sfx}"] = _t(np.asarray(cell["w_hh"]).T)
            out[f"align_rnn.rnn.bias_ih{sfx}"] = _t(cell["b_ih"])
            out[f"align_rnn.rnn.bias_hh{sfx}"] = _t(cell["b_hh"])
    _linear(head["fc"], "align_rnn.fc", out)
    return out


def load_reference_checkpoint(path: str) -> StateDict:
    """A reference ``{name}_model.pt`` (``AlignModel.state_dict()`` saved
    with ``torch.save``) as a state_dict of CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)
