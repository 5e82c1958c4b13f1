"""Checkpoints into and out of the port: the JAX parameter tree, OpenAI
and HF transformers Whisper checkpoints, and reference ``AlignModel`` ``.pt``
files.

Port of ``lyricalignment_tpu/models/convert.py:86-574``. The port's module
names are OpenAI's and the reference's, so every converter here works on
state dicts of tensors (keys ``encoder.*`` / ``decoder.*`` for a whisper
backbone, ``whisper_model.*`` / ``align_rnn.*`` for an align model):

* :func:`state_dict_from_jax_params` takes the JAX package's align-model
  parameter tree (``init_align_model``'s layout, nested dicts and lists of
  numpy arrays; the counterpart of ``align_params_to_state_dict``):
  linear ``w`` [in, out] -> ``weight`` [out, in], ``b`` -> ``bias``; conv
  weights are already [out, in, k]; GRU ``w_ih`` / ``w_hh`` [in, 3H] are
  transposed (gate order r, z, n is shared); LayerNorm ``scale`` ->
  ``weight``;
* :func:`load_openai_checkpoint` reads an OpenAI ``.pt`` (``{"dims",
  "model_state_dict"}``, the format ``whisper.load_model`` consumes);
* :func:`load_hf_checkpoint` / :func:`save_hf_checkpoint` read and write a
  transformers ``WhisperForConditionalGeneration`` save directory
  (``config.json`` + ``model.safetensors`` / ``pytorch_model.bin``,
  optionally index-sharded) by a key map on the state dict;
* :func:`load_reference_checkpoint` reads a reference ``{name}_model.pt``.

The whisper imports return float32 CPU tensors, and the encoder's
positional table is synthesised (the whisper sinusoids) wherever a whisper
checkpoint is imported or exported, as the JAX package recomputes it
in-model.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from lyricalignment_tpu_torch.models.whisper import (
    WHISPER_DIMS,
    WhisperConfig,
    sinusoid_position_embedding,
)

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


# ---------------------------------------------------------------------------
# Whisper backbones: OpenAI and HF transformers checkpoints
# ---------------------------------------------------------------------------

def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (any float dtype, bf16 included) as a float32 CPU tensor; no
    copy when it already is one."""
    return t.detach().to("cpu", torch.float32)


def _sinusoids(cfg: WhisperConfig) -> torch.Tensor:
    return torch.from_numpy(sinusoid_position_embedding(cfg.n_audio_ctx, cfg.n_audio_state))


_HF_LN = {"attn_ln": "self_attn_layer_norm", "cross_attn_ln": "encoder_attn_layer_norm",
          "mlp_ln": "final_layer_norm"}
_HF_ATTN = {"attn": "self_attn", "cross_attn": "encoder_attn"}
# OpenAI's key projection has no bias, nor has HF's k_proj
_HF_PROJ = {"query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj"}


def _hf_names(cfg: WhisperConfig) -> List[Tuple[str, str]]:
    """(the port's key, the HF key without ``model.``) of every whisper
    tensor except the encoder's positional table, which neither side
    trains."""
    wb = ("weight", "bias")
    names = [(f"encoder.{c}.{w}", f"encoder.{c}.{w}") for c in ("conv1", "conv2") for w in wb]

    def block(side: str, i: int, cross: bool) -> None:
        ours, hf = f"{side}.blocks.{i}", f"{side}.layers.{i}"
        lns = ("attn_ln", "cross_attn_ln", "mlp_ln") if cross else ("attn_ln", "mlp_ln")
        for ln in lns:
            names.extend((f"{ours}.{ln}.{w}", f"{hf}.{_HF_LN[ln]}.{w}") for w in wb)
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            for proj, hf_proj in _HF_PROJ.items():
                names.extend((f"{ours}.{attn}.{proj}.{w}", f"{hf}.{_HF_ATTN[attn]}.{hf_proj}.{w}")
                             for w in (("weight",) if proj == "key" else wb))
        for idx, fc in (("0", "fc1"), ("2", "fc2")):
            names.extend((f"{ours}.mlp.{idx}.{w}", f"{hf}.{fc}.{w}") for w in wb)

    for i in range(cfg.n_audio_layer):
        block("encoder", i, cross=False)
    names.extend((f"encoder.ln_post.{w}", f"encoder.layer_norm.{w}") for w in wb)
    names += [("decoder.token_embedding.weight", "decoder.embed_tokens.weight"),
              ("decoder.positional_embedding", "decoder.embed_positions.weight")]
    for i in range(cfg.n_text_layer):
        block("decoder", i, cross=True)
    names.extend((f"decoder.ln.{w}", f"decoder.layer_norm.{w}") for w in wb)
    return names


def config_from_openai_dims(dims: Mapping) -> WhisperConfig:
    """``WhisperConfig`` from an OpenAI checkpoint's ``dims``."""
    return WhisperConfig(**{k: int(dims[k]) for k in WHISPER_DIMS})


def load_openai_checkpoint(path: str) -> Tuple[WhisperConfig, StateDict]:
    """(config, whisper state dict) of an OpenAI whisper ``.pt``
    (``{"dims": dict or ModelDimensions, "model_state_dict": ...}``; the
    dims object needs ``weights_only=False``). The whisper tensors of
    ``cfg`` are taken by name, float32; other keys are dropped, as the JAX
    reader drops them, and a missing one is left for the strict load to
    name."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    dims = ckpt["dims"] if isinstance(ckpt["dims"], dict) else vars(ckpt["dims"])
    cfg = config_from_openai_dims(dims)
    sd = ckpt["model_state_dict"]
    out = {ours: _f32(sd[ours]) for ours, _ in _hf_names(cfg) if ours in sd}
    out["encoder.positional_embedding"] = _sinusoids(cfg)
    return cfg, out


def config_from_hf_config(hf: Mapping) -> WhisperConfig:
    """``WhisperConfig`` from a transformers Whisper ``config.json`` dict."""
    return WhisperConfig(
        n_mels=hf["num_mel_bins"], n_vocab=hf["vocab_size"],
        n_audio_ctx=hf["max_source_positions"], n_audio_state=hf["d_model"],
        n_audio_head=hf["encoder_attention_heads"], n_audio_layer=hf["encoder_layers"],
        n_text_ctx=hf["max_target_positions"], n_text_state=hf["d_model"],
        n_text_head=hf["decoder_attention_heads"], n_text_layer=hf["decoder_layers"])


def whisper_state_dict_from_hf(sd: Mapping, cfg: WhisperConfig) -> StateDict:
    """A transformers Whisper state dict -> the port's whisper state dict.

    Takes ``WhisperForConditionalGeneration`` naming (``model.encoder.*``,
    ``model.decoder.*``, a tied ``proj_out``) or bare ``WhisperModel``
    naming. HF scales q by ``head_dim**-0.5`` where OpenAI and this model
    scale q and k by ``head_dim**-0.25`` each: the same product, so the
    weights map verbatim. Refuses what cannot be represented: an untied
    ``proj_out`` (whisper's unembedding is the token embedding), and an
    encoder ``embed_positions`` table that is not the sinusoids (within
    the rounding of its storage: atol 2.5e-3 for 2-byte tensors, 1e-4
    otherwise), which transformers keeps frozen and this model recomputes.
    """
    if any(k.startswith("model.") for k in sd):
        inner = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
        if "proj_out.weight" in sd and not torch.allclose(
                _f32(sd["proj_out.weight"]), _f32(inner["decoder.embed_tokens.weight"])):
            raise ValueError(
                "HF checkpoint has an untied proj_out head; whisper's unembedding is "
                "the (tied) decoder token embedding and an untied head cannot be "
                "represented")
        sd = inner
    if "encoder.embed_positions.weight" in sd:
        raw = sd["encoder.embed_positions.weight"]
        want = torch.from_numpy(sinusoid_position_embedding(*raw.shape))
        atol = 2.5e-3 if raw.element_size() <= 2 else 1e-4
        if not torch.allclose(_f32(raw), want, atol=atol):
            raise ValueError(
                "HF checkpoint's encoder embed_positions differ from the whisper "
                "sinusoids (transformers keeps them frozen; this table appears "
                "trained); this model recomputes the sinusoids and cannot represent "
                "a trained encoder positional embedding")
    out = {ours: _f32(sd[hf]) for ours, hf in _hf_names(cfg)}
    out["encoder.positional_embedding"] = _sinusoids(cfg)
    return out


def _load_hf_weight_files(path: str) -> Dict[str, torch.Tensor]:
    """Merge an HF save directory's weight file(s) into one state dict:
    ``model.safetensors`` or ``pytorch_model.bin``, single or index-sharded,
    in that order of preference. Safetensors are read as torch tensors, so
    bf16 ones need no detour."""

    def safetensors_load(p):
        try:
            from safetensors import safe_open
        except ImportError as exc:
            raise ImportError(f"{p} is a safetensors file: reading it needs the "
                              f"safetensors package") from exc
        with safe_open(p, framework="pt") as f:
            return {k: f.get_tensor(k) for k in f.keys()}

    def torch_load(p):
        return torch.load(p, map_location="cpu", weights_only=True)

    for name, loader in (("model.safetensors.index.json", safetensors_load),
                         ("model.safetensors", safetensors_load),
                         ("pytorch_model.bin.index.json", torch_load),
                         ("pytorch_model.bin", torch_load)):
        full = os.path.join(path, name)
        if not os.path.exists(full):
            continue
        if name.endswith(".index.json"):
            with open(full) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            sd: Dict[str, torch.Tensor] = {}
            for shard in shards:
                sd.update(loader(os.path.join(path, shard)))
            return sd
        return loader(full)
    raise FileNotFoundError(f"no model.safetensors[.index.json] or "
                            f"pytorch_model.bin[.index.json] under {path}")


def load_hf_checkpoint(path: str) -> Tuple[WhisperConfig, StateDict]:
    """(config, whisper state dict) of a transformers Whisper save
    directory (``save_pretrained``)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf_config(json.load(f))
    return cfg, whisper_state_dict_from_hf(_load_hf_weight_files(path), cfg)


def hf_config_dict(cfg: WhisperConfig) -> Dict[str, Any]:
    """transformers Whisper ``config.json`` content for ``cfg``.

    Token ids follow HF's published whisper configs (pad = bos = eos =
    ``<|endoftext|>``, decoder_start = ``<|startoftranscript|>``): 50257 /
    50258 for the multilingual vocab (51865 and up), 50256 / 50257 for the
    51864-token English vocab; other (test-sized) vocabs clamp to the last
    id so ``from_pretrained`` never indexes past the embedding.
    """
    if cfg.n_vocab >= 51865:
        eos, dst = 50257, 50258
    elif cfg.n_vocab == 51864:
        eos, dst = 50256, 50257
    else:
        eos, dst = cfg.n_vocab - 1, cfg.n_vocab - 1
    return {
        "pad_token_id": eos,
        "bos_token_id": eos,
        "eos_token_id": eos,
        "decoder_start_token_id": dst,
        "model_type": "whisper",
        "architectures": ["WhisperForConditionalGeneration"],
        "vocab_size": cfg.n_vocab,
        "num_mel_bins": cfg.n_mels,
        "d_model": cfg.n_audio_state,
        "encoder_layers": cfg.n_audio_layer,
        "encoder_attention_heads": cfg.n_audio_head,
        "encoder_ffn_dim": 4 * cfg.n_audio_state,
        "decoder_layers": cfg.n_text_layer,
        "decoder_attention_heads": cfg.n_text_head,
        "decoder_ffn_dim": 4 * cfg.n_text_state,
        "max_source_positions": cfg.n_audio_ctx,
        "max_target_positions": cfg.n_text_ctx,
        "activation_function": "gelu",
        "is_encoder_decoder": True,
        "tie_word_embeddings": True,
    }


def whisper_state_dict_to_hf(sd: Mapping, cfg: WhisperConfig) -> StateDict:
    """The port's whisper state dict -> transformers naming, float32.

    Emits ``WhisperForConditionalGeneration`` keys (``model.encoder.*`` /
    ``model.decoder.*``); ``proj_out`` is left out (transformers ties it to
    ``embed_tokens`` from the config) and the encoder's frozen
    ``embed_positions`` table is synthesised."""
    out = {f"model.{hf}": _f32(sd[ours]).contiguous() for ours, hf in _hf_names(cfg)}
    out["model.encoder.embed_positions.weight"] = _sinusoids(cfg)
    return out


def save_hf_checkpoint(sd: Mapping, cfg: WhisperConfig, path: str) -> None:
    """Write a transformers-loadable Whisper save directory: ``config.json``
    and ``model.safetensors`` (``pytorch_model.bin`` when the safetensors
    package is missing), for ``WhisperForConditionalGeneration
    .from_pretrained(path)``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    hf = whisper_state_dict_to_hf(sd, cfg)
    try:
        from safetensors.torch import save_file
    except ImportError:
        torch.save(hf, os.path.join(path, "pytorch_model.bin"))
    else:
        save_file(hf, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
