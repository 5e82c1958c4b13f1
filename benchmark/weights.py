"""Seeded weights of an alignment model, made on the device.

The benchmark makes every weight itself, from the seed, with one generator
on the card and one large uniform draw sliced into the parameters, and hands
the same tensors to the program and to the reference. Names and shapes are
Whisper's published ``state_dict`` layout (``encoder.blocks.{i}.attn.query
.weight`` ...) under ``whisper_model.``, and the alignment head's
(``align_rnn.rnn.weight_ih_l{i}[_reverse]``, ``align_rnn.fc``) in
``torch.nn.GRU``'s gate order r, z, n.

Distributions: linear and conv weights U(+-1/sqrt(fan_in)); biases and
LayerNorm offsets U(+-0.02), LayerNorm scales 1 + U(+-0.1); the token
embedding U with standard deviation 0.02, the decoder positions U(+-0.5)
(so that a step's logits move with its position: with positions near zero a
random decoder repeats one token by a wide margin, and no served token is
ever contested) and its cross-attention's query and key U(+-4/sqrt(fan_in))
(so that a token attends to a few frames, as a trained decoder does, and
the audio moves its logits: flat attention over 1500 frames averages the
audio away); the GRU U(+-1/sqrt(H)); the classifier U(+-s/sqrt(fan_in)), with s = 8 for
the alignment cells so that the emissions are sharp as a trained head's are
(few near-ties in the Viterbi). The encoder's positions are Whisper's fixed
sinusoids.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# (name, shape, kind) of every parameter; kind picks the distribution
Spec = List[Tuple[str, Tuple[int, ...], str]]


def _attention(prefix: str, d: int, qk: str = "linear") -> Spec:
    out = []
    for proj in ("query", "key", "value", "out"):
        out.append((f"{prefix}.{proj}.weight", (d, d), qk if proj in ("query", "key") else "linear"))
        if proj != "key":
            out.append((f"{prefix}.{proj}.bias", (d,), "bias"))
    return out


def _ln(prefix: str, d: int) -> Spec:
    return [(f"{prefix}.weight", (d,), "ln_scale"), (f"{prefix}.bias", (d,), "bias")]


def _block(prefix: str, d: int, cross: bool) -> Spec:
    out = _attention(f"{prefix}.attn", d) + _ln(f"{prefix}.attn_ln", d)
    if cross:
        out += _attention(f"{prefix}.cross_attn", d, "cross_qk") + _ln(f"{prefix}.cross_attn_ln", d)
    out += [(f"{prefix}.mlp.0.weight", (4 * d, d), "linear"), (f"{prefix}.mlp.0.bias", (4 * d,), "bias"),
            (f"{prefix}.mlp.2.weight", (d, 4 * d), "linear"), (f"{prefix}.mlp.2.bias", (d,), "bias")]
    return out + _ln(f"{prefix}.mlp_ln", d)


def param_spec(cfg: Dict) -> Spec:
    """Every parameter of the alignment model that ``cfg`` (a configuration
    file's dict) describes, in a fixed order."""
    d, dt = cfg["n_audio_state"], cfg["n_text_state"]
    w = "whisper_model"
    spec: Spec = [(f"{w}.encoder.conv1.weight", (d, cfg["n_mels"], 3), "linear"),
                  (f"{w}.encoder.conv1.bias", (d,), "bias"),
                  (f"{w}.encoder.conv2.weight", (d, d, 3), "linear"),
                  (f"{w}.encoder.conv2.bias", (d,), "bias")]
    for i in range(cfg["n_audio_layer"]):
        spec += _block(f"{w}.encoder.blocks.{i}", d, cross=False)
    spec += _ln(f"{w}.encoder.ln_post", d)
    spec += [(f"{w}.decoder.token_embedding.weight", (cfg["n_vocab"], dt), "embedding"),
             (f"{w}.decoder.positional_embedding", (cfg["n_text_ctx"], dt), "positions")]
    for i in range(cfg["n_text_layer"]):
        spec += _block(f"{w}.decoder.blocks.{i}", dt, cross=True)
    spec += _ln(f"{w}.decoder.ln", dt)
    head = cfg["head"]
    h, dirs = head["hidden_dim"], 2 if head["bidirectional"] else 1
    for layer in range(head["num_rnn_layers"]):
        n_in = d if layer == 0 else h * dirs
        for sfx in ("", "_reverse")[:dirs]:
            spec += [(f"align_rnn.rnn.weight_ih_l{layer}{sfx}", (3 * h, n_in), "gru"),
                     (f"align_rnn.rnn.weight_hh_l{layer}{sfx}", (3 * h, h), "gru"),
                     (f"align_rnn.rnn.bias_ih_l{layer}{sfx}", (3 * h,), "gru"),
                     (f"align_rnn.rnn.bias_hh_l{layer}{sfx}", (3 * h,), "gru")]
    spec += [("align_rnn.fc.weight", (head["output_dim"], h * dirs), "classifier"),
             ("align_rnn.fc.bias", (head["output_dim"],), "bias")]
    return spec


def _half_width(name: str, shape, kind: str, cfg: Dict,
                classifier_scale: float) -> Tuple[float, float]:
    """(centre, half width) of the uniform draw of one parameter."""
    if kind == "linear":
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if kind == "cross_qk":
        return 0.0, 4.0 / math.sqrt(shape[1])
    if kind == "classifier":
        return 0.0, classifier_scale / math.sqrt(shape[1])
    if kind == "gru":
        return 0.0, 1.0 / math.sqrt(cfg["head"]["hidden_dim"])
    if kind == "embedding":
        return 0.0, 0.02 * math.sqrt(3.0)
    if kind == "positions":
        return 0.0, 0.5
    if kind == "ln_scale":
        return 1.0, 0.1
    return 0.0, 0.02                                     # biases, LayerNorm offsets


def served_dtype(name: str, shape, resident: str) -> torch.dtype:
    """The type a weight is served in: under bf16 residency every whisper
    matrix and conv kernel but the decoder's token and position tables;
    float32 otherwise."""
    keep = ("decoder.token_embedding.weight", "decoder.positional_embedding")
    if (resident == "bfloat16" and name.startswith("whisper_model.") and len(shape) >= 2
            and not name.endswith(keep)):
        return torch.bfloat16
    return torch.float32


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positions: log-spaced sinusoids, sin then cos."""
    step = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-step * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device, resident: str,
                 classifier_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """{name: tensor} on ``device`` from ``seed``: one uniform draw of every
    parameter's elements, sliced, scaled and cast to the type it is served
    in (``resident``: "bfloat16" or "float32"), plus the encoder's fixed
    positions (float32). ``classifier_scale`` widens the classifier's draw
    (the traffic file's ``classifier_scale``)."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        centre, half = _half_width(name, shape, kind, cfg, classifier_scale)
        piece = flat[at:at + n].view(shape).mul_(2.0 * half).add_(centre - half)
        out[name] = piece.to(served_dtype(name, shape, resident), copy=True)
        at += n
    del flat
    d = cfg["n_audio_state"]
    out["whisper_model.encoder.positional_embedding"] = torch.from_numpy(
        sinusoids(cfg["n_audio_ctx"], d)).to(device)
    return out
