"""Shared fixtures of the port's parity tests (tests/test_torch_*.py): a
tiny JAX align model with every parameter perturbed from a numpy seed, and
the same weights loaded into the PyTorch port."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.align_model import AlignModelConfig as JaxAlignConfig
from lyricalignment_tpu.models.align_model import init_align_model
from lyricalignment_tpu.models.convert import align_params_to_state_dict
from lyricalignment_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from lyricalignment_tpu_torch.models.align_model import AlignModel, AlignModelConfig
from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from lyricalignment_tpu_torch.models.whisper import WhisperConfig

# whisper dims of the tiny test backbone (the ten ints of WhisperConfig)
TINY_DIMS = dict(n_mels=80, n_vocab=64, n_audio_ctx=1500, n_audio_state=64,
                 n_audio_head=4, n_audio_layer=2, n_text_ctx=16,
                 n_text_state=64, n_text_head=4, n_text_layer=1)


def jax_tiny_model(output_dim: int = 420, hidden_dim: int = 16, seed: int = 0,
                   fc_scale: float = 1.0, dims=None, **whisper_kw):
    """(JAX config, numpy parameter tree): ``init_align_model`` plus a
    seeded perturbation of every leaf, so zero biases and unit LayerNorm
    scales do not hide a layout error. ``fc_scale`` multiplies the head's
    fc weights (sharper emissions, fewer near-ties in the Viterbi);
    ``dims`` overrides entries of ``TINY_DIMS``."""
    cfg = JaxAlignConfig(whisper=JaxWhisperConfig(**{**TINY_DIMS, **(dims or {})},
                                                  **whisper_kw),
                         hidden_dim=hidden_dim, output_dim=output_dim)
    params = init_align_model(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    params["align_head"]["fc"]["w"] = params["align_head"]["fc"]["w"] * fc_scale
    return cfg, params


def jax_whisper_sd(wp, n_audio_ctx: int = 1500):
    """A JAX whisper parameter tree in the port's names (numpy), through the
    JAX package's own reference export."""
    head = {"gru": {"layers": []}, "fc": {"w": np.zeros((1, 1)), "b": np.zeros(1)}}
    sd = align_params_to_state_dict({"whisper": as_jax(wp), "align_head": head},
                                    n_audio_ctx=n_audio_ctx)
    return {k[len("whisper_model."):]: v for k, v in sd.items()
            if k.startswith("whisper_model.")}


def as_jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def torch_config(jax_cfg, compute_dtype=torch.float32) -> AlignModelConfig:
    """The port's AlignModelConfig of a JAX one: the same dims and flags."""
    jw = jax_cfg.whisper
    wcfg = WhisperConfig(**{k: getattr(jw, k) for k in TINY_DIMS},
                         compute_dtype=compute_dtype, fast_gelu=jw.fast_gelu,
                         onepass_encoder=jw.onepass_encoder, int8_encoder=jw.int8_encoder,
                         int8_cross_kv=jw.int8_cross_kv)
    return AlignModelConfig(
        whisper=wcfg, hidden_dim=jax_cfg.hidden_dim, output_dim=jax_cfg.output_dim,
        num_rnn_layers=jax_cfg.num_rnn_layers, bidirectional=jax_cfg.bidirectional,
        dropout=jax_cfg.dropout, freeze_encoder=jax_cfg.freeze_encoder,
        train_alignment=jax_cfg.train_alignment, train_transcript=jax_cfg.train_transcript)


def torch_model(jax_cfg, params, compute_dtype=torch.float32) -> AlignModel:
    """The port's AlignModel with the same weights (strict load), eval mode."""
    model = AlignModel(torch_config(jax_cfg, compute_dtype))
    model.load_state_dict(state_dict_from_jax_params(
        params, n_audio_ctx=jax_cfg.whisper.n_audio_ctx), strict=True)
    return model.eval()


def with_whisper(jax_cfg, **kw):
    return dataclasses.replace(jax_cfg, whisper=dataclasses.replace(jax_cfg.whisper, **kw))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for a module that imports this fixture,
    restored after it. The decode loops run thousands of small ops; with
    torch's default of a thread a core, their threads spin against the
    other test workers' on a shared CPU (six workers of the longform tests:
    1185 s with 8 threads each, 75 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
