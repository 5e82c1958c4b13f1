"""Whisper checkpoint formats into and out of the port, against the JAX
package's converters: OpenAI ``.pt`` and HF transformers save directories
(safetensors and ``pytorch_model.bin``, single and index-sharded, float32
and bf16, ``model.``-prefixed and bare names) import to the same tensors
(atol 0); the HF export and ``config.json`` equal JAX's; an untied
``proj_out`` and a trained encoder ``embed_positions`` are refused as JAX
refuses them; and, where ``transformers`` is importable, the port's HF
export gives ``WhisperForConditionalGeneration`` the port's logits."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from lyricalignment_tpu.models import convert as jconv
from lyricalignment_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from lyricalignment_tpu_torch.models import convert
from lyricalignment_tpu_torch.models.whisper import Whisper, WhisperConfig
from tests.torch_port_helpers import TINY_DIMS, as_jax, jax_tiny_model, jax_whisper_sd


@dataclasses.dataclass
class ModelDimensions:
    """OpenAI's ``whisper.model.ModelDimensions`` (a checkpoint's ``dims``
    may be this object rather than a dict)."""
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int


def assert_same(got, want):
    """Key for key, and value for value (atol 0, float32)."""
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg, params = jax_tiny_model(seed=4)
    wp = params["whisper"]
    sd = jax_whisper_sd(wp, cfg.whisper.n_audio_ctx)
    hf_dir = str(tmp_path_factory.mktemp("hf") / "jax_written")
    jconv.save_hf_checkpoint(as_jax(wp), cfg.whisper, hf_dir)
    return dict(jcfg=cfg.whisper, wp=wp, sd=sd, hf_dir=hf_dir,
                cfg=WhisperConfig(**TINY_DIMS))


@pytest.mark.parametrize("dims_as", ["dict", "object"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_openai_import_equals_jax(tiny, tmp_path, dims_as, dtype):
    dims = ModelDimensions(**TINY_DIMS)
    path = str(tmp_path / "openai.pt")
    torch.save({"dims": dataclasses.asdict(dims) if dims_as == "dict" else dims,
                "model_state_dict": {k: torch.from_numpy(v).to(dtype)
                                     for k, v in tiny["sd"].items()}}, path)
    cfg, sd = convert.load_openai_checkpoint(path)
    jcfg, jparams = jconv.load_openai_checkpoint(path)
    assert cfg == tiny["cfg"]
    assert all(getattr(cfg, k) == getattr(jcfg, k) for k in TINY_DIMS)
    assert_same(sd, jax_whisper_sd(jparams, cfg.n_audio_ctx))
    Whisper(cfg).load_state_dict(sd, strict=True)


def _write_st(sd, path):
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in sd.items()}, path, metadata={"format": "pt"})


def _hf_variant(tiny, tmp_path, layout):
    """A copy of the JAX-written HF dir in another layout."""
    from safetensors.torch import load_file

    sd = load_file(os.path.join(tiny["hf_dir"], "model.safetensors"))
    d = tmp_path / layout
    d.mkdir()
    (d / "config.json").write_text((open(os.path.join(tiny["hf_dir"], "config.json")).read()))
    if layout == "safetensors":
        _write_st(sd, str(d / "model.safetensors"))
    elif layout == "bin":
        torch.save(sd, str(d / "pytorch_model.bin"))
    elif layout == "bf16_safetensors":
        _write_st({k: v.to(torch.bfloat16) for k, v in sd.items()}, str(d / "model.safetensors"))
    elif layout == "tied_proj_out":
        tied = sd["model.decoder.embed_tokens.weight"].clone()
        _write_st({**sd, "proj_out.weight": tied}, str(d / "model.safetensors"))
    elif layout in ("sharded_safetensors", "sharded_bin"):
        keys = sorted(sd)
        shards = {}
        for i, half in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
            if layout == "sharded_bin":
                name = f"pytorch_model-{i + 1:05d}-of-00002.bin"
                torch.save({k: sd[k] for k in half}, str(d / name))
            else:
                name = f"model-{i + 1:05d}-of-00002.safetensors"
                _write_st({k: sd[k] for k in half}, str(d / name))
            shards.update({k: name for k in half})
        index = "pytorch_model.bin.index.json" if layout == "sharded_bin" else \
            "model.safetensors.index.json"
        (d / index).write_text(json.dumps({"metadata": {}, "weight_map": shards}))
    return str(d)


@pytest.mark.parametrize("layout", ["jax_written", "safetensors", "bin", "sharded_safetensors",
                                    "sharded_bin", "bf16_safetensors", "tied_proj_out"])
def test_hf_import_equals_jax(tiny, tmp_path, layout):
    path = tiny["hf_dir"] if layout == "jax_written" else _hf_variant(tiny, tmp_path, layout)
    cfg, sd = convert.load_hf_checkpoint(path)
    jcfg, jparams = jconv.load_hf_checkpoint(path)
    assert cfg == tiny["cfg"]
    assert all(getattr(cfg, k) == getattr(jcfg, k) for k in TINY_DIMS)
    want = jax_whisper_sd(jparams, cfg.n_audio_ctx)
    assert_same(sd, want)
    if layout != "bf16_safetensors":  # the source's own values, unrounded
        assert_same(sd, tiny["sd"])


def test_bare_whisper_model_names_equal_jax(tiny):
    """``WhisperModel`` naming (no ``model.`` prefix), straight from a state
    dict."""
    from safetensors.torch import load_file

    sd = load_file(os.path.join(tiny["hf_dir"], "model.safetensors"))
    bare = {k[len("model."):]: v for k, v in sd.items()}
    got = convert.whisper_state_dict_from_hf(bare, tiny["cfg"])
    want = jax_whisper_sd(jconv.whisper_params_from_hf_state_dict(bare, tiny["jcfg"]),
                          tiny["cfg"].n_audio_ctx)
    assert_same(got, want)


def test_hf_export_equals_jax(tiny):
    sd = {k: torch.from_numpy(v) for k, v in tiny["sd"].items()}
    got = convert.whisper_state_dict_to_hf(sd, tiny["cfg"])
    want = jconv.whisper_params_to_hf_state_dict(as_jax(tiny["wp"]), tiny["jcfg"])
    assert_same(got, want)
    assert "model.encoder.layers.0.self_attn.k_proj.bias" not in got


@pytest.mark.parametrize("n_vocab", [64, 51864, 51865, 51866])
def test_hf_config_dict_equals_jax(n_vocab):
    dims = {**TINY_DIMS, "n_vocab": n_vocab, "n_text_layer": 3, "n_text_head": 2}
    assert convert.hf_config_dict(WhisperConfig(**dims)) == \
        jconv.hf_config_dict(JaxWhisperConfig(**dims))


@pytest.mark.parametrize("with_safetensors", [True, False])
def test_save_hf_checkpoint_reads_in_jax(tiny, tmp_path, monkeypatch, with_safetensors):
    """The port's HF writer: ``model.safetensors``, or ``pytorch_model.bin``
    without the safetensors package; the JAX reader gets the source back."""
    if not with_safetensors:
        monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    out = str(tmp_path / "port_written")
    convert.save_hf_checkpoint({k: torch.from_numpy(v) for k, v in tiny["sd"].items()},
                               tiny["cfg"], out)
    weights = "model.safetensors" if with_safetensors else "pytorch_model.bin"
    assert sorted(os.listdir(out)) == ["config.json", weights]
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == jconv.hf_config_dict(tiny["jcfg"])
    monkeypatch.undo()
    jcfg, jparams = jconv.load_hf_checkpoint(out)
    assert_same({k: torch.from_numpy(np.asarray(v)) for k, v in tiny["sd"].items()},
                jax_whisper_sd(jparams, jcfg.n_audio_ctx))
    assert_same(convert.load_hf_checkpoint(out)[1], tiny["sd"])


def test_reading_safetensors_needs_the_package(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError, match="model.safetensors"):
        convert.load_hf_checkpoint(tiny["hf_dir"])


def _hf_sd(tiny):
    from safetensors.torch import load_file

    return load_file(os.path.join(tiny["hf_dir"], "model.safetensors"))


def test_untied_proj_out_refused_as_jax(tiny):
    sd = _hf_sd(tiny)
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"] + 0.5
    with pytest.raises(ValueError, match="untied proj_out"):
        convert.whisper_state_dict_from_hf(sd, tiny["cfg"])
    with pytest.raises(ValueError, match="untied proj_out"):
        jconv.whisper_params_from_hf_state_dict(sd, tiny["jcfg"])


@pytest.mark.parametrize("storage,shift,refused", [
    (torch.float32, 2e-3, True),    # trained: past 1e-4 for 4-byte storage
    (torch.float32, 5e-5, False),
    (torch.bfloat16, 0.0, False),   # bf16 rounding of the sinusoids (<= 2^-9)
    (torch.bfloat16, 0.05, True),
    (torch.float16, 0.0, False),
])
def test_embed_positions_checked_as_jax(tiny, storage, shift, refused):
    sd = _hf_sd(tiny)
    key = "model.encoder.embed_positions.weight"
    sd[key] = (sd[key] + shift).to(storage)
    for fn, cfg in ((convert.whisper_state_dict_from_hf, tiny["cfg"]),
                    (jconv.whisper_params_from_hf_state_dict, tiny["jcfg"])):
        if refused:
            with pytest.raises(ValueError, match="embed_positions"):
                fn(sd, cfg)
        else:
            fn(sd, cfg)


def test_hf_export_logits_equal_transformers(tiny, tmp_path, monkeypatch):
    """Optional oracle: ``WhisperForConditionalGeneration.from_pretrained``
    on the port's export computes the port model's encoder states and
    logits (float32 on the CPU; atol 2e-4, rtol 1e-4: two orders of the
    same sums)."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    model = Whisper(tiny["cfg"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in tiny["sd"].items()}, strict=True)
    model.eval()
    out = str(tmp_path / "hf")
    convert.save_hf_checkpoint(model.state_dict(), tiny["cfg"], out)
    hf = transformers.WhisperForConditionalGeneration.from_pretrained(out).eval()

    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 3000)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 64, size=(2, 7)))
    with torch.no_grad():
        enc_hf = hf.model.encoder(mel).last_hidden_state
        logits_hf = hf(input_features=mel, decoder_input_ids=tokens).logits
        xa = model.embed_audio(mel)
        logits = model.decoder_logits(tokens, xa)
    torch.testing.assert_close(xa, enc_hf, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(logits, logits_hf, atol=2e-4, rtol=1e-4)
