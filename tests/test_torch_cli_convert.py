"""The port's checkpoint-converter CLI (``la-convert``) on the CPU: the three
cases of ``tests/test_cli_convert.py`` (export then import, OpenAI import
naming the size, an asymmetric backbone as "custom"), plus ``import-hf``
and ``export-hf``, each held to the JAX package's converters value for
value; every model dir the port writes loads in the JAX ``load_model_dir``
with the same backbone."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.cli.common import load_model_dir as jax_load_model_dir
from lyricalignment_tpu.models import convert as jconv
from lyricalignment_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from lyricalignment_tpu.models.whisper import encode_audio, init_whisper_params
from lyricalignment_tpu.train.checkpoints import export_reference_pt as jax_export_pt
from lyricalignment_tpu_torch.cli.common import load_model_dir
from lyricalignment_tpu_torch.cli.convert_checkpoint import main as convert_main
from lyricalignment_tpu_torch.models.align_head import AlignHead
from lyricalignment_tpu_torch.models.align_model import (
    AlignModel,
    init_head_weights,
    init_weights,
)
from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, WHISPER_DIMS
from lyricalignment_tpu_torch.train.checkpoints import export_reference_pt, save_json
from tests.torch_port_helpers import jax_whisper_sd


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    """A port model dir of whisper-tiny with a CTC head, every tensor
    perturbed from a seed (zero biases would hide a layout error)."""
    from lyricalignment_tpu_torch.cli.common import build_model_config

    d = tmp_path_factory.mktemp("model")
    mcfg = build_model_config("tiny", output_dim=21129)
    model = init_weights(AlignModel(mcfg), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    save_json(str(d / "args.json"), {"whisper_model": "tiny", "use_ctc_loss": True})
    save_json(str(d / "model_args.json"), {
        "embed_dim": 384, "hidden_dim": 384, "output_dim": 21129, "bidirectional": True,
        "freeze_encoder": False, "train_alignment": True, "train_transcript": False})
    export_reference_pt(model, str(d / "best_model.pt"))
    return str(d), model.state_dict()


def assert_whisper_equal_in_jax(model_dir, want_sd):
    """The JAX ``load_model_dir`` reads the port-written dir to the backbone
    of ``want_sd`` (port names)."""
    mcfg, params, _ = jax_load_model_dir(model_dir, "best")
    got = jax_whisper_sd(jax.tree_util.tree_map(np.asarray, params["whisper"]),
                         mcfg.whisper.n_audio_ctx)
    want = {k[len("whisper_model."):]: v for k, v in want_sd.items()
            if k.startswith("whisper_model.")}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    return mcfg, params


def test_export_then_import_round_trip(tiny_model_dir, tmp_path):
    model_dir, sd = tiny_model_dir
    pt = str(tmp_path / "ref.pt")
    assert convert_main(["export", "--model-dir", model_dir, "--pt", pt]) == 0

    # a reference-named state dict, with the keys of the JAX export
    exported = torch.load(pt, map_location="cpu", weights_only=True)
    for key in ("whisper_model.encoder.conv1.weight",
                "whisper_model.encoder.positional_embedding", "align_rnn.fc.weight"):
        assert key in exported
    jax_pt = str(tmp_path / "jax_ref.pt")
    _, jparams, _ = jax_load_model_dir(model_dir, "best")
    jax_export_pt(jparams, jax_pt, n_audio_ctx=1500)
    jax_exported = torch.load(jax_pt, map_location="cpu", weights_only=False)
    assert set(exported) == set(jax_exported)
    for k, v in jax_exported.items():
        np.testing.assert_array_equal(exported[k].numpy(), np.asarray(v), err_msg=k)

    out = str(tmp_path / "imported")
    assert convert_main(["import", "--pt", pt, "--whisper-model", "tiny",
                         "--output-dir", out, "--use-ctc-loss"]) == 0
    mcfg, model, train_args = load_model_dir(out, "best", device="cpu")
    assert train_args["use_ctc_loss"] is True and train_args["whisper_model"] == "tiny"
    assert mcfg.output_dim == 21129
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert_whisper_equal_in_jax(out, sd)


def _openai_pt(path, sd, dims):
    torch.save({"dims": dims,
                "model_state_dict": {k[len("whisper_model."):]: v for k, v in sd.items()
                                     if k.startswith("whisper_model.")}}, path)


def test_import_openai_infers_size(tiny_model_dir, tmp_path):
    _, sd = tiny_model_dir
    pt = str(tmp_path / "openai.pt")
    _openai_pt(pt, sd, {k: getattr(WHISPER_CONFIGS["tiny"], k) for k in WHISPER_DIMS})

    out = str(tmp_path / "pretrained")
    assert convert_main(["import-openai", "--pt", pt, "--output-dir", out, "--seed", "5"]) == 0
    mcfg, model, train_args = load_model_dir(out, "best", device="cpu")
    assert train_args["whisper_model"] == "tiny" and "whisper_dims" not in train_args
    got = model.state_dict()
    for k, v in sd.items():
        if k.startswith("whisper_model."):
            assert torch.equal(got[k], v), k
    # the head: 21128 classes, drawn from --seed with init_weights' law
    assert model.align_rnn.fc.weight.shape == (21128, 768)
    head = init_head_weights(AlignHead(384, 384, 21128), torch.Generator().manual_seed(5))
    for k, v in head.state_dict().items():
        assert torch.equal(got[f"align_rnn.{k}"], v), k
    jmcfg, jparams = assert_whisper_equal_in_jax(out, sd)
    assert jparams["align_head"]["fc"]["w"].shape[-1] == 21128


def test_import_openai_custom_dims(tmp_path):
    """An asymmetric backbone that matches no size name (a distil-whisper-
    style 1-layer decoder) imports as whisper_model "custom" with the full
    architecture in args.json; both packages' load_model_dir rebuild it."""
    dims = {"n_mels": 80, "n_vocab": 96, "n_audio_ctx": 40, "n_audio_state": 32,
            "n_audio_head": 4, "n_audio_layer": 2, "n_text_ctx": 12, "n_text_state": 32,
            "n_text_head": 4, "n_text_layer": 1}
    jcfg = JaxWhisperConfig(**dims)
    wp = init_whisper_params(jax.random.PRNGKey(7), jcfg)
    wsd = jax_whisper_sd(jax.tree_util.tree_map(np.asarray, wp), 40)
    pt = str(tmp_path / "asym.pt")
    torch.save({"dims": dims, "model_state_dict": {k: torch.from_numpy(v)
                                                   for k, v in wsd.items()}}, pt)

    out = str(tmp_path / "custom_dir")
    assert convert_main(["import-openai", "--pt", pt, "--output-dir", out]) == 0
    mcfg, model, train_args = load_model_dir(out, "best", device="cpu")
    assert train_args["whisper_model"] == "custom"
    assert train_args["whisper_dims"] == dims
    assert mcfg.whisper.n_audio_layer == 2 and mcfg.whisper.n_text_layer == 1
    for k, v in wsd.items():
        np.testing.assert_array_equal(model.whisper_model.state_dict()[k].numpy(), v, err_msg=k)

    jmcfg, jparams, jargs = jax_load_model_dir(out, "best")
    assert jargs["whisper_model"] == "custom" and jmcfg.whisper.n_text_layer == 1
    mel = jnp.asarray(np.random.default_rng(3).standard_normal((1, 80, 80)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(encode_audio(jparams["whisper"], jmcfg.whisper, mel)),
                               np.asarray(encode_audio(wp, jcfg, mel)), atol=1e-6)


@pytest.mark.parametrize("ctc", [True, False])
def test_import_hf_equals_jax_reader(tiny_model_dir, tmp_path, ctc):
    """An HF dir written by the JAX package imports to the backbone the JAX
    reader gives, under the size name it matches."""
    _, sd = tiny_model_dir
    wsd = {k[len("whisper_model."):]: v for k, v in sd.items() if k.startswith("whisper_model.")}
    jcfg = JaxWhisperConfig(**{k: getattr(WHISPER_CONFIGS["tiny"], k) for k in WHISPER_DIMS})
    hf = str(tmp_path / "hf")
    jparams = jconv.whisper_params_from_state_dict(wsd, jcfg)
    jconv.save_hf_checkpoint(jparams, jcfg, hf)

    out = str(tmp_path / "from_hf")
    argv = ["import-hf", "--hf-dir", hf, "--output-dir", out] + (["--use-ctc-loss"] if ctc else [])
    assert convert_main(argv) == 0
    mcfg, model, train_args = load_model_dir(out, "best", device="cpu")
    assert train_args == {"whisper_model": "tiny", "use_ctc_loss": ctc}
    assert mcfg.output_dim == 21128 + ctc
    _, from_jax = jconv.load_hf_checkpoint(hf)
    want = jax_whisper_sd(jax.tree_util.tree_map(np.asarray, from_jax), 1500)
    got = model.whisper_model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert_whisper_equal_in_jax(out, sd)


def test_export_hf_reads_in_jax(tiny_model_dir, tmp_path):
    model_dir, sd = tiny_model_dir
    out = str(tmp_path / "hf_out")
    assert convert_main(["export-hf", "--model-dir", model_dir, "--output-dir", out]) == 0
    jcfg, jparams = jconv.load_hf_checkpoint(out)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == jconv.hf_config_dict(jcfg)
    got = jax_whisper_sd(jax.tree_util.tree_map(np.asarray, jparams), 1500)
    for k, v in got.items():
        np.testing.assert_array_equal(v, sd[f"whisper_model.{k}"].numpy(), err_msg=k)
    # and back through import-hf: the same backbone, a new head
    back = str(tmp_path / "back")
    assert convert_main(["import-hf", "--hf-dir", out, "--output-dir", back,
                         "--use-ctc-loss"]) == 0
    _, model, _ = load_model_dir(back, "best", device="cpu")
    for k, v in model.whisper_model.state_dict().items():
        assert torch.equal(v, sd[f"whisper_model.{k}"]), k


def test_import_refuses_a_checkpoint_of_another_model(tiny_model_dir, tmp_path):
    _, sd = tiny_model_dir
    pt = str(tmp_path / "tiny.pt")
    torch.save(sd, pt)
    with pytest.raises(ValueError, match="shape"):  # a CTC head of 21129 classes
        convert_main(["import", "--pt", pt, "--whisper-model", "tiny",
                      "--output-dir", str(tmp_path / "x")])
    with pytest.raises(KeyError, match="blocks.4"):  # base has 6 layers, tiny 4
        convert_main(["import", "--pt", pt, "--whisper-model", "base",
                      "--output-dir", str(tmp_path / "x"), "--use-ctc-loss"])
    partial = {k: v for k, v in sd.items() if not k.startswith("align_rnn.fc.")}
    torch.save(partial, pt)
    with pytest.raises(KeyError, match="align_rnn.fc"):
        convert_main(["import", "--pt", pt, "--whisper-model", "tiny",
                      "--output-dir", str(tmp_path / "y"), "--use-ctc-loss"])
