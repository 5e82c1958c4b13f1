"""Weights into the port: ``state_dict_from_jax_params`` equals the JAX
package's own reference export key for key and value for value, loads
strictly, and a reference ``.pt`` model dir loads through the port's
``load_model_dir``. So does an orbax model dir of the JAX package (the
form ``la-convert import`` writes and a trainer's full-state dir): bit for
bit the JAX ``la-convert export`` of it, the alignment CLI's MAE on it the
JAX CLI's, and the port's ``export`` / ``export-hf`` of it the JAX tool's."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.convert import align_params_to_state_dict
from lyricalignment_tpu_torch.cli.common import load_model_dir
from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from tests.torch_port_helpers import TINY_DIMS, as_jax, jax_tiny_model, torch_model


def test_state_dict_equals_reference_export():
    _, params = jax_tiny_model()
    ref = align_params_to_state_dict(as_jax(params))
    got = state_dict_from_jax_params(params)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_model_state_dict_names_are_the_reference_names():
    cfg, params = jax_tiny_model()
    model = torch_model(cfg, params)  # strict load inside
    assert set(model.state_dict()) == set(align_params_to_state_dict(as_jax(params)))


def _model_dir(tmp_path, params):
    (tmp_path / "args.json").write_text(json.dumps(
        {"whisper_model": "custom", "whisper_dims": TINY_DIMS, "use_ctc_loss": True}))
    (tmp_path / "model_args.json").write_text(json.dumps({"output_dim": 420}))
    sd = align_params_to_state_dict(as_jax(params))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               str(tmp_path / "best_model.pt"))
    return sd


@pytest.mark.parametrize("bf16", [False, True])
def test_load_model_dir_reads_reference_pt(tmp_path, bf16):
    _, params = jax_tiny_model(hidden_dim=384)  # model dirs use hidden 384
    sd = _model_dir(tmp_path, params)
    mcfg, model, train_args = load_model_dir(str(tmp_path), use_bf16=bf16, device="cpu")
    assert train_args["whisper_model"] == "custom"
    assert mcfg.whisper.n_audio_state == 64 and mcfg.output_dim == 420
    assert not model.training
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.float().numpy(),
                                      torch.from_numpy(sd[name]).to(p.dtype).float().numpy())
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    want16 = torch.bfloat16 if bf16 else torch.float32
    assert dtypes["whisper_model.encoder.blocks.0.attn.query.weight"] == want16
    assert dtypes["whisper_model.encoder.conv1.weight"] == want16
    assert dtypes["whisper_model.decoder.token_embedding.weight"] == torch.float32
    assert dtypes["whisper_model.encoder.ln_post.weight"] == torch.float32
    assert all(p.dtype == torch.float32 for n, p in model.named_parameters()
               if n.startswith("align_rnn."))


def _cli_mae_against_jax(tmp_path, monkeypatch, write_checkpoint):
    import sys

    from lyricalignment_tpu.cli.inference_alignment import main as jax_main
    from lyricalignment_tpu_torch.cli.inference_alignment import main as port_main
    from lyricalignment_tpu_torch.data.audio_io import write_wav

    _, params = jax_tiny_model(hidden_dim=384, fc_scale=8.0, seed=5)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    write_checkpoint(model_dir, params)
    rng = np.random.default_rng(5)
    wav = str(tmp_path / "song.wav")
    write_wav(wav, (rng.standard_normal(3 * 16000) * 0.1).astype(np.float32))
    data = tmp_path / "test.json"
    data.write_text(json.dumps([{"song_path": wav, "lyric": "你好",
                                 "on_offset": [[0.1, 0.5], [0.6, 1.0]]}]))
    argv = ["-f", str(data), "--model-dir", str(model_dir), "--synthetic-vocab",
            "--use-ctc-loss"]
    got = port_main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["inference_alignment"] + argv)
    ref = jax_main()
    assert np.isfinite(got)
    assert abs(got - ref) <= 0.02 / 4 + 1e-6, (got, ref)


def test_cli_mae_matches_jax_cli(tmp_path, monkeypatch):
    """The alignment CLI end to end on a reference .pt model dir: the port
    (``--device cpu``) and the JAX CLI report the same average MAE (one
    frame of a 20 ms flip on one of the 4 boundaries allowed: float32
    summation order differs between the two)."""
    _cli_mae_against_jax(tmp_path, monkeypatch, _model_dir)


def test_cli_mae_on_orbax_dir_matches_jax_cli(tmp_path, monkeypatch):
    """The same on the JAX package's orbax form of the model dir
    (``{"params", "step"}`` as ``la-convert import`` saves it), which both
    CLIs read."""
    from lyricalignment_tpu.train.checkpoints import save_pytree

    def write(model_dir, params):
        _model_dir(model_dir, params)
        os.remove(model_dir / "best_model.pt")
        save_pytree(str(model_dir / "best_model"), {"params": params, "step": 0})

    _cli_mae_against_jax(tmp_path, monkeypatch, write)


FULL_STATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                              "torch_orbax", "tiny")


@pytest.fixture(scope="module")
def jax_model_dirs(tmp_path_factory):
    """Orbax model dirs of the JAX package: one written by ``la-convert
    import``'s ``_write_model_dir`` (a "custom" backbone, CTC head), and the
    committed full train state of the JAX trainer (bf16 Adam mu)."""
    from lyricalignment_tpu.cli.convert_checkpoint import _write_model_dir

    _, params = jax_tiny_model(output_dim=21129, hidden_dim=384, seed=3)
    imported = str(tmp_path_factory.mktemp("imported"))
    _write_model_dir(imported, "custom", True, params, "best", whisper_dims=TINY_DIMS)
    return {"import": imported, "full_state": FULL_STATE_DIR}


@pytest.mark.parametrize("kind", ["import", "full_state"])
def test_load_model_dir_reads_jax_orbax_dir(jax_model_dirs, tmp_path, kind):
    """``load_model_dir`` on an orbax dir gives, bit for bit, the state dict
    of that dir's JAX ``la-convert export`` .pt; the port's own ``export``
    writes the same file contents."""
    from lyricalignment_tpu.cli.convert_checkpoint import main as jax_convert
    from lyricalignment_tpu_torch.cli.convert_checkpoint import main as port_convert

    model_dir = jax_model_dirs[kind]
    jax_pt, port_pt = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    assert jax_convert(["export", "--model-dir", model_dir, "--pt", jax_pt]) == 0
    want = torch.load(jax_pt, weights_only=True)
    _, model, _ = load_model_dir(model_dir, device="cpu")
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    assert port_convert(["export", "--model-dir", model_dir, "--pt", port_pt]) == 0
    got = torch.load(port_pt, weights_only=True)
    assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())


def test_export_hf_of_jax_orbax_dir_equals_jax_tool(jax_model_dirs, tmp_path):
    """``la-convert export-hf`` of an orbax dir: the same ``config.json`` and
    the same weights as the JAX tool's export of it."""
    from lyricalignment_tpu.cli.convert_checkpoint import main as jax_convert
    from lyricalignment_tpu.models.convert import load_hf_checkpoint
    from lyricalignment_tpu_torch.cli.convert_checkpoint import main as port_convert

    model_dir = jax_model_dirs["import"]
    outs = {who: str(tmp_path / who) for who in ("jax", "port")}
    assert jax_convert(["export-hf", "--model-dir", model_dir, "--output-dir", outs["jax"]]) == 0
    assert port_convert(["export-hf", "--model-dir", model_dir,
                         "--output-dir", outs["port"]]) == 0
    configs = [json.load(open(os.path.join(outs[w], "config.json"))) for w in ("jax", "port")]
    assert configs[0] == configs[1]
    (_, want), (_, got) = (load_hf_checkpoint(outs[w]) for w in ("jax", "port"))
    flat_want, tree = jax.tree_util.tree_flatten(want)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    assert tree == tree_got
    for w, g in zip(flat_want, flat_got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
