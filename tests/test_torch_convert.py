"""Weights into the port: ``state_dict_from_jax_params`` equals the JAX
package's own reference export key for key and value for value, loads
strictly, and a reference ``.pt`` model dir loads through the port's
``load_model_dir``."""

import json

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


def test_orbax_dir_asks_for_export(tmp_path):
    _, params = jax_tiny_model(hidden_dim=384)
    _model_dir(tmp_path, params)
    (tmp_path / "last_model").mkdir()
    with pytest.raises(ValueError, match="la-convert export"):
        load_model_dir(str(tmp_path), model_name="last", device="cpu")


def test_cli_mae_matches_jax_cli(tmp_path, monkeypatch):
    """The alignment CLI end to end on a reference .pt model dir: the port
    (``--device cpu``) and the JAX CLI report the same average MAE (one
    frame of a 20 ms flip on one of the 4 boundaries allowed: float32
    summation order differs between the two)."""
    import sys

    from lyricalignment_tpu.cli.inference_alignment import main as jax_main
    from lyricalignment_tpu_torch.cli.inference_alignment import main as port_main
    from lyricalignment_tpu_torch.data.audio_io import write_wav

    _, params = jax_tiny_model(hidden_dim=384, fc_scale=8.0, seed=5)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    _model_dir(model_dir, params)
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
