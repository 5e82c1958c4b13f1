"""The port's postprocess and no-ground-truth alignment CLIs: the
postprocess cases of ``tests/test_cli_host.py`` on the port (each file's
result also equal to the JAX CLI's on a copy), and the nogt CLI's printed
rows and ``-o`` JSON against the JAX nogt CLI on one model dir (onsets and
offsets within one 20 ms frame on at most 1 boundary in 50: float32
summation order differs)."""

import ast
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from lyricalignment_tpu.cli import inference_alignment_nogt as jax_nogt
from lyricalignment_tpu.cli import postprocess as jax_pp
from lyricalignment_tpu_torch.cli import inference_alignment_nogt as nogt
from lyricalignment_tpu_torch.cli import postprocess as pp_cli
from lyricalignment_tpu_torch.data.audio_io import write_wav
from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from lyricalignment_tpu_torch.train.checkpoints import save_json
from tests.torch_port_helpers import TINY_DIMS, jax_tiny_model


def _jax_postprocess(tmp_path, f, argv, monkeypatch):
    """The JAX CLI on a copy of ``f`` (before the port rewrites it)."""
    copy = tmp_path / ("jax_" + f.name)
    shutil.copy(f, copy)
    monkeypatch.setattr(sys, "argv", ["pp", "-f", str(copy), *argv])
    try:
        jax_pp.main()
    except SystemExit as e:
        return copy, e.code
    return copy, None


def test_postprocess_cli_rewrites_in_place(tmp_path, monkeypatch):
    f = tmp_path / "r.json"
    f.write_text(json.dumps([{"inference": "Hello 愛你 world"},
                             {"inference": "第二 行."}], ensure_ascii=False), encoding="utf-8")
    copy, _ = _jax_postprocess(tmp_path, f, [], monkeypatch)
    pp_cli.main(["-f", str(f)])
    data = json.loads(f.read_text(encoding="utf-8"))
    assert data[0]["inference"] == "爱你"
    assert data[1]["inference"] == "第二行."  # periods kept (reference keeps '.')
    assert f.read_text(encoding="utf-8") == copy.read_text(encoding="utf-8")


def test_postprocess_strict_normalize(tmp_path, monkeypatch, capsys):
    f = tmp_path / "r.json"
    f.write_text(json.dumps([{"inference": "愛㐀"}], ensure_ascii=False), encoding="utf-8")
    copy, jax_code = _jax_postprocess(tmp_path, f, ["--strict-normalize"], monkeypatch)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        pp_cli.main(["-f", str(f), "--strict-normalize"])
    assert e.value.code == 2 == jax_code
    assert "㐀" in capsys.readouterr().err
    # conversion still happened before the strict exit
    assert json.loads(f.read_text(encoding="utf-8"))[0]["inference"].startswith("爱")
    assert f.read_text(encoding="utf-8") == copy.read_text(encoding="utf-8")


def test_t2s_overrides_flag(tmp_path, monkeypatch):
    f = tmp_path / "r.json"
    f.write_text(json.dumps([{"inference": "㐀好"}], ensure_ascii=False), encoding="utf-8")
    ov = tmp_path / "t2s.json"
    ov.write_text(json.dumps({"㐀": "一"}, ensure_ascii=False), encoding="utf-8")
    argv = ["--t2s-overrides", str(ov), "--strict-normalize"]
    copy, jax_code = _jax_postprocess(tmp_path, f, argv, monkeypatch)
    pp_cli.main(["-f", str(f), *argv])  # the override closes the gap: no exit
    assert jax_code is None
    assert json.loads(f.read_text(encoding="utf-8"))[0]["inference"] == "一好"
    assert f.read_text(encoding="utf-8") == copy.read_text(encoding="utf-8")


@pytest.mark.parametrize("text", ["Hello 愛你 world", "第二 行.", "  ", "後來 我們 ABC 說",
                                  "㐀好", "", "龘 x 國"])
def test_postprocess_entry_equals_jax(text):
    assert pp_cli.postprocess_entry(text) == jax_pp.postprocess_entry(text)
    ov = {"㐀": "一", "國": "国"}
    assert pp_cli.postprocess_entry(text, ov) == jax_pp.postprocess_entry(text, ov)


@pytest.fixture(scope="module")
def nogt_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("nogt")
    model_dir = d / "model"
    model_dir.mkdir()
    _, params = jax_tiny_model(seed=6, hidden_dim=384, output_dim=21129, fc_scale=8.0)
    save_json(str(model_dir / "args.json"), {"whisper_model": "custom", "use_ctc_loss": True,
                                             "whisper_dims": TINY_DIMS})
    save_json(str(model_dir / "model_args.json"), {"output_dim": 21129})
    torch.save(state_dict_from_jax_params(params), str(model_dir / "best_model.pt"))
    rng = np.random.default_rng(6)
    rows = []
    for i, (sec, sr, lyric) in enumerate([(3.2, 16000, "天地玄黄"), (6.5, 44100, "宇宙洪荒日月盈昃"),
                                          (4.0, 22050, "你好")]):
        t = np.arange(int(sec * sr)) / sr
        audio = 0.2 * np.sin(2 * np.pi * (170 + 30 * i) * t) + 0.05 * rng.standard_normal(t.shape)
        path = str(d / f"song{i}.wav")
        write_wav(path, audio.astype(np.float32), sr)
        rows.append({"song_path": path, "lyric": lyric})
    data = d / "test.json"
    data.write_text(json.dumps(rows, ensure_ascii=False), encoding="utf-8")
    return str(model_dir), str(data), d


def _printed(out):
    lines = out.strip().splitlines()
    return [(lines[i], ast.literal_eval(lines[i + 1])) for i in range(0, len(lines), 2)]


def test_nogt_equals_jax(nogt_setup, monkeypatch, capsys):
    model_dir, data, d = nogt_setup
    argv = ["-f", data, "--model-dir", model_dir, "--synthetic-vocab", "--use-ctc-loss",
            "--batch-size", "2"]
    port_json, jax_json = str(d / "port" / "out.json"), str(d / "jax" / "out.json")
    capsys.readouterr()
    results = nogt.main(argv + ["-o", port_json, "--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["nogt"] + argv + ["-o", jax_json])
    jax_nogt.main()
    jax_out = capsys.readouterr().out

    got, want = _printed(port_out), _printed(jax_out)
    assert [name for name, _ in got] == [name for name, _ in want] == \
        ["song0.wav", "song1.wav", "song2.wav"]
    with open(port_json, encoding="utf-8") as f:
        port_file = json.load(f)
    with open(jax_json, encoding="utf-8") as f:
        jax_file = json.load(f)
    assert port_file == results
    assert [r["alignment"] for r in port_file] == [rows for _, rows in got]
    assert [r["song_path"] for r in port_file] == [r["song_path"] for r in jax_file]
    flips = total = 0
    for (_, g_rows), (_, w_rows), w_file in zip(got, want, jax_file):
        assert w_file["alignment"] == w_rows
        assert len(g_rows) == len(w_rows)
        for (g_on, g_off, g_ch), (w_on, w_off, w_ch) in zip(g_rows, w_rows):
            assert g_ch == w_ch
            for a, b in ((g_on, w_on), (g_off, w_off)):
                total += 1
                flips += a != b
                assert abs(a - b) <= 0.02 + 1e-9, (a, b)
    assert total == 2 * (4 + 8 + 2) and flips <= total // 50


def test_nogt_int8_encoder_not_ported(nogt_setup):
    model_dir, data, _ = nogt_setup
    with pytest.raises(SystemExit, match="not ported"):
        nogt.main(["-f", data, "--model-dir", model_dir, "--synthetic-vocab",
                   "--int8-encoder", "--device", "cpu"])
