"""The port's prep scripts (``lyricalignment_tpu_torch/prep``) against the
JAX package's (``lyricalignment_tpu/prep``), the cases of
``tests/test_prep.py``: ``build_table`` with an injected phonemizer and the
shipped asset rebuilt, ``mix_pair`` for SNR 0, -5 and -10 (equal to JAX's,
power ratio at 1e-4), ``pick_segment`` with the same ``random.Random(0)``,
``replace_paths``; then each script's ``main`` on temporary directories
beside JAX's (the table from a seed table, since pypinyin is not
installed; the MUSDB mix; the path rewrite), and the separator CLI's
refusals: a missing separator package exits as in JAX, and demucs refuses
a missing CUDA unless ``--device cpu`` is given."""

import json
import math
import os
import random

import numpy as np
import pytest
import torch

from lyricalignment_tpu.prep import get_pronunce_table as jax_table
from lyricalignment_tpu.prep import mix_with_musdb as jax_mix
from lyricalignment_tpu.prep import replace_path as jax_replace
from lyricalignment_tpu.prep import separate_vocals as jax_separate
from lyricalignment_tpu_torch.data.audio_io import read_wav, write_wav
from lyricalignment_tpu_torch.prep import get_pronunce_table, mix_with_musdb, replace_path
from lyricalignment_tpu_torch.prep import separate_vocals
from lyricalignment_tpu_torch.text.pinyin import DEFAULT_TABLE_PATH


def test_build_table_matches_reference_format_and_jax():
    tokens = ["[PAD]", "你", "好", "好", "abc", "##x", "坏"]
    char_py = {"你": "ni", "好": "hao"}

    def phonemize(tok):
        if tok == "坏":
            raise KeyError(tok)  # a failing phonemizer makes the token 'bad'
        return [char_py[tok]] if tok in char_py else ["bad", "bad"]

    got = get_pronunce_table.build_table(tokens, phonemize)
    assert got == jax_table.build_table(tokens, phonemize)
    token_pinyin, reverse, lookup = got
    assert token_pinyin == ["bad", "ni", "hao", "hao", "bad", "bad", "bad"]
    assert reverse == {"ni": [1], "hao": [2, 3]}
    assert lookup == {"bad": 1, "ni": 2, "hao": 3}


def test_shipped_asset_reproducible_by_build_table():
    with open(DEFAULT_TABLE_PATH, encoding="utf-8") as f:
        token_pinyin, reverse, lookup = json.load(f)

    def phonemize(index):
        py = token_pinyin[int(index)]
        return [py] if py != "bad" else ["bad", "bad"]

    tp2, rev2, look2 = get_pronunce_table.build_table(
        [str(i) for i in range(len(token_pinyin))], phonemize)
    assert tp2 == token_pinyin and look2 == lookup
    assert rev2 == {k: list(v) for k, v in reverse.items()}


@pytest.mark.parametrize("snr", [0.0, -5.0, -10.0])
def test_mix_pair_matches_jax_and_snr(rng, snr):
    vocal = rng.standard_normal(44100).astype(np.float32)
    accomp = rng.standard_normal(44100).astype(np.float32) * 0.3
    mixed = mix_with_musdb.mix_pair(vocal, accomp, snr)
    np.testing.assert_array_equal(mixed, jax_mix.mix_pair(vocal, accomp, snr))
    assert mixed.shape == vocal.shape and mixed.dtype == np.float32
    assert np.abs(mixed).max() <= 1.01
    y = mix_with_musdb.peak_normalize(vocal) / 2.0
    inst = mix_with_musdb.peak_normalize(accomp) / 2.0
    ratio = 10.0 ** (snr / 10.0)
    y_pow, i_pow = np.mean(y ** 2), np.mean(inst ** 2)
    if i_pow * ratio > y_pow:
        inst = inst * math.sqrt(y_pow / (i_pow * ratio))
    else:
        y = y * math.sqrt((i_pow * ratio) / y_pow)
    assert np.mean(y ** 2) / np.mean(inst ** 2) == pytest.approx(ratio, rel=1e-4)
    np.testing.assert_allclose(mixed, y + inst, atol=1e-6)


def test_pick_segment_matches_jax_and_rejects_silence_and_short_clips(rng):
    silent = np.zeros(50000, np.float32)
    short = rng.standard_normal(100).astype(np.float32)
    good = rng.standard_normal(60000).astype(np.float32)
    pool = [silent, short, good]
    seg = mix_with_musdb.pick_segment(pool, 44100, random.Random(0))
    np.testing.assert_array_equal(seg, jax_mix.pick_segment(pool, 44100, random.Random(0)))
    assert len(seg) == 44100 and np.mean(seg ** 2) >= 1e-4
    with pytest.raises(RuntimeError, match="no usable accompaniment"):
        mix_with_musdb.pick_segment([silent], 100, random.Random(0))


def test_replace_paths_matches_jax(tmp_path):
    def data():
        return [{"song_id": "a.wav", "lyric": "x"}, {"song_id": "b.wav", "lyric": "y"}]

    out = replace_path.replace_paths(data(), str(tmp_path))
    assert out == jax_replace.replace_paths(data(), str(tmp_path))
    assert out[0]["song_path"] == str(tmp_path / "a.wav")
    assert os.path.isabs(out[1]["song_path"])


def test_get_pronunce_table_main_from_a_seed_table(tmp_path, capsys):
    """Without pypinyin both scripts derive char -> pinyin from a seed
    table and its vocab and write the same table for another vocab."""
    seed_tokens = ["[PAD]", "[UNK]", "你", "好", "天", "地", "坏"]
    seed_py = {"你": "ni", "好": "hao", "天": "tian", "地": "di"}
    table = get_pronunce_table.build_table(
        seed_tokens, lambda t: [seed_py[t]] if t in seed_py else ["bad", "bad"])
    (tmp_path / "seed.json").write_text(json.dumps(list(table)), encoding="utf-8")
    (tmp_path / "seed_vocab.txt").write_text("\n".join(seed_tokens) + "\n", encoding="utf-8")
    (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "地", "天", "##a", "你", "好", "x"])
                                        + "\n", encoding="utf-8")
    outs = []
    for name, script in (("port", get_pronunce_table), ("jax", jax_table)):
        out = tmp_path / f"{name}.json"
        script.main([str(tmp_path / "vocab.txt"), str(out), "--seed-table",
                     str(tmp_path / "seed.json"), "--seed-vocab", str(tmp_path / "seed_vocab.txt")])
        outs.append(json.loads(out.read_text(encoding="utf-8")))
    assert outs[0] == outs[1]
    assert outs[0][0][:3] == ["bad", "di", "tian"]
    with pytest.raises(SystemExit, match="pypinyin is not installed"):
        get_pronunce_table.main([str(tmp_path / "vocab.txt"), str(tmp_path / "x.json")])
    assert "7 tokens" in capsys.readouterr().out


def test_mix_with_musdb_main_matches_jax(tmp_path, rng):
    vocals, musdb = tmp_path / "vocals", tmp_path / "musdb"
    vocals.mkdir()
    for i, n in enumerate((8000, 12000)):
        write_wav(str(vocals / f"v{i}.wav"), (0.3 * rng.standard_normal(n)).astype(np.float32),
                  22050)
    for i in range(3):
        (musdb / f"song{i}").mkdir(parents=True)
        stereo = (0.2 * rng.standard_normal((2, 20000))).astype(np.float32)
        write_wav(str(musdb / f"song{i}" / "accompaniment.wav"), stereo, 22050)
    for name, script in (("port", mix_with_musdb), ("jax", jax_mix)):
        script.main([str(vocals), str(tmp_path / name), str(musdb), "-5"])
    for i in range(2):
        got, sr = read_wav(str(tmp_path / "port" / f"v{i}.wav"))
        want, want_sr = read_wav(str(tmp_path / "jax" / f"v{i}.wav"))
        assert sr == want_sr == 22050
        np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        mix_with_musdb.main([str(vocals)])


def test_replace_path_main_matches_jax(tmp_path):
    data = [{"song_id": "a.wav", "lyric": "你好"}, {"song_id": "b/c.wav", "lyric": "天地"}]
    (tmp_path / "in.json").write_text(json.dumps(data, ensure_ascii=False), encoding="utf-8")
    for name, script in (("port", replace_path), ("jax", jax_replace)):
        script.main([str(tmp_path / "in.json"), str(tmp_path / f"{name}.json"), str(tmp_path)])
    assert ((tmp_path / "port.json").read_text(encoding="utf-8")
            == (tmp_path / "jax.json").read_text(encoding="utf-8"))
    with pytest.raises(SystemExit):
        replace_path.main([str(tmp_path / "in.json")])


def test_separate_vocals_cli_refusals(tmp_path, monkeypatch):
    for argv in ([], ["demucs", "a"], ["other", "a", "b"], ["demucs", "a", "b", "--device"]):
        with pytest.raises(SystemExit) as caught:
            separate_vocals.main(argv)
        assert "Usage" in str(caught.value)
    for script in (separate_vocals, jax_separate):
        with pytest.raises(SystemExit, match="spleeter not available"):
            script.main(["spleeter", str(tmp_path), str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="demucs not available"):
        separate_vocals.main(["demucs", str(tmp_path), str(tmp_path / "out"), "--device", "cpu"])


def test_separate_demucs_needs_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        separate_vocals.separate_demucs(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        separate_vocals.main(["demucs", str(tmp_path), str(tmp_path / "out")])
