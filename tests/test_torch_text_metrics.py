"""The port's host copies that score a transcript against JAX's: the
normalisers (``text/normalize.py``), the phonemizer (``text/heteronyms.py``
and ``text/pinyin.py``), ``edit_ops``/``cer``/``per``
(``utils/metrics.py``) and ``cli/evaluate_transcript.py``'s printed CER and
PER, on the strings of ``tests/test_metrics.py``,
``tests/test_text_and_data.py``, ``tests/test_t2s_table.py`` and
``tests/test_phonemizer_deviation.py`` and on seeded ones."""

import json
import sys

import numpy as np
import pytest

from lyricalignment_tpu.cli import evaluate_transcript as jax_eval
from lyricalignment_tpu.text import normalize as jn
from lyricalignment_tpu.text import pinyin as jp
from lyricalignment_tpu.utils import metrics as jm
from lyricalignment_tpu_torch.cli import evaluate_transcript as port_eval
from lyricalignment_tpu_torch.text import normalize as tn
from lyricalignment_tpu_torch.text import pinyin as tp
from lyricalignment_tpu_torch.utils import metrics as tm

STRINGS = [
    "", "abcd", "abxd", "你好", "李好", "你好世界", "Hello 你好. World", "銀行 音樂 重慶",
    "音乐很快乐", "受不了解释", "不了解", "行规", "仿佛埋怨呢喃主角角色执拗", "什么",
    "廟裡的鐘聲 響徹雲霄", "猛水山人我你他的一是不了在有好天上中大小月日心手口明星花雨唱歌",
    "勐着里舍卷干面台只苏", "我們的愛 像風一樣。", "abc。", "天地玄黄宇宙洪荒",
    "㐀㐁𠀀 丽", "长大 长度 重要 重复 行走 银行",
]


def test_t2s_table_equals_jax():
    assert tn._T2S_PAIRS == jn._T2S_PAIRS
    every = "".join(p[0] for p in jn._T2S_PAIRS)
    assert tn.to_simplified(every) == jn.to_simplified(every)


@pytest.mark.parametrize("text", STRINGS)
def test_normalisers_equal_jax(text):
    assert tn.remove_english(text) == jn.remove_english(text)
    assert tn.to_simplified(text) == jn.to_simplified(text)
    assert tn.normalize_for_eval(text) == jn.normalize_for_eval(text)
    over = {"鐘": "X", "你": "妳"}
    assert tn.normalize_for_eval(text, over) == jn.normalize_for_eval(text, over)
    assert tn.normalization_gaps(text) == jn.normalization_gaps(text)


def test_t2s_overrides_and_gap_report_equal_jax(tmp_path):
    path = tmp_path / "t2s.json"
    path.write_text(json.dumps({"們": "们", "丽": "麗"}, ensure_ascii=False))
    assert tn.load_t2s_overrides(str(path)) == jn.load_t2s_overrides(str(path))
    gaps = {chr(0x3400 + i): i + 1 for i in range(25)}
    assert (tn.format_gap_report(gaps, "anchor", "remedy")
            == jn.format_gap_report(gaps, "anchor", "remedy"))


@pytest.fixture(scope="module")
def phonemizers():
    table_t, table_j = tp.load_pronunciation_table(), jp.load_pronunciation_table()
    chars = sorted({c for s in STRINGS for c in s})
    vocab = {c: 100 + 37 * i for i, c in enumerate(chars)}
    return (tp.CharPhonemizer(table_t, vocab), jp.CharPhonemizer(table_j, vocab),
            table_t)


def test_split_syllable_equals_jax(phonemizers):
    syllables = list(phonemizers[2].pinyin_to_class) + ["", "。", "Zhong", "lv", "nve", "ng",
                                                        "a1", "x-y", "éa"]
    for s in syllables:
        assert tp.split_syllable(s) == jp.split_syllable(s), s


@pytest.mark.parametrize("text", STRINGS)
def test_phonemizer_equals_jax(phonemizers, text):
    ours, ref, _ = phonemizers
    assert ours(text) == ref(text)
    assert ours.phonemes(text) == ref.phonemes(text)
    assert [ours.knows(c) for c in text] == [ref.knows(c) for c in text]
    knows = tn.normalization_gaps(text, has_reading=ours.knows)
    assert knows == jn.normalization_gaps(text, has_reading=ref.knows)


def test_heteronym_table_and_phrase_file_equal_jax(tmp_path):
    from lyricalignment_tpu.text.heteronyms import HETERONYM_PHRASES as jax_phrases
    from lyricalignment_tpu_torch.text.heteronyms import HETERONYM_PHRASES

    assert HETERONYM_PHRASES == jax_phrases
    path = tmp_path / "phrases.json"
    path.write_text(json.dumps({"行规": ["hang", "gui"], "银行": ["yin", "xing"]},
                               ensure_ascii=False))
    merged = tp.load_phrase_readings(str(path))
    assert merged == jp.load_phrase_readings(str(path))
    ph = tp.CharPhonemizer(tp.load_pronunciation_table(), {}, phrase_readings=merged)
    assert ph("行规银行") == ["hang", "gui", "yin", "xing"]
    for bad in ({"": ["a"]}, {"行规": ["hang"]}, {"行规": ["hang", 3]}):
        path.write_text(json.dumps(bad, ensure_ascii=False))
        with pytest.raises(ValueError):
            tp.load_phrase_readings(str(path))
        with pytest.raises(ValueError):
            jp.load_phrase_readings(str(path))


PAIRS = [("abcd", "abcd"), ("abxd", "abcd"), ("abxcd", "abcd"), ("abd", "abcd"),
         ("", "abc"), ("你好", "李好"), ("我们的爱", "我的爱情啊"), ("abcabc", "cbacba")]


@pytest.mark.parametrize("hyp,ref", PAIRS)
def test_cer_and_per_equal_jax(phonemizers, hyp, ref):
    ours, theirs, _ = phonemizers
    assert tm.edit_ops(list(hyp), list(ref)) == jm.edit_ops(list(hyp), list(ref))
    assert tm.cer(list(hyp), list(ref)) == jm.cer(list(hyp), list(ref))
    assert tm.per(hyp, ref, ours) == jm.per(hyp, ref, theirs)


def test_edit_ops_equal_jax_on_seeded_sequences():
    rng = np.random.default_rng(0)
    for _ in range(200):
        h = rng.integers(0, 4, rng.integers(0, 9)).tolist()
        r = rng.integers(0, 4, rng.integers(1, 9)).tolist()
        assert tm.edit_ops(h, r) == jm.edit_ops(h, r)
    assert tm.mae([[[0.1, 0.5], [0.6, 1.0]]], [[[0.2, 0.4], [0.6, 1.3]]]) == \
        jm.mae([[[0.1, 0.5], [0.6, 1.0]]], [[[0.2, 0.4], [0.6, 1.3]]])


def test_evaluate_transcript_prints_jax_cer_and_per(tmp_path, capsys, monkeypatch):
    # references keep a character after normalisation (PER raises on an
    # empty one, in both packages)
    rows = [{"lyric": "李好", "inference": "你好"},
            {"lyric": "我的爱情啊", "inference": "我们的爱"},
            {"lyric": "廟裡的鐘聲", "inference": "庙里的钟声 la."},
            {"lyric": "音乐很快乐", "inference": "银行很快"},
            {"lyric": "天地玄黄", "inference": ""}]
    path = tmp_path / "result.json"
    path.write_text(json.dumps(rows, ensure_ascii=False))
    port_eval.main(["-f", str(path)])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["evaluate_transcript", "-f", str(path)])
    jax_eval.main()
    theirs = capsys.readouterr().out
    assert "CER:" in ours and "PER:" in ours
    assert ours == theirs
    refs, preds = [r["lyric"] for r in rows], [r["inference"] for r in rows]
    assert port_eval.compute_cer(refs, preds) == jax_eval.compute_cer(refs, preds)
