"""The port's whisper text codec (``text/whisper_tokenizer.py``) against
JAX's on a synthetic byte-level ranks file (the one
``tests/test_tokenizers_pipeline.py`` writes): ``encode``, ``decode`` (with
its skip of unknown ids), ``decode_with_timestamps``,
``non_speech_token_ids`` and ``num_languages_for_vocab``; and the port's
training pipeline building JAX's decoder targets once the ranks are
given."""

import base64
import json

import numpy as np
import pytest

from lyricalignment_tpu.data.pipeline import MultitaskExampleBuilder as JaxBuilder
from lyricalignment_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from lyricalignment_tpu.data.records import read_many as jax_read_many
from lyricalignment_tpu.text import whisper_tokenizer as jwt
from lyricalignment_tpu.text.bert_tokenizer import BertWordPieceTokenizer as JaxBert
from lyricalignment_tpu.text.pinyin import load_pronunciation_table as jax_table
from lyricalignment_tpu_torch.data.pipeline import MultitaskExampleBuilder, PipelineConfig
from lyricalignment_tpu_torch.data.records import read_many
from lyricalignment_tpu_torch.text import whisper_tokenizer as twt
from lyricalignment_tpu_torch.text.bert_tokenizer import (
    BertWordPieceTokenizer,
    make_synthetic_vocab,
)
from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table

TEXTS = ["abc", "你好", "天地玄黄 宇宙洪荒", "", " ", "♪♪ (la) [x] {y}", "hello, world!",
         "mixed 中文 and English 123"]


@pytest.fixture(scope="module")
def byte_bpe(tmp_path_factory):
    # every byte its own token, plus a few merges so multi-byte tokens exist
    p = tmp_path_factory.mktemp("bpe") / "ranks.tiktoken"
    pieces = [bytes([i]) for i in range(256)] + [b" (", b"))", b"--", "你".encode()]
    p.write_text("\n".join(base64.b64encode(t).decode() + f" {i}"
                           for i, t in enumerate(pieces)))
    return str(p)


@pytest.fixture(scope="module", params=[99, 100])
def pair(request, byte_bpe):
    kw = dict(bpe_path=byte_bpe, num_languages=request.param)
    return twt.WhisperTokenizer(**kw), jwt.WhisperTokenizer(**kw)


def test_special_layout_and_bpe(pair):
    ours, ref = pair
    assert ours.has_bpe and ref.has_bpe
    assert ours.special_tokens == ref.special_tokens
    assert ours.sot_sequence == ref.sot_sequence


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_equal_jax(pair, text):
    ours, ref = pair
    ids = ours.encode(text)
    assert ids == ref.encode(text)
    assert ours.decode(ids) == ref.decode(ids) == text


def test_decode_skips_unknown_ids_as_jax(pair):
    ours, ref = pair
    ids = ours.encode("你好") + [300, 5000, ours.eot, ours.timestamp_begin] + ours.encode("a")
    assert ours.decode(ids) == ref.decode(ids)


def test_decode_with_timestamps_equal_jax(pair):
    ours, ref = pair
    ts = ours.timestamp_begin
    ids = [ts, *ours.encode("你好"), ts + 50, ts + 50, *ours.encode("ab"), ts + 1500]
    assert ours.decode_with_timestamps(ids) == ref.decode_with_timestamps(ids)
    assert ours.decode_with_timestamps(ids).startswith("<|0.00|>")


def test_non_speech_token_ids_equal_jax(pair):
    ours, ref = pair
    got = twt.non_speech_token_ids(ours)
    assert got == jwt.non_speech_token_ids(ref)
    assert len(got) > 10
    assert twt.non_speech_token_ids(twt.WhisperTokenizer()) == []


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866, 51867])
def test_num_languages_for_vocab_equals_jax(n_vocab):
    assert twt.num_languages_for_vocab(n_vocab) == jwt.num_languages_for_vocab(n_vocab)


@pytest.mark.parametrize("with_timestamps", [False, True])
def test_pipeline_decoder_targets_equal_jax(tmp_path, byte_bpe, with_timestamps, monkeypatch):
    from lyricalignment_tpu_torch.data.audio_io import write_wav

    monkeypatch.setattr("lyricalignment_tpu.data.native_loader.available", lambda: False)
    rng = np.random.default_rng(0)
    rows = []
    for i, (text, onoff) in enumerate([("你好", [[0.1, 0.5], [0.6, 1.2]]), ("世界", None),
                                       ("", None), ("天地玄黄", [[0.0, 0.3], [0.3, 0.6],
                                                              [0.7, 1.0], [1.0, 1.4]])]):
        path = str(tmp_path / f"{i}.wav")
        write_wav(path, (rng.standard_normal(32000) * 0.1).astype(np.float32))
        rows.append({"song_path": path, "lyric": text, **({"on_offset": onoff} if onoff else {})})
    data = tmp_path / "data.json"
    data.write_text(json.dumps(rows, ensure_ascii=False))
    vocab = make_synthetic_vocab(chars="你好世界天地玄黄", size=300)
    kw = dict(batch_size=2, max_label_len=8, max_decoder_len=32,
              with_timestamps=with_timestamps)
    ours = MultitaskExampleBuilder(BertWordPieceTokenizer(vocab=vocab),
                                   twt.WhisperTokenizer(bpe_path=byte_bpe),
                                   load_pronunciation_table(), PipelineConfig(**kw))
    ref = JaxBuilder(JaxBert(vocab=vocab), jwt.WhisperTokenizer(bpe_path=byte_bpe),
                     jax_table(), JaxPipelineConfig(**kw))
    for a, b in zip(read_many(str(data)), jax_read_many(str(data))):
        got, want = ours.build(a), ref.build(b)
        for key in ("decoder_input", "decoder_output"):
            assert got[key] is not None
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert (got["decoder_output"] != -100).sum() > 1
