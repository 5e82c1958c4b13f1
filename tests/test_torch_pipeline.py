"""The port's host-side training data path against the JAX package's, array
for array: frame-label rasters, the whisper special-token layout, examples
built from WAV records and collated (shuffled loader order included), and
the checkpoint policy's four criteria and metric log."""

import json

import numpy as np
import pytest
import torch

from lyricalignment_tpu.data.frames import rasterize_frame_labels as jax_raster
from lyricalignment_tpu.data.pipeline import MultitaskExampleBuilder as JaxBuilder
from lyricalignment_tpu.data.pipeline import MultitaskLoader as JaxLoader
from lyricalignment_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from lyricalignment_tpu.data.records import read_many as jax_read_many
from lyricalignment_tpu.text.bert_tokenizer import BertWordPieceTokenizer as JaxBert
from lyricalignment_tpu.text.pinyin import load_pronunciation_table as jax_table
from lyricalignment_tpu.text.whisper_tokenizer import WhisperTokenizer as JaxWhisperTokenizer
from lyricalignment_tpu_torch.data.frames import rasterize_frame_labels
from lyricalignment_tpu_torch.data.pipeline import (
    MultitaskExampleBuilder,
    MultitaskLoader,
    PipelineConfig,
    infinite_batches,
)
from lyricalignment_tpu_torch.data.records import read_many
from lyricalignment_tpu_torch.text.bert_tokenizer import (
    BertWordPieceTokenizer,
    make_synthetic_vocab,
)
from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table
from lyricalignment_tpu_torch.text.whisper_tokenizer import (
    WhisperTokenizer,
    num_languages_for_vocab,
)

CHARS = "天地玄黄宇宙洪荒日月"


@pytest.mark.parametrize("use_ctc", [False, True])
@pytest.mark.parametrize("total", [None, 40, 1500])
def test_frame_raster_matches_jax(rng, use_ctc, total):
    tokens = rng.integers(2, 400, 6)
    onoff = [[0.1, 0.3], [0.25, 0.5], [0.51, 0.51], [0.6, 1.2], [1.1, 1.4], [2.0, 2.31]]
    np.testing.assert_array_equal(
        rasterize_frame_labels(tokens, onoff, use_ctc, total_frames=total),
        jax_raster(tokens, onoff, use_ctc, total_frames=total))


@pytest.mark.parametrize("n_vocab", [51865, 51866])
def test_whisper_special_tokens_match_jax(n_vocab):
    n = num_languages_for_vocab(n_vocab)
    ours, ref = WhisperTokenizer(num_languages=n), JaxWhisperTokenizer(num_languages=n)
    assert ours.special_tokens == ref.special_tokens
    assert ours.sot_sequence == ref.sot_sequence and ours.n_vocab == ref.n_vocab
    assert [ours.timestamp_token(s) for s in (0, 1.37, 30)] == \
        [ref.timestamp_token(s) for s in (0, 1.37, 30)]
    assert not ours.has_bpe
    with pytest.raises(RuntimeError, match="BPE"):
        ours.encode("你好")
    with pytest.raises(NotImplementedError):
        WhisperTokenizer(bpe_path="ranks.tiktoken")


@pytest.fixture
def records(tmp_path, rng):
    from lyricalignment_tpu_torch.data.audio_io import write_wav

    rows = []
    for i in range(5):
        audio = (rng.standard_normal(int((2.0 + i) * 44100)) * 0.1).astype(np.float32)
        path = str(tmp_path / f"s{i}.wav")
        write_wav(path, audio, sr=44100)
        lyric = CHARS[i: i + 4]
        row = {"song_path": path, "lyric": lyric}
        if i != 3:  # one transcript-only sample
            row["on_offset"] = [[0.1 + 0.4 * k, 0.4 + 0.4 * k] for k in range(4)]
        rows.append(row)
    path = tmp_path / "data.json"
    path.write_text(json.dumps(rows, ensure_ascii=False))
    return str(path)


@pytest.mark.parametrize("use_ctc", [False, True])
def test_batches_match_jax(records, use_ctc, monkeypatch):
    # the JAX package's Python WAV path, which the port copies (its native
    # C++ loader resamples with other float32 rounding)
    monkeypatch.setattr("lyricalignment_tpu.data.native_loader.available", lambda: False)
    vocab = make_synthetic_vocab(chars=CHARS, size=300)
    kw = dict(batch_size=2, use_ctc=use_ctc, max_label_len=8, max_decoder_len=12)
    ours = MultitaskLoader(read_many(records), MultitaskExampleBuilder(
        BertWordPieceTokenizer(vocab=vocab), WhisperTokenizer(), load_pronunciation_table(),
        PipelineConfig(**kw)), shuffle=True, seed=3)
    ref = JaxLoader(jax_read_many(records), JaxBuilder(
        JaxBert(vocab=vocab), JaxWhisperTokenizer(), jax_table(), JaxPipelineConfig(**kw)),
        shuffle=True, seed=3)
    assert len(ours) == len(ref) == 2
    got = [b for _, b in zip(range(4), infinite_batches(ours))]  # two epochs
    want = [b for _ in range(2) for b in ref]
    for a, b in zip(got, want):
        assert a.texts == b.texts and a.onset_offset == b.onset_offset
        arrays, ref_arrays = a.device_arrays(), b.device_arrays()
        assert arrays.keys() == ref_arrays.keys()
        for k in arrays:
            assert arrays[k].dtype == ref_arrays[k].dtype, k
            np.testing.assert_array_equal(arrays[k], ref_arrays[k], err_msg=k)


def test_checkpoint_policy_and_metrics(tmp_path):
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WhisperConfig
    from lyricalignment_tpu_torch.train.checkpoints import (
        BestCheckpointPolicy,
        restore_train_state,
    )
    from lyricalignment_tpu_torch.train.trainer import TrainConfig, init_train_state
    from lyricalignment_tpu_torch.utils.observability import MetricLogger

    wcfg = WhisperConfig(n_vocab=16, n_audio_state=16, n_audio_head=1, n_audio_layer=1,
                         n_text_ctx=8, n_text_state=16, n_text_head=1, n_text_layer=1)
    model = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=4, output_dim=5))
    init_weights(model, torch.Generator().manual_seed(0))
    state, _ = init_train_state(model, TrainConfig(adam_mu_dtype=torch.bfloat16))
    state.step, state.opt_state.count = 7, 7
    policy = BestCheckpointPolicy(str(tmp_path), {"total": 3.0, "align_ce": 1.0,
                                                  "align_ctc": 1.0, "trans_ce": 1.0})
    fired = policy.update({"total": 2.5, "align_ce": 1.5, "align_ctc": 0.0, "trans_ce": 1.0},
                          state, save_all=True)
    assert fired == {"best": True, "best_align": True, "best_trans": False}
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"{n}_{kind}.pt" for n in ("best", "best_align", "step7", "last")
                           for kind in ("model", "state"))
    sd = torch.load(tmp_path / "last_model.pt", weights_only=True)
    assert sd.keys() == model.state_dict().keys()

    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    restore_train_state(str(tmp_path / "best_model"), state)
    torch.testing.assert_close(model.state_dict(), sd)
    assert state.step == 7 and state.opt_state.count == 7
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu.values())

    log = MetricLogger(str(tmp_path / "m"))
    log.log(3, {"total": torch.tensor(1.5), "align_ce": 0.25})
    log.close()
    row = json.loads(open(log.path).read())
    assert row["step"] == 3 and row["total"] == 1.5 and row["align_ce"] == 0.25
