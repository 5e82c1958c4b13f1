"""The whole alignment slice, port vs JAX, on tiny weights exported from
JAX: WAV files -> ``LyricAligner.align_many`` (length buckets, batch
padding, a > 30 s song encoded as two windows) on both sides, CTC and CE.

* Pre-classifier hidden states at valid frames agree within atol 1e-4.
* Onsets and offsets are exact. The fc weights are scaled x8 so the
  emissions are sharp and no near-tie decides a path; since the two sides'
  emissions still differ in the last float32 bits (summation order), a flip
  of at most one frame on at most 1 position in 50 is allowed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.api import LyricAligner as JaxAligner
from lyricalignment_tpu.models.align_model import forward_from_audio as jax_forward
from lyricalignment_tpu.text.bert_tokenizer import BertWordPieceTokenizer as JaxBert
from lyricalignment_tpu_torch.api import LyricAligner
from lyricalignment_tpu_torch.data.audio_io import write_wav
from lyricalignment_tpu_torch.models.align_model import forward_from_audio
from lyricalignment_tpu_torch.text.bert_tokenizer import (
    BertWordPieceTokenizer,
    make_synthetic_vocab,
)
from lyricalignment_tpu_torch.text.pinyin import PronunciationTable
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model, with_whisper

CHARS = "你好世界天空海洋山川日月星辰风雨"
OUTPUT_DIM = 421


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(7)
    paths = []
    for i, sec in enumerate([3.1, 4.25, 33.0]):
        t = np.arange(int(sec * 16000)) / 16000.0
        tone = np.sin(2 * np.pi * (180 + 40 * i) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
        audio = 0.2 * tone + 0.05 * rng.standard_normal(t.shape)
        paths.append(str(d / f"song{i}.wav"))
        write_wav(paths[-1], audio.astype(np.float32))
    lyrics = ["你好世界", "天空海洋山川", "日月星辰风雨你好世界天空海洋"]
    vocab = make_synthetic_vocab(chars=CHARS, size=200)
    # syllable classes spread over the head's columns (real tables map the
    # synthetic ids to the 'bad' class), with repeats for banned skips
    classes = rng.integers(2, OUTPUT_DIM - 2, size=200).astype(np.int32)
    classes[vocab["好"]] = classes[vocab["你"]]
    table = PronunciationTable((), {}, {}, classes)
    cfg, params = jax_tiny_model(output_dim=OUTPUT_DIM, fc_scale=8.0, seed=3)
    return dict(paths=paths, lyrics=lyrics, vocab=vocab, table=table, cfg=cfg,
                params=params)


@pytest.mark.parametrize("use_ctc", [True, False])
def test_align_many_matches_jax(setup, use_ctc):
    s = setup
    requests = list(zip(s["paths"], s["lyrics"]))
    jcfg = with_whisper(s["cfg"], onepass_encoder=True)  # the JAX inference default
    ref = JaxAligner(jcfg, as_jax(s["params"]), JaxBert(vocab=s["vocab"]), s["table"],
                     use_ctc=use_ctc, batch_size=2).align_many(requests)
    port = LyricAligner(torch_model(s["cfg"], s["params"]),
                        BertWordPieceTokenizer(vocab=s["vocab"]), s["table"],
                        use_ctc=use_ctc, batch_size=2)
    got = port.align_many(requests)

    assert [len(r) for r in got] == [len(lyr) for lyr in s["lyrics"]]
    flips = total = 0
    for g_req, r_req in zip(got, ref):
        for (g_on, g_off, g_ch), (r_on, r_off, r_ch) in zip(g_req, r_req):
            assert g_ch == r_ch
            for a, b in ((g_on, r_on), (g_off, r_off)):
                total += 1
                if a != b:
                    flips += 1
                    assert abs(a - b) <= 0.02 + 1e-9, (a, b)
    assert flips <= total // 50, f"{flips} of {total} positions differ"


def test_hidden_states_match_jax(setup):
    """One padded batch of a 33 s song and a short one (two encoder windows
    each, ragged true lengths): hidden states at valid frames."""
    from lyricalignment_tpu_torch.data.audio_io import load_audio_file

    s = setup
    long_a = load_audio_file(s["paths"][2])["speech"]
    short_a = load_audio_file(s["paths"][0])["speech"]
    audio = np.zeros((2, 60 * 16000), np.float32)
    audio[0, :len(long_a)] = long_a
    audio[1, :len(short_a)] = short_a
    mel_lens = np.array([len(long_a) // 160, len(short_a) // 160], np.int32)
    frames = np.round(mel_lens / 2.0).astype(np.int32)

    jcfg = with_whisper(s["cfg"], onepass_encoder=True)
    ref, _ = jax_forward(as_jax(s["params"]), jcfg, jnp.asarray(audio),
                         frame_lengths=jnp.asarray(frames), mel_lengths=jnp.asarray(mel_lens),
                         align_head_output="hidden")
    model = torch_model(s["cfg"], s["params"])
    with torch.inference_mode():
        got, _ = forward_from_audio(model, torch.from_numpy(audio),
                                    frame_lengths=torch.from_numpy(frames),
                                    mel_lengths=torch.from_numpy(mel_lens),
                                    align_head_output="hidden")
    assert got.shape == ref.shape
    for b, n in enumerate(frames):
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(ref)[b, :n],
                                   atol=1e-4, rtol=0)
