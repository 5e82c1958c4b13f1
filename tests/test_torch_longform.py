"""The port's long-form transcription (``decode/longform.py``) against the
JAX functions on a seeded tiny model over ~35-70 s of seeded audio:

- single-song seek (beam and greedy), without conditioning, and the
  lockstep batched loop (queue refill, two slots and one): segments and
  text equal JAX's, and batched equals single;
- the no-speech skip and the temperature-fallback ladder, set up as
  ``tests/test_longform.py`` sets them up (sampled rungs draw from a
  ``torch.Generator``, so they are held to the ladder's structure, not to
  JAX's tokens);
- an oversized ``max_new_tokens`` is clamped to the context budget.

The tokenizer is ``tests/test_longform.py``'s scaled-down special-token
layout with the full 1501 timestamp positions, so windows advance by
seconds rather than by the 1.2 s of its 60 positions.
"""

import numpy as np
import pytest

from lyricalignment_tpu import N_SAMPLES
from lyricalignment_tpu.decode import longform as jl
from lyricalignment_tpu_torch.decode import longform as tl
from tests.test_longform import TinyTokenizer
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)


class Tokenizer(TinyTokenizer):
    def __init__(self):
        super().__init__()
        self.n_vocab = self.timestamp_begin + 1501


ACCEPT = dict(logprob_threshold=-1e9, no_speech_threshold=2.0)


@pytest.fixture(scope="module")
def setup():
    tok = Tokenizer()
    cfg, params = jax_tiny_model(seed=0, dims=dict(n_vocab=tok.n_vocab, n_text_ctx=64))
    model = torch_model(cfg, params).whisper_model
    return tok, cfg.whisper, as_jax(params)["whisper"], model


def _audio(seed, windows):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(windows * N_SAMPLES)) * 0.1).astype(np.float32)


def _key(result):
    return [(s["start"], s["end"], tuple(s["tokens"]), s["text"], s["temperature"])
            for s in result["segments"]]


def _assert_same(got, want):
    assert got["text"] == want["text"]
    assert got["language"] == want["language"]
    assert _key(got) == _key(want)
    for g, w in zip(got["segments"], want["segments"]):
        assert g["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=1e-5)
        assert g["no_speech_prob"] == pytest.approx(w["no_speech_prob"], abs=1e-5)


SINGLE = {
    "beam3": dict(beam_size=3),
    "greedy": dict(beam_size=1),
    "greedy_unconditioned": dict(beam_size=1, condition_on_previous_text=False),
}


@pytest.fixture(scope="module")
def single_runs(setup):
    tok, jcfg, jparams, model = setup
    audio = _audio(42, 2.3)                                     # 69 s
    return {name: (tl.transcribe_longform(model, model.cfg, audio, tok, temperatures=(0.0,),
                                          **ACCEPT, **kw),
                   jl.transcribe_longform(jparams, jcfg, audio, tok, temperatures=(0.0,),
                                          **ACCEPT, **kw))
            for name, kw in SINGLE.items()}


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_song_equals_jax(single_runs, name):
    got, want = single_runs[name]
    assert len(want["segments"]) > 2 and want["segments"][-1]["end"] > 30.0
    _assert_same(got, want)


BATCHED = {
    "beam3_refill": (dict(beam_size=3), 2, (1.6, 2.3, 1.2)),
    "greedy_one_slot": (dict(beam_size=1), 1, (1.2, 2.1, 1.4)),
}


@pytest.mark.parametrize("name", list(BATCHED))
def test_batched_equals_jax_and_single(setup, name):
    tok, jcfg, jparams, model = setup
    kw, bsz, lengths = BATCHED[name]
    audios = [_audio(77 + i, n) for i, n in enumerate(lengths)]
    kw = dict(temperatures=(0.0,), **ACCEPT, **kw)
    got = tl.transcribe_longform_batched(model, model.cfg, audios, tok, batch_size=bsz,
                                         **kw)
    want = jl.transcribe_longform_batched(jparams, jcfg, audios, tok, batch_size=bsz,
                                          **kw)
    singles = [tl.transcribe_longform(model, model.cfg, a, tok, **kw) for a in audios]
    for g, w, s in zip(got, want, singles):
        _assert_same(g, w)
        assert _key(g) == _key(s) and g["text"] == s["text"]


@pytest.mark.parametrize("batched", [False, True])
def test_no_speech_skip(setup, batched):
    """Every window reads as silent and no decode is confident: each seek
    loop skips window by window and ends with no segments."""
    tok, jcfg, jparams, model = setup
    audios = [_audio(5, 1.2), _audio(6, 2.2)]
    kw = dict(beam_size=1, temperatures=(0.0,), no_speech_threshold=0.0,
              logprob_threshold=1e9)
    if batched:
        outs = tl.transcribe_longform_batched(model, model.cfg, audios, tok, batch_size=2, **kw)
        wants = jl.transcribe_longform_batched(jparams, jcfg, audios, tok, batch_size=2, **kw)
    else:
        outs = [tl.transcribe_longform(model, model.cfg, audios[0], tok, **kw)]
        wants = [jl.transcribe_longform(jparams, jcfg, audios[0], tok, **kw)]
    for out, want in zip(outs, wants):
        assert out["segments"] == [] == want["segments"]
        assert out["text"] == "" == want["text"]


def test_fallback_ladder_reaches_the_last_rung(setup):
    """An impossible compression gate walks every window down the ladder:
    the segments keep the last rung's temperature, the seek still ends,
    and the sampled rungs repeat for a seed."""
    tok, _, _, model = setup
    audio = _audio(6, 1.2)
    kw = dict(beam_size=2, temperatures=(0.0, 0.7), compression_ratio_threshold=-1.0,
              **ACCEPT)
    out = tl.transcribe_longform(model, model.cfg, audio, tok, **kw)
    assert out["segments"]
    assert all(s["temperature"] == 0.7 for s in out["segments"])
    assert _key(tl.transcribe_longform(model, model.cfg, audio, tok, **kw)) == _key(out)
    batched = tl.transcribe_longform_batched(
        model, model.cfg, [audio, _audio(7, 1.7)], tok, batch_size=2,
        beam_size=2, temperatures=(0.0, 0.4, 0.8), compression_ratio_threshold=-1.0,
        logprob_threshold=1e9, no_speech_threshold=2.0)
    for res in batched:
        assert res["segments"]
        for s in res["segments"]:
            assert s["temperature"] == 0.8 and s["end"] >= s["start"] >= 0.0


def test_max_new_tokens_is_clamped(setup):
    tok, _, _, model = setup
    out = tl.transcribe_longform(model, model.cfg, _audio(9, 1.1), tok, beam_size=1,
                                 temperatures=(0.0,), max_new_tokens=10_000, **ACCEPT)
    assert out["segments"]
    assert tl._context_budget(model.cfg, tok.sot_sequence, True, 10_000) == (31, 35, 29)
