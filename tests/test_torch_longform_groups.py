"""The port's batched long-form loop with overlap groups
(``transcribe_longform_batched(overlap_groups=G)``, ``decode/longform.py``)
on the seeded tiny model of ``tests/test_torch_longform.py``, five songs of
1.6 / 2.3 / 1.2 / 1.9 / 1.3 x 30 s over groups of two slots (the queue is
longer than the slots, so slots refill and the prefetch pool loads ahead):

- beam 3 and greedy: G = 2 gives JAX's ``overlap_groups=2`` segments song
  by song (``tests/test_longform.py``'s overlap test), and G = 1, 2 and 3
  give identical results;
- an error in one group's thread fails the call, with no thread left;
- a sampled fallback under G = 2 repeats for a seed (songs reach the
  groups in JAX's round-robin order whatever the threads' timing);
- each raw song's log-mel is computed once, ahead of its slot, and a
  staged song's not at all.
"""

import threading

import numpy as np
import pytest

from lyricalignment_tpu.decode import longform as jl
from lyricalignment_tpu_torch.decode import longform as tl
from tests.test_torch_longform import ACCEPT, _assert_same, _audio, _key, setup  # noqa: F401
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

LENGTHS = (1.6, 2.3, 1.2, 1.9, 1.3)
CASES = {"beam3": dict(beam_size=3), "greedy": dict(beam_size=1)}


def _songs():
    return [_audio(79 + i, n) for i, n in enumerate(LENGTHS)]


def _port(model, audios, tok, groups, **kw):
    return tl.transcribe_longform_batched(model, model.cfg, audios, tok, batch_size=2,
                                          overlap_groups=groups, **kw)


@pytest.fixture(scope="module")
def jax_refs(setup):
    tok, jcfg, jparams, _ = setup
    audios = _songs()
    return {name: jl.transcribe_longform_batched(
                jparams, jcfg, audios, tok, batch_size=2, overlap_groups=2,
                temperatures=(0.0,), **ACCEPT, **kw)
            for name, kw in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_groups_equal_jax_and_each_other(setup, jax_refs, name):
    tok, _, _, model = setup
    audios = _songs()
    kw = dict(temperatures=(0.0,), **ACCEPT, **CASES[name])
    runs = {g: _port(model, audios, tok, g, **kw) for g in (1, 2, 3)}
    assert len(runs[2]) == len(LENGTHS)
    for got, want in zip(runs[2], jax_refs[name]):
        _assert_same(got, want)
    for g in (1, 3):
        assert runs[g] == runs[2]


class _FailingTokenizer:
    """The test tokenizer, whose rendering fails in group 1's thread."""

    def __init__(self, tok):
        self._tok = tok
        self.has_bpe = True

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def decode(self, ids):
        if threading.current_thread().name.endswith("-1"):
            raise KeyError("group 1's tokenizer")
        return " ".join(map(str, ids))


def test_a_failing_group_fails_the_call(setup):
    tok, _, _, model = setup
    before = threading.active_count()
    with pytest.raises(KeyError, match="group 1's tokenizer"):
        _port(model, _songs(), _FailingTokenizer(tok), 2, beam_size=1,
              temperatures=(0.0,), **ACCEPT)
    assert threading.active_count() == before


def test_sampled_fallback_repeats_under_two_groups(setup):
    """An impossible compression gate walks every window to the sampled
    rungs; two runs of G = 2 give the same tokens."""
    tok, _, _, model = setup
    kw = dict(beam_size=2, temperatures=(0.0, 0.4, 0.8), compression_ratio_threshold=-1.0,
              logprob_threshold=1e9, no_speech_threshold=2.0)
    first, second = (_port(model, _songs(), tok, 2, **kw) for _ in range(2))
    for a, b in zip(first, second):
        assert a["segments"] and _key(a) == _key(b)
        assert all(s["temperature"] == 0.8 for s in a["segments"])


def test_each_raw_song_mel_once_and_ahead(setup, monkeypatch):
    """Songs 0 and 3 staged by ``prepare_longform_audio``, the rest raw:
    ``log_mel`` runs once for each raw song and never for a staged one. The
    fifth song, queued behind the four slots, is loaded by the prefetch
    pool before the first window decode; the results equal the all-raw
    run's."""
    tok, _, _, model = setup
    audios = _songs()
    mixed = [tl.prepare_longform_audio(a, device="cpu") if i in (0, 3) else a
             for i, a in enumerate(audios)]
    events = []
    prep_mel, log_mel, window_decode = tl._prep_mel, tl.log_mel, tl._window_decode

    def counted_prep(audio, *args):
        if not isinstance(audio, tuple):
            events.append(("song", len(audio)))
        return prep_mel(audio, *args)

    def counted_mel(x, n_mels):
        events.append(("mel", None))
        return log_mel(x, n_mels=n_mels)

    def counted_decode(*args):
        events.append(("decode", None))
        return window_decode(*args)

    monkeypatch.setattr(tl, "_prep_mel", counted_prep)
    monkeypatch.setattr(tl, "log_mel", counted_mel)
    monkeypatch.setattr(tl, "_window_decode", counted_decode)
    kw = dict(beam_size=1, temperatures=(0.0,), **ACCEPT)
    got = _port(model, mixed, tok, 2, **kw)
    songs = [n for kind, n in events if kind == "song"]
    assert sorted(songs) == sorted(len(audios[i]) for i in (1, 2, 4))
    assert sum(kind == "mel" for kind, _ in events) == 3
    first_decode = next(i for i, (kind, _) in enumerate(events) if kind == "decode")
    assert ("song", len(audios[4])) in events[:first_decode]
    monkeypatch.undo()
    assert got == _port(model, audios, tok, 2, **kw)
    assert np.isfinite([s["avg_logprob"] for r in got for s in r["segments"]]).all()
