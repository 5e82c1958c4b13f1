"""The port's quality battery (``decode/transcribe.py``) against JAX's:
``compression_ratio``, ``no_speech_probs`` (atol 1e-6) and
``decode_with_fallback`` at temperature 0 (every entry) equal JAX's on a
seeded tiny model; the sampled rungs are deterministic for a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.decode import transcribe as jt
from lyricalignment_tpu_torch.decode import transcribe as tt
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

EOT, SOT, NO_SPEECH = 30, 31, 35
DIMS = dict(n_vocab=40, n_audio_ctx=50, n_text_ctx=32, n_text_layer=2)


class TinyTokenizer:
    """The special ids the fallback ladder reads, on a 40-token vocab."""
    eot, sot, no_speech, has_bpe = EOT, SOT, NO_SPEECH, False


@pytest.fixture(scope="module")
def tiny():
    cfg, params = jax_tiny_model(seed=3, dims=DIMS)
    model = torch_model(cfg, params).whisper_model
    rng = np.random.default_rng(7)
    xa = (rng.standard_normal((3, 50, 64)) * 2.0).astype(np.float32)
    prompt = np.array([[SOT, SOT + 1]] * 3, np.int32)
    return cfg.whisper, as_jax(params)["whisper"], model, xa, prompt


@pytest.mark.parametrize("text", ["", "a", "你好世界" * 20, "abcdefghij" * 3,
                                  "the the the the the the the the"])
def test_compression_ratio_equals_jax(text):
    assert tt.compression_ratio(text) == jt.compression_ratio(text)


def test_no_speech_probs_equal_jax(tiny):
    jcfg, jparams, model, xa, _ = tiny
    want = np.asarray(jt.no_speech_probs(jparams, jcfg, jnp.asarray(xa), SOT, NO_SPEECH))
    got = tt.no_speech_probs(model, model.cfg, torch.from_numpy(xa), SOT, NO_SPEECH)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_decode_with_fallback_at_temperature_zero_equals_jax(tiny):
    jcfg, jparams, model, xa, prompt = tiny
    kw = dict(beam_size=3, max_new_tokens=8, temperatures=(0.0,))
    want = jt.decode_with_fallback(jparams, jcfg, jnp.asarray(xa), jnp.asarray(prompt),
                                   TinyTokenizer(), **kw)
    got = tt.decode_with_fallback(model, model.cfg, torch.from_numpy(xa),
                                  torch.from_numpy(prompt), TinyTokenizer(), **kw)
    assert any(entry["tokens"] for entry in want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("tokens", "text", "compression_ratio", "temperature"):
            assert g[key] == w[key], key
        assert g["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=1e-5)
        assert g["no_speech_prob"] == pytest.approx(w["no_speech_prob"], abs=1e-6)


def test_fallback_sampling_is_deterministic_for_a_seed(tiny, monkeypatch):
    _, _, model, xa, prompt = tiny

    def ladder(seed):
        # an unreachable compression gate sends every sample down the ladder
        return tt.decode_with_fallback(
            model, model.cfg, torch.from_numpy(xa), torch.from_numpy(prompt),
            TinyTokenizer(), beam_size=2, max_new_tokens=8,
            temperatures=(0.0, 0.5, 1.0), seed=seed)

    monkeypatch.setattr(tt, "COMPRESSION_RATIO_THRESHOLD", -1.0)
    a, b, c = ladder(3), ladder(3), ladder(4)
    assert [e["temperature"] for e in a] == [1.0, 1.0, 1.0]
    assert a == b
    assert [e["tokens"] for e in a] != [e["tokens"] for e in c]
