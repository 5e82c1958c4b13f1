"""Port log-mel frontend vs the JAX one (einsum path and the Pallas kernel in
interpret mode). Tolerance atol/rtol 1e-5 on the final (x + 4) / 4 values:
both sides compute the DFT and mel projection in float32 and differ only in
summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.ops.mel import log_mel_spectrogram
from lyricalignment_tpu.ops.mel import pad_or_trim as jax_pad_or_trim
from lyricalignment_tpu.ops.mel_pallas import fused_log_mel
from lyricalignment_tpu_torch.ops import mel as port_mel


def _audio(rng, batch=2, seconds=1.0):
    audio = rng.standard_normal((batch, int(seconds * 16000))).astype(np.float32) * 0.1
    audio[-1, 9000:] = 0.0  # a silent tail: the 1e-10 floor and the clamp
    return audio


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("per_sample_max", [False, True])
def test_log_mel_matches_jax(rng, n_mels, per_sample_max):
    audio = _audio(rng)
    ref = log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels,
                              per_sample_max=per_sample_max)
    got = port_mel.log_mel(torch.from_numpy(audio), per_sample_max=per_sample_max,
                           n_mels=n_mels)
    assert got.shape == (2, n_mels, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_log_mel_matches_pallas_kernel(rng):
    audio = _audio(rng, seconds=0.5)
    ref = fused_log_mel(jnp.asarray(audio), interpret=True)
    got = port_mel.log_mel(torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_log_mel_unbatched(rng):
    audio = _audio(rng, batch=1)[0]
    ref = log_mel_spectrogram(jnp.asarray(audio))
    got = port_mel.log_mel(torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("per_sample_max", [False, True])
def test_log_mel_leading_dimensions(rng, per_sample_max):
    """[2, 3, T] audio: each leading index a sample. The JAX function's
    einsum takes one batch dimension, so it gets the same 6 samples as
    [6, T] (the batch-wide peak is the same) and its output is reshaped."""
    audio = rng.standard_normal((2, 3, 4000)).astype(np.float32) * 0.1
    audio[1, 2, 1500:] = 0.0
    ref = np.asarray(log_mel_spectrogram(jnp.asarray(audio.reshape(6, -1)),
                                         per_sample_max=per_sample_max))
    got = port_mel.log_mel(torch.from_numpy(audio), per_sample_max=per_sample_max)
    assert got.shape == (2, 3, 80, 25)
    np.testing.assert_allclose(got.numpy(), ref.reshape(2, 3, 80, 25), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("samples", [150, 161, 200, 320])
def test_log_mel_short_audio(rng, samples):
    """Audio no longer than the 200-sample pad: the reflection repeats as
    ``jnp.pad``'s does (numpy's rule). Under 160 samples there is no frame:
    the port returns [..., n_mels, 0], where the JAX function raises at its
    peak (the max of an empty spectrum). Two clips, so the batch's peak
    clamps the bands 8 decades under it: a lone reflected frame can hold a
    band there, where float32 DFTs differ in the 4th digit."""
    audio = rng.standard_normal((2, samples)).astype(np.float32) * 0.1
    got = port_mel.log_mel(torch.from_numpy(audio))
    assert got.shape == (2, 80, samples // 160)
    if samples < 160:
        with pytest.raises(ValueError, match="zero-size"):
            log_mel_spectrogram(jnp.asarray(audio))
        return
    ref = np.asarray(log_mel_spectrogram(jnp.asarray(audio)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_reflect_pad_matches_numpy(rng):
    """The centre pad against ``np.pad(mode="reflect")`` from 1 sample to
    well past the pad."""
    for n in (1, 2, 3, 150, 200, 201, 450):
        audio = rng.standard_normal((2, n)).astype(np.float32)
        got = port_mel.reflect_pad(torch.from_numpy(audio)).numpy()
        np.testing.assert_array_equal(got, np.pad(audio, ((0, 0), (200, 200)), mode="reflect"))


@pytest.mark.parametrize("length", [5, 8, 12])
def test_pad_or_trim(rng, length):
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    for axis in (-1, 1):
        ref = np.asarray(jax_pad_or_trim(jnp.asarray(x), length, axis=axis))
        got = port_mel.pad_or_trim(torch.from_numpy(x), length, axis=axis).numpy()
        np.testing.assert_array_equal(got, ref)


def test_filterbank_and_bases_match_jax():
    from lyricalignment_tpu.ops.mel import _dft_bases, mel_filterbank

    for n_mels in (80, 128):
        np.testing.assert_array_equal(port_mel.mel_filterbank(n_mels=n_mels),
                                      mel_filterbank(n_mels=n_mels))
    for a, b in zip(port_mel._dft_bases(), _dft_bases()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_band_ranges_hold_every_nonzero_weight(n_mels):
    """The kernel runs band m only over bins [lo, hi): every nonzero weight of
    the JAX filterbank must lie inside, so the skipped terms are exact zeros."""
    from lyricalignment_tpu.ops.mel import mel_filterbank

    fb = mel_filterbank(n_mels=n_mels)
    band = port_mel._constants(torch.device("cpu"), n_mels)[3].numpy()
    bins = np.arange(fb.shape[1])
    inside = (bins[None, :] >= band[:, :1]) & (bins[None, :] < band[:, 1:])
    assert not fb[~inside].any()
    assert (band[:, 1] > band[:, 0]).all()
