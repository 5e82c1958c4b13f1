"""What the redesigned row log-sum-exp and log-mel kernels rest on, as far as
a machine without a GPU can check it:

* the 3xTF32 split of ``csrc/lse.cu`` (hi = the float32 value with its low
  13 bits cleared, which is what the tensor cores read; lo = x - hi, itself
  truncated when read; three float32 products), emulated in torch and held
  to the kernel's tolerance against a float64 log-sum-exp;
* the tables of ``ops/mel.py:_fft_tables`` driven through the staged
  transform of ``csrc/mel.cu`` (a frame's 400 windowed samples as 200
  complex points, 8 x 25, then the even/odd join) in numpy, against
  ``np.fft.rfft``.
"""

import math

import numpy as np
import pytest
import torch

from lyricalignment_tpu_torch import HOP_LENGTH, N_FFT
from lyricalignment_tpu_torch.ops import mel


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read it: the low 13 bits of the float32 dropped."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _lse_case(h_scale, rows=64, feat=768, cols=4224, seed=0):
    """The scales of chip_smoke.py's row-LSE check (h ~ 0.5 N(0, 1) there,
    w and b uniform in +-1/sqrt(feat)), a 4224-column slice."""
    rng = np.random.default_rng(seed)
    s = 1.0 / math.sqrt(feat)
    h = torch.from_numpy((rng.standard_normal((rows, feat)) * h_scale).astype(np.float32))
    w = torch.from_numpy(((rng.random((cols, feat)) * 2 - 1) * s).astype(np.float32))
    b = torch.from_numpy(((rng.random(cols) * 2 - 1) * s).astype(np.float32))
    exact = torch.logsumexp(h.double() @ w.double().T + b.double(), dim=-1)
    return h, w, b, exact


def _holds(got, exact):
    return bool(((got.double() - exact).abs() <= 1e-4 + 1e-5 * exact.abs()).all())


@pytest.mark.parametrize("h_scale", [0.5, 30.0])
def test_three_tf32_products_hold_the_lse_tolerance(h_scale):
    """h.w ~ h_lo.w_hi + h_hi.w_lo + h_hi.w_hi in float32 holds rtol 1e-5 /
    atol 1e-4 of the log-sum-exp, at the smoke run's scales and with h
    scaled by 30 (logits of +-100)."""
    h, w, b, exact = _lse_case(h_scale)
    h_hi, w_hi = _tf32(h), _tf32(w)
    h_lo, w_lo = _tf32(h - h_hi), _tf32(w - w_hi)
    assert torch.equal(h_hi + (h - h_hi), h) and torch.equal(w_hi + (w - w_hi), w)  # exact split
    logits = (h_lo @ w_hi.T + h_hi @ w_lo.T) + h_hi @ w_hi.T + b
    got = torch.logsumexp(logits, dim=-1)
    assert _holds(got, exact), float((got.double() - exact).abs().max())


def test_one_tf32_product_does_not_hold_it():
    """Without the lo products the same logits miss the tolerance: the
    split is needed."""
    h, w, b, exact = _lse_case(30.0)
    got = torch.logsumexp(_tf32(h) @ _tf32(w).T + b, dim=-1)
    err = float((got.double() - exact).abs().max())
    assert not _holds(got, exact) and err > 1e-3, err


def test_fft_tables_are_float64_values_rounded_once():
    window, twiddle, post = mel._fft_tables(N_FFT)
    assert window.dtype == twiddle.dtype == post.dtype == np.float32
    assert window.shape == (400,) and twiddle.shape == (8, 25, 2) and post.shape == (201, 2)
    n = np.arange(400)
    np.testing.assert_array_equal(
        window, (0.5 * (1.0 - np.cos(2.0 * np.pi * n / 400))).astype(np.float32))
    want = np.exp(-2j * np.pi * np.outer(np.arange(8), np.arange(25)) / 200)
    np.testing.assert_array_equal(twiddle[..., 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(twiddle[..., 1], want.imag.astype(np.float32))
    want = np.exp(-2j * np.pi * np.arange(201) / 400)
    np.testing.assert_array_equal(post[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(post[:, 1], want.imag.astype(np.float32))
    assert twiddle[0].tolist() == [[1.0, 0.0]] * 25 and post[0].tolist() == [1.0, 0.0]


def _staged_rfft(frames: np.ndarray) -> np.ndarray:
    """The kernel's passes on float64 frames [F, 400] with the float32
    tables: returns the 201-bin spectra."""
    window, twiddle, post = mel._fft_tables(N_FFT)
    tw = twiddle[..., 0].astype(np.float64) + 1j * twiddle[..., 1]
    join = post[:, 0].astype(np.float64) + 1j * post[:, 1]
    n1, n2 = mel.FFT_N1, mel.FFT_N2
    xw = frames * window.astype(np.float64)
    z = xw[:, 0::2] + 1j * xw[:, 1::2]                  # [F, 200], n = 25 n1 + n2
    y = np.fft.fft(z.reshape(-1, n1, n2), axis=1)       # pass 1: [F, k1, n2]
    y = np.fft.fft(y * tw, axis=2)                      # pass 2: Z[k1 + 8 k2] at [F, k1, k2]
    k = np.arange(N_FFT // 2 + 1)
    ka, kb = k % 200, (200 - k) % 200
    zk, zc = y[:, ka % n1, ka // n1], np.conj(y[:, kb % n1, kb // n1])
    return (zk + zc) / 2 + join * (zk - zc) / 2j


@pytest.mark.parametrize("n_frames", [8, 7, 1])
@pytest.mark.parametrize("kind", ["noise", "sine"])
def test_staged_transform_matches_rfft(kind, n_frames):
    """The kernel's 8 x 25 split with the even/odd join, on frames
    cut at hop 160 from one signal, against np.fft.rfft of the windowed
    frames: atol 1e-5 of each frame's largest bin."""
    rng = np.random.default_rng(n_frames)
    n = (n_frames - 1) * HOP_LENGTH + N_FFT
    if kind == "noise":
        audio = rng.standard_normal(n)
    else:
        audio = np.sin(2 * np.pi * 1234.5 * np.arange(n) / 16000.0)
    frames = np.stack([audio[f * HOP_LENGTH:f * HOP_LENGTH + N_FFT] for f in range(n_frames)])
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    want = np.fft.rfft(frames * window, axis=-1)
    got = _staged_rfft(frames)
    assert got.shape == (n_frames, 201)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * peak), float((np.abs(got - want) / peak).max())


def test_staged_transform_keeps_silent_frames_exact():
    """Every frame is transformed on its own, so an all-zero frame gives
    exact zeros (the log's 1e-10 floor) whatever its neighbours hold."""
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((5, N_FFT))
    frames[2] = 0.0
    got = _staged_rfft(frames)
    assert not got[2].any() and got[1].any() and got[3].any()


def test_staged_power_matches_the_plain_version():
    """Power of the staged spectra through the mel filterbank and log10
    against ``log10_mel_plain`` (dense float32 bases): atol 1e-4."""
    rng = np.random.default_rng(5)
    n_frames = 9
    audio = (rng.standard_normal((n_frames - 1) * HOP_LENGTH + N_FFT) * 0.1).astype(np.float32)
    frames = np.stack([audio[f * HOP_LENGTH:f * HOP_LENGTH + N_FFT] for f in range(n_frames)])
    power = np.abs(_staged_rfft(frames.astype(np.float64))) ** 2
    got = np.log10(np.maximum(power @ mel.mel_filterbank(n_mels=80).T.astype(np.float64), 1e-10))
    ref = mel.log10_mel_plain(torch.from_numpy(audio)[None], n_frames, 80)[0].numpy()
    np.testing.assert_allclose(got.T, ref, atol=1e-4, rtol=0)
