"""Log-mel spectrogram frontend (Whisper parity).

Port of ``lyricalignment_tpu/ops/mel.py`` and ``ops/mel_pallas.py``:
reflect-centred 400-point STFT with a periodic Hann window, hop 160 at
16 kHz, power spectrum, Slaney mel filterbank, log10 clamped at 1e-10,
dynamic-range compression to 8 below the batch (or per-sample) peak, then
(x + 4) / 4.

The framing + DFT + power + mel + log10 middle is one function with two
forms: the CUDA kernel ``csrc/mel.cu`` for a CUDA tensor (the counterpart of
the TPU's fused Pallas kernel, for any ``n_mels``; its DFT is a fast
transform on the tables of :func:`_fft_tables`) and :func:`log10_mel_plain`
(dense cos/sin bases) for a CPU tensor. The reflect pad and the clamp stay in PyTorch around it,
as they stay outside the TPU kernel (`mel_pallas.py:122-126`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from lyricalignment_tpu_torch import HOP_LENGTH, N_FFT, N_MELS, SAMPLE_RATE
from lyricalignment_tpu_torch import kernels

# ---------------------------------------------------------------------------
# Mel filterbank and DFT bases (numpy, copied from the JAX package)
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(hz: np.ndarray) -> np.ndarray:
    hz = np.asarray(hz, dtype=np.float64)
    mel = hz / _F_SP
    with np.errstate(divide="ignore"):
        log_mel = _MIN_LOG_MEL + np.log(np.maximum(hz, 1e-12) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(hz >= _MIN_LOG_HZ, log_mel, mel)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    hz = mel * _F_SP
    return np.where(mel >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), hz)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS
) -> np.ndarray:
    """Slaney mel filterbank, float32 [n_mels, 1 + n_fft // 2]."""
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: each triangle integrates to ~2 / bandwidth
    enorm = 2.0 / (mel_pts[2:] - mel_pts[:-2])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int = N_FFT, dtype=np.float32) -> tuple:
    """Real-DFT cos/sin bases with the periodic Hann window folded in.

    Returns (cos_basis, sin_basis), each ``dtype`` [n_fft, 1 + n_fft // 2]
    (computed in float64, rounded once), so that for a frame x:
    rfft(x * hann) = x @ cos - 1j * (x @ sin).
    """
    n = np.arange(n_fft)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    k = np.arange(1 + n_fft // 2)
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(dtype)
    sin_b = (np.sin(angle) * window[:, None]).astype(dtype)
    return cos_b, sin_b


FFT_N1, FFT_N2 = 8, 25  # the kernel's split of a frame's 200 complex points


@functools.lru_cache(maxsize=None)
def _fft_tables(n_fft: int = N_FFT) -> tuple:
    """Tables of the kernel's fast transform, computed in float64 and
    rounded once to float32. A frame's ``n_fft`` windowed real samples are
    transformed as ``n_fft // 2`` complex points z[n] = x[2n] + i x[2n+1],
    n = FFT_N2 * n1 + n2, k = k1 + FFT_N1 * k2.

    Returns (window [n_fft] periodic Hann, twiddle [FFT_N1, FFT_N2, 2] =
    exp(-2 pi i n2 k1 / (n_fft / 2)) as (re, im), post [n_fft // 2 + 1, 2] =
    exp(-2 pi i k / n_fft), which joins the even and odd samples' spectra).
    """
    half = n_fft // 2
    if FFT_N1 * FFT_N2 != half:
        raise ValueError(f"the transform is written for n_fft = {2 * FFT_N1 * FFT_N2}")
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    angle = -2.0 * np.pi * np.outer(np.arange(FFT_N1), np.arange(FFT_N2)) / half
    twiddle = np.stack([np.cos(angle), np.sin(angle)], axis=-1)
    angle = -2.0 * np.pi * np.arange(half + 1) / n_fft
    post = np.stack([np.cos(angle), np.sin(angle)], axis=-1)
    return (window.astype(np.float32), twiddle.astype(np.float32),
            post.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _fft_constants(device: torch.device):
    """(window f32[400], twiddles f32[8 * 25 + 201, 2]: the pass twiddles then
    the even/odd ones) on ``device``, as the kernel reads them."""
    window, twiddle, post = _fft_tables(N_FFT)
    both = np.concatenate([twiddle.reshape(-1, 2), post])
    return torch.from_numpy(window).to(device), torch.from_numpy(both).to(device)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, n_mels: int, dtype: torch.dtype = torch.float32):
    """(cos, sin, mel^T, band range) on ``device``: [400, 201] x2 and
    [201, n_mels] of ``dtype`` (float32 or float64; the filterbank is the
    float32 one either way), and i32 [n_mels, 2] holding each band's first
    nonzero bin and last nonzero bin + 1 (0, 0 for an empty band)."""
    cos_b, sin_b = _dft_bases(N_FFT, np.float64 if dtype == torch.float64 else np.float32)
    fb = mel_filterbank(SAMPLE_RATE, N_FFT, n_mels)
    mel_t = np.ascontiguousarray(fb.T)
    band = np.zeros((n_mels, 2), dtype=np.int32)
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            band[m] = nz[0], nz[-1] + 1
    return (*(torch.from_numpy(a).to(device, dtype) for a in (cos_b, sin_b, mel_t)),
            torch.from_numpy(band).to(device))


# ---------------------------------------------------------------------------
# Kernel 1: framing + DFT + power + mel + log10
# ---------------------------------------------------------------------------

def log10_mel_plain(padded: torch.Tensor, n_frames: int, n_mels: int) -> torch.Tensor:
    """Plain version of the kernel: reflect-padded audio f32[B, N + 400] ->
    log10(max(mel power, 1e-10)) f32[B, n_mels, n_frames]. A float64 input
    is transformed in float64 throughout: the reference for long inputs,
    whose small bins a float32 dense DFT rounds by ~2e-4 in log10."""
    cos_b, sin_b, mel_t, _ = _constants(padded.device, n_mels, padded.dtype)
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]  # [B, T', 400]
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ mel_t                            # [B, T', n_mels]
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def log10_mel(padded: torch.Tensor, n_frames: int, n_mels: int) -> torch.Tensor:
    """Framing + DFT + power + mel + log10 of reflect-padded audio: the CUDA
    kernel for a CUDA tensor, :func:`log10_mel_plain` for a CPU tensor."""
    if not padded.is_cuda:
        kernels.plain_or_raise("log10_mel", padded)
        return log10_mel_plain(padded, n_frames, n_mels)
    kernels.check_cuda("log10_mel", padded, torch.float32, 2)
    batch, padded_len = padded.shape
    if padded_len < (n_frames - 1) * HOP_LENGTH + N_FFT:
        raise ValueError("log10_mel: audio too short for n_frames")
    _, _, mel_t, band = _constants(padded.device, n_mels)
    window, twiddle = _fft_constants(padded.device)
    out = torch.empty((batch, n_mels, n_frames), dtype=torch.float32,
                      device=padded.device)
    if out.numel():
        kernels.launch("la_log10_mel", padded.data_ptr(), window.data_ptr(),
                       twiddle.data_ptr(), mel_t.data_ptr(), band.data_ptr(),
                       out.data_ptr(),
                       batch, padded_len, n_frames, n_mels,
                       kernels.stream_of(padded))
    return out


# ---------------------------------------------------------------------------
# Public frontend
# ---------------------------------------------------------------------------

def reflect_pad(audio: torch.Tensor) -> torch.Tensor:
    """Centre padding of torch.stft(center=True, pad_mode='reflect') of
    audio [B, T], with numpy's (and ``jnp.pad``'s) rule where the pad is
    longer than the audio: the reflection repeats with period 2 (T - 1)."""
    pad, n = N_FFT // 2, audio.shape[-1]
    if n > pad:
        return F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    idx = np.abs(np.arange(-pad, n + pad)) % max(2 * (n - 1), 1)
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return audio[:, torch.from_numpy(idx).to(audio.device)]


def log_mel(audio: torch.Tensor, per_sample_max: bool = False,
            n_mels: int = N_MELS) -> torch.Tensor:
    """audio f32[..., T] (16 kHz) -> log-mel f32[..., n_mels, T // 160].

    ``per_sample_max=False`` clamps to 8 below the peak of the whole batch,
    as the reference does (`module/align_model.py:84`); True uses each
    sample's own peak. The leading dimensions are samples; audio under 160
    samples gives zero frames.
    """
    lead, n = audio.shape[:-1], audio.shape[-1]
    audio = audio.reshape(-1, n).to(torch.float32)
    log_spec = log10_mel(reflect_pad(audio).contiguous(), n // HOP_LENGTH, n_mels)
    if log_spec.shape[-1]:
        if per_sample_max:
            peak = log_spec.amax(dim=(-2, -1), keepdim=True)
        else:
            peak = log_spec.max()
        log_spec = (torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0
    return log_spec.reshape(*lead, n_mels, log_spec.shape[-1])


def pad_or_trim(array: torch.Tensor, length: int, axis: int = -1) -> torch.Tensor:
    """Pad with zeros or trim ``array`` to ``length`` along ``axis`` (whisper
    ``pad_or_trim``)."""
    cur = array.shape[axis]
    if cur > length:
        return array.narrow(axis, 0, length)
    if cur < length:
        axis = axis % array.dim()
        pad = [0, 0] * (array.dim() - axis - 1) + [0, length - cur]
        return F.pad(array, pad)
    return array
