"""WAV decoding, resampling to 16 kHz and Whisper's log-mel, plainly."""

from __future__ import annotations

import wave
from math import gcd

import numpy as np
import torch

SR, N_FFT, HOP = 16000, 400, 160
N_SAMPLES = 30 * SR


def read_mono_16k(path: str) -> np.ndarray:
    """PCM16 WAV -> float32 mono at 16 kHz: samples / 32768, polyphase
    resampling (a Kaiser-windowed FIR, ``scipy.signal.resample_poly``) in
    float64, then the channels' mean."""
    from scipy.signal import resample_poly

    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: only PCM16 is written by the benchmark")
        ch, sr, n = w.getnchannels(), w.getframerate(), w.getnframes()
        data = np.frombuffer(w.readframes(n), "<i2").astype(np.float64) / 32768.0
    data = data.reshape(-1, ch).T
    if sr != SR:
        g = gcd(sr, SR)
        data = resample_poly(data, SR // g, sr // g, axis=-1)
    return data.mean(axis=0).astype(np.float32)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_part = min_hz / f_sp + np.log(np.maximum(f, 1e-12) / min_hz) / logstep
    return np.where(f >= min_hz, log_part, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    min_mel = min_hz / f_sp
    return np.where(m >= min_mel, min_hz * np.exp(logstep * (m - min_mel)), m * f_sp)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's Slaney-normalised mel filterbank at 16 kHz, n_fft 400, as
    Whisper ships it: float32 [n_mels, 201]."""
    freqs = np.linspace(0.0, SR / 2.0, 1 + N_FFT // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return weights.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """audio f32[B, N] -> Whisper's log-mel f32[B, n_mels, N // 160]: the
    centred, reflect-padded STFT with a periodic Hann window (its last frame
    dropped), the power, the filterbank, log10 floored at 1e-10, clamped to
    8 below the batch's peak, then (x + 4) / 4."""
    window = torch.hann_window(N_FFT, periodic=True, device=audio.device)
    spec = torch.stft(audio, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    fb = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    power = spec.real ** 2 + spec.imag ** 2
    logm = torch.log10(torch.clamp(fb @ power, min=1e-10))
    logm = torch.maximum(logm, logm.max() - 8.0)
    return (logm + 4.0) / 4.0


def bucket_len(n: int, bucket_seconds: float) -> int:
    """The alignment service's padded length for ``n`` samples: up to the
    next multiple of the bucket, at most one 30 s window (whole windows
    above it)."""
    bucket = max(1, int(round(bucket_seconds * SR)))
    if n > N_SAMPLES:
        return -(-n // N_SAMPLES) * N_SAMPLES
    return min(max(bucket, -(-n // bucket) * bucket), N_SAMPLES)
