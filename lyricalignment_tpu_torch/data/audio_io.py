"""Host-side audio loading: WAV decode + resample to 16 kHz float32.

The port's own copy of ``lyricalignment_tpu/data/audio_io.py``:
:func:`load_audio_file` goes through the native C++ loader
(``data/native_loader.py``) when ``g++`` built it, else through the Python
path here (stdlib ``wave`` + numpy decoding + scipy polyphase resampling).
The ``audio_type`` convention of the reference (`utils/audio.py:3-20`):
    0 = mono (channel-averaged if the file is multi-channel)
    1 = stereo mixture -> average of the two channels
    2 = stereo where channel 1 is the vocal stem -> take channel index 1
"""

from __future__ import annotations

import wave
from math import gcd
from typing import Dict

import numpy as np
from scipy.signal import resample_poly

from lyricalignment_tpu_torch.data import native_loader

TARGET_SR = 16_000


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a PCM WAV file -> (float32 array [channels, samples], sr).

    Supports PCM 8/16/24/32-bit. Values are scaled to [-1, 1] like
    librosa/libsndfile.
    """
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if sampwidth == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as_int = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        as_int = np.where(as_int >= 1 << 23, as_int - (1 << 24), as_int)
        data = as_int.astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")

    data = data.reshape(-1, n_channels).T  # [channels, samples]
    return np.ascontiguousarray(data), sr


def resample(audio: np.ndarray, orig_sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    """Polyphase resampling along the last axis (kaiser-windowed sinc)."""
    if orig_sr == target_sr:
        return audio
    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_audio_file(path: str, audio_type: int = 0) -> Dict[str, np.ndarray]:
    """Load + resample a WAV file; returns {'speech': f32[T], 'sampling_rate'}.
    Dispatches to the native loader when it is available."""
    if native_loader.available():
        return native_loader.load_audio_file_native(path, audio_type)
    return load_audio_file_python(path, audio_type)


def load_audio_file_python(path: str, audio_type: int = 0) -> Dict[str, np.ndarray]:
    """The Python path of :func:`load_audio_file`."""
    data, sr = read_wav(path)
    data = resample(data, sr)

    if audio_type == 0:
        speech = data.mean(axis=0) if data.shape[0] > 1 else data[0]
    elif audio_type == 1:
        speech = (data[0] + data[1]) / 2.0
    elif audio_type == 2:
        speech = data[1]
    else:
        raise ValueError("audio_type must be 0, 1, or 2")

    return {"speech": speech.astype(np.float32), "sampling_rate": TARGET_SR}


def write_wav(path: str, audio: np.ndarray, sr: int = TARGET_SR) -> None:
    """Write mono or [channels, samples] float audio as PCM16 WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
    interleaved = pcm.T.reshape(-1).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(interleaved)


def audio_num_samples_16k(path: str) -> int:
    """Length (in 16 kHz samples) an audio file will have after loading,
    from the header alone — lets loaders bucket by length without decoding."""
    with wave.open(path, "rb") as w:
        frames = w.getnframes()
        sr = w.getframerate()
    if sr == TARGET_SR:
        return frames
    return -(-frames * TARGET_SR // sr)
