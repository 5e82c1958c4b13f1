"""ctypes bridge to the native (C++) WAV loader.

Port of ``lyricalignment_tpu/data/native_loader.py`` over the port's own
copy of the source, ``native/wavio.cpp``: built with ``g++`` at first use
into ``_build/libwavio-<hash>.so``, the hash covering the source and the
flags, so an edited source is rebuilt and an unchanged one reused. It has
the contract of the Python path in ``data/audio_io.py``, which
``audio_io.load_audio_file`` takes when ``g++`` is absent or the build
fails (with a message on stderr). This is host code: no GPU kernel.

The FIR prototype of the polyphase resampler is designed on the host with
scipy (``scipy.signal.resample_poly``'s kaiser(5.0) default) and handed to
the C++ loop, which runs without the GIL.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import tempfile
from math import gcd
from pathlib import Path
from typing import Dict, Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "wavio.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC"]

TARGET_SR = 16_000


def _build() -> Optional[Path]:
    """The library's path, built if no library of this source and these
    flags exists; None (and a message on stderr) when g++ fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + repr(GXX_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"libwavio-{digest}.so"
    if target.exists():
        return target
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = os.path.join(tmp, target.name)
            subprocess.run(["g++", *GXX_FLAGS, "-o", tmp_so, str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp_so, target)  # atomic: concurrent processes agree
        return target
    except (OSError, subprocess.CalledProcessError) as e:
        sys.stderr.write(f"native loader build failed, using the Python path: {e}\n")
        return None


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_decode.argtypes = [ctypes.c_char_p, f32p, ctypes.c_long, ctypes.c_int]
    lib.wav_decode.restype = ctypes.c_long
    lib.resample_poly_fir.argtypes = [f32p, ctypes.c_long, f32p, ctypes.c_long, f32p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.resample_poly_fir.restype = ctypes.c_long
    lib.resample_polyphase.argtypes = [f32p, ctypes.c_long, f32p, ctypes.c_long, f32p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.resample_polyphase.restype = ctypes.c_long
    return lib


def available() -> bool:
    """Whether the native loader built and loaded (building it on first
    call)."""
    return _lib() is not None


@functools.lru_cache(maxsize=32)
def _fir_taps(up: int, down: int) -> np.ndarray:
    """scipy.resample_poly's default filter: kaiser(5.0) windowed sinc with
    cutoff at min(1/up, 1/down) of the upsampled Nyquist, scaled by up."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    taps = firwin(2 * 10 * max_rate + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (taps * up).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _polyphase_bank(up: int, down: int):
    """Reversed contiguous polyphase decomposition of the FIR prototype:
    bank[p, i] = taps[p + (L-1-i)*up], zero-padded. Returns
    (bank f32[up, L], L, half)."""
    taps = _fir_taps(up, down)
    n_taps = len(taps)
    L = -(-n_taps // up)
    padded = np.zeros(up * L, np.float32)
    padded[:n_taps] = taps
    bank = padded.reshape(L, up).T[:, ::-1]  # [up, L], reversed in i
    return np.ascontiguousarray(bank), L, n_taps // 2


def load_audio_file_native(path: str, audio_type: int = 0) -> Dict[str, np.ndarray]:
    """Native decode + resample with the ``audio_io.load_audio_file``
    contract: ``FileNotFoundError`` for a missing file, ``ValueError`` for
    one that is not a readable WAV."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native WAV loader is not available (g++ build failed)")
    f32p = ctypes.POINTER(ctypes.c_float)
    sr, channels, frames = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    rc = lib.wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(channels),
                      ctypes.byref(frames))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(f"unreadable WAV: {path}")

    pcm = np.empty(frames.value, np.float32)
    got = lib.wav_decode(path.encode(), pcm.ctypes.data_as(f32p), frames.value, audio_type)
    if got < 0:
        raise ValueError(f"decode failed ({got}) for {path} audio_type={audio_type}")
    pcm = pcm[:got]

    if sr.value != TARGET_SR:
        g = gcd(sr.value, TARGET_SR)
        up, down = TARGET_SR // g, sr.value // g
        bank, L, half = _polyphase_bank(up, down)
        out_len = -(-len(pcm) * up // down)
        out = np.empty(out_len, np.float32)
        wrote = lib.resample_polyphase(pcm.ctypes.data_as(f32p), len(pcm),
                                       out.ctypes.data_as(f32p), out_len,
                                       bank.ctypes.data_as(f32p), L, up, down, half)
        pcm = out[:wrote]

    return {"speech": pcm, "sampling_rate": TARGET_SR}
