"""ctypes bridge to the hand-written Zstandard decoder (``native/zstd.cpp``).

The checkpoint reader (``train/orbax.py``) needs zstd twice: the OCDBT
manifests and b-tree nodes of an orbax checkpoint are zstd frames, and so is
every zarr chunk of its arrays. The decoder is host C++ with no library,
built with ``g++`` at first use into ``_build/libzstd_la-<hash>.so`` (the
hash covering the source and the flags, the file moved into place
atomically, as ``data/native_loader.py`` builds the WAV loader). Unlike the
WAV loader it has no Python path: a failed build raises with ``g++``'s
message. ctypes releases the GIL for the call, so chunks decode in parallel
on a thread pool.

This is host code, not a GPU kernel: decompressing a checkpoint is one
linear pass over its bytes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "zstd.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_ERR_BYTES = 256


class ZstdError(ValueError):
    """Corrupt, truncated or unsupported zstd input."""


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + repr(GXX_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"libzstd_la-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, target.name)
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", tmp_so, str(SOURCE)],
                           check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"building the zstd decoder needs g++: {e}") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{e.stderr}") from e
        os.replace(tmp_so, target)  # atomic: concurrent processes agree
    return target


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build()))
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    lib.la_zstd_content_size.argtypes = [vp, sz, ctypes.c_char_p, sz]
    lib.la_zstd_content_size.restype = ctypes.c_longlong
    lib.la_zstd_decompress.argtypes = [vp, sz, vp, sz, ctypes.c_char_p, sz]
    lib.la_zstd_decompress.restype = ctypes.c_longlong
    lib.la_crc32c.argtypes = [vp, sz]
    lib.la_crc32c.restype = ctypes.c_uint32
    return lib


def content_size(data) -> Optional[int]:
    """The decoded size declared by every frame of ``data``, or None when a
    frame does not declare it."""
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = _lib().la_zstd_content_size(src.ctypes.data, src.size, err, _ERR_BYTES)
    if n == -2:
        raise ZstdError(err.value.decode())
    return None if n < 0 else int(n)


def _decode(data, out: np.ndarray) -> int:
    """Bytes written into ``out``, or -2 when they do not fit."""
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = _lib().la_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, out.nbytes,
                                  err, _ERR_BYTES)
    if n == -1:
        raise ZstdError(err.value.decode())
    return int(n)


def decompress_into(data, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into the contiguous array ``out``;
    returns the bytes written. Raises :class:`ZstdError` for corrupt or
    truncated input and when the output does not fit."""
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("decompress_into needs a writeable C-contiguous array")
    n = _decode(data, out)
    if n == -2:
        raise ZstdError(f"output buffer too small ({out.nbytes} bytes)")
    return n


def decompress(data, size: Optional[int] = None) -> bytes:
    """Decode every frame of ``data``. ``size`` is the decoded size when the
    caller knows it; otherwise the frames' declared sizes are used, and
    when a frame declares none the output buffer grows until it fits."""
    if size is None:
        size = content_size(data)
    if size is not None:
        out = np.empty(size, np.uint8)
        n = decompress_into(data, out)
        if n != size:
            raise ZstdError(f"decoded {n} bytes where {size} were expected")
        return out.tobytes()
    cap = max(1 << 16, 8 * len(memoryview(data)))
    while True:
        out = np.empty(cap, np.uint8)
        n = _decode(data, out)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    src = np.frombuffer(data, np.uint8)
    return int(_lib().la_crc32c(src.ctypes.data, src.size))
