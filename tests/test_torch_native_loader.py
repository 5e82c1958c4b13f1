"""The port's native C++ WAV loader (its own copy of ``native/wavio.cpp``,
built by ``g++`` into ``_build/``): the cases of
``tests/test_native_loader.py`` on the port's copy, its output bit-equal to
the JAX package's native loader, and the Python path when ``g++`` is
absent."""

import struct

import numpy as np
import pytest
from scipy.signal import resample_poly as scipy_resample_poly

from lyricalignment_tpu.data import native_loader as jax_native
from lyricalignment_tpu_torch.data import audio_io, native_loader
from lyricalignment_tpu_torch.data.audio_io import write_wav
from tests.conftest import forge_wav_bytes as _wav_bytes


@pytest.fixture
def native():
    """The built loader (decided when a test runs, never at import)."""
    if not native_loader.available():
        pytest.skip("g++ is not available: the native loader cannot be built")
    return native_loader


def python_load(path, audio_type=0):
    return audio_io.load_audio_file_python(path, audio_type)["speech"]


def test_decode_16bit_mono_no_resample(native, tmp_path, rng):
    sig = (rng.standard_normal(16000) * 0.4).astype(np.float32)
    p = str(tmp_path / "a.wav")
    write_wav(p, sig, 16000)
    out = native.load_audio_file_native(p)["speech"]
    np.testing.assert_allclose(out, python_load(p), atol=1e-6)


@pytest.mark.parametrize("audio_type", [0, 1, 2])
def test_decode_stereo_audio_types(native, tmp_path, rng, audio_type):
    left = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    right = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    p = str(tmp_path / "s.wav")
    write_wav(p, np.stack([left, right]), 16000)
    out = native.load_audio_file_native(p, audio_type)["speech"]
    np.testing.assert_allclose(out, python_load(p, audio_type), atol=1e-6)


def test_resample_44k_matches_scipy(native, tmp_path, rng):
    sig = (rng.standard_normal(44100) * 0.4).astype(np.float32)
    p = str(tmp_path / "r.wav")
    write_wav(p, sig, 44100)
    out = native.load_audio_file_native(p)["speech"]
    data, _ = audio_io.read_wav(p)
    expected = scipy_resample_poly(data[0], 160, 441).astype(np.float32)
    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, atol=2e-5)


@pytest.mark.parametrize("sr,channels", [(16000, 1), (44100, 2), (22050, 2), (48000, 1)])
def test_bit_equal_to_the_jax_native_loader(native, tmp_path, rng, sr, channels):
    if not jax_native.available():
        pytest.skip("the JAX package's native loader did not build")
    sig = (rng.standard_normal((channels, int(1.3 * sr))) * 0.3).astype(np.float32)
    p = str(tmp_path / "x.wav")
    write_wav(p, sig, sr)
    for audio_type in ((0, 1, 2) if channels == 2 else (0,)):
        got = native.load_audio_file_native(p, audio_type)
        want = jax_native.load_audio_file_native(p, audio_type)
        assert got["sampling_rate"] == want["sampling_rate"] == 16000
        assert got["speech"].dtype == want["speech"].dtype == np.float32
        np.testing.assert_array_equal(got["speech"], want["speech"])


def test_missing_file_raises(native):
    with pytest.raises(FileNotFoundError):
        native.load_audio_file_native("/nope/missing.wav")


# malformed or hostile input: the parser rejects it (ValueError) or
# truncates gracefully, never crashes the process, since the serving path
# (cli/serve.py) loads caller-supplied paths in-process


def _write(tmp_path, name, blob):
    p = tmp_path / name
    p.write_bytes(blob)
    return str(p)


@pytest.mark.parametrize("kw", [
    dict(bits=4),           # bits/8 == 0: a division by zero in the frame count
    dict(bits=0),
    dict(bits=12),
    dict(channels=0),
    dict(channels=60000),   # absurd channel count -> a giant allocation otherwise
    dict(sr=0),
    dict(sr=100_000_000),   # absurd rate -> an unbounded FIR design otherwise
])
def test_malformed_header_raises_not_crashes(native, tmp_path, kw):
    p = _write(tmp_path, "bad.wav", _wav_bytes(**kw))
    with pytest.raises(ValueError):
        native.load_audio_file_native(p)


@pytest.mark.parametrize("name,blob", [("garbage.wav", b"not a riff file at all" * 10),
                                       ("empty.wav", b""),
                                       ("riff_only.wav", b"RIFF\x04\x00\x00\x00WAVE")])
def test_garbage_and_empty_files_raise(native, tmp_path, name, blob):
    with pytest.raises(ValueError):
        native.load_audio_file_native(_write(tmp_path, name, blob))


def test_truncated_data_chunk_clamps_to_real_bytes(native, tmp_path):
    # the header declares 1000 frames but only 100 are present
    real = struct.pack("<100h", *range(100))
    p = _write(tmp_path, "trunc.wav", _wav_bytes(data=real, declared_data_len=2000))
    out = native.load_audio_file_native(p)["speech"]
    assert out.shape == (100,)
    np.testing.assert_allclose(out, np.arange(100, dtype=np.float32) / 32768.0, atol=1e-7)


def test_empty_data_chunk_yields_empty_audio(native, tmp_path):
    p = _write(tmp_path, "zero.wav", _wav_bytes(data=b""))
    assert native.load_audio_file_native(p)["speech"].shape == (0,)


def test_header_mutation_fuzz_never_crashes(native, tmp_path, rng):
    """Seeded byte flips over a valid WAV: every mutation loads or raises,
    and the port's copy answers as the JAX package's does."""
    data = struct.pack("<400h", *rng.integers(-30000, 30000, 400))
    base = bytearray(_wav_bytes(channels=2, sr=22050, data=data))
    p = tmp_path / "fuzz.wav"
    check_jax = jax_native.available()
    for _ in range(1500):
        blob = bytearray(base)
        for _ in range(int(rng.integers(1, 9))):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        if rng.random() < 0.2:
            blob = blob[: int(rng.integers(0, len(blob)))]
        p.write_bytes(blob)
        audio_type = int(rng.integers(0, 3))
        try:
            got = native.load_audio_file_native(str(p), audio_type)["speech"]
        except (ValueError, FileNotFoundError) as exc:
            got = type(exc)
        if check_jax:
            try:
                want = jax_native.load_audio_file_native(str(p), audio_type)["speech"]
            except (ValueError, FileNotFoundError) as exc:
                want = type(exc)
            if isinstance(want, type):
                assert got is want
            else:
                np.testing.assert_array_equal(got, want)


def test_dispatch_through_load_audio_file(native, tmp_path, rng):
    sig = (rng.standard_normal(22050) * 0.2).astype(np.float32)
    p = str(tmp_path / "d.wav")
    write_wav(p, sig, 22050)
    out = audio_io.load_audio_file(p)["speech"]
    assert out.dtype == np.float32
    assert abs(len(out) - 16000) <= 2
    np.testing.assert_array_equal(out, native.load_audio_file_native(p)["speech"])


def test_python_path_without_gxx(tmp_path, rng, monkeypatch, capsys):
    """No g++: the build reports on stderr, ``available()`` is false and
    ``load_audio_file`` takes the Python path."""
    def no_gxx(*args, **kwargs):
        raise FileNotFoundError("g++")

    sig = (rng.standard_normal(22050) * 0.2).astype(np.float32)
    p = str(tmp_path / "d.wav")
    write_wav(p, sig, 22050)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_loader.subprocess, "run", no_gxx)
    native_loader._lib.cache_clear()
    try:
        assert not native_loader.available()
        assert "native loader build failed" in capsys.readouterr().err
        out = audio_io.load_audio_file(p)["speech"]
        np.testing.assert_array_equal(out, python_load(p))
    finally:
        monkeypatch.undo()
        native_loader._lib.cache_clear()
