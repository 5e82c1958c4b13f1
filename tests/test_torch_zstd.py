"""The port's hand-written zstd decoder (``data/zstd.py`` over
``native/zstd.cpp``, built with g++) against the ``zstandard`` package:
every input kind at levels -5, 1, 3 and 19, with and without the content
size and the checksum, decodes bit for bit; so do back-to-back and
skippable frames, tiny and empty frames, and a frame into a buffer of the
caller's size. A flipped byte or a truncated frame raises, as does an
output that does not fit; the decoder has no fallback path. CRC-32C
(OCDBT's checksum) against its check value."""

import struct

import numpy as np
import pytest
import zstandard

from lyricalignment_tpu_torch.data import zstd

N = 300_000  # bytes: more than one 128 KB block


def _data(kind: str) -> bytes:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "random_bytes":
        return rng.integers(0, 256, N, dtype=np.uint8).tobytes()
    if kind == "random_f32":
        return rng.standard_normal(N // 4).astype(np.float32).tobytes()
    if kind == "zero_f32":
        return np.zeros(N // 4, np.float32).tobytes()
    if kind == "tiled_f32":
        return np.resize(rng.standard_normal(64).astype(np.float32), N // 4).tobytes()
    if kind == "text":
        return b"".join(b"line %d of a lyric, %s\n" % (i, b"la" * (i % 7)) for i in range(12000))
    raise ValueError(kind)


def _compress(data: bytes, level: int, size: bool = True, checksum: bool = False) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_content_size=size,
                                    write_checksum=checksum).compress(data)


@pytest.mark.parametrize("size_and_checksum", [(True, True), (False, False)])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("kind", ["random_bytes", "random_f32", "zero_f32", "tiled_f32",
                                  "text"])
def test_decodes_like_zstandard(kind, level, size_and_checksum):
    data = _data(kind)
    frame = _compress(data, level, *size_and_checksum)
    assert zstd.content_size(frame) == (len(data) if size_and_checksum[0] else None)
    assert zstd.decompress(frame) == data
    out = np.empty(len(data), np.uint8)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out.tobytes() == data


def test_frames_back_to_back_and_skippable():
    a, b = _data("random_f32"), _data("text")
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    frames = skip + _compress(a, 3) + skip + _compress(b, 19, checksum=True) + skip
    assert zstd.content_size(frames) == len(a) + len(b)
    assert zstd.decompress(frames) == a + b
    # a frame with no content size among them: the output grows to fit
    frames = _compress(a, 1) + _compress(b, 1, size=False)
    assert zstd.content_size(frames) is None
    assert zstd.decompress(frames) == a + b


@pytest.mark.parametrize("data", [b"", b"a", b"abc" * 5, bytes(range(256)), b"\x00" * 70_000])
def test_small_and_empty_frames(data):
    for level in (1, 19):
        assert zstd.decompress(_compress(data, level, checksum=True)) == data
        assert zstd.decompress(_compress(data, level, size=False)) == data


def _corrupt_positions(frame: bytes):
    return [len(frame) // 3, len(frame) // 2, len(frame) - 9, len(frame) - 2]


@pytest.mark.parametrize("kind", ["random_f32", "tiled_f32", "text"])
def test_flipped_byte_raises(kind):
    data = _data(kind)
    frame = _compress(data, 3, checksum=True)
    for pos in _corrupt_positions(frame):
        bad = bytearray(frame)
        bad[pos] ^= 0x10
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(bad), len(data))


@pytest.mark.parametrize("kind", ["random_f32", "tiled_f32", "text"])
def test_truncated_frame_raises(kind):
    data = _data(kind)
    for checksum in (False, True):
        frame = _compress(data, 3, checksum=checksum)
        for cut in (0, 3, 9, len(frame) // 2, len(frame) - 1):
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(frame[:cut], len(data))


def test_output_that_does_not_fit_raises():
    data = _data("text")
    with pytest.raises(zstd.ZstdError, match="too small"):
        zstd.decompress_into(_compress(data, 3), np.empty(len(data) - 1, np.uint8))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16, 16)


def _crc32c_bitwise(data: bytes) -> int:
    c = 0xFFFFFFFF
    for byte in data:
        c ^= byte
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    return c ^ 0xFFFFFFFF


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    data = _data("random_bytes")[:2003]  # slices of 8 and a remainder
    assert zstd.crc32c(data) == _crc32c_bitwise(data)
