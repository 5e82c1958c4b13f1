"""Offline prep: mix Opencpop vocals with random MUSDB accompaniment at a
target SNR.

The port's own copy of ``lyricalignment_tpu/prep/mix_with_musdb.py`` (the
reference's ``dataset_preprocessing/mix_with_musdb.py:22-100``, which as
committed cannot run: a syntax error at `:49`). Peak-normalise both sides
to 0.5, pick a random accompaniment segment (re-rolling segments whose mean
power is below 1e-4, and clips shorter than the vocal, where the reference
would crash on a negative randint range), scale down whichever side is too
loud so that the vocal / accompaniment power ratio is 10^(SNR/10), sum and
write PCM16. Seeded with the reference's 114514.

Usage:
    python -m lyricalignment_tpu_torch.prep.mix_with_musdb \\
        <vocal_dir> <output_dir> <musdb_dir> <snr_db>
"""

from __future__ import annotations

import math
import os
import random
import sys

import numpy as np

from lyricalignment_tpu_torch.data.audio_io import read_wav, write_wav


def peak_normalize(y: np.ndarray) -> np.ndarray:
    peak = np.abs(y).max()
    return y / peak if peak > 0 else y


def load_mono(path: str) -> tuple:
    data, sr = read_wav(path)
    return data.mean(axis=0) if data.shape[0] > 1 else data[0], sr


def pick_segment(pool, length: int, rng: random.Random) -> np.ndarray:
    """A random non-silent accompaniment segment of ``length`` samples."""
    for _ in range(1000):
        clip = pool[rng.randint(0, len(pool) - 1)]
        if len(clip) < length:
            continue
        start = rng.randint(0, len(clip) - length)
        seg = clip[start: start + length]
        if float(np.mean(seg ** 2)) >= 1e-4:
            return seg
    raise RuntimeError("no usable accompaniment segment found")


def mix_pair(vocal: np.ndarray, accomp: np.ndarray, snr_db: float) -> np.ndarray:
    """Energy-matched mix at the given vocal-to-accompaniment SNR."""
    y = peak_normalize(vocal) / 2.0
    inst = peak_normalize(accomp) / 2.0

    ratio = math.pow(10.0, snr_db / 10.0)
    y_pow = float(np.mean(y ** 2))
    i_pow = float(np.mean(inst ** 2))

    if i_pow * ratio > y_pow:
        inst = inst * math.sqrt(y_pow / (i_pow * ratio))
    else:
        y = y * math.sqrt((i_pow * ratio) / y_pow)
    return (y + inst).astype(np.float32)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 4:
        raise SystemExit(__doc__)
    audio_dir, out_dir, musdb_dir, snr = argv[0], argv[1], argv[2], float(argv[3])
    print("SNR:", snr)
    os.makedirs(out_dir, exist_ok=True)

    rng = random.Random(114514)
    pool = []
    for song in sorted(os.listdir(musdb_dir)):
        y, _ = load_mono(os.path.join(musdb_dir, song, "accompaniment.wav"))
        pool.append(peak_normalize(y))
    print(f"{len(pool)} accompaniment clips loaded")

    for name in sorted(os.listdir(audio_dir)):
        vocal, sr = load_mono(os.path.join(audio_dir, name))
        seg = pick_segment(pool, len(vocal), rng)
        write_wav(os.path.join(out_dir, name), mix_pair(vocal, seg, snr), sr)


if __name__ == "__main__":
    main()
