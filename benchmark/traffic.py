"""The one traffic generator: every mix is a data file of parameters under
``benchmark/traffic/<name>.json`` that this module reads.

From the seed it writes a pool of WAV requests (16 kHz mono, or 44.1 kHz
stereo for a share of them, so the loader's resampler runs), each a sung
line stand-in (a tone with a slow envelope and noise) with a lyric drawn
from a pool of characters, and the synthetic BERT vocabulary that maps those
characters onto real syllables of the pronunciation table. The sizes (the
request lengths and lyric lengths) are the same for every seed, laid out as
``groups`` groups of ``per_group`` evenly spaced values; the seed only
shuffles them and draws the content, so two seeds ask for the same work.

Parameters (all mixes): ``pool_groups``, ``per_group``, ``seconds`` [lo,
hi], ``lyric_chars`` [lo, hi], ``stereo_44k_share``; and each entry's own
(see ``benchmark/entries``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the pronunciation table, a data file the program reads too
TABLE_PATH = os.path.join(ROOT, "lyricalignment_tpu", "assets",
                          "bert_base_chinese_pronunce_table.json")
# lyric characters: single CJK characters, each its own BERT token
CHARS = "天地玄黄宇宙洪荒日月盈昃辰宿列张寒来暑往秋收冬藏闰余成岁律吕调阳云腾致雨露结为霜金生丽水玉出昆冈"
VOCAB_SIZE = 21128
SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]"}


@dataclass
class Request:
    path: str
    seconds: float          # true length of the audio
    sample_rate: int
    channels: int
    lyric: str
    onset_offset: Optional[List[List[float]]] = None   # ground truth (training)


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, *stream])


def write_vocab(dirname: str) -> str:
    """vocab.txt (one token a line, the id its line number) with the
    special tokens at bert-base-chinese's ids and the lyric characters at
    ids whose table entry is a real syllable (every 7th such id): 43
    syllable classes among the 48 characters. Returns its path."""
    with open(TABLE_PATH, encoding="utf-8") as f:
        token_pinyin = json.load(f)[0]
    good = [i for i, p in enumerate(token_pinyin) if p != "bad" and i not in SPECIALS]
    lines = [f"[unused{i}]" for i in range(VOCAB_SIZE)]
    for i, tok in SPECIALS.items():
        lines[i] = tok
    for ch, tid in zip(dict.fromkeys(CHARS), good[::7]):
        lines[tid] = ch
    path = os.path.join(dirname, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _sizes(params: Dict, key: str) -> np.ndarray:
    lo, hi = params[key]
    return np.tile(np.linspace(lo, hi, params["per_group"]), params["pool_groups"])


def _write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """PCM16 WAV of mono [n] or [channels, n] float audio."""
    import wave

    audio = np.atleast_2d(audio)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.T.reshape(-1).tobytes())


def _ground_truth(rng, n_chars: int, seconds: float) -> List[List[float]]:
    """Increasing [onset, offset] seconds a character over the audio, with
    gaps between them."""
    cuts = np.sort(rng.uniform(0.2, seconds - 0.2, 2 * n_chars))
    return [[round(float(cuts[2 * i]), 3), round(float(cuts[2 * i + 1]), 3)]
            for i in range(n_chars)]


def write_pool(params: Dict, seed: int, dirname: str) -> List[Request]:
    """The mix's pool of requests, written into ``dirname``."""
    os.makedirs(dirname, exist_ok=True)
    rng = rng_of(seed, 1)
    seconds = _sizes(params, "seconds")
    chars = np.round(_sizes(params, "lyric_chars")).astype(int)
    n = len(seconds)
    order = rng.permutation(n)
    seconds, chars = seconds[order], chars[order]
    stereo = set(rng.permutation(n)[:int(round(params.get("stereo_44k_share", 0.0) * n))].tolist())
    with_truth = params.get("alignment_share", 0.0)
    truth = set(rng.permutation(n)[:int(round(with_truth * n))].tolist())
    pool = []
    for i in range(n):
        sr = 44100 if i in stereo else 16000
        t = np.arange(int(round(seconds[i] * sr))) / sr
        f0 = rng.uniform(110.0, 330.0)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t + rng.uniform(0, 6.3))
        audio = 0.2 * env * np.sin(2 * np.pi * f0 * t) + 0.03 * rng.standard_normal(t.shape)
        if i in stereo:
            audio = np.stack([audio, 0.8 * audio + 0.03 * rng.standard_normal(t.shape)])
        path = os.path.join(dirname, f"req{i:04d}.wav")
        _write_wav(path, audio.astype(np.float32), sr)
        lyric = "".join(rng.choice(list(CHARS), int(chars[i])))
        gt = _ground_truth(rng, len(lyric), len(t) / sr) if i in truth else None
        pool.append(Request(path, len(t) / sr, sr, 2 if i in stereo else 1, lyric, gt))
    return pool


def call_plan(params: Dict, seed: int, n_pool: int, per_call: int, n_calls: int) -> List[List[int]]:
    """Pool indices of each call: the pool in a seeded order, taken
    ``per_call`` at a time, the order drawn anew each pass over the pool."""
    rng = rng_of(seed, 2)
    out, queue = [], []
    for _ in range(n_calls):
        while len(queue) < per_call:
            queue.extend(rng.permutation(n_pool).tolist())
        out.append(queue[:per_call])
        queue = queue[per_call:]
    return out
