"""Pronunciation table: BERT token id -> pinyin syllable -> syllable class id.

The port's own copy of ``lyricalignment_tpu/text/pinyin.py``: the table,
``split_syllable`` and the PER phonemizer ``CharPhonemizer``. The table
itself is a data file, read by path from the JAX package's ``assets/``
directory rather than duplicated.

Class-id conventions: class 1 is the 'bad' bucket (tokens that are not a
single pinyin syllable), classes 2..402 are real syllables, and class 0 is
never produced by the table (the CTC blank / CE silence).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_TABLE_PATH = os.path.join(
    _REPO_DIR, "lyricalignment_tpu", "assets", "bert_base_chinese_pronunce_table.json")

IGNORE_ID = -100  # label-ignore convention shared with the reference

# Pinyin initials for strict=False splitting (pypinyin semantics: 'y'/'w'
# count as initials). Two-letter initials must be matched first.
_INITIALS_2 = ("zh", "ch", "sh")
_INITIALS_1 = ("b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
               "j", "q", "x", "r", "z", "c", "s", "y", "w")


@dataclass(frozen=True)
class PronunciationTable:
    """Dense token->syllable-class lookup plus the raw string tables."""

    token_pinyin: Tuple[str, ...]          # vocab_size strings ('bad' if not 1 syllable)
    pinyin_to_class: Dict[str, int]        # syllable string -> class id (1..402)
    pinyin_reverse: Dict[str, List[int]]   # syllable string -> token ids
    token_to_class: np.ndarray             # int32[vocab_size] dense gather table

    @property
    def vocab_size(self) -> int:
        return len(self.token_pinyin)

    @property
    def num_classes(self) -> int:
        # +1 for the never-emitted class 0 (silence / CTC blank)
        return max(self.pinyin_to_class.values()) + 1

    def map_tokens(self, token_ids: np.ndarray) -> np.ndarray:
        """Vectorised token-id -> syllable-class-id conversion; IGNORE_ID
        entries pass through unchanged."""
        token_ids = np.asarray(token_ids)
        valid = token_ids != IGNORE_ID
        safe = np.where(valid, token_ids, 0)
        mapped = self.token_to_class[safe]
        return np.where(valid, mapped, IGNORE_ID).astype(np.int32)

    def classes_of_text(self, text: str, char_to_token: Dict[str, int]) -> np.ndarray:
        """Map a string to syllable class ids given a char -> token-id vocab
        (characters outside it take token 0)."""
        ids = np.array([char_to_token.get(ch, 0) for ch in text], dtype=np.int32)
        return self.map_tokens(ids)


def load_pronunciation_table(path: str = DEFAULT_TABLE_PATH) -> PronunciationTable:
    """Load the 3-element JSON asset: [token_pinyin, pinyin_reverse,
    pinyin_lookup_table] (reference `get_pronunce_table.py:36-47`)."""
    with open(path, "r", encoding="utf-8") as f:
        token_pinyin, pinyin_reverse, pinyin_to_class = json.load(f)

    dense = np.array([pinyin_to_class[p] for p in token_pinyin], dtype=np.int32)
    return PronunciationTable(
        token_pinyin=tuple(token_pinyin),
        pinyin_to_class={k: int(v) for k, v in pinyin_to_class.items()},
        pinyin_reverse={k: list(v) for k, v in pinyin_reverse.items()},
        token_to_class=dense,
    )


def split_syllable(syllable: str) -> Tuple[str, str]:
    """Split a toneless pinyin syllable into (initial, final).

    Follows pypinyin's ``strict=False`` behaviour used by the reference's PER
    metric (`utils/CER.py:79-100`): 'y'/'w' are initials, the final is simply
    the remainder of the written syllable, and a vowel-initial syllable has an
    empty initial. Non-pinyin strings (e.g. punctuation passed through the
    phonemizer) are returned as (s, s), mirroring pypinyin's errors='default'
    passthrough for both the INITIALS and FINALS calls.
    """
    s = syllable
    if not s or not s[0].isalpha() or not s.isascii():
        return (s, s)
    low = s.lower()
    for ini in _INITIALS_2:
        if low.startswith(ini):
            return (ini, low[len(ini):])
    for ini in _INITIALS_1:
        if low.startswith(ini):
            return (ini, low[len(ini):])
    if all(c.isalpha() for c in low):
        return ("", low)
    return (s, s)


def load_phrase_readings(path: str) -> Dict[str, Tuple[str, ...]]:
    """External heteronym phrase table, merged OVER the embedded dict.

    JSON format: ``{"phrase": ["syl", "syl", ...], ...}`` — one toneless
    syllable per character (pypinyin ``lazy_pinyin`` NORMAL style). A user
    with pypinyin's phrase data (``pypinyin.phrases_dict``, toneless-ified)
    reaches exact PER parity with the reference's ``lazy_pinyin``
    (`utils/CER.py:79-95`) — the same external-asset policy as
    ``--bert-vocab`` / ``--whisper-bpe`` (zero-egress environments ship no
    third-party data). Pass the result as ``CharPhonemizer``'s
    ``phrase_readings``.
    """
    from lyricalignment_tpu_torch.text.heteronyms import HETERONYM_PHRASES

    with open(path, "r", encoding="utf-8") as f:
        user = json.load(f)
    for phrase, readings in user.items():
        if not phrase:
            # an empty key would later index p[0] in CharPhonemizer
            raise ValueError("phrase keys must be non-empty strings")
        if not isinstance(readings, (list, tuple)) or \
                len(readings) != len(phrase) or \
                not all(isinstance(r, str) for r in readings):
            raise ValueError(
                f"phrase {phrase!r} needs exactly one string syllable per "
                f"character, got {readings!r}")
    merged = dict(HETERONYM_PHRASES)
    merged.update({p: tuple(r) for p, r in user.items()})
    return merged


class CharPhonemizer:
    """text -> toneless pinyin syllables, built from the pronunciation table
    plus a BERT-style vocab (token string -> id).

    The reference phonemizes with pypinyin's ``lazy_pinyin`` over whole
    strings (`utils/CER.py:79-95`), which disambiguates polyphonic characters
    (多音字) through its phrase dictionary. With zero egress we reproduce
    that in two tiers:

    1. **Phrase tier** — greedy longest-match left-to-right against the
       embedded heteronym phrase dictionary (``text.heteronyms``), the same
       max-match strategy pypinyin's default segmenter applies to its
       phrases dict. This resolves 银行 -> ``yin hang``, 音乐 ->
       ``yin yue``, 重庆 -> ``chong qing`` etc.
    2. **Character tier** — ``vocab[char] -> token_pinyin[id]``: a single
       CJK character tokenises to itself in bert-base-chinese, so the
       shipped table reproduces ``lazy_pinyin(char)`` by construction.

    Characters outside both tiers (or mapping to 'bad') pass through
    unchanged, matching pypinyin's errors='default'. Residual gap: a
    heteronym inside a phrase absent from ``text.heteronyms`` falls back to
    its single table reading (README "Parity notes").
    """

    def __init__(self, table: PronunciationTable, char_to_token: Dict[str, int],
                 phrase_readings: Dict[str, Tuple[str, ...]] = None):
        from lyricalignment_tpu_torch.text.heteronyms import HETERONYM_PHRASES

        self._table = table
        self._vocab = char_to_token
        phrases = (HETERONYM_PHRASES if phrase_readings is None
                   else phrase_readings)
        # index by first char, longest phrase first (greedy max-match)
        self._by_first: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
        for p, readings in phrases.items():
            self._by_first.setdefault(p[0], []).append((p, tuple(readings)))
        for cands in self._by_first.values():
            cands.sort(key=lambda pr: len(pr[0]), reverse=True)

    def _char_reading(self, ch: str) -> str:
        tid = self._vocab.get(ch)
        if tid is None:
            return ch
        py = self._table.token_pinyin[tid]
        return ch if py == "bad" else py

    def knows(self, ch: str) -> bool:
        """True when the character has a real table reading (i.e. the PER
        phoneme stream for it is anchored to pypinyin's, rather than the
        character passing through as an opaque symbol)."""
        return self._char_reading(ch) != ch

    def __call__(self, text: str) -> List[str]:
        out: List[str] = []
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for phrase, readings in self._by_first.get(text[i], ()):
                if text.startswith(phrase, i):
                    out.extend(readings)
                    i += len(phrase)
                    matched = True
                    break
            if not matched:
                out.append(self._char_reading(text[i]))
                i += 1
        return out

    def phonemes(self, text: str) -> List[str]:
        """Interleaved [initial, final] sequence, as the reference's PER
        builds it (`utils/CER.py:84-95`)."""
        seq: List[str] = []
        for syl in self(text):
            ini, fin = split_syllable(syl)
            seq.append(ini)
            seq.append(fin)
        return seq
