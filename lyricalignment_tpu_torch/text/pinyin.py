"""Pronunciation table: BERT token id -> pinyin syllable -> syllable class id.

The port's own copy of the table half of ``lyricalignment_tpu/text/pinyin.py``
(the phonemizer is not ported yet). The table itself is a data file, read by
path from the JAX package's ``assets/`` directory rather than duplicated.

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


@dataclass(frozen=True)
class PronunciationTable:
    """Dense token->syllable-class lookup plus the raw string tables."""

    token_pinyin: Tuple[str, ...]          # vocab_size strings ('bad' if not 1 syllable)
    pinyin_to_class: Dict[str, int]        # syllable string -> class id (1..402)
    pinyin_reverse: Dict[str, List[int]]   # syllable string -> token ids
    token_to_class: np.ndarray             # int32[vocab_size] dense gather table

    def map_tokens(self, token_ids: np.ndarray) -> np.ndarray:
        """Vectorised token-id -> syllable-class-id conversion; IGNORE_ID
        entries pass through unchanged."""
        token_ids = np.asarray(token_ids)
        valid = token_ids != IGNORE_ID
        safe = np.where(valid, token_ids, 0)
        mapped = self.token_to_class[safe]
        return np.where(valid, mapped, IGNORE_ID).astype(np.int32)


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
