"""Pronunciation table and text normalisers."""

from lyricalignment_tpu_torch.text.normalize import remove_english, to_simplified
from lyricalignment_tpu_torch.text.pinyin import (
    PronunciationTable,
    load_pronunciation_table,
    split_syllable,
)

__all__ = [
    "PronunciationTable",
    "load_pronunciation_table",
    "split_syllable",
    "remove_english",
    "to_simplified",
]
