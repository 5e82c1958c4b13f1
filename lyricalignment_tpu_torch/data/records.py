"""Dataset record model: one audio file + its lyric (+ optional char timings).

The port's own copy of ``lyricalignment_tpu/data/records.py``.

JSON schema parity with the reference (`data_processor/record.py:8-38`):
each dataset file is a list of objects with keys ``song_path``, ``lyric`` and
optionally ``on_offset`` (list of [onset_sec, offset_sec] per character).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Record:
    audio_path: str
    text: str
    lyric_onset_offset: Optional[List[List[float]]] = None

    @property
    def has_alignment(self) -> bool:
        return self.lyric_onset_offset is not None


def read_data(data_path: str) -> List[Record]:
    """Parse one dataset JSON into records."""
    if not os.path.exists(data_path):
        raise FileNotFoundError(data_path)
    with open(data_path, "r", encoding="utf-8") as f:
        data_list = json.load(f)

    records = []
    for data in data_list:
        records.append(
            Record(
                audio_path=data["song_path"],
                text=data["lyric"],
                lyric_onset_offset=data.get("on_offset"),
            )
        )
    return records



def read_many(*data_paths: str) -> List[Record]:
    records: List[Record] = []
    for path in data_paths:
        records.extend(read_data(path))
    return records
