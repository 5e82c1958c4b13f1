"""Offline prep: write the resolved ``song_path`` into a dataset JSON.

The port's own copy of ``lyricalignment_tpu/prep/replace_path.py`` (the
reference's ``dataset_preprocessing/replace_path.py:10-29``):
``song_path = resolve(target_dir / song_id)`` for every entry.

Usage:
    python -m lyricalignment_tpu_torch.prep.replace_path <in.json> <out.json> <target_dir>
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def replace_paths(data, target_dir: str):
    for entry in data:
        entry["song_path"] = str((Path(target_dir) / entry["song_id"]).resolve())
    return data


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        raise SystemExit(__doc__)
    data_path, output_path, target_dir = argv
    with open(data_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    data = replace_paths(data, target_dir)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=4, ensure_ascii=False)


if __name__ == "__main__":
    main()
