"""Result-JSON postprocessing CLI (host only).

Port of ``lyricalignment_tpu/cli/postprocess.py`` (the reference's
``utils/postprocess.py:27-41``): rewrites each result file in place,
converting every ``inference`` field to simplified Chinese and stripping
spaces and English letters.

``--t2s-overrides`` merges extra traditional->simplified pairs over the
embedded table; ``--strict-normalize`` exits 2 when a character survives
conversion with no t2s entry (without it, such characters are reported on
stderr).

    python -m lyricalignment_tpu_torch.cli.postprocess -f result1.json [result2.json ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

from lyricalignment_tpu_torch.text.normalize import (
    format_gap_report,
    load_t2s_overrides,
    normalization_gaps,
    remove_english,
    to_simplified,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input-file", "-f", nargs="+", required=True)
    p.add_argument("--key", default="inference")
    p.add_argument("--t2s-overrides", type=str, default=None,
                   help="JSON {traditional: simplified} pairs merged over "
                        "the embedded t2s table")
    p.add_argument("--strict-normalize", action="store_true",
                   help="exit non-zero if any character survives conversion "
                        "with no t2s entry (default: warn to stderr)")
    return p.parse_args(argv)


def postprocess_entry(text: str, t2s_overrides: Optional[Dict[str, str]] = None) -> str:
    return remove_english(to_simplified(text, overrides=t2s_overrides).replace(" ", ""))


def main(argv=None):
    args = parse_args(argv)
    t2s = load_t2s_overrides(args.t2s_overrides) if args.t2s_overrides else None
    gaps: Dict[str, int] = {}
    for file in args.input_file:
        with open(file, "r", encoding="utf-8") as f:
            data = json.load(f)
        for entry in data:
            entry[args.key] = postprocess_entry(entry[args.key], t2s)
            for ch, n in normalization_gaps(entry[args.key]).items():
                gaps[ch] = gaps.get(ch, 0) + n
        with open(file, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=4, ensure_ascii=False)
    if gaps:
        print(format_gap_report(gaps, anchor="outside the t2s table",
                                remedy="extend coverage with --t2s-overrides"),
              file=sys.stderr)
        if args.strict_normalize:
            raise SystemExit(2)


if __name__ == "__main__":
    main()
