"""Transcript evaluation CLI: CER + PER with op counts.

The port's own copy of ``lyricalignment_tpu/cli/evaluate_transcript.py``
(host only: it runs no model). A re-design of the reference's
``evaluate_transcript.py`` (`:35-109`): read a result JSON, normalise both
sides (strip English/spaces/periods, traditional -> simplified), and print
CER and PER with substitution/insertion/deletion/correct counts.

The PER phonemizer derives char -> pinyin from the shipped pronunciation
table + a BERT vocab (pypinyin is not required); pass --bert-vocab for
full coverage, or rely on passthrough for unknown characters.

Closing the residual parity gaps with external assets (same policy as
--bert-vocab / --whisper-bpe — zero egress ships no third-party data):

* ``--pinyin-phrases phrases.json`` — heteronym phrase readings merged
  over the embedded dict (``text.heteronyms``); with pypinyin's phrase
  data the PER phoneme stream matches ``lazy_pinyin`` exactly.
* ``--t2s-overrides t2s.json`` — extra traditional->simplified pairs
  merged over the embedded table.
* ``--strict-normalize`` — exit non-zero when any evaluated character has
  neither a t2s entry nor a pronunciation-table reading (silent-divergence
  candidates vs the reference's chinese_converter/pypinyin normalizer).
  Without the flag such characters still WARN to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from lyricalignment_tpu_torch.cli.common import add_asset_args
from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer, make_synthetic_vocab
from lyricalignment_tpu_torch.text.normalize import (
    format_gap_report, normalization_gaps, normalize_for_eval)
from lyricalignment_tpu_torch.text.pinyin import (
    CharPhonemizer, load_phrase_readings, load_pronunciation_table)
from lyricalignment_tpu_torch.utils.metrics import cer, per


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", "--result-file", type=str, required=True)
    p.add_argument("--ref-text-key", type=str, default="lyric")
    p.add_argument("--pred-text-key", type=str, default="inference")
    p.add_argument("--pinyin-phrases", type=str, default=None,
                   help="JSON {phrase: [syllable, ...]} heteronym readings, "
                        "merged over the embedded dict (exact lazy_pinyin "
                        "parity with pypinyin's phrase data)")
    p.add_argument("--t2s-overrides", type=str, default=None,
                   help="JSON {traditional: simplified} pairs merged over "
                        "the embedded t2s table")
    p.add_argument("--strict-normalize", action="store_true",
                   help="exit non-zero if any evaluated character has "
                        "neither a t2s entry nor a pronunciation-table "
                        "reading (default: warn to stderr)")
    add_asset_args(p)
    return p.parse_args(argv)


def compute_cer(reference: List[str], prediction: List[str],
                phonemize=None, is_per: bool = False,
                t2s_overrides: Optional[Dict[str, str]] = None):
    metric_name = "PER" if is_per else "CER"
    weighted = 0.0
    op_count = {"substitution": 0, "insertion": 0, "deletion": 0, "correct": 0}

    for ref, pred in zip(reference, prediction):
        pred = normalize_for_eval(pred, t2s_overrides)
        ref = normalize_for_eval(ref, t2s_overrides)
        if is_per:
            rate, nb = per(pred, ref, phonemize)
        else:
            try:
                rate, nb = cer(list(pred), list(ref))
            except ZeroDivisionError:
                rate, nb = 1.0, {"S": 0, "I": len(pred), "D": 0, "C": 0}
        weighted += rate
        op_count["substitution"] += nb["S"]
        op_count["insertion"] += nb["I"]
        op_count["deletion"] += nb["D"]
        op_count["correct"] += nb["C"]

    print("=" * 30)
    print(f"{metric_name}:", weighted / len(reference))
    print("Wrong Operations:")
    for key, value in op_count.items():
        print(f"{key}: {value}")
    print("=" * 30)
    return weighted / len(reference), op_count


def report_gaps(texts: List[str], has_reading,
                t2s_overrides: Optional[Dict[str, str]]) -> bool:
    """Surface silent-divergence candidates (VERDICT r4 #6). Returns True
    when any were found. ``has_reading`` is ``CharPhonemizer.knows`` when a
    real vocab anchors the pronunciation table, or None for the conservative
    rare-block-only check."""
    gaps: Dict[str, int] = {}
    for t in texts:
        for ch, n in normalization_gaps(
                normalize_for_eval(t, t2s_overrides),
                has_reading=has_reading).items():
            gaps[ch] = gaps.get(ch, 0) + n
    if not gaps:
        return False
    print(format_gap_report(
        gaps,
        anchor="with no t2s entry and no pronunciation-table reading",
        remedy="CER/PER may diverge from the reference's chinese_converter/"
               "pypinyin on these; extend coverage with --t2s-overrides / "
               "--pinyin-phrases / --bert-vocab"),
        file=sys.stderr)
    return True


def main(argv=None):
    args = parse_args(argv)
    assert os.path.exists(args.result_file)
    with open(args.result_file, "r", encoding="utf-8") as f:
        results = json.load(f)

    refs = [r[args.ref_text_key] for r in results]
    preds = [r[args.pred_text_key] for r in results]

    table = load_pronunciation_table()
    if args.bert_vocab:
        bert = BertWordPieceTokenizer(vocab_path=args.bert_vocab)
    else:
        bert = BertWordPieceTokenizer(vocab=make_synthetic_vocab(size=21128))
    phrases = (load_phrase_readings(args.pinyin_phrases)
               if args.pinyin_phrases else None)
    phonemize = CharPhonemizer(table, bert.char_to_id_map(),
                               phrase_readings=phrases)
    t2s = None
    if args.t2s_overrides:
        from lyricalignment_tpu_torch.text.normalize import load_t2s_overrides
        t2s = load_t2s_overrides(args.t2s_overrides)

    compute_cer(refs, preds, t2s_overrides=t2s)
    compute_cer(refs, preds, phonemize=phonemize, is_per=True,
                t2s_overrides=t2s)

    # gap reporting needs real readings to be meaningful: the synthetic
    # vocab (no --bert-vocab) knows no real characters, so using its
    # phonemizer would flag EVERY character — fall back to the conservative
    # rare-block-only check (has_reading=None) in that case, and only
    # report at all when a real vocab is loaded or strictness was asked for
    if args.bert_vocab or args.strict_normalize:
        found = report_gaps(refs + preds,
                            phonemize.knows if args.bert_vocab else None,
                            t2s)
        if found and args.strict_normalize:
            raise SystemExit(2)


if __name__ == "__main__":
    main()
