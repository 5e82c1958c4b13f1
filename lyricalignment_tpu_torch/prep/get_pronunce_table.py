"""Offline prep: rebuild the BERT-token -> pinyin pronunciation table.

The port's own copy of ``lyricalignment_tpu/prep/get_pronunce_table.py``
(the reference's ``get_pronunce_table.py:11-47``): map every token of a
BERT vocab to its toneless pinyin ('bad' for anything that is not exactly
one syllable), build the reverse index and the syllable -> class-id table,
and dump the 3-element JSON that ``text/pinyin.py`` loads.

The shipped asset covers bert-base-chinese verbatim; run this only to
target another vocab. Phonemization uses pypinyin when it is installed (it
is imported only then), else an existing table JSON and its vocab seed
char -> pinyin.

Usage:
    python -m lyricalignment_tpu_torch.prep.get_pronunce_table <vocab.txt> <out.json> \\
        [--seed-table existing_table.json --seed-vocab vocab.txt]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List


def build_table(tokens: List[str], phonemize: Callable[[str], List[str]]):
    """(token_pinyin, pinyin_reverse, pinyin_lookup): each token's syllable
    or 'bad', the token ids of each syllable, and class ids from 1 in
    first-seen order."""
    token_pinyin: List[str] = []
    pinyin_reverse: Dict[str, List[int]] = {}
    for i, tok in enumerate(tokens):
        try:
            syllables = phonemize(tok)
        except Exception:  # any phonemizer failure makes the token 'bad'
            syllables = ["bad", "bad"]
        if len(syllables) == 1:
            py = syllables[0]
            token_pinyin.append(py)
            pinyin_reverse.setdefault(py, []).append(i)
        else:
            token_pinyin.append("bad")

    pinyin_lookup: Dict[str, int] = {}
    for py in token_pinyin:
        if py not in pinyin_lookup:
            pinyin_lookup[py] = len(pinyin_lookup) + 1
    return token_pinyin, pinyin_reverse, pinyin_lookup


def _pypinyin_phonemizer():
    from pypinyin import Style, lazy_pinyin

    def handle_error(chars):
        return ["bad", "bad"]

    return lambda tok: lazy_pinyin(tok, style=Style.NORMAL, errors=handle_error)


def _seed_table_phonemizer(seed_path: str, seed_vocab_path: str):
    """char -> pinyin lookup derived from an existing table and its vocab."""
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer
    from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table

    table = load_pronunciation_table(seed_path)
    vocab = BertWordPieceTokenizer(vocab_path=seed_vocab_path).char_to_id_map()
    char_py = {ch: table.token_pinyin[i] for ch, i in vocab.items()
               if i < len(table.token_pinyin)}

    def phonemize(tok: str) -> list:
        if len(tok) == 1 and tok in char_py and char_py[tok] != "bad":
            return [char_py[tok]]
        return ["bad", "bad"]

    return phonemize


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vocab", help="BERT-format vocab.txt")
    p.add_argument("output", help="output table JSON")
    p.add_argument("--seed-table", default=None,
                   help="existing table JSON to derive char->pinyin from "
                        "(offline fallback when pypinyin is unavailable)")
    p.add_argument("--seed-vocab", default=None,
                   help="vocab.txt matching --seed-table")
    args = p.parse_args(argv)

    with open(args.vocab, "r", encoding="utf-8") as f:
        tokens = [line.rstrip("\n") for line in f]

    try:
        phonemize = _pypinyin_phonemizer()
    except ImportError:
        if not (args.seed_table and args.seed_vocab):
            raise SystemExit(
                "pypinyin is not installed; pass --seed-table/--seed-vocab "
                "to bootstrap from an existing pronunciation table")
        phonemize = _seed_table_phonemizer(args.seed_table, args.seed_vocab)

    token_pinyin, pinyin_reverse, pinyin_lookup = build_table(tokens, phonemize)
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump([token_pinyin, pinyin_reverse, pinyin_lookup], f, indent=2)
    print(f"{len(tokens)} tokens, {len(pinyin_lookup)} classes -> {args.output}")


if __name__ == "__main__":
    main()
