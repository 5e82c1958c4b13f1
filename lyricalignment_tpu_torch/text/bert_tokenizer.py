"""Self-contained BERT-style WordPiece tokenizer (bert-base-chinese compat).

The port's own copy of ``lyricalignment_tpu/text/bert_tokenizer.py``.

The reference loads ``AutoTokenizer.from_pretrained('bert-base-chinese')``
(`train_multitask.py:649`) and uses it for (a) per-char lyric token ids that
index the pronunciation table and (b) batched padding with [CLS]/[SEP]
stripping in the collate (`dataset.py:215-220`). This implementation
reproduces the tokenization pipeline (basic tokenizer with CJK isolation +
greedy longest-match WordPiece) from a plain ``vocab.txt``, with zero
network or package dependencies. A vocab path can point at any BERT-format
vocabulary; bert-base-chinese's 21128-entry vocab.txt gives exact id parity.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


class BertWordPieceTokenizer:
    def __init__(
        self,
        vocab_path: Optional[str] = None,
        vocab: Optional[Dict[str, int]] = None,
        do_lower_case: bool = False,
        max_wordpiece_chars: int = 100,
    ):
        if vocab is None:
            if vocab_path is None or not os.path.exists(vocab_path):
                raise FileNotFoundError(
                    "BertWordPieceTokenizer needs a vocab.txt (BERT format, one "
                    "token per line). Pass vocab_path= pointing at a local "
                    "bert-base-chinese vocab.txt for id parity with the "
                    "reference (this environment has no network access)."
                )
            with open(vocab_path, "r", encoding="utf-8") as f:
                vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_wordpiece_chars = max_wordpiece_chars
        self.pad_id = vocab.get(PAD_TOKEN, 0)
        self.unk_id = vocab.get(UNK_TOKEN, 100)
        self.cls_id = vocab.get(CLS_TOKEN, 101)
        self.sep_id = vocab.get(SEP_TOKEN, 102)

    def __len__(self) -> int:
        return len(self.vocab)

    # -- basic tokenization ------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _tokenize_basic(self, text: str) -> List[str]:
        text = self._clean(text)
        # isolate CJK characters
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        tokens = []
        for tok in "".join(spaced).split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split punctuation
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_wordpiece_chars:
            return [UNK_TOKEN]
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK_TOKEN]
            pieces.append(piece)
            start = end
        return pieces

    # -- public API --------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self._tokenize_basic(text):
            out.extend(self._wordpiece(tok))
        return out

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), UNK_TOKEN) for i in ids]
        return " ".join(toks).replace(" ##", "")

    def batch_encode(self, texts: Iterable[str]) -> np.ndarray:
        """[CLS] x [SEP] encoding padded with pad_id, as the HF call in the
        reference's collate (`dataset.py:215-217`). Returns i32[B, S]."""
        encoded = [self.encode(t, add_special_tokens=True) for t in texts]
        max_len = max(len(e) for e in encoded)
        out = np.full((len(encoded), max_len), self.pad_id, np.int32)
        for i, e in enumerate(encoded):
            out[i, : len(e)] = e
        return out

    def char_to_id_map(self) -> Dict[str, int]:
        """Single-character vocab entries (covers all CJK chars) — used by
        the PER phonemizer and the pronunciation-table gather."""
        return {t: i for t, i in self.vocab.items() if len(t) == 1}


def make_synthetic_vocab(chars: str = "", size: int = 200) -> Dict[str, int]:
    """Tiny BERT-shaped vocab for tests and offline smoke runs: special
    tokens at the canonical bert-base-chinese ids (0/100/101/102)."""
    vocab: Dict[str, int] = {}
    specials = {PAD_TOKEN: 0, UNK_TOKEN: 100, CLS_TOKEN: 101, SEP_TOKEN: 102}
    next_id = 0

    def alloc() -> int:
        nonlocal next_id
        while next_id in specials.values():
            next_id += 1
        nid = next_id
        next_id += 1
        return nid

    for tok, tid in specials.items():
        vocab[tok] = tid
    for ch in chars:
        if ch not in vocab:
            vocab[ch] = alloc()
    i = 0
    while len(vocab) < size:
        tok = f"[unused{i}]"
        if tok not in vocab:
            vocab[tok] = alloc()
        i += 1
    return vocab
