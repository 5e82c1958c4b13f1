"""Whisper tokenizer: special-token layout + optional BPE text codec.

The port's own copy of ``lyricalignment_tpu/text/whisper_tokenizer.py``.

The reference gets its tokenizer from the openai-whisper package
(`train_multitask.py:648`: ``get_tokenizer(multilingual=True,
task='transcribe')``) and uses: ``sot``, ``eot``, ``no_speech``,
``no_timestamps``, ``special_tokens['<|zh|>']``/``['<|transcribe|>']``,
``timestamp_begin`` and ``encode`` (`dataset.py:38-81`).

The special-token id layout is fully determined by the model family
(multilingual vs English-only) and is reproduced here without any data
files. Text encode/decode needs the BPE ranks; pass ``bpe_path`` pointing
at a ``*.tiktoken`` ranks file (base64 token + rank per line — the format
openai-whisper ships) to enable it. Without it, special-token ids and
timestamp arithmetic still work (enough for alignment training on
pre-tokenized data); ``encode``/``decode`` raise a clear error.
"""

from __future__ import annotations

import base64
import os
from typing import Dict, List, Optional, Sequence

# Whisper's 99 languages in canonical order (token id = sot + 1 + index).
# large-v3 models append "yue" as the 100th language, shifting every
# special token after the language block up by one (n_vocab 51866).
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()
LANGUAGES_V3 = LANGUAGES + ["yue"]


def num_languages_for_vocab(n_vocab: int) -> int:
    """Language count implied by a model's vocab size: 51866 (the v3
    family) carries 100 languages, everything else 99."""
    return 100 if n_vocab >= 51866 else 99


class WhisperTokenizer:
    def __init__(
        self,
        multilingual: bool = True,
        language: str = "zh",
        task: str = "transcribe",
        bpe_path: Optional[str] = None,
        num_languages: int = 99,
    ):
        self.multilingual = multilingual
        self.language = language
        self.task = task
        self.num_languages = num_languages
        self.languages = (LANGUAGES_V3 if num_languages == 100
                          else LANGUAGES[:num_languages])
        # text vocab size: 50257 GPT-2-style tokens for English-only,
        # 50257 + re-trained multilingual vocab -> eot sits at this offset
        self.eot = 50257 if multilingual else 50256
        self.sot = self.eot + 1
        n_langs = len(self.languages)
        self.translate = self.sot + n_langs + 1
        self.transcribe = self.sot + n_langs + 2
        self.sot_lm = self.sot + n_langs + 3
        self.sot_prev = self.sot + n_langs + 4
        self.no_speech = self.sot + n_langs + 5
        self.no_timestamps = self.sot + n_langs + 6
        self.timestamp_begin = self.no_timestamps + 1
        self.n_vocab = self.timestamp_begin + 1501

        self.special_tokens: Dict[str, int] = {
            "<|endoftext|>": self.eot,
            "<|startoftranscript|>": self.sot,
            "<|translate|>": self.translate,
            "<|transcribe|>": self.transcribe,
            "<|startoflm|>": self.sot_lm,
            "<|startofprev|>": self.sot_prev,
            "<|nospeech|>": self.no_speech,
            "<|notimestamps|>": self.no_timestamps,
        }
        for i, lang in enumerate(self.languages):
            self.special_tokens[f"<|{lang}|>"] = self.sot + 1 + i

        self._encoding = None
        if bpe_path is not None:
            self._encoding = _load_tiktoken_encoding(bpe_path, self.special_tokens, self.eot)

    # -- prompt construction ----------------------------------------------
    @property
    def sot_sequence(self) -> List[int]:
        if not self.multilingual:
            return [self.sot]
        seq = [self.sot, self.special_tokens[f"<|{self.language}|>"]]
        seq.append(self.transcribe if self.task == "transcribe" else self.translate)
        return seq

    def timestamp_token(self, seconds: float) -> int:
        """<|t|> id for a timestamp: reference uses
        ``timestamp_begin + (t * 100 // 2)`` (`dataset.py:73-74`)."""
        return int(self.timestamp_begin + (seconds * 100 // 2))

    # -- text codec --------------------------------------------------------
    @property
    def has_bpe(self) -> bool:
        return self._encoding is not None

    def encode(self, text: str) -> List[int]:
        if self._encoding is None:
            raise RuntimeError(
                "Text encoding needs BPE ranks: construct WhisperTokenizer "
                "with bpe_path= pointing at whisper's multilingual.tiktoken."
            )
        return self._encoding.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        if self._encoding is None:
            raise RuntimeError("Text decoding needs BPE ranks (see encode).")
        ids = [int(i) for i in ids if int(i) < self.eot]
        try:
            return self._encoding.decode(ids)
        except KeyError:
            # ids outside the ranks table (possible with partial/synthetic
            # ranks files): best-effort skip of unknown tokens
            parts = []
            for i in ids:
                try:
                    parts.append(self._encoding.decode_single_token_bytes(i))
                except KeyError:
                    continue
            return b"".join(parts).decode("utf-8", errors="replace")

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        out = []
        chunk: List[int] = []
        for i in ids:
            i = int(i)
            if i >= self.timestamp_begin:
                if chunk:
                    out.append(self.decode(chunk))
                    chunk = []
                out.append(f"<|{(i - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                chunk.append(i)
        if chunk:
            out.append(self.decode(chunk))
        return "".join(out)


def _load_tiktoken_encoding(path: str, special_tokens: Dict[str, int], n_text: int):
    """Build a tiktoken Encoding from a ranks file (no network)."""
    import tiktoken

    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)

    specials = dict(special_tokens)
    # timestamps are appended after the named specials in whisper's encoding
    ts_base = max(special_tokens.values()) + 1
    for i in range(1501):
        specials[f"<|{i * 0.02:.2f}|>"] = ts_base + i

    # no explicit_n_vocab: synthetic/partial ranks files (tests) would fail
    # tiktoken's contiguity check; whisper's real file is already consistent
    return tiktoken.Encoding(
        name=os.path.basename(path),
        pat_str=(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
        ),
        mergeable_ranks=ranks,
        special_tokens=specials,
    )


# whisper's non-speech symbol list (tokenizer.non_speech_tokens): tokens that
# never occur in real transcripts — music/markup symbols suppressed during
# decoding unless sampling demands otherwise.
_NON_SPEECH_SYMBOLS = (
    '"', "#", "(", ")", "*", "+", "/", ":", ";", "<", "=", ">", "@", "[",
    "\\", "]", "^", "_", "`", "{", "|", "}", "~", "「", "」", "『", "』",
    "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", '("', "((",
    "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪", "♩", "♪",
    "♫", "♬", "♭", "♮", "♯",
)


def non_speech_token_ids(tokenizer: "WhisperTokenizer") -> list:
    """Ids of whisper's suppressed non-speech symbols (needs BPE ranks).

    Mirrors ``whisper.tokenizer.Tokenizer.non_speech_tokens``: for each
    symbol, the id of the symbol itself and of " symbol", kept only when
    the symbol encodes to a single token.
    """
    if not tokenizer.has_bpe:
        return []
    ids = set()
    for sym in _NON_SPEECH_SYMBOLS:
        for variant in (sym, " " + sym):
            toks = tokenizer.encode(variant)
            if len(toks) == 1:
                ids.add(toks[0])
    return sorted(ids)
