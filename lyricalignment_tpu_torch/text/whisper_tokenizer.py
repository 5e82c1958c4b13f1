"""Whisper tokenizer: the special-token layout.

The port's own copy of ``lyricalignment_tpu/text/whisper_tokenizer.py:24-147``
without its tiktoken BPE codec, which is not ported yet: ``bpe_path`` raises,
and ``encode``/``decode`` raise as the JAX tokenizer does without BPE ranks.

The reference gets its tokenizer from the openai-whisper package
(`train_multitask.py:648`: ``get_tokenizer(multilingual=True,
task='transcribe')``) and uses: ``sot``, ``eot``, ``no_speech``,
``no_timestamps``, ``special_tokens['<|zh|>']``/``['<|transcribe|>']``,
``timestamp_begin`` and ``encode`` (`dataset.py:38-81`).

The special-token id layout is fully determined by the model family
(multilingual vs English-only) and is reproduced here without any data
files. Special-token ids and timestamp arithmetic work without BPE ranks
(enough for alignment training); text encode/decode needs the codec.
"""

from __future__ import annotations

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

        if bpe_path is not None:
            raise NotImplementedError(
                "whisper BPE ranks: the tiktoken text codec is not ported yet")

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

    # -- text codec (not ported yet) --------------------------------------
    @property
    def has_bpe(self) -> bool:
        return False

    def encode(self, text: str) -> List[int]:
        raise RuntimeError(
            "Text encoding needs BPE ranks: the tiktoken codec is not ported yet.")

    def decode(self, ids: Sequence[int]) -> str:
        raise RuntimeError("Text decoding needs BPE ranks (see encode).")
