"""High-level library API for alignment and transcription (port of
``lyricalignment_tpu/api.py``):

    from lyricalignment_tpu_torch.api import LyricAligner

    aligner = LyricAligner.from_model_dir("result", bert_vocab="vocab.txt",
                                          use_ctc=True)
    segments = aligner.align("song.wav", "你好世界")   # [[on, off, char], ...]
    error = aligner.mae("song.wav", "你好世界", ground_truth_onoff)
    text = aligner.transcribe("song.wav", whisper_bpe="multilingual.tiktoken")

The model runs on the device it was loaded to (``device="cuda"`` by
default).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

from lyricalignment_tpu_torch.utils.metrics import mae as mae_metric


class LyricAligner:
    def __init__(self, model, bert_tokenizer, table, use_ctc: bool = False,
                 bucket_seconds: float = 5.0, max_label_len: int = 128,
                 batch_size: int = 8):
        self.model = model
        self.bert = bert_tokenizer
        self.table = table
        self.use_ctc = use_ctc
        self.bucket_seconds = bucket_seconds
        self.max_label_len = max_label_len
        # device batch cap: requests are padded to the next power of two up
        # to this size
        self.batch_size = max(1, batch_size)

    @classmethod
    def from_model_dir(
        cls,
        model_dir: str,
        model_name: str = "best",
        bert_vocab: Optional[str] = None,
        synthetic_vocab: bool = False,
        use_ctc: bool = False,
        bf16: bool = False,
        device: str = "cuda",
        **kwargs,
    ) -> "LyricAligner":
        from lyricalignment_tpu_torch.cli.common import load_model_dir
        from lyricalignment_tpu_torch.text.bert_tokenizer import (
            BertWordPieceTokenizer,
            make_synthetic_vocab,
        )
        from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table

        _, model, _ = load_model_dir(model_dir, model_name, use_bf16=bf16,
                                     device=device)
        if bert_vocab:
            bert = BertWordPieceTokenizer(vocab_path=bert_vocab)
        elif synthetic_vocab:
            bert = BertWordPieceTokenizer(vocab=make_synthetic_vocab(size=21128))
        else:
            raise ValueError("pass bert_vocab= (vocab.txt) or synthetic_vocab=True")
        return cls(model, bert, load_pronunciation_table(), use_ctc=use_ctc, **kwargs)

    def align(self, audio_path: str, lyric: str) -> List[list]:
        """Forced-align one song: [[onset_s, offset_s, char], ...]."""
        return self.align_many([(audio_path, lyric)])[0]

    def align_many(self, requests: Sequence[Sequence[str]]) -> List[List[list]]:
        """Forced-align a batch of ``(audio_path, lyric)`` pairs, length-
        bucketed so each batch shares one encoder/Viterbi pass. Returns one
        ``[[onset_s, offset_s, char], ...]`` list per request, in input
        order."""
        from lyricalignment_tpu_torch.cli.inference_alignment import align_records
        from lyricalignment_tpu_torch.data.records import Record
        from lyricalignment_tpu_torch.utils.observability import trace

        records = [Record(audio_path=p, text=t) for p, t in requests]
        args = SimpleNamespace(
            use_ctc_loss=self.use_ctc, is_mixture=0,
            bucket_seconds=self.bucket_seconds,
            max_label_len=self.max_label_len, batch_size=self.batch_size)
        with trace("align.call"):
            out = list(align_records(records, self.model, self.table, self.bert, args))
        return [[[on, off, ch] for (on, off), ch in zip(segments, record.text)]
                for record, segments in out]

    def mae(self, audio_path: str, lyric: str,
            ground_truth: Sequence[Sequence[float]]) -> float:
        segments = self.align(audio_path, lyric)
        return float(mae_metric([list(ground_truth)],
                                [[[s[0], s[1]] for s in segments]]))

    def transcribe(self, audio_path: str, **kwargs) -> str:
        """Transcribe one song; >30 s audio runs whisper's sequential seek
        decode (``decode.longform``) unless ``fast_windows=True``."""
        return self.transcribe_many([audio_path], **kwargs)[0]

    def transcribe_many(
        self,
        audio_paths: Sequence[str],
        whisper_bpe: Optional[str] = None,
        beam_size: int = 5,
        max_new_tokens: int = 224,
        language: str = "zh",
        fast_windows: bool = False,
        length_penalty: Optional[float] = None,
        patience: Optional[float] = None,
        condition_on_previous_text: bool = True,
        temperature_fallback: bool = False,
        batch_size: Optional[int] = None,
    ) -> List[str]:
        """Transcribe a batch of songs with the model's whisper
        (``cli.inference_transcript.transcribe_records``): single-window
        audio shares fixed-size batched beam searches; results come back in
        input order. ``batch_size`` caps the decode batch; the default is
        the aligner's ``batch_size`` capped at 8, the transcript CLI's
        default."""
        from lyricalignment_tpu_torch.cli.inference_transcript import transcribe_records
        from lyricalignment_tpu_torch.data.records import Record
        from lyricalignment_tpu_torch.text.whisper_tokenizer import (
            WhisperTokenizer,
            num_languages_for_vocab,
        )
        from lyricalignment_tpu_torch.utils.observability import trace

        wcfg = self.model.cfg.whisper
        wt = WhisperTokenizer(
            multilingual=True, language=language, task="transcribe",
            bpe_path=whisper_bpe, num_languages=num_languages_for_vocab(wcfg.n_vocab))
        if batch_size is None:
            batch_size = min(self.batch_size, 8)
        args = SimpleNamespace(
            is_mixture=0, batch_size=max(1, batch_size), beam_size=beam_size,
            max_new_tokens=max_new_tokens, use_groundtruth=False,
            temperature_fallback=temperature_fallback,
            fast_windows=fast_windows, length_penalty=length_penalty,
            patience=patience,
            no_condition_on_previous_text=not condition_on_previous_text,
            seed=114514,
        )
        with trace("transcribe.call"):
            results = transcribe_records(
                [Record(audio_path=p, text="") for p in audio_paths],
                self.model.whisper_model, wcfg, wt, args)
        return [r["inference"] for r in results]
