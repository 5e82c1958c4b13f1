"""Host-side data pipeline: records -> fixed-shape multitask batches.

The port's own copy of ``lyricalignment_tpu/data/pipeline.py:44-259``, a
rewrite of the reference's dataset/collate/split machinery
(`dataset.py:154-266`, `train_multitask.py:166-211`):

  * every batch has fixed shapes — audio padded to a fixed window,
    labels/decoder sequences padded to configured maxima;
  * the reference's dynamic ``split_batch`` into multitask/transcript
    sub-batches becomes a per-sample ``has_alignment`` mask consumed by
    masked losses (`train_multitask.py:188-211` equivalent);
  * the per-batch Python double-loop converting BERT token ids to pinyin
    classes (`train_multitask.py:260-269`) is done once per example as a
    vectorised gather at build time;
  * audio is zero-padded to the full 30 s window up front. (The reference
    pads audio to the batch max and then zero-pads the *mel* to 3000 frames
    — `module/align_model.py:78-82,109`; the difference only touches
    padding frames, which are loss-masked.)

Transcript-only samples note: the reference computes CTC for those batches
against **raw BERT token ids** (the pinyin conversion at
`train_multitask.py:260-269` only runs on the multitask sub-batch, but the
CTC at `:313` uses ``transcript_batch[1]`` unconverted). That is a class-id
inconsistency in the reference; this pipeline converts every sample's CTC
labels to pinyin classes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from lyricalignment_tpu_torch import EMBED_FRAMES, N_SAMPLES
from lyricalignment_tpu_torch.data.audio_io import load_audio_file
from lyricalignment_tpu_torch.data.frames import rasterize_frame_labels
from lyricalignment_tpu_torch.data.records import Record
from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer
from lyricalignment_tpu_torch.text.pinyin import IGNORE_ID, PronunciationTable
from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer


@dataclass(frozen=True)
class PipelineConfig:
    batch_size: int = 2
    max_audio_samples: int = N_SAMPLES        # 30 s window
    max_label_len: int = 128                  # lyric chars (incl. [SEP] slot)
    max_frames: int = EMBED_FRAMES            # 1500 alignment frames
    max_decoder_len: int = 160                # whisper prompt + text + eot
    use_ctc: bool = False
    with_timestamps: bool = False             # per-char timestamp tokens
    language: str = "zh"
    audio_type: int = 0                       # see data/audio_io.py
    drop_remainder: bool = True


@dataclass
class MultitaskBatch:
    """One fixed-shape batch: numpy arrays for the device + host metadata."""

    audio: np.ndarray            # f32[B, max_audio_samples]
    ctc_labels: np.ndarray       # i32[B, L] pinyin classes, -100 padded (left-packed)
    frame_labels: np.ndarray     # i32[B, max_frames] pinyin classes / fill
    label_lengths: np.ndarray    # i32[B] true lyric length
    has_alignment: np.ndarray    # bool[B]
    decoder_input: np.ndarray    # i32[B, S], 0 padded
    decoder_output: np.ndarray   # i32[B, S], -100 padded
    onset_offset: List[Optional[List[List[float]]]]  # host-side ground truth
    texts: List[str]

    def device_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "audio": self.audio,
            "ctc_labels": self.ctc_labels,
            "frame_labels": self.frame_labels,
            "label_lengths": self.label_lengths,
            "has_alignment": self.has_alignment,
            "decoder_input": self.decoder_input,
            "decoder_output": self.decoder_output,
        }


class MultitaskExampleBuilder:
    """record -> padded example arrays (the __getitem__+collate equivalent)."""

    def __init__(
        self,
        bert_tokenizer: BertWordPieceTokenizer,
        whisper_tokenizer: Optional[WhisperTokenizer],
        table: PronunciationTable,
        cfg: PipelineConfig,
    ):
        self.bert = bert_tokenizer
        self.whisper = whisper_tokenizer
        self.table = table
        self.cfg = cfg

    def lyric_token_ids(self, text: str) -> np.ndarray:
        """BERT ids of the lyric, no special tokens. Net-equivalent of the
        reference's [CLS]-strip + pad/[SEP]->-100 (`dataset.py:215-220`)."""
        return np.asarray(self.bert.encode(text, add_special_tokens=False), np.int32)

    def pinyin_classes(self, text: str) -> np.ndarray:
        return self.table.map_tokens(self.lyric_token_ids(text))

    def decoder_sequences(self, record: Record):
        cfg = self.cfg
        if self.whisper is None or not self.whisper.has_bpe:
            return None
        wt = self.whisper
        if cfg.with_timestamps and record.lyric_onset_offset is not None:
            text_tokens: List[int] = []
            for ch, (on, off) in zip(record.text, record.lyric_onset_offset):
                if not (0 <= on <= 30) or not (0 <= off <= 30):
                    raise ValueError(f"Invalid timestamp: {on}/{off}")
                text_tokens.append(wt.timestamp_token(on))
                text_tokens.extend(wt.encode(ch))
                text_tokens.append(wt.timestamp_token(off))
            specials = [wt.sot, wt.special_tokens[f"<|{cfg.language}|>"], wt.transcribe]
        else:
            text_tokens = wt.encode(record.text)
            if len(text_tokens) == 0:
                specials = [wt.sot, wt.no_speech]
            else:
                specials = [wt.sot, wt.special_tokens[f"<|{cfg.language}|>"], wt.transcribe]
                if not cfg.with_timestamps:
                    specials.append(wt.no_timestamps)
        dec_in = specials + text_tokens
        dec_out = specials[1:] + text_tokens + [wt.eot]
        return dec_in, dec_out

    def build(self, record: Record) -> Dict:
        cfg = self.cfg
        audio = load_audio_file(record.audio_path, cfg.audio_type)["speech"]
        a = np.zeros((cfg.max_audio_samples,), np.float32)
        n = min(len(audio), cfg.max_audio_samples)
        a[:n] = audio[:n]

        classes = self.pinyin_classes(record.text)
        L = min(len(classes), cfg.max_label_len)
        ctc = np.full((cfg.max_label_len,), IGNORE_ID, np.int32)
        ctc[:L] = classes[:L]

        if record.lyric_onset_offset is not None:
            frame_labels = rasterize_frame_labels(
                classes, record.lyric_onset_offset, use_ctc=cfg.use_ctc,
                total_frames=cfg.max_frames,
            )
        else:
            fill = IGNORE_ID if cfg.use_ctc else 0
            frame_labels = np.full((cfg.max_frames,), fill, np.int32)

        dec = self.decoder_sequences(record)
        dec_in = np.zeros((cfg.max_decoder_len,), np.int32)
        dec_out = np.full((cfg.max_decoder_len,), IGNORE_ID, np.int32)
        if dec is not None:
            di, do = dec
            dec_in[: min(len(di), cfg.max_decoder_len)] = di[: cfg.max_decoder_len]
            dec_out[: min(len(do), cfg.max_decoder_len)] = do[: cfg.max_decoder_len]

        return {
            "audio": a,
            "ctc_labels": ctc,
            "frame_labels": frame_labels,
            "label_lengths": np.int32(L),
            "has_alignment": np.bool_(record.lyric_onset_offset is not None),
            "decoder_input": dec_in,
            "decoder_output": dec_out,
            "onset_offset": record.lyric_onset_offset,
            "text": record.text,
        }


def collate(examples: Sequence[Dict]) -> MultitaskBatch:
    stack = lambda k: np.stack([e[k] for e in examples])
    return MultitaskBatch(
        audio=stack("audio"),
        ctc_labels=stack("ctc_labels"),
        frame_labels=stack("frame_labels"),
        label_lengths=stack("label_lengths"),
        has_alignment=stack("has_alignment"),
        decoder_input=stack("decoder_input"),
        decoder_output=stack("decoder_output"),
        onset_offset=[e["onset_offset"] for e in examples],
        texts=[e["text"] for e in examples],
    )


class MultitaskLoader:
    """Deterministic, thread-prefetched batch loader over records.

    Replaces the reference's torch DataLoader(num_workers=4)
    (`dataset.py:259-266`) with a dependency-free prefetching iterator.
    """

    def __init__(
        self,
        records: Sequence[Record],
        builder: MultitaskExampleBuilder,
        shuffle: bool = False,
        seed: int = 114514,
        num_workers: int = 4,
    ):
        self.records = list(records)
        self.builder = builder
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self._epoch = 0

    def __len__(self) -> int:
        b = self.builder.cfg.batch_size
        if self.builder.cfg.drop_remainder:
            return len(self.records) // b
        return -(-len(self.records) // b)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.records))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[MultitaskBatch]:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.builder.cfg
        order = self._order()
        self._epoch += 1
        n_batches = len(self)
        prefetch = max(2, self.num_workers)

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending = deque()

            def submit(bi):
                ids = order[bi * cfg.batch_size: (bi + 1) * cfg.batch_size]
                pending.append([pool.submit(self.builder.build, self.records[i]) for i in ids])

            for bi in range(min(prefetch, n_batches)):
                submit(bi)
            next_bi = min(prefetch, n_batches)
            while pending:
                batch_futures = pending.popleft()
                if next_bi < n_batches:
                    submit(next_bi)
                    next_bi += 1
                yield collate([f.result() for f in batch_futures])
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def infinite_batches(loader: MultitaskLoader) -> Iterator[MultitaskBatch]:
    """Reference ``infinite_iter`` equivalent (`train_multitask.py:161-164`);
    re-shuffles each epoch."""
    while True:
        yield from loader
