"""Alignment cells: ``LyricAligner.align_many`` in a closed loop.

One caller sends ``requests_per_call`` (WAV, lyric) requests a call and
waits for the onsets and offsets. Traffic parameters: ``requests_per_call``,
``batch_size`` (the aligner's device batch cap), ``bucket_seconds``,
``warm_calls``, ``check_calls`` (calls of the window judged afterwards,
drawn from the seed), ``limits`` (the comparison's limits, by name).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import program, roofline, traffic, weights
from benchmark.reference.audio import HOP, mel_filters
from benchmark.reference.align import judge_calls, load_labels


class Entry:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.params = ctx.cfg, ctx.traffic
        self.records: List[Dict] = []

    # --- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from lyricalignment_tpu_torch.api import LyricAligner
        from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer
        from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table

        ctx, p = self.ctx, self.params
        self.pool = traffic.write_pool(p, ctx.seed, ctx.tmp("pool"))
        self.vocab = traffic.write_vocab(ctx.tmp())
        w = weights.make_weights(self.cfg, ctx.seed, ctx.dev, self.cfg["precision"]["resident"],
                                 p["classifier_scale"])
        model = program.build(self.cfg, w, ctx.dev, serving=True,
                              int8_encoder=ctx.control == "int8")
        del w
        self.aligner = LyricAligner(
            model, BertWordPieceTokenizer(vocab_path=self.vocab), load_pronunciation_table(),
            use_ctc=True, bucket_seconds=p["bucket_seconds"], batch_size=p["batch_size"])
        self.plan = traffic.call_plan(p, ctx.seed, len(self.pool), p["requests_per_call"], 100000)
        self.next_call = 0
        for _ in range(p["warm_calls"]):
            self.call(record=False)

    # --- the timed path -------------------------------------------------------
    def call(self, record: bool = True) -> Dict:
        idx = self.plan[self.next_call]
        self.next_call += 1
        reqs = [self.pool[i] for i in idx]
        out = self.aligner.align_many([(r.path, r.lyric) for r in reqs])
        if record:
            self.records.append({"idx": idx, "segments": [[s[:2] for s in segs] for segs in out]})
        return {"audio_s": sum(r.seconds for r in reqs), "requests": len(reqs)}

    # --- what the readers need ---------------------------------------------
    def shapes(self) -> Dict:
        cfg, p = self.cfg, self.params
        b = min(1 << (p["requests_per_call"] - 1).bit_length(), p["batch_size"])
        return {"batch": b, "padded_len": 30 * 16000 + 400, "mel_frames": 3000,
                "n_mels": cfg["n_mels"], "fb_nonzero": int((mel_filters(cfg["n_mels"]) != 0).sum()),
                "frames": cfg["n_audio_ctx"], "heads": cfg["n_audio_head"],
                "feat": 2 * cfg["head"]["hidden_dim"], "cols": cfg["head"]["output_dim"] - 2,
                "labels": 128, "calls_per_batch": math.ceil(p["requests_per_call"] / b)}

    def call_flops(self, idx) -> float:
        """Model FLOPs of one call: the encoder over its 30 s windows, the
        head over each request's frames and the classifier's normaliser."""
        s = self.shapes()
        frames = sum(int(round((min(int(self.pool[i].seconds * 16000), 480000) // HOP) / 2.0))
                     for i in idx)
        windows = s["calls_per_batch"] * s["batch"]
        return (roofline.encoder_flops(self.cfg, windows)
                + roofline.head_flops(self.cfg, 1, frames, s["cols"]))

    def window_flops(self, n_calls: int) -> float:
        return sum(self.call_flops(r["idx"]) for r in self.records[:n_calls])

    # --- after the window ----------------------------------------------------
    def release(self) -> None:
        self.narrow = program.narrow_tensors(self.aligner.model, self.cfg["precision"]["resident"])
        del self.aligner
        if self.ctx.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[Dict]:
        """The served model's tensors narrower than the configuration's
        resident type (an exact check: the program's int8 encoder has them);
        each judged request's path: whether it is a path of the DP at all
        (an exact check), and its gap below the reference's best: the
        widest, and the median over the sample."""
        ctx, p = self.ctx, self.params
        rng = traffic.rng_of(ctx.seed, 3)
        n = min(p["check_calls"], len(self.records))
        picks = sorted(rng.choice(len(self.records), n, replace=False).tolist())
        calls = []
        for k in picks:
            rec = self.records[k]
            calls.append({"paths": [self.pool[i].path for i in rec["idx"]],
                          "lyrics": [self.pool[i].lyric for i in rec["idx"]],
                          "segments": rec["segments"]})
        w = weights.make_weights(self.cfg, ctx.seed, ctx.dev, self.cfg["precision"]["resident"],
                                 p["classifier_scale"])
        gaps = judge_calls(w, self.cfg, calls, load_labels(self.vocab, traffic.TABLE_PATH),
                           p["bucket_seconds"], p["batch_size"], control=ctx.control == "fp8")
        g = np.array(gaps)
        valid = g[np.isfinite(g)]
        note = f"{len(g)} requests of {n} calls"
        if len(valid):
            note += (f"; valid ones' mean {valid.mean():.6g}, p90 {np.percentile(valid, 90):.6g},"
                     f" max {valid.max():.6g}")
        return [{"name": "align_narrow_tensors", "value": float(self.narrow),
                 "note": "served tensors narrower than the stated resident type"},
                {"name": "align_invalid_answers", "value": float(len(g) - len(valid))},
                {"name": "align_gap_max_nats", "value": float(g.max())},
                {"name": "align_gap_median_nats", "value": float(np.median(g)), "note": note}]
