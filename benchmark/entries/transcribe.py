"""Transcription cells: ``cli.inference_transcript.transcribe_records``
(what ``LyricAligner.transcribe_many`` and the transcript CLI run) in a
closed loop.

One caller sends ``requests_per_call`` WAVs a call and waits for the
texts: each 30 s window encoded, then a batched beam search through the
decoder's KV cache, the prompt <|startoftranscript|> <|language|>
<|transcribe|> <|notimestamps|>, no BPE file (a window's text is the JSON
list of its token ids). Traffic parameters: ``requests_per_call``,
``batch_size`` (windows a device batch), ``beam_size``,
``max_new_tokens``, ``language``, ``decode_group`` (steps between two host
reads of "every sample complete"), ``warm_calls``, ``check_calls`` (calls
of the window judged afterwards, drawn from the seed), and the pool's
(``traffic.py``).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark import program, roofline, roofline_decode, traffic, weights
from benchmark.reference.decoder import prompt_ids
from benchmark.reference.transcribe import judge_calls
from benchmark.spans import counts

DIMS = ("n_text_state", "n_text_layer", "n_audio_ctx", "n_vocab")


class Entry:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.params = ctx.cfg, ctx.traffic
        self.records: List[Dict] = []

    # --- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from lyricalignment_tpu_torch.text.whisper_tokenizer import (
            WhisperTokenizer,
            num_languages_for_vocab,
        )

        ctx, p, cfg = self.ctx, self.params, self.cfg
        self.pool = traffic.write_pool(p, ctx.seed, ctx.tmp("pool"))
        w = weights.make_weights(cfg, ctx.seed, ctx.dev, cfg["precision"]["resident"])
        self.model = program.build(cfg, w, ctx.dev, serving=True,
                                   int8_encoder=ctx.control == "int8")
        del w
        self.whisper, self.wcfg = self.model.whisper_model, self.model.cfg.whisper
        if ctx.control == "int8_cross_kv":
            # a reading, not a control of the cells: the program's int8 cross K/V
            self.wcfg = dataclasses.replace(self.wcfg, int8_cross_kv=True)
        self.tok = WhisperTokenizer(multilingual=True, language=p["language"], task="transcribe",
                                    num_languages=num_languages_for_vocab(cfg["n_vocab"]))
        self.args = SimpleNamespace(
            is_mixture=0, batch_size=p["batch_size"], beam_size=p["beam_size"],
            max_new_tokens=p["max_new_tokens"], use_groundtruth=False,
            temperature_fallback=False, fast_windows=False, length_penalty=None, patience=None,
            no_condition_on_previous_text=False, seed=114514, decode_group=p["decode_group"])
        self.plan = traffic.call_plan(p, ctx.seed, len(self.pool), p["requests_per_call"], 100000)
        self.next_call = 0
        for k in range(p["warm_calls"]):
            out = self._transcribe(self.plan[self.next_call])
            self.next_call += 1
            if k == 0 and not all("avg_logprob" in r for r in out):
                raise SystemExit("the program does not report its scores (no avg_logprob in "
                                 "transcribe_records' results): nothing to judge them by")

    def _transcribe(self, idx) -> List[Dict]:
        from lyricalignment_tpu_torch.cli.inference_transcript import transcribe_records
        from lyricalignment_tpu_torch.data.records import Record

        return transcribe_records([Record(audio_path=self.pool[i].path, text="") for i in idx],
                                  self.whisper, self.wcfg, self.tok, self.args)

    # --- the timed path -------------------------------------------------------
    def call(self, record: bool = True) -> Dict:
        idx = self.plan[self.next_call]
        self.next_call += 1
        before = (counts() or {}).get("decode.steps")
        out = self._transcribe(idx)
        if record:
            after = (counts() or {}).get("decode.steps")
            self.records.append({
                "idx": idx, "texts": [r["inference"] for r in out],
                "scores": [r["avg_logprob"] for r in out],
                "positions": None if before is None or after is None else after - before})
        return {"audio_s": sum(self.pool[i].seconds for i in idx), "requests": len(idx)}

    # --- what the readers need ---------------------------------------------
    def shapes(self) -> Dict:
        p = self.params
        return {"windows": min(p["requests_per_call"], p["batch_size"]), "beam": p["beam_size"],
                "prompt": len(prompt_ids(self.cfg["n_vocab"], p["language"])),
                "elem": getattr(torch, self.cfg["precision"]["resident"]).itemsize,
                "dims": {k: self.cfg[k] for k in DIMS}}

    def call_flops(self, rec) -> float:
        """Model FLOPs of one call: the encoder over its windows, then each
        batch's prime and steps (one step fewer than the token positions
        decided; the counter ``decode.steps`` gives those, split evenly
        over the call's batches)."""
        s, p = self.shapes(), self.params
        batches = math.ceil(len(rec["idx"]) / p["batch_size"])
        steps = rec["positions"] / batches - 1
        windows = sum(max(1, math.ceil(self.pool[i].seconds / 30.0)) for i in rec["idx"])
        return (roofline.encoder_flops(self.cfg, windows)
                + batches * roofline_decode.decoder_flops(s["dims"], s["windows"], s["beam"],
                                                          s["prompt"], round(steps)))

    def window_flops(self, n_calls: int) -> float:
        recs = self.records[:n_calls]
        if any(r["positions"] is None for r in recs):
            return 0.0
        return sum(self.call_flops(r) for r in recs)

    # --- after the window ----------------------------------------------------
    def release(self) -> None:
        self.narrow = program.narrow_tensors(self.model, self.cfg["precision"]["resident"])
        del self.model, self.whisper
        if self.ctx.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[Dict]:
        """The served model's tensors narrower than the configuration's
        resident type, and the judged windows' invalid answers (exact
        checks); their scores' gap to the float32 reference's (the widest
        and the median) and their beam shortfall (the widest); the
        program's counters as readings."""
        ctx, p = self.ctx, self.params
        rng = traffic.rng_of(ctx.seed, 3)
        n = min(p["check_calls"], len(self.records))
        picks = sorted(rng.choice(len(self.records), n, replace=False).tolist())
        calls = [{"paths": [self.pool[i].path for i in self.records[k]["idx"]],
                  "texts": self.records[k]["texts"], "scores": self.records[k]["scores"]}
                 for k in picks]
        w = weights.make_weights(self.cfg, ctx.seed, ctx.dev, self.cfg["precision"]["resident"])
        got = judge_calls(w, self.cfg, calls, p["language"], p["beam_size"],
                          p["max_new_tokens"], p["batch_size"], control=ctx.control == "fp8")
        gap, short = np.array(got["gap"]), np.array(got["shortfall"])
        note = f"{len(gap)} windows of {n} calls"
        ok = gap[np.isfinite(gap)]
        if len(ok):
            note += f"; valid ones' gap mean {ok.mean():.6g}, p90 {np.percentile(ok, 90):.6g}"
        found = counts() or {}
        # a request a window: each call decodes ceil(requests / batch_size) batches
        batches = (found.get("decode.windows", 0) / p["requests_per_call"]
                   * math.ceil(p["requests_per_call"] / p["batch_size"]))
        return [{"name": "transcribe_narrow_tensors", "value": float(self.narrow),
                 "note": "served tensors narrower than the stated resident type"},
                {"name": "transcribe_invalid_tokens", "value": float(sum(got["invalid"]))},
                {"name": "transcribe_logprob_gap_max_nats", "value": float(gap.max())},
                {"name": "transcribe_logprob_gap_median_nats", "value": float(np.median(gap)),
                 "note": note},
                {"name": "transcribe_beam_shortfall_max_nats", "value": float(short.max()),
                 "note": f"median {float(np.median(short)):.6g}"},
                {"name": "transcribe_calls", "value": float(len(self.records)),
                 "note": "timed calls in the window"},
                {"name": "decode_steps_per_batch",
                 "value": found.get("decode.steps", 0) / batches if batches else float("nan"),
                 "note": "token positions decided a batch (decode.steps), the first from "
                         f"the prime's logits; counters: {dict(sorted(found.items()))}"},
                {"name": "decode_tokens_per_window",
                 "value": found.get("decode.tokens", 0) / max(found.get("decode.windows", 0), 1)}]
