"""Streaming alignment/transcription service (JSONL over stdin/stdout).

Port of ``lyricalignment_tpu/cli/serve.py``. The model loads once, then
each input line is a JSON request and each output line a JSON response:

Request:  {"song_path": "...", "lyric": "..."}            -> alignment
          {"song_path": "...", "task": "transcribe"}      -> transcription
Response: {"song_path": ..., "alignment": [[on, off, char], ...]}
          {"song_path": ..., "inference": "..."}
          {"song_path": ..., "error": "..."} on failure
An optional request ``"id"`` is echoed verbatim on its response (success or
error); responses otherwise come back in request order.

Continuous batching: a reader thread puts input lines on a queue (it only
reads; the main thread alone touches the device); the serve loop drains up
to ``--max-batch`` queued requests at a time (waiting at most
``--batch-window-ms`` after the first) and runs the batch's alignment
requests through one ``LyricAligner.align_many`` and its transcription
requests through one ``transcribe_many``. With the default window of 0 no
latency is added: batches form only under a backlog. A fused batch that
fails (one unreadable WAV fails the whole ``align_many``) is retried one
request at a time, so a bad request gets its own error response and the
others their results.

Usage:
    python -m lyricalignment_tpu_torch.cli.serve --model-dir result \\
        --use-ctc-loss --bert-vocab vocab.txt [--whisper-bpe ranks.tiktoken] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time

from lyricalignment_tpu_torch.cli.common import add_asset_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", default="best",
                   choices=["best", "best_align", "best_trans", "last"])
    p.add_argument("--use-ctc-loss", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--bucket-seconds", type=float, default=5.0)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--max-new-tokens", type=int, default=224,
                   help="decode token budget per 30 s window")
    p.add_argument("--length-penalty", type=float, default=None,
                   help="Google-NMT beam ranking penalty (default: rank by "
                        "plain length-normalized logprob, whisper's default)")
    p.add_argument("--patience", type=float, default=None,
                   help="beam patience: finished-candidate set holds "
                        "round(beam_size * patience) sequences (whisper "
                        "semantics; values < 1 allowed)")
    p.add_argument("--max-batch", type=int, default=16,
                   help="max queued requests fused into one device batch "
                        "(default 16, the JAX service's default)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="after the first request of a batch, wait up to "
                        "this long for more (0 = only drain the backlog)")
    p.add_argument("--transcribe-batch", type=int, default=None,
                   help="device decode batch for fused transcription "
                        "requests (default: min(--max-batch, 8), the "
                        "transcript CLI's default batch)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    add_asset_args(p)
    args = p.parse_args(argv)
    # fail fast on a decode config every transcribe request would reject:
    # whisper's beam search needs round(beam_size * patience) > 0, and the
    # beam search raises only per call, after the model has loaded
    if args.patience is not None and round(args.beam_size * args.patience) < 1:
        p.error(f"--patience {args.patience} with --beam-size {args.beam_size} "
                "gives round(beam_size * patience) < 1; no finished "
                "candidates could ever be kept")
    return args


def _decode_kwargs(args):
    return dict(whisper_bpe=args.whisper_bpe, beam_size=args.beam_size,
                max_new_tokens=args.max_new_tokens, length_penalty=args.length_penalty,
                patience=args.patience)


def _handle_one(aligner, args, req):
    """Process a single parsed request (also the batch-failure fallback)."""
    try:
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        path = req["song_path"]
        if req.get("task") == "transcribe":
            return {"song_path": path,
                    "inference": aligner.transcribe(path, **_decode_kwargs(args))}
        return {"song_path": path, "alignment": aligner.align(path, req["lyric"])}
    except Exception as e:  # keep serving on per-request failures
        return {"song_path": req.get("song_path") if isinstance(req, dict) else None,
                "error": f"{type(e).__name__}: {e}"}


def _reader(stdin, q):
    try:
        for line in stdin:
            q.put(line)
    finally:
        # always deliver EOF: a reader crash (e.g. UnicodeDecodeError on a
        # bad byte stream) must shut the serve loop down, not hang it
        q.put(None)


def _next_batch(q, max_batch, window_s):
    """Up to ``max_batch`` queued lines (the first waited for, the rest
    taken within ``window_s`` of it) and whether EOF was reached; None at
    EOF with nothing pending."""
    first = q.get()
    if first is None:
        return None, True
    pending = [first]
    deadline = time.monotonic() + window_s
    while len(pending) < max_batch:
        remaining = deadline - time.monotonic()
        try:
            nxt = q.get(timeout=remaining) if remaining > 0 else q.get_nowait()
        except queue.Empty:
            break
        if nxt is None:
            return pending, True
        pending.append(nxt)
    return pending, False


def serve(aligner, args, stdin=None, stdout=None):
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    max_batch = max(1, args.max_batch)
    window_s = max(0.0, args.batch_window_ms) / 1000.0

    q = queue.Queue()
    threading.Thread(target=_reader, args=(stdin, q), daemon=True).start()

    eof = False
    while not eof:
        pending, eof = _next_batch(q, max_batch, window_s)
        if pending is None:
            break

        reqs = []
        for line in pending:
            line = line.strip()
            if not line:
                continue
            try:
                reqs.append(json.loads(line))
            except Exception as e:
                reqs.append(e)  # answered as a per-request error below

        responses = [None] * len(reqs)
        # fuse the well-formed requests of each task into one device batch
        align_idx = [i for i, r in enumerate(reqs)
                     if isinstance(r, dict) and r.get("task") != "transcribe"
                     and "song_path" in r and "lyric" in r]
        trans_idx = [i for i, r in enumerate(reqs)
                     if isinstance(r, dict) and r.get("task") == "transcribe"
                     and "song_path" in r]
        if len(align_idx) > 1:
            try:
                outs = aligner.align_many(
                    [(reqs[i]["song_path"], reqs[i]["lyric"]) for i in align_idx])
                for i, seg in zip(align_idx, outs):
                    responses[i] = {"song_path": reqs[i]["song_path"], "alignment": seg}
            except Exception as e:
                # e.g. one bad audio file fails the fused batch: retry one
                # request at a time (which isolates it), and say so
                print(f"serve: batched alignment failed ({type(e).__name__}: {e}); "
                      f"retrying per-request", file=sys.stderr, flush=True)
        if len(trans_idx) > 1:
            try:
                texts = aligner.transcribe_many(
                    [reqs[i]["song_path"] for i in trans_idx],
                    batch_size=args.transcribe_batch, **_decode_kwargs(args))
                for i, text in zip(trans_idx, texts):
                    responses[i] = {"song_path": reqs[i]["song_path"], "inference": text}
            except Exception as e:
                print(f"serve: batched transcription failed ({type(e).__name__}: {e}); "
                      f"retrying per-request", file=sys.stderr, flush=True)

        for i, r in enumerate(reqs):
            if responses[i] is None:
                if isinstance(r, Exception):
                    responses[i] = {"song_path": None, "error": f"{type(r).__name__}: {r}"}
                else:
                    responses[i] = _handle_one(aligner, args, r)

        # echo a client-supplied id on every response so callers can
        # correlate without relying on song_path uniqueness or order
        for i, r in enumerate(reqs):
            if isinstance(r, dict) and "id" in r:
                responses[i]["id"] = r["id"]

        for resp in responses:
            stdout.write(json.dumps(resp, ensure_ascii=False) + "\n")
        stdout.flush()


def load_aligner(args):
    """The service's ``LyricAligner``, on ``args.device``."""
    from lyricalignment_tpu_torch.api import LyricAligner

    return LyricAligner.from_model_dir(
        args.model_dir, model_name=args.model_name, bert_vocab=args.bert_vocab,
        synthetic_vocab=args.synthetic_vocab, use_ctc=args.use_ctc_loss, bf16=args.bf16,
        device=args.device, bucket_seconds=args.bucket_seconds,
        batch_size=max(1, args.max_batch))


def main(argv=None):
    args = parse_args(argv)
    aligner = load_aligner(args)
    print("ready", file=sys.stderr, flush=True)
    serve(aligner, args)


if __name__ == "__main__":
    main()
