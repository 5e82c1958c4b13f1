"""Transcription CLI: batched KV-cached beam search -> result JSON.

Port of ``lyricalignment_tpu/cli/inference_transcript.py`` (the
reference's ``inference_transcript.py:72-190``): loads a
fine-tuned AlignModel's whisper (or a pretrained OpenAI checkpoint with
``--use-pretrained --whisper-checkpoint``), transcribes each record with
beam search (default beam 5) and writes ``[{song_id, song_path, lyric?,
inference}]``. Refuses to overwrite an existing output file (reference
`:153-157`).

Records that fit one 30 s window are transcribed in fixed-size batches:
``log_mel`` (the log-mel kernel) -> ``pad_or_trim`` -> ``embed_audio`` (the
encoder attention kernel) -> one batched beam search. Longer audio goes
through whisper's sequential seek decode (``decode.longform``):
timestamp-rule decoding, condition-on-previous-text prompts, seek to the
last complete timestamp pair. ``--fast-windows`` switches long audio to
independent batched 30 s windows instead.

``--mesh-data`` / ``--mesh-model`` shard the batched path over a ("data",
"model") mesh of torchrun ranks (``parallel.mesh``): each batch is padded to
``--batch-size``, which the data axis must divide, each data rank decodes
its rows with the backbone tensor-sharded over the model axis (the
vocab-sharded logits gathered before beam selection), and rank 0 gathers the
texts and alone writes the output. Long-form songs run whole on every data
rank; the fallback ladder's sampled retries draw from each shard's own
generator.

    python -m lyricalignment_tpu_torch.cli.inference_transcript \\
        -f test.json --model-dir result --whisper-bpe multilingual.tiktoken
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from lyricalignment_tpu_torch import N_FRAMES, N_SAMPLES
from lyricalignment_tpu_torch.cli.common import (
    add_asset_args,
    add_mesh_args,
    init_distributed,
    load_model_dir,
    model_mesh,
    resolve_device,
    set_seed,
)
from lyricalignment_tpu_torch.data.audio_io import load_audio_file
from lyricalignment_tpu_torch.data.records import read_data
from lyricalignment_tpu_torch.decode.beam import beam_search, greedy_decode
from lyricalignment_tpu_torch.models.convert import load_openai_checkpoint
from lyricalignment_tpu_torch.models.whisper import Whisper, WhisperConfig, bf16_resident
from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim
from lyricalignment_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    gather_objects,
    is_primary,
    shard_whisper,
)
from lyricalignment_tpu_torch.text.whisper_tokenizer import (
    WhisperTokenizer,
    non_speech_token_ids,
    num_languages_for_vocab,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-f", "--test-data", type=str, required=True)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--use-pretrained", action="store_true")
    p.add_argument("--use-groundtruth", action="store_true")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--is-mixture", type=int, choices=[0, 1, 2], default=0)
    p.add_argument("-o", "--output", type=str, default="output/result.json")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=224)
    p.add_argument("--temperature-fallback", action="store_true",
                   help="whisper-style quality gates: retry degenerate "
                        "segments with sampling at rising temperatures, "
                        "silence high-no-speech segments")
    p.add_argument("--fast-windows", action="store_true",
                   help="decode >30 s audio as independent batched windows "
                        "instead of whisper's sequential seek loop")
    p.add_argument("--length-penalty", type=float, default=None,
                   help="beam ranking length penalty (Google NMT formula); "
                        "default None = average logprob, whisper's default")
    p.add_argument("--decode-group", type=int, default=1,
                   help="decode steps between two host reads of the "
                        "every-row-done flag (token selection is unchanged)")
    p.add_argument("--patience", type=float, default=None,
                   help="beam search patience (whisper DecodingOptions): "
                        "keep decoding until round(beam_size * patience) "
                        "finished candidates exist; default None = 1.0")
    p.add_argument("--no-condition-on-previous-text", action="store_true",
                   help="long-form: do not prompt each window with the "
                        "previous window's text")
    p.add_argument("--language", type=str, default="zh")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast-gelu", action="store_true",
                   help="tanh-approximate GELU (error below bf16 rounding)")
    p.add_argument("--int8-cross-kv", action="store_true",
                   help="int8-quantise the decode cache's cross-attention K/V "
                        "(~0.5-1%% relative attention-output error)")
    p.add_argument("--seed", type=int, default=114514)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch versions "
                        "of the kernels)")
    add_mesh_args(p, "the batched (<= 30 s) transcription path")
    add_asset_args(p)
    return p.parse_args(argv)


def suppress_token_ids(whisper_tok) -> tuple:
    """(suppress_ids, begin_suppress_ids) of every decode: whisper's
    non-speech symbols, and " " and eot at the first step (both need BPE
    ranks; empty without them)."""
    suppress_ids = tuple(non_speech_token_ids(whisper_tok))
    begin_suppress_ids = (
        tuple(whisper_tok.encode(" ")) + (whisper_tok.eot,)
        if whisper_tok.has_bpe else ()
    )
    return suppress_ids, begin_suppress_ids


def transcribe_records(records, whisper: Whisper, wcfg: WhisperConfig, whisper_tok, args):
    """Transcription dispatcher, on the device ``whisper`` lives on. Audio
    fitting one 30 s window is decoded in fixed-size batches; longer audio
    goes through whisper's sequential seek loop (``decode.longform``)
    unless ``--fast-windows`` asks for independent batched windows."""
    dev = next(whisper.parameters()).device
    prompt_ids = list(whisper_tok.sot_sequence) + [whisper_tok.no_timestamps]
    suppress_ids, begin_suppress_ids = suppress_token_ids(whisper_tok)
    group = getattr(args, "decode_group", 1)
    mesh = model_mesh(whisper, args, dev, shard_whisper, args.batch_size)

    @torch.no_grad()
    def encode(audio):
        mel = pad_or_trim(log_mel(audio, n_mels=wcfg.n_mels), N_FRAMES)
        return whisper.embed_audio(mel)

    # expand records into (record_idx, window) work items; long audio is
    # routed to the sequential long-form decoder unless --fast-windows
    work = []
    longform_texts: dict = {}
    longform_items: list = []  # (record_idx, audio) for the batched seek loop
    for ri, r in enumerate(records):
        a = load_audio_file(r.audio_path, args.is_mixture)["speech"]
        if len(a) > N_SAMPLES and not args.fast_windows:
            longform_items.append((ri, a))
            continue
        n_windows = max(1, -(-len(a) // N_SAMPLES))
        for w in range(n_windows):
            seg = a[w * N_SAMPLES: (w + 1) * N_SAMPLES]
            win = np.zeros((N_SAMPLES,), np.float32)
            win[: len(seg)] = seg
            work.append((ri, w, win))

    if longform_items:
        longform_kw = dict(
            max_new_tokens=args.max_new_tokens,  # clamped to the ctx cap
            beam_size=args.beam_size,
            temperatures=((0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
                          if args.temperature_fallback else (0.0,)),
            condition_on_previous_text=not args.no_condition_on_previous_text,
            suppress_ids=suppress_ids,
            begin_suppress_ids=begin_suppress_ids,
            length_penalty=args.length_penalty,
            patience=getattr(args, "patience", None),
            seed=args.seed,
            decode_group=group,
        )
        if len(longform_items) > 1:
            # many long songs: advance their seek loops in lockstep so every
            # window round is one batched decode
            from lyricalignment_tpu_torch.decode.longform import transcribe_longform_batched

            outs = transcribe_longform_batched(
                whisper, wcfg, [a for _, a in longform_items], whisper_tok,
                batch_size=min(args.batch_size, len(longform_items)), **longform_kw)
            for (ri, _), out in zip(longform_items, outs):
                longform_texts[ri] = out["text"]
        else:
            from lyricalignment_tpu_torch.decode.longform import transcribe_longform

            ri, a = longform_items[0]
            longform_texts[ri] = transcribe_longform(whisper, wcfg, a, whisper_tok,
                                                     **longform_kw)["text"]

    texts: dict = {}
    bs = args.batch_size
    for i in range(0, len(work), bs):
        chunk = work[i: i + bs]
        if mesh is not None:
            # pad rows keep the data shards equal; they are dropped below
            chunk = [chunk[r] if r < len(chunk) else None
                     for r in range(bs)[batch_sharding(mesh).rows(bs)]]
        audio = np.stack([np.zeros((N_SAMPLES,), np.float32) if w is None else w[2]
                          for w in chunk])
        xa = encode(torch.from_numpy(audio).to(dev))
        prompt = torch.tensor([prompt_ids] * len(chunk), dtype=torch.int64, device=dev)
        if args.temperature_fallback:
            from lyricalignment_tpu_torch.decode.transcribe import decode_with_fallback

            entries = decode_with_fallback(
                whisper, wcfg, xa, prompt, whisper_tok,
                beam_size=args.beam_size, max_new_tokens=args.max_new_tokens,
                suppress_ids=suppress_ids, begin_suppress_ids=begin_suppress_ids,
                group=group)
            done = [(w[0], w[1], e["text"]) for w, e in zip(chunk, entries) if w is not None]
        else:
            done = _decode_texts(whisper, wcfg, xa, prompt, chunk, whisper_tok, args,
                                 suppress_ids, begin_suppress_ids, group)
        if mesh is not None:
            done = [d for part in gather_objects(done, mesh.get_group(DATA_AXIS)) for d in part]
        for ri, w, text in done:
            texts.setdefault(ri, {})[w] = text

    results = []
    for ri, r in enumerate(records):
        if ri in longform_texts:
            text = longform_texts[ri]
        else:
            windows = texts.get(ri, {})
            text = "".join(windows[w] for w in sorted(windows))
        entry = {"song_id": Path(r.audio_path).stem, "song_path": r.audio_path}
        if args.use_groundtruth:
            entry["lyric"] = r.text
        entry["inference"] = text
        results.append(entry)
        if is_primary():
            print(entry["song_id"], "->", text[:60])
    return results


def _decode_texts(whisper, wcfg, xa, prompt, chunk, whisper_tok, args, suppress_ids,
                  begin_suppress_ids, group):
    """Beam (or greedy) decode of a batch of windows -> [(record index,
    window, text)] of its real rows (``chunk`` entries; None for pad)."""
    if args.beam_size > 1:
        tokens, _ = beam_search(
            whisper, wcfg, xa, prompt, beam_size=args.beam_size,
            max_new_tokens=args.max_new_tokens, eot=whisper_tok.eot,
            suppress_ids=suppress_ids, begin_suppress_ids=begin_suppress_ids,
            length_penalty=args.length_penalty,
            patience=getattr(args, "patience", None), group=group)
    else:
        tokens = greedy_decode(
            whisper, wcfg, xa, prompt, max_new_tokens=args.max_new_tokens,
            eot=whisper_tok.eot, suppress_ids=suppress_ids,
            begin_suppress_ids=begin_suppress_ids)
    done = []
    for item, row_tokens in zip(chunk, tokens.cpu().numpy()):
        if item is None:
            continue
        row = [int(t) for t in row_tokens if int(t) != whisper_tok.eot]
        text = whisper_tok.decode(row) if whisper_tok.has_bpe else json.dumps(row)
        done.append((item[0], item[1], text))
    return done


def load_pretrained_whisper(path: str, bf16: bool, device: str, int8_cross_kv: bool = False):
    """(config, ``Whisper`` in eval mode on ``device``) from an OpenAI
    ``.pt`` checkpoint, its dims giving the config (``bf16``: bfloat16
    compute with bf16-resident weights; ``int8_cross_kv``: int8 cross K/V
    in the decode cache)."""
    dev = resolve_device(device)
    wcfg, sd = load_openai_checkpoint(path)
    if bf16:
        wcfg = dataclasses.replace(wcfg, compute_dtype=torch.bfloat16)
    wcfg = dataclasses.replace(wcfg, int8_cross_kv=int8_cross_kv)
    whisper = Whisper(wcfg)
    whisper.load_state_dict(sd, strict=True)
    if bf16:
        bf16_resident(whisper)
    return wcfg, whisper.to(dev).eval()


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.seed)
    if os.path.exists(args.output):
        print("File Exists, Pass")
        return
    device = args.device
    if args.mesh_data or args.mesh_model > 1:
        device = str(init_distributed(args.device))
    resolve_device(device)

    whisper_tok = WhisperTokenizer(
        multilingual=True, language=args.language, task="transcribe",
        bpe_path=args.whisper_bpe,
    )

    if os.path.exists(args.model_dir) and not args.use_pretrained:
        mcfg, model, _ = load_model_dir(args.model_dir, "best", use_bf16=args.bf16,
                                        fast_gelu=args.fast_gelu,
                                        int8_cross_kv=args.int8_cross_kv, device=device)
        wcfg, whisper = mcfg.whisper, model.whisper_model
    elif args.whisper_checkpoint:
        print("Use pretrained model")
        wcfg, whisper = load_pretrained_whisper(args.whisper_checkpoint, args.bf16,
                                                device, args.int8_cross_kv)
    else:
        raise SystemExit("--model-dir not found; pass --whisper-checkpoint for "
                         "a pretrained run (no network downloads available)")

    # v3-family backbones (n_vocab 51866) carry 100 languages: rebuild the
    # tokenizer with the matching special-token layout
    nl = num_languages_for_vocab(wcfg.n_vocab)
    if nl != whisper_tok.num_languages:
        whisper_tok = WhisperTokenizer(
            multilingual=True, language=args.language, task="transcribe",
            bpe_path=args.whisper_bpe, num_languages=nl,
        )

    records = read_data(args.test_data)
    results = transcribe_records(records, whisper, wcfg, whisper_tok, args)
    if not is_primary():
        return results

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    return results


if __name__ == "__main__":
    main()
