"""Alignment evaluation CLI: forced-align test data, report MAE.

Port of ``lyricalignment_tpu/cli/inference_alignment.py`` (the reference's
``inference_alignment.py:126-214``): records are grouped by length bucket
and aligned a batch at a time, batches padded to the next power of two; the
GRU and the Viterbi are masked to each sample's true frame count
(round(mel_len / 2)), so results at valid frames equal the reference's
exact per-sample trim.

``--mesh-data`` / ``--mesh-model`` run it over a ("data", "model") mesh of
torchrun ranks (``parallel.mesh``): batches are padded to the full
``--batch-size``, which the data axis must divide, each data rank aligns its
rows with the backbone tensor-sharded over the model axis, and rank 0
gathers the segments in input order and alone prints. ``--mesh-pipe N``
stages the encoder instead (``parallel.pipeline``: N stages over the model
axis, each rank holding 1 / N of the blocks), with 2 micro-batches of a data
rank's rows when they are even and 1 otherwise; it excludes
``--mesh-model``.

    python -m lyricalignment_tpu_torch.cli.inference_alignment \\
        -f test.json --model-dir result --bert-vocab vocab.txt --use-ctc-loss
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m lyricalignment_tpu_torch.cli.inference_alignment -f test.json \\
        --model-dir result --bert-vocab vocab.txt --batch-size 8 \\
        --mesh-data 2 --mesh-model 2
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m lyricalignment_tpu_torch.cli.inference_alignment -f test.json \\
        --model-dir result --bert-vocab vocab.txt --batch-size 8 --mesh-pipe 2
"""

from __future__ import annotations

import argparse
import math
import os
import random

import numpy as np
import torch

from lyricalignment_tpu_torch import HOP_LENGTH, N_SAMPLES
from lyricalignment_tpu_torch.cli.common import (
    add_asset_args,
    add_mesh_args,
    build_tokenizers,
    init_distributed,
    load_model_dir,
    model_mesh,
)
from lyricalignment_tpu_torch.data.audio_io import audio_num_samples_16k, load_audio_file
from lyricalignment_tpu_torch.data.records import read_data
from lyricalignment_tpu_torch.models.align_model import forward_from_audio
from lyricalignment_tpu_torch.ops.viterbi import (
    frames_to_seconds,
    viterbi_align,
    viterbi_align_fused,
)
from lyricalignment_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    batch_sharding,
    gather_objects,
    is_primary,
    shard_align_params,
)
from lyricalignment_tpu_torch.parallel.pipeline import make_pipeline_encode_fn
from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table
from lyricalignment_tpu_torch.utils.metrics import mae


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-f", "--test-data", type=str, required=True)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", default="best",
                   choices=["best", "best_align", "best_trans", "last"])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--is-mixture", type=int, choices=[0, 1, 2], default=0)
    p.add_argument("--use-ctc-loss", action="store_true")
    p.add_argument("--seed", type=int, default=114514)
    p.add_argument("--bucket-seconds", type=float, default=5.0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast-gelu", action="store_true",
                   help="tanh-approximate GELU in the encoder")
    p.add_argument("--int8-encoder", action="store_true",
                   help="W8A8 int8 encoder matmuls on int8-resident weights "
                        "(~1%% relative error per matmul, above bf16 rounding)")
    p.add_argument("--max-label-len", type=int, default=128)
    p.add_argument("--no-fused-align", action="store_true",
                   help="materialise the full [B, T, C] logits instead of "
                        "the fused classifier->Viterbi emission path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    add_mesh_args(p, "inference batches", pipe=True)
    add_asset_args(p)
    return p.parse_args(argv)


def bucket_samples(n_samples: int, bucket_seconds: float) -> int:
    """Round audio length up to a bucket; above 30 s, buckets are whole
    30 s windows (the windowed encoder path)."""
    bucket = max(1, int(round(bucket_seconds * 16000)))
    if n_samples > N_SAMPLES:
        return math.ceil(n_samples / N_SAMPLES) * N_SAMPLES
    return min(max(bucket, math.ceil(n_samples / bucket) * bucket), N_SAMPLES)


@torch.inference_mode()
def align_records(records, model, table, bert, args):
    """Yield (record, [[on, off], ...]) in input order.

    ``args`` carries use_ctc_loss, batch_size, bucket_seconds,
    max_label_len, is_mixture and (optionally) no_fused_align, mesh_data,
    mesh_model and mesh_pipe; the batch runs on the device of ``model``'s
    parameters. Under a mesh every rank reads every record, runs its data
    rank's rows of each batch (padded to ``batch_size``) and gets every
    segment back; under ``mesh_pipe`` the encoder runs pipelined.
    """
    device = next(model.parameters()).device
    mode = "ctc" if args.use_ctc_loss else "ce"
    batch_size = max(1, getattr(args, "batch_size", 1))
    fused = not getattr(args, "no_fused_align", False)
    mesh = model_mesh(model, args, device, shard_align_params, batch_size)
    encode_fn = None
    if getattr(args, "mesh_pipe", 1) > 1:
        # 2 micro-batches overlap the stages; 1 for an odd local batch
        b_local = batch_size // axis_size(mesh, DATA_AXIS)
        encode_fn = make_pipeline_encode_fn(mesh, n_micro=2 if b_local % 2 == 0 else 1)
    fc = model.align_rnn.fc

    buckets = {}
    for i, r in enumerate(records):
        n = audio_num_samples_16k(r.audio_path)
        buckets.setdefault(bucket_samples(n, args.bucket_seconds), []).append(i)

    results = {}
    for padded_len in sorted(buckets):
        idxs = buckets[padded_len]
        for start in range(0, len(idxs), batch_size):
            group = idxs[start: start + batch_size]
            # pad rows are dropped after the Viterbi; a mesh pads to the full
            # batch so that every data rank holds the same number of rows
            B = batch_size if mesh is not None else min(1 << (len(group) - 1).bit_length(),
                                                         batch_size)
            a = np.zeros((B, padded_len), np.float32)
            labels = np.zeros((B, args.max_label_len), np.int32)
            lens = np.ones((B,), np.int32)
            frames = np.ones((B,), np.int32)
            mel_lens = np.ones((B,), np.int32)
            for j, i in enumerate(group):
                audio = load_audio_file(records[i].audio_path, args.is_mixture)["speech"]
                n = min(len(audio), padded_len)
                a[j, :n] = audio[:n]
                classes = table.map_tokens(np.asarray(
                    bert.encode(records[i].text, add_special_tokens=False), np.int32))
                L = min(len(classes), args.max_label_len)
                labels[j, :L] = classes[:L]
                lens[j] = L
                mel_lens[j] = n // HOP_LENGTH
                frames[j] = int(round(mel_lens[j] / 2.0))

            rows = slice(None) if mesh is None else batch_sharding(mesh).rows(B)
            out, _ = forward_from_audio(
                model, torch.from_numpy(a[rows]).to(device),
                frame_lengths=torch.from_numpy(frames[rows]).to(device),
                mel_lengths=torch.from_numpy(mel_lens[rows]).to(device),
                align_head_output="hidden" if fused else "logits", encode_fn=encode_fn)
            frames = np.minimum(frames, out.shape[1])
            lab_t, len_t, fr_t = (torch.from_numpy(x[rows]) for x in (labels, lens, frames))
            if fused:
                on, off = viterbi_align_fused(out, fc.weight, fc.bias, lab_t,
                                              len_t, fr_t, mode=mode)
            else:
                on, off = viterbi_align(out, lab_t, len_t, fr_t, mode=mode)
            sec = frames_to_seconds(on, off).cpu().numpy()
            if mesh is not None:
                sec = np.concatenate(gather_objects(sec, mesh.get_group(DATA_AXIS)))
            for j, i in enumerate(group):
                L = int(lens[j])
                results[i] = [[float(s), float(e)] for s, e in sec[j, :L]]

    for i, record in enumerate(records):
        yield record, results[i]


def main(argv=None):
    args = parse_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if not os.path.exists(args.model_dir) or not os.path.exists(args.test_data):
        raise SystemExit("--model-dir and --test-data must exist")

    device = args.device
    if args.mesh_data or args.mesh_model > 1 or args.mesh_pipe > 1:
        device = str(init_distributed(args.device))
    _, model, _ = load_model_dir(args.model_dir, args.model_name, use_bf16=args.bf16,
                                 fast_gelu=args.fast_gelu, int8_encoder=args.int8_encoder,
                                 device=device)
    bert, _ = build_tokenizers(args)
    table = load_pronunciation_table()
    records = read_data(args.test_data)

    total_mae = 0.0
    cnt = 0
    primary = is_primary()
    for record, segments in align_records(records, model, table, bert, args):
        if record.lyric_onset_offset is None:
            continue  # reference skips samples without ground truth (:156-157)
        sample_mae = mae([record.lyric_onset_offset], [segments])
        total_mae += sample_mae
        cnt += 1
        if primary:
            print(f"{os.path.basename(record.audio_path)}: MAE={sample_mae:.4f}")

    avg_mae = total_mae / max(cnt, 1)
    if primary:
        print("Average MAE:", avg_mae)
    return avg_mae


if __name__ == "__main__":
    main()
