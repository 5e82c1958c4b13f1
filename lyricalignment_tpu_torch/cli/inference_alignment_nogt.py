"""No-ground-truth alignment CLI: print per-song [[onset, offset, char], ...].

Port of ``lyricalignment_tpu/cli/inference_alignment_nogt.py`` (the
reference's ``inference_alignment_nogt.py:130-205``): aligns every record
(no ground truth needed) and prints each song's file name and its
per-character segments; ``-o`` also writes them as JSON.

    python -m lyricalignment_tpu_torch.cli.inference_alignment_nogt \\
        -f test.json --model-dir result --bert-vocab vocab.txt --use-ctc-loss
"""

from __future__ import annotations

import argparse
import json
import os

from lyricalignment_tpu_torch.cli.common import (
    add_asset_args,
    build_tokenizers,
    load_model_dir,
    set_seed,
)
from lyricalignment_tpu_torch.cli.inference_alignment import align_records
from lyricalignment_tpu_torch.data.records import read_data
from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-f", "--test-data", type=str, required=True)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", default="best",
                   choices=["best", "best_align", "best_trans", "last"])
    p.add_argument("--is-mixture", type=int, choices=[0, 1, 2], default=0)
    p.add_argument("--use-ctc-loss", action="store_true")
    p.add_argument("--batch-size", type=int, default=1,
                   help="records aligned per device pass")
    p.add_argument("--seed", type=int, default=114514)
    p.add_argument("--bucket-seconds", type=float, default=5.0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast-gelu", action="store_true",
                   help="tanh-approximate GELU in the encoder")
    p.add_argument("--int8-encoder", action="store_true",
                   help="W8A8 int8 encoder matmuls on int8-resident weights")
    p.add_argument("--max-label-len", type=int, default=128)
    p.add_argument("-o", "--output", type=str, default=None,
                   help="optional JSON output path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    add_asset_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.seed)
    if not os.path.exists(args.model_dir) or not os.path.exists(args.test_data):
        raise SystemExit("--model-dir and --test-data must exist")

    _, model, _ = load_model_dir(args.model_dir, args.model_name, use_bf16=args.bf16,
                                 fast_gelu=args.fast_gelu, int8_encoder=args.int8_encoder,
                                 device=args.device)
    bert, _ = build_tokenizers(args)
    table = load_pronunciation_table()
    records = read_data(args.test_data)

    results = []
    for record, segments in align_records(records, model, table, bert, args):
        rows = [[on, off, ch] for (on, off), ch in zip(segments, record.text)]
        print(os.path.basename(record.audio_path))
        print(rows)
        results.append({"song_path": record.audio_path, "alignment": rows})

    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2, ensure_ascii=False)
    return results


if __name__ == "__main__":
    main()
