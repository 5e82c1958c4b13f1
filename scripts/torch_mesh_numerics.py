#!/usr/bin/env python3
"""How the row-parallel sums of tensor parallelism move a bf16 encoder, on
one NVIDIA GPU, at whisper-medium (B = 16 x 30 s, random weights from a
seed, bf16-resident, tanh GELU):

    python3 scripts/torch_mesh_numerics.py [M]

Under ``--mesh-model M`` each rank's attention out and fc2 linears give a
partial product of its input columns; ``parallel.mesh`` sums the partials
over the model group and adds the bias after the sum. This script runs the
encoder in one process with every row-parallel linear computed as M such
partials (``models.whisper._row_linear`` replaced), in the ways the sum can
be taken, and prints each one's rel-L2 against the unsharded bf16 encoder
and against the float32 encoder on the same bf16-rounded weights:

* ``bf16_sum``: bf16 partials summed in bf16, then the bias in bf16 (what
  an all-reduce of the bf16 partials gives);
* ``fp32_sum``: bf16 partials summed in float32 with the bias, one rounding;
* ``fp32_partials``: float32 partials of the bf16 operands (``torch.mm``
  with ``out_dtype``), summed with the bias in float32, one rounding.

It also prints the torch version, whether ``out_dtype`` is taken, and the
card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F

    from lyricalignment_tpu_torch.cli.common import resolve_device
    from lyricalignment_tpu_torch.models import whisper
    from lyricalignment_tpu_torch.ops.mel import log_mel

    m = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}; model axis {m}")

    wcfg = dataclasses.replace(whisper.WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True)
    model = whisper.init_whisper_params(wcfg, torch.Generator(device=dev).manual_seed(0), dev)
    whisper.bf16_resident(model).eval()
    f32 = whisper.Whisper(dataclasses.replace(wcfg, compute_dtype=torch.float32)).to(dev).eval()
    f32.load_state_dict(model.state_dict())
    g = torch.Generator(device=dev).manual_seed(21)
    mel = log_mel(torch.randn(16, 30 * 16000, device=dev, generator=g) * 0.1)

    def partials(x, w):
        k = x.shape[-1] // m
        return [(x[..., i * k:(i + 1) * k], w[:, i * k:(i + 1) * k]) for i in range(m)]

    def bf16_sum(lin, x):
        w = lin.weight.to(x.dtype)
        y = sum(F.linear(a, b) for a, b in partials(x, w))
        return y + lin.bias.to(x.dtype)

    def fp32_sum(lin, x):
        w = lin.weight.to(x.dtype)
        y = sum(F.linear(a, b).float() for a, b in partials(x, w))
        return (y + lin.bias.float()).to(x.dtype)

    def fp32_partials(lin, x):
        w = lin.weight.to(x.dtype)
        y = sum(torch.mm(a.reshape(-1, a.shape[-1]), b.t(), out_dtype=torch.float32)
                for a, b in partials(x, w)).reshape(*x.shape[:-1], w.shape[0])
        return (y + lin.bias.float()).to(x.dtype)

    try:
        torch.mm(mel[0, :, :64].bfloat16(), mel[0, :64, :8].bfloat16(), out_dtype=torch.float32)
        out_dtype = True
    except (TypeError, RuntimeError, NotImplementedError) as exc:
        out_dtype = False
        print(f"out_dtype not taken: {type(exc).__name__}: {str(exc)[:120]}")

    rel = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    with torch.inference_mode():
        ref16 = model.embed_audio(mel)
        ref32 = f32.embed_audio(mel)
        print(f"unsharded bf16 against float32: {rel(ref16, ref32):.3e}")
        original = whisper._row_linear
        for name, fn in (("bf16_sum", bf16_sum), ("fp32_sum", fp32_sum),
                         ("fp32_partials", fp32_partials)):
            if name == "fp32_partials" and not out_dtype:
                continue
            whisper._row_linear = lambda lin, x, group, int8=False, fn=fn: fn(lin, x)
            try:
                out = model.embed_audio(mel)
            finally:
                whisper._row_linear = original
            print(f"{name}: against unsharded bf16 {rel(out, ref16):.3e}, "
                  f"against float32 {rel(out, ref32):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
