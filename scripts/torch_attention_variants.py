#!/usr/bin/env python3
"""Times variants of the port's bf16 attention forward
(``lyricalignment_tpu_torch/csrc/attention.cu``) on one NVIDIA GPU:

    python3 scripts/torch_attention_variants.py [VARIANT ...]

Each variant is the kernel source with the text substitutions listed in
``VARIANTS`` below, compiled on its own (one nvcc each, all started
together) from a copy of ``csrc/``. Each is checked against the plain
float32 version at the serving shape (B = 16, H = 16, T = 1500, with a key
bias) and the training shape (B = 2, H = 16, T = 1500, with the row
log-sum-exp), then timed there in two rounds, beside
``scaled_dot_product_attention``. The ``no_*`` variants leave out one stage
of the key loop to show what it costs; their outputs are wrong on purpose
and only timed. With no arguments every variant runs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> [(text in attention.cu, replacement), ...]
VARIANTS = {
    "as_built": [],
    "ring_3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "consumers_2": [("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;"),
                    ("kProducerRegs = 32, kConsumerRegs = 160;",
                     "kProducerRegs = 40, kConsumerRegs = 232;")],
    "grid_per_item": [("n_work < sms ? n_work : sms", "n_work")],
    "expf": [("scale[i] = ex2_ftz((m[i] - mx[i]) * kLog2e);", "scale[i] = expf(m[i] - mx[i]);"),
             ("sc[j] = ex2_ftz(fmaf(sc[j], kLog2e, neg[(j / 2) % 2]));",
              "sc[j] = expf(sc[j] - mx[(j / 2) % 2]);")],
    "no_softmax": [("online_softmax<kBias>(sc, m, l, scale, sm.bias[s], t * kRows, seq, lane);",
                    "scale[0] = scale[1] = 1.f; l[0] = l[1] = 1.f; m[0] = m[1] = 0.f;")],
    "no_exp": [("sc[j] = ex2_ftz(fmaf(sc[j], kLog2e, neg[(j / 2) % 2]));",
                "sc[j] = fmaf(sc[j], kLog2e, neg[(j / 2) % 2]);")],
    "no_pv": [("issue_pv(o, pa, sm.v[s]);",
               "for (int kk = 0; kk < 8; ++kk) o[kk] += __uint_as_float(pa[kk][0] ^ pa[kk][3]);")],
    "no_qk": [("issue_qk(sc, desc_q, sm.k[s]);\n        wgmma_wait<0>();",
               "for (int j = 0; j < 64; ++j) sc[j] = __int_as_float(j * it + lane);")],
}
SHAPES = {"serving": (16, 1500, 16, True), "training": (2, 1500, 16, False)}


def patched_csrc(name: str, subs, root: str) -> str:
    """A copy of csrc/ under ``root`` with ``subs`` applied to attention.cu."""
    from lyricalignment_tpu_torch.kernels import build

    dst = os.path.join(root, name)
    shutil.copytree(build.CSRC_DIR, dst)
    path = os.path.join(dst, "attention.cu")
    with open(path) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} is not in attention.cu")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return dst


def compile_variants(names, root):
    """name -> ctypes library with the two forward launchers bound."""
    from lyricalignment_tpu_torch.kernels import build

    procs = {}
    for name in names:
        csrc = patched_csrc(name, VARIANTS[name], root)
        so = os.path.join(csrc, "attention.so")
        cmd = ([build._nvcc()] + build.ARCH_FLAGS + build.COMMON_FLAGS
               + ["-shared", "-I", csrc, "-o", so, os.path.join(csrc, "attention.cu")])
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        regs = sorted({line.split(":", 1)[1].strip() for line in out.splitlines()
                       if "Used" in line and "registers" in line})
        print(f"[{name}] ptxas: {regs}", flush=True)
        lib = ctypes.CDLL(so)
        for fn in ("la_bias_attention", "la_attention_fwd"):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import rel_l2, time_ms
    from lyricalignment_tpu_torch.ops import attention

    names = argv or list(VARIANTS)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as root:
        libs = compile_variants(names, root)
        g = torch.Generator(device="cuda").manual_seed(0)
        data = {}
        for key, (b, t, h, with_bias) in SHAPES.items():
            q, k, v = (torch.randn(b, t, h, 64, device="cuda", generator=g).mul_(0.35)
                       .to(torch.bfloat16) for _ in range(3))
            bias = torch.randn(t, device="cuda", generator=g) * 0.5 if with_bias else None
            ref, ref_lse = attention.attention_fwd_plain(q, k, v, bias, with_lse=True)
            data[key] = (q, k, v, bias, ref, ref_lse)
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for rnd in range(2):
            for name, lib in libs.items():
                for key, (q, k, v, bias, ref, ref_lse) in data.items():
                    b, t, h = q.shape[:3]
                    out = torch.empty_like(q)
                    lse = torch.empty(b, h, t, device="cuda")
                    bp = None if bias is None else bias.data_ptr()
                    if key == "serving":
                        def call():
                            return lib.la_bias_attention(q.data_ptr(), k.data_ptr(),
                                                         v.data_ptr(), bp, out.data_ptr(),
                                                         b, t, h, 1, stream)
                    else:
                        def call():
                            return lib.la_attention_fwd(q.data_ptr(), k.data_ptr(),
                                                        v.data_ptr(), bp, out.data_ptr(),
                                                        lse.data_ptr(), b, t, h, 1, stream)
                    if call() != 0:
                        raise RuntimeError(f"variant {name}: launch refused at {key}")
                    torch.cuda.synchronize()
                    if rnd == 0:
                        lse_err = ((lse - ref_lse).abs().max().item() if key == "training"
                                   else float("nan"))
                        print(f"[{name}] {key}: rel_l2 {rel_l2(out, ref):.3e} "
                              f"lse max_abs {lse_err:.3e}", flush=True)
                    times.setdefault((name, key), []).append(time_ms(call, reps=20, warmup=3))
        for key, (q, k, v, bias, _, _) in data.items():
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if bias is None else bias[None].to(torch.bfloat16)
            ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                 scale=1.0), reps=20, warmup=3)
            print(f"[sdpa] {key}: {ms:.4f} ms")
        for (name, key), ms in times.items():
            b, t, h = data[key][0].shape[:3]
            ops = 4 * b * h * t * t * 64
            print(f"[{name}] {key}: ms {[round(x, 4) for x in ms]} -> "
                  f"{ops / min(ms) / 1e9:.1f} TFLOP/s")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
