#!/usr/bin/env python3
"""Times variants of the port's bf16 attention kernels on one NVIDIA GPU: the
forward (``lyricalignment_tpu_torch/csrc/attention.cu``) and the backward
pair, dK/dV and dQ (``csrc/attention_bwd.cu``):

    python3 scripts/torch_attention_variants.py [fwd | bwd | VARIANT ...]

Each variant is a kernel source with the text substitutions listed in
``VARIANTS`` below, compiled on its own (one nvcc each, all started
together) from a copy of ``csrc/``. ``fwd`` / ``bwd`` name every variant of
one source; with no arguments every variant runs.

Forward variants are checked against the plain float32 version at the
serving shape (B = 16, H = 16, T = 1500, with a key bias) and the training
shape (B = 2, H = 16, T = 1500, with the row log-sum-exp), then timed there
in two rounds, beside ``scaled_dot_product_attention``. Backward variants
(names starting ``bwd_``) are checked against the plain versions of dK/dV
and dQ at the training shape and timed there and at B = 16 (a grid without
a tail), beside the backward of ``scaled_dot_product_attention`` (dq, dk and
dv in one call). The ``no_*`` variants leave out one stage of the loop to
show what it costs; their outputs are wrong on purpose and only timed.
ptxas' register and spill lines of each variant's kernels are printed.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ex2_ftz(fmaf(x, kLog2e, y)) in attention_bwd.cu, for the expf variant
_EX2 = re.compile(r"ex2_ftz\(\s*fmaf\(([^,]+), kLog2e, (.*?)\)\);", re.S)


def _drop(call: str, keep_alive: str = ""):
    """Replace one product by an empty commit group (the waits count groups)."""
    return (call, "wgmma_commit();" + keep_alive)


def _fill(name: str) -> str:
    return f" for (int j = 0; j < kRows / 2; ++j) {name}[j] = 1e-3f * (j + lane);"


def _touch(acc: str, frags: str) -> str:
    return (" for (int kk = 0; kk < kRows / 16; ++kk) "
            f"{acc}[kk] += __uint_as_float({frags}[kk][0] ^ {frags}[kk][3]);")


# name -> (source, [(text in the source, replacement) or (compiled regex, replacement), ...])
VARIANTS = {
    "as_built": ("attention.cu", []),
    "ring_3": ("attention.cu", [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "consumers_2": ("attention.cu", [
        ("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;"),
        ("kProducerRegs = 32, kConsumerRegs = 160;", "kProducerRegs = 40, kConsumerRegs = 232;")]),
    "grid_per_item": ("attention.cu", [("n_work < sms ? n_work : sms", "n_work")]),
    "expf": ("attention.cu", [
        ("scale[i] = ex2_ftz((m[i] - mx[i]) * kLog2e);", "scale[i] = expf(m[i] - mx[i]);"),
        ("sc[j] = ex2_ftz(fmaf(sc[j], kLog2e, neg[(j / 2) % 2]));",
         "sc[j] = expf(sc[j] - mx[(j / 2) % 2]);")]),
    "no_softmax": ("attention.cu", [
        ("online_softmax<kBias>(sc, m, l, scale, sm.bias[s], t * kRows, seq, lane);",
         "scale[0] = scale[1] = 1.f; l[0] = l[1] = 1.f; m[0] = m[1] = 0.f;")]),
    "no_exp": ("attention.cu", [("sc[j] = ex2_ftz(fmaf(sc[j], kLog2e, neg[(j / 2) % 2]));",
                                 "sc[j] = fmaf(sc[j], kLog2e, neg[(j / 2) % 2]);")]),
    "no_pv": ("attention.cu", [
        ("issue_pv(o, pa, sm.v[s]);",
         "for (int kk = 0; kk < 8; ++kk) o[kk] += __uint_as_float(pa[kk][0] ^ pa[kk][3]);")]),
    "no_qk": ("attention.cu", [
        ("issue_qk(sc, desc_q, sm.k[s]);\n        wgmma_wait<0>();",
         "for (int j = 0; j < 64; ++j) sc[j] = __int_as_float(j * it + lane);")]),
    # ---- the backward pair
    "bwd_as_built": ("attention_bwd.cu", []),
    # 512 threads leave a dK/dV consumer 152 registers beside a producer that
    # carries the statistics: its accumulators and operands do not fit
    "bwd_dkdv_consumers_3": ("attention_bwd.cu", [
        ("using DkdvShape = Shape<2, 40, 232, 4>;", "using DkdvShape = Shape<3, 56, 152, 4>;")]),
    "bwd_dq_consumers_2": ("attention_bwd.cu", [
        ("using DqShape = Shape<3, 24, 160, 4>;", "using DqShape = Shape<2, 40, 232, 4>;")]),
    # 128-row ring tiles: the score accumulators double, past the registers
    "bwd_tile_128": ("attention_bwd.cu", [
        ("constexpr int kRows = 64;", "constexpr int kRows = 128;"),
        ("using DkdvShape = Shape<2, 40, 232, 4>;", "using DkdvShape = Shape<2, 40, 232, 2>;"),
        ("using DqShape = Shape<3, 24, 160, 4>;", "using DqShape = Shape<2, 40, 232, 2>;")]),
    "bwd_rings_2": ("attention_bwd.cu", [
        ("using DkdvShape = Shape<2, 40, 232, 4>;", "using DkdvShape = Shape<2, 40, 232, 2>;"),
        ("using DqShape = Shape<3, 24, 160, 4>;", "using DqShape = Shape<3, 24, 160, 2>;")]),
    "bwd_rings_8": ("attention_bwd.cu", [
        ("using DkdvShape = Shape<2, 40, 232, 4>;", "using DkdvShape = Shape<2, 40, 232, 8>;"),
        ("using DqShape = Shape<3, 24, 160, 4>;", "using DqShape = Shape<3, 24, 160, 8>;")]),
    "bwd_grid_per_item": ("attention_bwd.cu", [("*blocks = n_work < sms ? n_work : sms;",
                                                "*blocks = n_work;")]),
    "bwd_expf": ("attention_bwd.cu", [(_EX2, r"expf(\1 + (\2) * 0.6931471805599453f);")]),
    "bwd_no_exp": ("attention_bwd.cu", [("ex2_ftz(", "(")]),
    "bwd_no_elementwise": ("attention_bwd.cu", [
        ("probs_t<kBias>(st, kb2, sm.nl2[s], lane);", ""),
        ("dscores_t(dpt, st, sm.delta[s], lane);", ""),
        ("probs<kBias>(sc, nl2, sm.bias[s], lane);", ""),
        ("dscores(sc, dp, dl, t * kRows, seq, lane);", "")]),
    "bwd_no_s": ("attention_bwd.cu", [
        _drop("issue_scores(st, ka, sm.q[s]);", _fill("st")),
        _drop("issue_scores(sc, qa, sm.k[s]);", _fill("sc"))]),
    "bwd_no_dp": ("attention_bwd.cu", [
        _drop("issue_scores(dpt, va, sm.dout[s]);", _fill("dpt")),
        _drop("issue_scores(dp, oa, sm.v[s]);", _fill("dp"))]),
    "bwd_no_dv": ("attention_bwd.cu", [
        _drop("issue_grad(dva, pa, sm.dout[s]);", _touch("dva", "pa"))]),
    "bwd_no_dk_dq": ("attention_bwd.cu", [
        _drop("issue_grad(dka, dsa, sm.q[s]);", _touch("dka", "dsa")),
        _drop("issue_grad(dqa, dsa, sm.k[s]);", _touch("dqa", "dsa"))]),
}
FWD_SHAPES = {"serving": (16, 1500, 16, True), "training": (2, 1500, 16, False)}
BWD_SHAPES = {"training": (2, 1500, 16), "B=16": (16, 1500, 16)}
LAUNCHERS = {"attention.cu": ("la_bias_attention", "la_attention_fwd"),
             "attention_bwd.cu": ("la_attention_dkdv", "la_attention_dq")}


def patched_csrc(name: str, root: str) -> str:
    """A copy of csrc/ under ``root`` with the variant's substitutions applied
    to its source."""
    from lyricalignment_tpu_torch.kernels import build

    source, subs = VARIANTS[name]
    dst = os.path.join(root, name)
    shutil.copytree(build.CSRC_DIR, dst)
    path = os.path.join(dst, source)
    with open(path) as f:
        src = f.read()
    for old, new in subs:
        if isinstance(old, re.Pattern):
            src, count = old.subn(new, src)
        else:
            count = src.count(old)
            src = src.replace(old, new)
        if not count:
            raise ValueError(f"variant {name}: {old!r} is not in {source}")
    with open(path, "w") as f:
        f.write(src)
    return dst


def compile_variants(names, root):
    """name -> ctypes library with the launchers of the variant's source."""
    from lyricalignment_tpu_torch.kernels import build

    procs = {}
    for name in names:
        source = VARIANTS[name][0]
        csrc = patched_csrc(name, root)
        so = os.path.join(csrc, "variant.so")
        cmd = ([build._nvcc()] + build.ARCH_FLAGS + build.COMMON_FLAGS
               + ["-shared", "-I", csrc, "-o", so, os.path.join(csrc, source)])
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        # the Hopper kernels (they take CUtensorMaps): function, registers, spills
        lines, found = out.splitlines(), []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "CUtensorMap" in line:
                kernel = ("dkdv" if "dkdv" in line else "dq" if "dq_kernel" in line else "fwd")
                info = " ".join(x.strip().replace("ptxas info    : ", "")
                                for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x)
                found.append(f"{kernel}: {info}")
        print(f"[{name}] ptxas: {sorted(set(found))}", flush=True)
        lib = ctypes.CDLL(so)
        for fn in LAUNCHERS[VARIANTS[name][0]]:
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_forward(libs):
    import torch
    import torch.nn.functional as F

    from chip_smoke import rel_l2, time_ms
    from lyricalignment_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for key, (b, t, h, with_bias) in FWD_SHAPES.items():
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


def time_backward(libs):
    import torch
    import torch.nn.functional as F

    from chip_smoke import rel_l2, time_ms
    from lyricalignment_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(1)
    data = {}
    for key, (b, t, h) in BWD_SHAPES.items():
        q, k, v, dout = (torch.randn(b, t, h, 64, device="cuda", generator=g).mul_(0.4)
                         .to(torch.bfloat16) for _ in range(4))
        out, lse = attention.attention_forward(q, k, v, None, with_lse=True)
        delta = attention.attention_delta(out, dout)
        refs = None
        if key == "training":  # the plain versions hold [B, H, T, T] in float32
            refs = (*attention.attention_dkdv_plain(q, k, v, dout, lse, delta),
                    attention.attention_dq_plain(q, k, v, dout, lse, delta))
        data[key] = (q, k, v, dout, lse, delta, refs)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for rnd in range(2):
        for name, lib in libs.items():
            for key, (q, k, v, dout, lse, delta, refs) in data.items():
                b, t, h = q.shape[:3]
                dk, dv, dq = (torch.empty_like(q) for _ in range(3))
                ins = tuple(x.data_ptr() for x in (q, k, v, dout, lse, delta))

                def dkdv():
                    return lib.la_attention_dkdv(*ins, None, dk.data_ptr(), dv.data_ptr(),
                                                 b, t, h, 1, stream)

                def dq_call():
                    return lib.la_attention_dq(*ins, None, dq.data_ptr(), b, t, h, 1, stream)

                if dkdv() != 0 or dq_call() != 0:
                    raise RuntimeError(f"variant {name}: launch refused at {key}")
                torch.cuda.synchronize()
                if rnd == 0 and refs is not None:
                    print(f"[{name}] {key}: rel_l2 dk {rel_l2(dk, refs[0]):.3e} dv "
                          f"{rel_l2(dv, refs[1]):.3e} dq {rel_l2(dq, refs[2]):.3e}", flush=True)
                times.setdefault((name, key, "dkdv"), []).append(
                    time_ms(dkdv, reps=20, warmup=3))
                times.setdefault((name, key, "dq"), []).append(
                    time_ms(dq_call, reps=20, warmup=3))
    for key, (q, k, v, dout, _, _, _) in data.items():
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
        dout_t = dout.transpose(1, 2)
        ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                                 retain_graph=True), reps=20, warmup=3)
        print(f"[sdpa backward] {key}: {ms:.4f} ms")
    for (name, key, kernel), ms in times.items():
        b, t, h = data[key][0].shape[:3]
        ops = (4 if kernel == "dkdv" else 3) * 2 * b * h * t * t * 64
        print(f"[{name}] {key} {kernel}: ms {[round(x, 4) for x in ms]} -> "
              f"{ops / min(ms) / 1e9:.1f} TFLOP/s")


def main(argv) -> int:
    import torch

    families = {"fwd": [n for n in VARIANTS if not n.startswith("bwd_")],
                "bwd": [n for n in VARIANTS if n.startswith("bwd_")]}
    names = [n for arg in (argv or list(families)) for n in families.get(arg, [arg])]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as root:
        libs = compile_variants(names, root)
        fwd = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "attention.cu"}
        bwd = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "attention_bwd.cu"}
        if fwd:
            time_forward(fwd)
        if bwd:
            time_backward(bwd)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
