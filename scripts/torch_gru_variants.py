#!/usr/bin/env python3
"""Times variants of the port's bi-GRU recurrence kernel
(``lyricalignment_tpu_torch/csrc/gru.cu``, ``la_gru_recurrence``) on one
NVIDIA GPU at the alignment cells' shape (B = 16, T = 1500, H = 384, both
directions), beside cuDNN's packed float32 layer:

    python3 scripts/torch_gru_variants.py [VARIANT ...]

Each variant is the source with the text substitutions listed in
``VARIANTS``, compiled on its own (one nvcc each, all started together)
from a copy of ``csrc/`` with the library's flags. A variant is checked
against ``gru_recurrence_plain`` (atol 1e-5), except those marked "timed
only", which leave out part of the work to show what it costs. Each is
timed in two rounds by CUDA events, and ptxas' register and spill line is
printed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_PRODUCTS = ("for (int i = 0; i < NK4; ++i) {\n      float4 h4[NCH][kChunk];",
                "for (int i = 0; i < 0; ++i) {\n      float4 h4[NCH][kChunk];")
_WAIT = "      wait_cluster(&bars[b], ((s - 1) >> 1) & 1);\n"
_FAST_CELL = ("__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }",
              "__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + __expf(-x)); }\n"
              "#define tanhf(x) (2.0f * sigmoid(2.0f * (x)) - 1.0f)")
# clock64 stamps of block 0's thread 0 at seven points of each step
# (timeline variants): the step's start, the state's arrival, the products,
# the reduction, the cell, the barrier, the push
_STAMP = "if (tid == 0 && blockIdx.x == 0 && s < 2048) g_stamps[0][{k}][s] = clock64();\n"
_TIMELINE = [
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n__device__ long long g_stamps[2][7][2048];\n'
     'LA_API int la_gru_stamps(void* host) {\n'
     '  return cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n'),
    ("    if (s > 0) {\n      // h_s arrived", "    " + _STAMP.format(k=0)
     + "    if (s > 0) {\n      // h_s arrived"),
    ("  // its next phase\n    }\n", "  // its next phase\n    }\n    " + _STAMP.format(k=1)),
    ("    // reduce the sums", "    " + _STAMP.format(k=2) + "    // reduce the sums"),
    ("    float* sl = stage +", "    " + _STAMP.format(k=3) + "    float* sl = stage +"),
    ("    if (s + 1 == T) return;", "    " + _STAMP.format(k=4) + "    if (s + 1 == T) return;"),
    ("    __syncthreads();\n    // this block's slice", "    __syncthreads();\n    "
     + _STAMP.format(k=5) + "    // this block's slice"),
    ("bar[m] + 8u * (b ^ 1));\n", "bar[m] + 8u * (b ^ 1));\n    " + _STAMP.format(k=6)),
]
STAMP_NAMES = ("wait", "products", "reduce", "cell", "barrier", "push")


def _groups(n):
    return ("const int fit = max(1, p->active / p->dirs);", f"const int fit = {n};")


# name -> (timed only?, [(old, new), ...])
VARIANTS = {
    "as_built": (False, []),
    # no products: the exchange, the cell and the loads alone
    "no_products": (True, [_NO_PRODUCTS]),
    # two groups of 8 rows (64 SMs), or four of 4 whatever the card holds
    "groups2": (False, [_groups(2)]),
    "groups4": (False, [_groups(4)]),
    # one warp waits for the state, then a block barrier
    "wait_warp": (False, [(_WAIT, "      if (tid < 32) " + _WAIT.lstrip()
                           + "      __syncthreads();\n")]),
    # sigmoid and tanh from __expf and a rounded reciprocal
    "fast_cell": (False, [_FAST_CELL]),
    "timeline": (False, _TIMELINE),
    "fast_cell_timeline": (False, [_FAST_CELL] + _TIMELINE),
}


def patched_csrc(name: str, root: str) -> str:
    src = os.path.join(REPO, "lyricalignment_tpu_torch", "csrc")
    dst = os.path.join(root, name)
    shutil.copytree(src, dst)
    path = os.path.join(dst, "gru.cu")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise ValueError(f"{name}: substitution not found: {old[:60]!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return dst


def compile_variants(names, root):
    sys.path.insert(0, REPO)
    from lyricalignment_tpu_torch.kernels import build

    procs = []
    for name in names:
        csrc = patched_csrc(name, root)
        so = os.path.join(root, f"{name}.so")
        cmd = ([build._nvcc()] + build.ARCH_FLAGS + build.COMMON_FLAGS
               + ["-shared", "-I", csrc, "-o", so, os.path.join(csrc, "gru.cu"),
                  os.path.join(csrc, "runtime.cu")])
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        regs = [line.strip() for line in out.splitlines() if "Used" in line]
        print(f"[ptxas] {name}: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(so)
        lib.la_gru_recurrence.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.la_gru_recurrence.restype = ctypes.c_int
        if "timeline" in name:
            lib.la_gru_stamps.argtypes = [ctypes.c_void_p]
            lib.la_gru_stamps.restype = ctypes.c_int
        libs[name] = lib
    return libs


def report_timeline(name, lib, t):
    """Mean clock64 cycles of each part of a step of block 0, by chunk,
    over the steps away from the ends."""
    import numpy as np

    stamps = np.zeros((2, 7, 2048), dtype=np.int64)
    if lib.la_gru_stamps(ctypes.c_void_p(stamps.ctypes.data)) != 0:
        raise RuntimeError("no stamps")
    lo, hi = 50, min(t, 2048) - 50
    for q in range(1):
        st = stamps[q, :, lo:hi].astype(np.float64)
        if not st[0].any():
            continue
        parts = {n: float(np.mean(st[k + 1] - st[k])) for k, n in enumerate(STAMP_NAMES)}
        period = float(np.mean(np.diff(stamps[q, 0, lo:hi].astype(np.float64))))
        print(f"[timeline] {name}: step period {period:.0f} cycles; "
              + ", ".join(f"{n} {v:.0f}" for n, v in parts.items()), flush=True)


def main(argv) -> int:
    import torch
    import torch.nn.functional as F
    from torch import nn

    sys.path.insert(0, REPO)
    from chip_smoke import time_ms
    from lyricalignment_tpu_torch.cli.common import resolve_device
    from lyricalignment_tpu_torch.ops.gru import gru_recurrence_plain

    names = argv or list(VARIANTS)
    dev = resolve_device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    with tempfile.TemporaryDirectory() as root:
        libs = compile_variants(names, root)
        torch.manual_seed(0)
        b, t, h, n_in = 16, 1500, 384, 1024
        rnn = nn.GRU(n_in, h, bidirectional=True, batch_first=True).to(dev)
        x = torch.randn(b, t, n_in, device=dev)
        sfx = ("", "_reverse")
        with torch.no_grad():
            gi = F.linear(x, torch.cat([getattr(rnn, f"weight_ih_l0{s}") for s in sfx]),
                          torch.cat([getattr(rnn, f"bias_ih_l0{s}") for s in sfx])).contiguous()
            w_hh = torch.stack([getattr(rnn, f"weight_hh_l0{s}") for s in sfx]).contiguous()
            b_hh = torch.stack([getattr(rnn, f"bias_hh_l0{s}") for s in sfx]).contiguous()
            lens = torch.randint(1, t + 1, (b,), device=dev, dtype=torch.int32)
            lens[0] = t
            want = gru_recurrence_plain(gi, w_hh, b_hh, lens)
            stream = torch.cuda.current_stream().cuda_stream
            out = torch.empty(b, t, 2 * h, device=dev)

            def run(lib):
                rc = lib.la_gru_recurrence(gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                           lens.data_ptr(), out.data_ptr(), b, t, h, 2, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")

            for name in names:
                run(libs[name])
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                timed_only = VARIANTS[name][0]
                if not timed_only and err > 1e-5:
                    raise AssertionError(f"{name}: max abs err {err:.3e}")
                print(f"[check] {name}: max abs err {err:.3e}"
                      f"{' (timed only)' if timed_only else ''}", flush=True)
                if "timeline" in name:
                    report_timeline(name, libs[name], t)
            packed = nn.utils.rnn.pack_padded_sequence(x, lens.cpu(), batch_first=True,
                                                       enforce_sorted=False)
            for rnd in range(2):
                for name in names:
                    ms = time_ms(lambda: run(libs[name]), reps=10)
                    print(f"[time] round {rnd} {name}: {ms:.4f} ms, {ms / t * 1e3:.3f} us a step",
                          flush=True)
                cudnn_ms = time_ms(lambda: rnn(packed), reps=5)
                print(f"[time] round {rnd} cuDNN packed layer (with its input product): "
                      f"{cudnn_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
