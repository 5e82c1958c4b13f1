#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lyricalignment_tpu_torch``) on one
NVIDIA GPU (written for the H100, sm_90a):

    python3 chip_smoke.py

1. builds the CUDA kernels from ``lyricalignment_tpu_torch/csrc`` with
   nvcc (printing the build time and ptxas' register/shared-memory report);
2. holds each serving kernel against its plain PyTorch version at the
   shapes of the alignment main path (whisper-medium, 16 clips of 30 s, 48 labels, CTC
   head of 21129 classes), and times kernel, plain version and, where one
   PyTorch call computes the same function, that call; for the bf16
   attention forward also its row log-sum-exp (atol 1e-4), achieved
   TFLOP/s, share of the bound and ptxas' register and spill line; for the
   row log-sum-exp its rate and share of both its bounds (float32 on the
   CUDA cores, the three TF32 products it issues on the tensor cores), two
   runs' equal bits and ptxas' line; for the log-mel its share of the bound,
   its time beside the library call's and ptxas' line; for the Viterbi DP
   exact onsets and offsets and two runs' equal bits at the main path's
   shape and at 16 x 3000 frames x 128 labels, its chain floor (a one-warp
   probe's cycles a dependent step, times the longest row's frames, at the
   SM clock read) and ptxas' lines of every states-a-lane instantiation;
3. serves ``LyricAligner.align_many`` on a whisper-medium AlignModel
   (random weights from a seeded generator, bf16, tanh GELU) for 8 WAV
   requests of 8-45 s, with every kernel's launch counter reset just before
   and read just after; every kernel must have launched, and every segment
   must be finite and ordered;
4. runs a tiny float32 model through the same path on the GPU and on the
   CPU (plain versions), compares hidden states and segments, and checks
   that every kernel (attention on its float32 path) launched on the GPU;
5. times the device-only forward at the bench's operating point (B = 16,
   30 s, L = 48, CTC, medium, bf16) through the serving path's own calls
   (``forward_from_audio`` then ``viterbi_align_fused``) in audio-seconds
   per second, with CUDA-event times of both for each timed batch and the
   launch counts of the timed batches (each kernel once a batch, attention
   once a layer); then traces one more batch with torch.profiler for the
   device time by kernel and the device's idle share, when the profiler
   records device activity.

   Phase "int8", on the same weights: the alignment batch with the int8
   encoder (``int8_resident`` weights, ``torch._int_mm``) beside bf16
   (audio-s/s of each, encoder output rel-L2, onsets/offsets within one
   frame), a trace in which the int8 GEMMs must show, then ``beam_search``
   of 8 windows with int8 cross K/V beside bf16 (ms a step, the first
   logits' rel-L2, the cross K/V cache bytes).

6. phase "train", the multitask training path:
   (a) holds the training attention kernels (forward with the row
       log-sum-exp, dK/dV, dQ) against autograd through the plain einsum at
       edge shapes (T = 1, 63, 65, 1500, with and without a key bias, and
       T = 127, 129 with one; float32 and bf16) and at the training shape
       (B = 2, H = 16, T = 1500, bf16), and times each beside its plain
       version and ``scaled_dot_product_attention`` forward and backward;
       each kernel's rate, share of the bound and ptxas line as in 2., and
       its rate at B = 16 beside B = 2 (the grid's tail);
   (a') holds the row LSE (``la_row_lse``, atol 2e-5 against float64) and
       its backward (``la_row_lse_bwd``: dh, dw, db) against the plain
       chunked recompute in float64 at the training shape (3000 rows, feat
       768, the fc slices w[1:21128] and w[0:21128]; rel-L2 1e-5, two runs
       bit-equal); prints the backward's plan, scratch and ptxas lines, times
       it (all outputs, dh alone, dw and db alone) beside the chunked cuBLAS
       routes, the plain version and the bound, and its kernels' device ms
       from a trace;
   (a'') holds the reduced CTC kernels against the plain recursions at
       B = 2, T = 1500, N = 48 and with an all-padding target and one that
       cannot fit; prints their plan and ptxas lines, times each beside its
       own chain floor (one-warp probes of the forward's _lse3 step and the
       backward's FMA step), the forward beside ``F.ctc_loss`` on the same
       reduced emissions and the backward beside ``F.ctc_loss`` forward and
       backward;
   (b) runs one ``make_train_step`` of a tiny float32 model on the GPU and
       on the CPU (plain versions) and compares losses (rtol 1e-4) and
       updates (at most 1 in 1000 entries off by more than 2e-2 lr);
   (c) trains whisper-medium at the JAX ``bench_train`` operating point
       (bf16, tanh GELU, 8 micro-batches of 2 x 30 s, CTC head of 21129
       classes, align CE + CTC + transcript CE, bf16 gradient accumulation
       and Adam mu; random weights from a seed): one warm-up step, then 3
       timed steps with launch counts reset just before and checked just
       after (mel 8, attention forward 192, dK/dV 192, dQ 192 a step), step
       ms, trained audio-s/s, peak memory and one traced step;
   (e) repeats (c) with ``fused_losses``: on (c)'s weights and first
       micro-batch the row LSE against float64 (atol 2e-5), the fused
       losses and gradients against the unfused ones,
       then one warm-up and 2 timed steps (step ms, peak memory beside
       (c)'s, launches: the row LSE and its backward 16 a step, each
       CTC kernel 8);
   (d) runs ``python -m lyricalignment_tpu_torch.cli.train_multitask`` for 2
       steps of whisper-tiny on synthetic WAVs with ``--fused-losses
       --profile-at-step 2`` (the profile must hold the ``data`` and
       ``train_step`` spans; their host ms and the step's device-busy ms are
       printed), loads the written ``best_model`` with
       ``cli.common.load_model_dir`` and aligns with
       ``LyricAligner.align_many``.

7. phase "transcribe": a tiny float32 model's ``transcribe_records``
   (beam 5 with long-form, greedy with ``--fast-windows``) and a 70 s
   long-form song against the CPU plain path token for token; whisper-medium
   ``beam_search`` and ``greedy_decode`` of 8 windows (encode, prime and
   per-step ms, launches); the transcript and evaluation CLIs.

8. phase "serve", checkpoint interop and the JSONL service at whisper-medium
   (bf16, random weights from a seed): the backbone goes through
   ``la-convert export-hf`` then ``la-convert import-hf`` (seconds and bytes
   printed) and must come back bit for bit; ``cli.serve.serve`` then answers
   a JSONL stream with ``--max-batch 8``: 8 alignment requests of 8-45 s
   (three of them 44.1 kHz stereo WAVs, read by the native loader), 3
   transcription requests, a malformed WAV, a bad JSON line and ids. No
   well-formed request may get an error, only the batch that holds the
   malformed WAV may fall back to one request at a time, every alignment
   must equal ``align_many``'s on the same requests, and the four serving
   kernels must launch.

9. phase "mesh", scale-out (``parallel/mesh.py``) on the one card:
   (a) a world of one over nccl at whisper-medium: the alignment batch (B =
       16 x 30 s) through ``align_records`` unmeshed, with ``--mesh-data 1``
       (equal bit for bit) and tensor-parallel on a model axis of one (every
       f / g / gather collective on nccl; encoder rel-L2 5e-3, onsets and
       offsets within one frame), then one bf16 train step at bench_train's
       micro-batch unmeshed and over the mesh (losses and parameters equal bit
       for bit), launches as in phases "throughput" and "train" (c);
   (b) two spawned processes sharing the card over gloo, ``--mesh-model 2``:
       whisper-medium alignment with 8 of the 16 heads a rank (each rank
       launches la_bias_attention 24 times a batch), the encoder's rel-L2 to
       float32 on the same weights at most 1.1x the single bf16 process's,
       onsets and offsets within one frame of float32's as often, less 0.01,
       and a float32 tiny model's segments at atol 1e-4; fails loudly if the
       card's compute mode is exclusive-process;
   (c) the same two processes, ``--mesh-data 2``: one whisper-tiny train step
       with its align and transcript samples on different ranks, losses rtol
       1e-4 of the single-process GPU step, every training kernel launched on
       each rank.

10. phase "pipe", pipeline parallelism (``parallel/pipeline.py``): two
   spawned processes, the two stages, share the card over gloo (a send is
   a broadcast over the pair's group), after the one-process references
   are computed here:
   (a) whisper-medium alignment of 16 x 30 s through ``align_records`` with
       ``--mesh-pipe 2``: 12 of the 24 encoder blocks a rank (half the
       single process's block bytes), 2 micro-batches of 8, launches a rank
       1 / 24 / 1 / 1, the encoder and segments bit-equal to one bf16
       process (else held to float32 as phase "mesh" (b) is), a float32
       tiny model's segments at atol 1e-4, peak memory beside one
       process's;
   (b) a whisper-medium bf16 train step of 2 x 30 s with both halves
       staged (12 + 12 blocks a rank), 2 micro-batches of 1: losses within
       1e-3 (rel) of one process's, every training kernel launched (1 / 24
       / 24 / 24 a rank), step ms and peak memory beside one process's; a
       float32 tiny model's step with every loss: losses at 1e-5 of one
       process's; gradients at 1e-5 (rel-L2) and updated parameters at
       1e-5 (where the gradient is at least 1e-3 of its tensor's largest;
       elsewhere at most 1 in 1000 entries of a tensor off by more than
       2e-2 of the rate) of one process that runs the same micro-batches
       one after another; the gradients' distance to the unsplit process at
       most 1.1x that process's own, plus 1e-5.

It prints one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero (and prints no result) without CUDA or without the repository
around it, and on any failed check.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, float32 on the
# CUDA cores, TF32 and bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 494.5e12
PEAK_BF16 = 989e12

B, SECONDS, L_BENCH, C_CTC = 16, 30, 48, 21129
# launchers of the alignment serving path (the training path adds
# la_attention_fwd, la_attention_dkdv and la_attention_dq)
SERVING_KERNELS = ("la_log10_mel", "la_bias_attention", "la_row_lse", "la_viterbi")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Device ms of one call: CUDA events around ``reps`` calls that the host
    enqueues while the device is held busy (about 1 ms of sleep a call), so
    a call shorter than its own host-side work is timed on the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * reps))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, peak_ops: float, nbytes: float):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sm_clock_mhz() -> float:
    """The SM clock now, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    return float(out[0])


# One warp timing `steps` dependent steps of the Viterbi DP's chain as it
# stands between two lanes: the shuffle from the previous lane, the compare
# and select of stay against left, the add. out[0] = clock64 cycles for all
# of them (out[1] keeps the result alive).
_STEP_PROBE = r"""
__global__ void step_cycles_kernel(int steps, float em, long long* out) {
  float dp = static_cast<float>(threadIdx.x);
  const long long t0 = clock64();
  for (int t = 0; t < steps; ++t) {
    const float a = __shfl_up_sync(0xffffffffu, dp, 1);
    dp = __fadd_rn(dp > a ? dp : a, em);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = __float_as_int(dp);
  }
}

extern "C" int step_cycles(int steps, long long* out) {
  step_cycles_kernel<<<1, 32>>>(steps, -1.0f, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def viterbi_step_cycles(steps: int = 100000) -> float:
    """SM cycles of one dependent step of the Viterbi DP's chain, from
    ``_STEP_PROBE`` built with the DP's own flags beside the kernel library."""
    import ctypes

    import torch

    from lyricalignment_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src, so = os.path.join(tmp, "step_probe.cu"), os.path.join(tmp, "step_probe.so")
        with open(src, "w") as f:
            f.write(_STEP_PROBE)
        subprocess.run([build._nvcc()] + build.ARCH_FLAGS + build.COMMON_FLAGS
                       + build.PER_SOURCE_FLAGS["viterbi.cu"] + ["-shared", "-o", so, src],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(so)
        out = torch.zeros(2, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        if lib.step_cycles(steps, ctypes.c_void_p(out.data_ptr())) != 0:
            raise AssertionError("the step probe did not launch")
        torch.cuda.synchronize()
        return out[0].item() / steps


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def ptxas_report(source: str, *name_parts: str) -> str:
    """ptxas' register and spill lines, from this run's build log, for the
    kernels of ``source`` whose mangled names contain every ``name_parts``."""
    from lyricalignment_tpu_torch import kernels

    log = str(kernels.build_info.get("log", ""))
    if f"== {source}\n" not in log:
        return "not measured (no build log beside the library)"
    lines = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0].splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and all(p in line for p in name_parts):
            found.append("; ".join(x.strip().replace("ptxas info    : ", "")
                                   for x in lines[i + 1:i + 5]
                                   if "spill" in x or "Used" in x))
    return " | ".join(found) or "no such kernel in the build log"


def report_rate(name: str, ms: float, ops: float, bound_ms: float, sdpa_ms: float,
                source: str, mangled: str, sdpa_text: str = "SDPA") -> None:
    """Achieved rate, share of the bound and ptxas' line for a bf16 attention
    row (the Hopper kernels' instantiations take CUtensorMaps)."""
    log(f"[kernel] {name} bf16: {ops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
        f"bound, {sdpa_text} {sdpa_ms:.4f} ms; ptxas: "
        f"{ptxas_report(source, 'CUtensorMap', mangled)}")


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version at main-path shapes
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from lyricalignment_tpu_torch import HOP_LENGTH, N_FFT
    from lyricalignment_tpu_torch.ops import attention, mel, viterbi

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def report(name, src, replaces, err, tol_text, ok, ms, plain_ms, library_ms,
               bound_ms, bound_by):
        log(f"[kernel] {name}: max_abs_err={err:.3e} ({tol_text}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if library_ms is None else f'{library_ms:.4f}'} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by))

    # --- kernel 1: log10 mel of 16 x 30 s
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    padded = mel.reflect_pad(audio).contiguous()
    n_frames, n_mels = audio.shape[1] // HOP_LENGTH, 80
    got = mel.log10_mel(padded, n_frames, n_mels)
    ref = mel.log10_mel_plain(padded, n_frames, n_mels)
    err = (got - ref).abs().max().item()
    window = torch.hann_window(N_FFT, periodic=True, device=dev)
    fb = torch.from_numpy(mel.mel_filterbank(n_mels=n_mels)).to(dev)

    def stft_mel():
        spec = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, center=True,
                          pad_mode="reflect", return_complex=True)[..., :-1]
        return torch.log10(torch.clamp(fb @ spec.abs() ** 2, min=1e-10))

    # the least work for this function: a real
    # FFT of 5/2 N log2 N a frame, the power (3 a bin) and the filterbank's
    # nonzero weights; bytes of the padded audio in and the log-mel out
    nnz = int((fb != 0).sum())
    ops = B * n_frames * (2.5 * N_FFT * math.log2(N_FFT) + 3 * 201 + 2 * nnz)
    nbytes = 4 * (padded.numel() + nnz + got.numel())
    ms = time_ms(lambda: mel.log10_mel(padded, n_frames, n_mels), reps=20)
    stft_ms = time_ms(stft_mel, reps=20)
    bound_ms, bound_by = bound(ops, PEAK_F32, nbytes)
    report("log10_mel", "lyricalignment_tpu_torch/csrc/mel.cu",
           "lyricalignment_tpu/ops/mel_pallas.py:43", err, "atol 1e-4",
           err <= 1e-4, ms,
           time_ms(lambda: mel.log10_mel_plain(padded, n_frames, n_mels)),
           stft_ms, bound_ms, bound_by)
    log(f"[kernel] log10_mel: {bound_ms / ms:.3f} of the bound ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.2f} GFLOP), {stft_ms / ms:.2f}x faster than torch.stft + mel "
        f"({stft_ms:.4f} ms); ptxas: {ptxas_report('mel.cu', 'log10_mel_kernel')}")
    del audio, padded, got, ref

    # --- kernel 2: encoder attention, B x H = 16 x 16, T = 1500, d_h = 64
    T, H, D = 1500, 16, 64
    bias = torch.zeros(1, T, device=dev)
    bias[0, -7:] = -1e9  # masked keys as the pad-once path has them
    bias[0, :-7] += torch.randn(T - 7, device=dev, generator=g) * 0.5
    q32, k32, v32 = (torch.randn(B, T, H, D, device=dev, generator=g) * 0.35
                     for _ in range(3))
    got = attention.onepass_self_attention(q32, k32, v32, bias)
    ref = attention.einsum_bias_attention(q32, k32, v32, bias)
    err32 = (got - ref).abs().max().item()
    log(f"[kernel] bias_attention f32: max_abs_err={err32:.3e} (atol 1e-4)")
    if err32 > 1e-4:
        raise AssertionError("bias_attention f32 disagrees with its plain version")
    del got, ref
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    del q32, k32, v32
    got = attention.onepass_self_attention(q, k, v, bias)
    ref = attention.einsum_bias_attention(q, k, v, bias)
    err = (got.float() - ref.float()).abs().max().item()
    rel = rel_l2(got, ref)
    _, lse = attention.attention_forward(q, k, v, bias[0], with_lse=True)
    _, ref_lse = attention.attention_fwd_plain(q, k, v, bias[0], with_lse=True)
    lse_err = (lse - ref_lse).abs().max().item()
    log(f"[kernel] bias_attention bf16 row log-sum-exp: max_abs_err={lse_err:.3e} (atol 1e-4)")
    if lse_err > 1e-4:
        raise AssertionError("bias_attention's row log-sum-exp disagrees with its plain version")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = bias.to(torch.bfloat16)
    ops = 4 * B * H * T * T * D
    nbytes = 2 * 4 * q.numel() + 4 * T
    ms = time_ms(lambda: attention.onepass_self_attention(q, k, v, bias), reps=20)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             scale=1.0), reps=20)
    bound_ms, bound_by = bound(ops, PEAK_BF16, nbytes)
    report("bias_attention", "lyricalignment_tpu_torch/csrc/attention.cu",
           "lyricalignment_tpu/ops/attention.py:118", err,
           f"bf16 rel_l2={rel:.3e} <= 1e-2", rel <= 1e-2, ms,
           time_ms(lambda: attention.einsum_bias_attention(q, k, v, bias), reps=3),
           sdpa_ms, bound_ms, bound_by)
    report_rate("bias_attention", ms, ops, bound_ms, sdpa_ms, "attention.cu", "ILb1ELb0E")
    del q, k, v, qt, kt, vt, got, ref, lse, ref_lse

    # --- kernel 3: class normaliser, 24000 rows x 21127 CTC syllable columns
    rows_h, feat = B * 1500, 768
    h = torch.randn(rows_h, feat, device=dev, generator=g) * 0.5
    s = 1.0 / math.sqrt(feat)
    w = (torch.rand(C_CTC, feat, device=dev, generator=g) * 2 - 1) * s
    b = (torch.rand(C_CTC, device=dev, generator=g) * 2 - 1) * s
    ws, bs = w[1:-1], b[1:-1]
    got = viterbi.row_lse(h, ws, bs)
    ref = viterbi.row_lse_plain(h, ws, bs)
    err = (got - ref).abs().max().item()
    ok = bool(((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
    if not torch.equal(got, viterbi.row_lse(h, ws, bs)):
        raise AssertionError("row_lse: two runs differ in their bits")
    # two routes to the same function: 2 rows feat cols float32 operations
    # on the CUDA cores, or the three TF32 products of the split the kernel
    # issues on the tensor cores; holding the tolerance on the second shows
    # it to be the same work, and the row's bound is the smaller of the two
    ops = 2 * rows_h * feat * ws.shape[0]
    nbytes = 4 * (h.numel() + ws.numel() + bs.numel() + rows_h)
    f32_ms, _ = bound(ops, PEAK_F32, nbytes)
    tf32_ms, bound_by = bound(3 * ops, PEAK_TF32, nbytes)
    ms = time_ms(lambda: viterbi.row_lse(h, ws, bs), reps=5)
    lib_ms = time_ms(lambda: torch.logsumexp(h @ ws.T + bs, dim=-1), reps=3)
    report("row_lse", "lyricalignment_tpu_torch/csrc/lse.cu",
           "lyricalignment_tpu/ops/viterbi.py:269", err, "rtol 1e-5 / atol 1e-4", ok, ms,
           time_ms(lambda: viterbi.row_lse_plain(h, ws, bs), reps=3), lib_ms,
           min(f32_ms, tf32_ms), bound_by)
    log(f"[kernel] row_lse: {ops / ms / 1e9:.1f} TFLOP/s of the function's {ops / 1e9:.1f} "
        f"GFLOP, {3 * ops / ms / 1e9:.1f} TFLOP/s of the three TF32 products it issues; "
        f"{f32_ms / ms:.3f} of the float32 CUDA-core bound ({f32_ms:.2f} ms), "
        f"{tf32_ms / ms:.3f} of the 3xTF32 tensor-core bound ({tf32_ms:.2f} ms, the row's: "
        f"the smaller); {lib_ms / ms:.2f}x faster than logsumexp(h @ W.T + b) "
        f"({lib_ms:.3f} ms); two runs bit-equal; ptxas: "
        f"{ptxas_report('lse.cu', 'row_lse_kernel')}")
    del h, w, b, ws, bs, got, ref

    # --- kernel 4: Viterbi DP, 16 x 1500 frames x 48 labels (K = 97), and
    # 16 x 3000 x 128 (K = 257: a 45 s clip at the default max_label_len,
    # whose backpointers go through the scratch)
    def viterbi_case(t, l_max):
        logp = torch.log_softmax(torch.randn(B, t, l_max + 1, device=dev, generator=g) * 3, -1)
        lab = logp[..., :l_max].clamp(min=-1000.0).contiguous()
        sil = logp[..., l_max].clamp(min=-1000.0).contiguous()
        labels = torch.randint(2, 400, (B, l_max), device=dev, generator=g, dtype=torch.int32)
        labels[:, 5] = labels[:, 4]  # a repeat: skip banned
        nl = torch.full((B,), l_max, dtype=torch.int32, device=dev)
        nl[1], nl[2] = 30, 1
        nf = torch.full((B,), t, dtype=torch.int32, device=dev)
        nf[1], nf[3] = t * 4 // 5, 60
        args = (lab, sil, labels, nl, nf)
        got = viterbi.viterbi_dp(*args)
        ref = viterbi.viterbi_dp_plain(*args)
        exact = all(torch.equal(x, y) for x, y in zip(got, ref))
        exact = exact and all(torch.equal(x, y) for x, y in zip(got, viterbi.viterbi_dp(*args)))
        err = max((x - y).abs().max().item() for x, y in zip(got, ref))
        # the DP stops at each row's num_frames: count the frames this data needs
        live = nf.clamp(0, t)
        nbytes = 4 * (int(live.sum()) * (l_max + 1) + labels.numel() + 2 * B + 2 * B * l_max)
        ms = time_ms(lambda: viterbi.viterbi_dp(*args), reps=10)
        plain_ms = time_ms(lambda: viterbi.viterbi_dp_plain(*args), reps=1, warmup=0)
        return (float(err), exact, ms, plain_ms,
                bound(int(live.sum()) * (2 * l_max + 1), PEAK_F32, nbytes), int(live.max()))

    # the chain's floor: the longest row's live frames, each one dependent
    # step (shuffle from the previous lane, compare and select, add) whose
    # cycles a one-warp probe measures, at the SM clock read now
    step_cycles = viterbi_step_cycles()
    for t, l_max in ((1500, L_BENCH), (3000, 128)):
        err, exact, ms, plain_ms, (bound_ms, bound_by), live_max = viterbi_case(t, l_max)
        mhz = sm_clock_mhz()
        floor_ms = live_max * step_cycles / (mhz * 1e3)
        log(f"[kernel] viterbi B={B} T={t} L={l_max} (K={2 * l_max + 1}): kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); chain floor "
            f"{floor_ms:.4f} ms ({live_max} frames x {step_cycles:.1f} cycles a step at "
            f"{mhz:.0f} MHz), {floor_ms / ms:.3f} of the kernel's time; exact and two runs "
            f"bit-equal: {exact}")
        if t == 1500:
            report("viterbi", "lyricalignment_tpu_torch/csrc/viterbi.cu",
                   "lyricalignment_tpu/ops/viterbi_pallas.py:54", err, "exact", exact,
                   ms, plain_ms, None, bound_ms, bound_by)
        elif not exact:
            raise AssertionError(f"viterbi disagrees with its plain version at T={t}")
    # K = 97 and 257 both run two states a lane
    log("[kernel] viterbi ptxas: " + "; ".join(
        f"S={s}: {ptxas_report('viterbi.cu', f'viterbi_kernelILi{s}E')}" for s in (2, 4, 8, 16, 32)))
    return rows


# ---------------------------------------------------------------------------
# Phase 2: the serving path at whisper-medium width
# ---------------------------------------------------------------------------

POOL = "天地玄黄宇宙洪荒日月盈昃辰宿列张寒来暑往秋收冬藏闰余成岁律吕调阳云腾致雨露结为霜金生丽水玉出昆冈"


def _vocab_and_table():
    """Synthetic vocab over POOL whose ids land on real syllables of the
    pronunciation table (the first ids of the table are the 'bad' class)."""
    from lyricalignment_tpu_torch.text.bert_tokenizer import make_synthetic_vocab
    from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table

    table = load_pronunciation_table()
    vocab = make_synthetic_vocab(chars=POOL, size=21128)
    by_id = {i: t for t, i in vocab.items()}
    good = [i for i, p in enumerate(table.token_pinyin) if p != "bad"]
    for ch, target in zip(dict.fromkeys(POOL), good[::7]):
        old = vocab[ch]
        other = by_id[target]
        vocab[ch], vocab[other] = target, old
        by_id[target], by_id[old] = ch, other
    return vocab, table


def _write_requests(dirname, lengths, seed, stereo=()):
    """WAV requests of ``lengths`` seconds, 16 kHz mono, or 44.1 kHz stereo
    for the indices in ``stereo``; each with a lyric of 10-48 characters."""
    import numpy as np

    from lyricalignment_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    requests = []
    for i, sec in enumerate(lengths):
        sr = 44100 if i in stereo else 16000
        t = np.arange(int(sec * sr)) / sr
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t)
        audio = 0.2 * env * np.sin(2 * np.pi * (150 + 30 * i) * t) + 0.03 * rng.standard_normal(t.shape)
        if i in stereo:
            audio = np.stack([audio, 0.8 * audio + 0.03 * rng.standard_normal(t.shape)])
        path = os.path.join(dirname, f"req{i}.wav")
        write_wav(path, audio.astype(np.float32), sr)
        n_chars = int(rng.integers(10, 49))
        requests.append((path, "".join(rng.choice(list(POOL), n_chars))))
    return requests


def _check_segments(results, requests, lengths):
    for (path, lyric), segs, sec in zip(requests, results, lengths):
        assert len(segs) == len(lyric), (path, len(segs), len(lyric))
        prev_off = 0.0
        for on, off, ch in segs:
            assert math.isfinite(on) and math.isfinite(off), (path, on, off)
            assert prev_off - 1e-9 <= on < off <= sec + 0.04, (path, prev_off, on, off)
            prev_off = off


def phase_serving(dev, tmp):
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, bf16_resident
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    t0 = time.perf_counter()
    # the inference configuration load_model_dir builds: the pad-once
    # (key bias) encoder route, as in the JAX package
    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True, onepass_encoder=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=C_CTC)
    with torch.device(dev):
        model = AlignModel(cfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    bf16_resident(model.whisper_model)
    model.eval()
    vocab, table = _vocab_and_table()
    aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table,
                           use_ctc=True, batch_size=8)
    lengths = [8.0, 11.5, 14.2, 17.3, 21.0, 24.6, 29.4, 45.0]
    requests = _write_requests(tmp, lengths, seed=1)
    log(f"[serving] whisper-medium AlignModel built in {time.perf_counter() - t0:.1f} s")

    aligner.align_many(requests[:1])  # first-use allocations outside the window
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = aligner.align_many(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    _check_segments(results, requests, lengths)
    log(f"[serving] answered {len(results)} requests ({sum(lengths):.1f} s of audio, "
        f"one of {lengths[-1]:.0f} s) in {wall:.3f} s; launches {counts}")
    for name in SERVING_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return model, counts


# ---------------------------------------------------------------------------
# Phase 3: a tiny float32 model, GPU kernels vs the CPU plain path
# ---------------------------------------------------------------------------

def phase_tiny_reference(dev, tmp):
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        forward_from_audio,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WhisperConfig
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    wcfg = WhisperConfig(n_vocab=64, n_audio_state=64, n_audio_head=1, n_audio_layer=2,
                         n_text_ctx=16, n_text_state=64, n_text_head=1, n_text_layer=1,
                         onepass_encoder=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=32, output_dim=C_CTC)
    cpu_model = AlignModel(cfg)
    init_weights(cpu_model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        cpu_model.align_rnn.fc.weight.mul_(8.0)  # sharp emissions: no near-ties
    cpu_model.eval()
    gpu_model = AlignModel(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev).eval()

    lengths = [6.3, 9.0, 33.0]
    requests = _write_requests(tmp, lengths, seed=2)
    vocab, table = _vocab_and_table()
    segs = {}
    for name, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table,
                               use_ctc=True, batch_size=4)
        kernels.reset_launch_counts()
        segs[name] = aligner.align_many(requests)
    # the float32 model takes the attention kernel's float32 path
    counts = dict(kernels.launches)
    for name in SERVING_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the float32 GPU run")
    flips = total = 0
    for a_req, b_req in zip(segs["cpu"], segs["gpu"]):
        for a, b in zip(a_req, b_req):
            for x, y in zip(a[:2], b[:2]):
                total += 1
                flips += x != y
                assert abs(x - y) <= 0.02 + 1e-9, (a, b)
    audio = torch.randn(2, 33 * 16000, generator=torch.Generator().manual_seed(4)) * 0.1
    frames = torch.tensor([1650, 700])
    with torch.inference_mode():
        h_cpu, _ = forward_from_audio(cpu_model, audio, frame_lengths=frames,
                                      mel_lengths=2 * frames, align_head_output="hidden")
        h_gpu, _ = forward_from_audio(gpu_model, audio.to(dev), frame_lengths=frames.to(dev),
                                      mel_lengths=2 * frames.to(dev),
                                      align_head_output="hidden")
    err = max((h_gpu[i, :n].cpu() - h_cpu[i, :n]).abs().max().item()
              for i, n in enumerate(frames.tolist()))
    log(f"[reference] tiny f32 model, GPU kernels vs CPU plain path: hidden max_abs_err="
        f"{err:.3e} (atol 1e-3); segments differ at {flips} of {total} positions "
        f"(<= 1 frame, <= 1 in 50 allowed); GPU align_many launches {counts}")
    if err > 1e-3 or flips > total // 50:
        raise AssertionError("GPU path disagrees with the CPU plain path")
    _check_segments(segs["gpu"], requests, lengths)


# ---------------------------------------------------------------------------
# Phase 4: device-only forward at the bench's operating point
# ---------------------------------------------------------------------------

def _device_trace(fn):
    """Device busy time of one call of ``fn`` from a torch.profiler (CUPTI)
    trace: (busy ms, {kernel name: (ms, count)}), or None when the trace
    holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "?")) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    if not spans:
        return None
    busy_us, end_us, by_name = 0.0, -math.inf, {}
    for t0, t1, name in spans:  # union of the intervals: one stream, but be safe
        busy_us += max(0.0, t1 - max(t0, end_us))
        end_us = max(end_us, t1)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t1 - t0) / 1e3, n + 1)
    return busy_us / 1e3, by_name


def phase_throughput(dev, model, card):
    import torch

    from lyricalignment_tpu_torch import EMBED_FRAMES, kernels
    from lyricalignment_tpu_torch.models.align_model import forward_from_audio
    from lyricalignment_tpu_torch.ops.viterbi import frames_to_seconds, viterbi_align_fused

    g = torch.Generator(device=dev).manual_seed(5)
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    frames = torch.full((B,), EMBED_FRAMES, dtype=torch.int32, device=dev)
    labels = torch.randint(2, 400, (B, L_BENCH), device=dev, generator=g, dtype=torch.int32)
    num_labels = torch.full((B,), L_BENCH, dtype=torch.int32, device=dev)
    fc = model.align_rnn.fc
    marks = []

    def stage(name, fn, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        marks.append((name, start, end))
        return out

    @torch.inference_mode()
    def align_batch():
        # the serving path's own calls (cli/inference_alignment.py:align_records)
        h, _ = stage("forward_from_audio", forward_from_audio, model, audio,
                     frame_lengths=frames, mel_lengths=2 * frames, align_head_output="hidden")
        on, off = stage("emissions+viterbi", viterbi_align_fused, h, fc.weight, fc.bias,
                        labels, num_labels, frames, "ctc")
        return frames_to_seconds(on, off)

    out = align_batch()
    torch.cuda.synchronize()
    assert out.shape == (B, L_BENCH, 2) and bool(torch.isfinite(out).all())
    marks.clear()
    iters = 5
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = align_batch()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(kernels.launches)
    per_batch = {"la_log10_mel": 1, "la_bias_attention": model.cfg.whisper.n_audio_layer,
                 "la_row_lse": 1, "la_viterbi": 1}
    expected = {name: iters * n for name, n in per_batch.items()}
    rate = iters * B * SECONDS / elapsed
    per_stage = {}
    for name, start, end in marks:
        per_stage.setdefault(name, []).append(start.elapsed_time(end))
    stages = {name: [round(x, 3) for x in sorted(ms)] for name, ms in per_stage.items()}
    log(f"[throughput] medium bf16 B={B} {SECONDS} s L={L_BENCH} CTC: "
        f"{rate:.2f} audio-s/s ({elapsed / iters * 1e3:.1f} ms/batch, mean of {iters}) "
        f"on {card}; stage ms (each batch, sorted) {json.dumps(stages)}; "
        f"launches in {iters} batches {counts}")
    if counts != expected:
        raise AssertionError(f"throughput batches launched {counts}, expected {expected}")

    # one more batch under the profiler: where the device time goes, and the
    # device's idle share against the mean batch above (a diagnostic: the
    # trace is optional and its absence fails nothing)
    try:
        trace = _device_trace(align_batch)
    except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
        log(f"[trace] not measured: {type(exc).__name__}: {exc}")
        return
    if trace is None:
        log("[trace] not measured: the profiler recorded no device activity")
        return
    busy, by_name = trace
    batch_ms = elapsed / iters * 1e3
    log(f"[trace] one batch: device busy {busy:.2f} ms of the {batch_ms:.1f} ms mean "
        f"batch, idle share {1 - busy / batch_ms:.3f}; top device kernels (ms, count):")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"[trace]   {ms:9.3f} {n:5d}  {name[:110]}")


# ---------------------------------------------------------------------------
# Phase 6: the multitask training path
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_H, TRAIN_T, ACCUM, TRAIN_STEPS = 2, 16, 1500, 8, 3
TAIL_B = 16  # a batch with no tail to speak of (15.5 work items an SM)
TRAIN_KERNELS = {"la_log10_mel": 1, "la_attention_fwd": 24, "la_attention_dkdv": 24,
                 "la_attention_dq": 24}  # a micro-batch of whisper-medium


def _attention_case(dev, b, t, h, dtype, with_bias, seed):
    """Kernel forward + backward under autograd vs autograd through the
    plain float32 einsum on the same (dtype-rounded) inputs: max abs errors
    of out, lse, dq, dk, dv and their rel-L2."""
    import torch

    from lyricalignment_tpu_torch.ops.attention import (
        attention_forward,
        einsum_bias_attention,
        onepass_self_attention,
        self_attention,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(b, t, h, 64, device=dev, generator=g).mul_(0.4).to(dtype)
                     for _ in range(4))
    bias = torch.zeros(1, t, device=dev)
    if with_bias:
        bias += torch.randn(1, t, device=dev, generator=g) * 0.5
        bias[0, t - t // 4:] = -1e9
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = onepass_self_attention(*leaves, bias) if with_bias else self_attention(*leaves)
    out.backward(dout)
    ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
    ref = einsum_bias_attention(*ref_leaves, bias)
    ref.backward(dout.float())
    _, lse = attention_forward(q, k, v, bias[0] if with_bias else None, with_lse=True)
    with torch.no_grad():
        ref_lse = torch.logsumexp(
            torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias[0], dim=-1)
    errs, rels = {}, {}
    for name, got, want in (("out", out.detach(), ref.detach()), ("lse", lse, ref_lse),
                            ("dq", leaves[0].grad, ref_leaves[0].grad),
                            ("dk", leaves[1].grad, ref_leaves[1].grad),
                            ("dv", leaves[2].grad, ref_leaves[2].grad)):
        diff = (got.double() - want.double())
        errs[name] = diff.abs().max().item()
        # rel-L2 with a floor for exactly-zero references (one key: dK = 0)
        rels[name] = diff.norm().item() / max(want.double().norm().item(), 1e-3)
    return errs, rels


def phase_train_kernels(dev):
    """(a): the training attention kernels at edge shapes and at the
    training shape; rows for the kernels line (launches filled in later)."""
    import torch

    from lyricalignment_tpu_torch.ops.attention import (
        attention_delta,
        attention_dkdv,
        attention_dq,
        attention_forward,
        einsum_attention,
    )

    # the key-bias route also next to the 128-row tiles of the bf16 kernels
    cases = [(t, with_bias) for t in (1, 63, 65, 1500) for with_bias in (False, True)]
    for t, with_bias in cases + [(127, True), (129, True)]:
        for dtype in (torch.float32, torch.bfloat16):
            errs, rels = _attention_case(dev, 2, t, 3, dtype, with_bias, seed=t)
            if dtype == torch.float32:
                ok, text = max(errs.values()) <= 1e-4, f"max_abs={max(errs.values()):.2e}"
            else:
                ok = errs["lse"] <= 1e-3 and max(
                    rels[n] for n in ("out", "dq", "dk", "dv")) <= 1e-2
                text = (f"rel_l2 out/dq/dk/dv = {rels['out']:.2e}/{rels['dq']:.2e}/"
                        f"{rels['dk']:.2e}/{rels['dv']:.2e}, lse {errs['lse']:.2e}")
            log(f"[train-kernels] T={t} bias={with_bias} {str(dtype)[6:]}: {text} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("attention training kernels disagree with autograd "
                                     f"through the plain einsum at T={t}")

    # the training shape: whisper-medium micro-batch, B = 2, H = 16, T = 1500
    b, t, h, d = TRAIN_B, TRAIN_T, TRAIN_H, 64
    for dtype in (torch.float32, torch.bfloat16):
        errs, rels = _attention_case(dev, b, t, h, dtype, False, seed=11)
        log(f"[train-kernels] training shape {str(dtype)[6:]}: max_abs {json.dumps(errs)} "
            f"rel_l2 {json.dumps(rels)}")
        ok = (max(errs.values()) <= 1e-4 if dtype == torch.float32 else
              errs["lse"] <= 1e-3 and max(rels[n] for n in ("out", "dq", "dk", "dv")) <= 1e-2)
        if not ok:
            raise AssertionError(f"training-shape attention ({dtype}) disagrees")
    bf16_errs = errs
    if bf16_errs["lse"] > 1e-4:
        raise AssertionError(f"training-shape bf16 row log-sum-exp off by {bf16_errs['lse']:.3e}"
                             " (atol 1e-4)")

    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, dout = (torch.randn(b, t, h, d, device=dev, generator=g).mul_(0.4)
                     .to(torch.bfloat16) for _ in range(4))
    out, lse = attention_forward(q, k, v, None, with_lse=True)
    delta = attention_delta(out, dout)
    fwd_ms = time_ms(lambda: attention_forward(q, k, v, None, with_lse=True), reps=20)
    dkdv_ms = time_ms(lambda: attention_dkdv(q, k, v, dout, lse, delta), reps=20)
    dq_ms = time_ms(lambda: attention_dq(q, k, v, dout, lse, delta), reps=20)
    delta_ms = time_ms(lambda: attention_delta(out, dout), reps=20)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    plain_out = einsum_attention(*leaves)
    plain_fwd_ms = time_ms(lambda: einsum_attention(q, k, v), reps=5)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(plain_out, leaves, dout,
                                                       retain_graph=True), reps=5)
    del plain_out
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in leaves)
    F = torch.nn.functional
    sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0),
                          reps=20)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
    dout_t = dout.transpose(1, 2)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                                      retain_graph=True), reps=20)
    # the grid's tail: B = 2 gives 256 work items of 192 queries (1.94 for
    # each of 132 SMs); TAIL_B = 16 (2,048 items) sets the rate without one
    qb, kb, vb = (torch.randn(TAIL_B, t, h, d, device=dev, generator=g).mul_(0.4)
                  .to(torch.bfloat16) for _ in range(3))
    full_ms = time_ms(lambda: attention_forward(qb, kb, vb, None, with_lse=True), reps=20)
    rate = 4 * b * h * t * t * d / fwd_ms / 1e9
    full_rate = 4 * TAIL_B * h * t * t * d / full_ms / 1e9
    log(f"[train-kernels] forward tail: B={b} {rate:.1f} TFLOP/s, B={TAIL_B} {full_rate:.1f} "
        f"TFLOP/s ({full_ms:.4f} ms): the B={b} grid runs at {rate / full_rate:.3f} of that rate")
    # the backward pair's: at B = 2 dK/dV has 384 work items of 128 keys
    # (2.91 for each SM) and dQ 256 of 192 queries (1.94), 8 times that at
    # TAIL_B
    doutb = torch.randn(TAIL_B, t, h, d, device=dev, generator=g).mul_(0.4).to(torch.bfloat16)
    outb, lseb = attention_forward(qb, kb, vb, None, with_lse=True)
    deltab = attention_delta(outb, doutb)
    del outb
    for name, products, small_ms, fn in (("dK/dV", 4, dkdv_ms, attention_dkdv),
                                         ("dQ", 3, dq_ms, attention_dq)):
        full_ms = time_ms(lambda: fn(qb, kb, vb, doutb, lseb, deltab), reps=10)
        rate = 2 * products * b * h * t * t * d / small_ms / 1e9
        full_rate = 2 * products * TAIL_B * h * t * t * d / full_ms / 1e9
        log(f"[train-kernels] {name} tail: B={b} {rate:.1f} TFLOP/s, B={TAIL_B} "
            f"{full_rate:.1f} TFLOP/s ({full_ms:.4f} ms): the B={b} grid runs at "
            f"{rate / full_rate:.3f} of that rate")
    del qb, kb, vb, doutb, lseb, deltab
    log(f"[train-kernels] training shape bf16 B={b} H={h} T={t}: forward {fwd_ms:.4f} ms, "
        f"dK/dV {dkdv_ms:.4f} ms, dQ {dq_ms:.4f} ms, delta (torch reduction) "
        f"{delta_ms:.4f} ms; plain forward {plain_fwd_ms:.4f} ms, plain backward "
        f"{plain_bwd_ms:.4f} ms; SDPA forward {sdpa_fwd_ms:.4f} ms, backward "
        f"{sdpa_bwd_ms:.4f} ms, forward + backward {sdpa_fwd_ms + sdpa_bwd_ms:.4f} ms")

    product = 2 * b * h * t * t * d   # one T x T x 64 product
    tensor = 2 * b * t * h * d        # one bf16 [B, T, H, 64] tensor
    stats = 4 * b * h * t             # one f32 [B, H, T] row statistic
    rows = []
    for name, ms, plain_ms, lib_ms, products, nbytes, replaces in (
            ("attention_fwd", fwd_ms, plain_fwd_ms, sdpa_fwd_ms, 2, 4 * tensor + stats,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:758 "
             "_flash_attention_kernel)"),
            ("attention_dkdv", dkdv_ms, plain_bwd_ms, sdpa_bwd_ms, 4, 6 * tensor + 2 * stats,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:1121 "
             "_flash_attention_dkv_kernel)"),
            ("attention_dq", dq_ms, plain_bwd_ms, sdpa_bwd_ms, 3, 5 * tensor + 2 * stats,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:1456 "
             "_flash_attention_dq_kernel)")):
        bound_ms, bound_by = bound(products * product, PEAK_BF16, nbytes)
        src = "attention.cu" if name == "attention_fwd" else "attention_bwd.cu"
        rows.append(dict(name=name, route="cuda", source=f"lyricalignment_tpu_torch/csrc/{src}",
                         replaces=replaces, max_abs_err=bf16_errs[
                             {"attention_fwd": "out", "attention_dkdv": "dk",
                              "attention_dq": "dq"}[name]],
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        log(f"[kernel] {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        if name == "attention_fwd":
            report_rate(name, ms, products * product, bound_ms, lib_ms, src, "ILb0ELb1E",
                        "SDPA forward")
        else:
            report_rate(name, ms, products * product, bound_ms, lib_ms, src,
                        f"{name}_kernelILb0E", "SDPA backward (dq, dk, dv together)")
    return rows


# One warp timing `steps` dependent steps of each reduced CTC chain. The
# forward's as it stands between states: the two neighbours from the lanes
# below, their max, three exponentials, a log and the adds (_lse3 plus the
# emission). The backward's, its weights computed off the chain: the two
# neighbours from the lanes above and three FMAs. out[0] = clock64 cycles
# for all of them (out[1] keeps the result alive).
_CTC_STEP_PROBE = r"""
__global__ void ctc_step_cycles_kernel(int steps, float em, long long* out) {
  float a = -static_cast<float>(threadIdx.x);
  const long long t0 = clock64();
  for (int t = 0; t < steps; ++t) {
    const float a1 = __shfl_up_sync(0xffffffffu, a, 1);
    const float a2 = __shfl_up_sync(0xffffffffu, a, 2);
    const float m = fmaxf(fmaxf(a, a1), a2);
    a = em + (m + logf(expf(a - m) + expf(a1 - m) + expf(a2 - m)));
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = __float_as_int(a);
  }
}

__global__ void ctc_adjoint_cycles_kernel(int steps, float u, long long* out) {
  float adj = static_cast<float>(threadIdx.x);
  const long long t0 = clock64();
  for (int t = 0; t < steps; ++t) {
    const float x1 = __shfl_down_sync(0xffffffffu, adj, 1);
    const float x2 = __shfl_down_sync(0xffffffffu, adj, 2);
    adj = fmaf(u, x2, fmaf(u, x1, u * adj));
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = __float_as_int(adj);
  }
}

extern "C" int ctc_step_cycles(int steps, long long* fwd, long long* bwd) {
  ctc_step_cycles_kernel<<<1, 32>>>(steps, -0.5f, fwd);
  ctc_adjoint_cycles_kernel<<<1, 32>>>(steps, 0.3f, bwd);
  return static_cast<int>(cudaGetLastError());
}
"""


def ctc_step_cycles(steps: int = 20000) -> dict:
    """SM cycles of one dependent step of the reduced CTC's chains
    ({"forward": ..., "backward": ...}), from ``_CTC_STEP_PROBE`` built
    with ``ctc.cu``'s flags beside the library."""
    import ctypes

    import torch

    from lyricalignment_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src, so = os.path.join(tmp, "ctc_probe.cu"), os.path.join(tmp, "ctc_probe.so")
        with open(src, "w") as f:
            f.write(_CTC_STEP_PROBE)
        subprocess.run([build._nvcc()] + build.ARCH_FLAGS + build.COMMON_FLAGS
                       + ["-shared", "-o", so, src], check=True, capture_output=True,
                       timeout=300)
        lib = ctypes.CDLL(so)
        out = torch.zeros(2, 2, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        if lib.ctc_step_cycles(steps, ctypes.c_void_p(out[0].data_ptr()),
                               ctypes.c_void_p(out[1].data_ptr())) != 0:
            raise AssertionError("the CTC step probes did not launch")
        torch.cuda.synchronize()
        return {"forward": out[0, 0].item() / steps, "backward": out[1, 0].item() / steps}


ROWS_FUSED = TRAIN_B * TRAIN_T   # rows of a micro-batch's hidden: 2 x 1500
N_CTC, N_CTC_VALID = 48, 24      # the CTC label positions of bench_train's batch
# the kernels of each reduced CTC entry, by name
CTC_KERNELS = {"la_ctc_reduced_fwd": ("ctc_fwd_kernel",),
               "la_ctc_reduced_bwd": ("ctc_bwd_weights_kernel", "ctc_bwd_kernel")}


# the kernels of la_row_lse_bwd, by the names the profiler gives them
# (demangled or mangled)
LSE_BWD_PARTS = {
    "p": ("bwd_gemm_kernel<128,0>", "bwd_gemm_kernelILi128ELi0E"),
    "dh": ("bwd_gemm_kernel<64,1>", "bwd_gemm_kernelILi64ELi1E"),
    "dw, db": ("bwd_gemm_kernel<64,2>", "bwd_gemm_kernelILi64ELi2E"),
    "transposes": ("split_transpose_kernel",),
    "w_lo": ("split_lo_kernel",),
    "dh reduce": ("bwd_reduce_kernel",),
}


def _lse_bwd_part(name):
    flat = name.replace(" ", "")
    return next((part for part, keys in LSE_BWD_PARTS.items()
                 if any(k in flat for k in keys)), None)


def phase_train_lse_bwd(dev):
    """(a'): the row LSE and its backward at the training shape (3000 rows,
    feat 768, the head's 21129-row fc) with both column slices the fused
    losses take: w[1:21128] (CE with the silence head) and w[0:21128] (CTC).
    The forward (``la_row_lse``) against float64 (atol 2e-5), the backward
    (``la_row_lse_bwd``: dh, dw, db) against ``row_lse_bwd_plain`` run in
    float64 (rel-L2 1e-5 each: 3xTF32 with round-to-nearest group sums),
    each bit-equal from run to run; the forward timed at this shape beside
    ``logsumexp(h @ W.T + b)``; the backward's plan (chunks, items, K ranges,
    waves), scratch bytes and ptxas lines, then its CUDA-event times: all
    three outputs, dh alone and dw with db alone, each beside the chunked
    cuBLAS route (float32, TF32 off) of its outputs, the plain version and
    the bound (the smaller of the float32 CUDA-core and the 3xTF32
    tensor-core routes of its products), and its kernels' device ms from a
    profiler trace of one call."""
    import ctypes

    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops import viterbi

    g = torch.Generator(device=dev).manual_seed(21)
    h = torch.randn(ROWS_FUSED, 768, device=dev, generator=g) * 0.5
    w_full = torch.randn(C_CTC, 768, device=dev, generator=g) * 768 ** -0.5
    b_full = torch.randn(C_CTC, device=dev, generator=g)
    gl = torch.randn(ROWS_FUSED, device=dev, generator=g) / ROWS_FUSED
    timed, errs_all = {}, []
    for first, name in ((1, "CE w[1:21128]"), (0, "CTC w[0:21128]")):
        last = C_CTC - 1
        w, b = w_full[first:last], b_full[first:last]
        lse = viterbi.row_lse(h, w, b)
        exact = torch.logsumexp(h.double() @ w.double().T + b.double(), dim=-1)
        fwd_err = (lse.double() - exact).abs().max().item()
        fwd_same = torch.equal(lse, viterbi.row_lse(h, w, b))
        log(f"[train-lse-bwd] {name}: row_lse max_abs_err {fwd_err:.3e} against float64 "
            f"(<= 2e-5); two runs bit-equal: {fwd_same} "
            f"{'OK' if fwd_err <= 2e-5 and fwd_same else 'FAIL'}")
        if not (fwd_err <= 2e-5 and fwd_same):
            raise AssertionError(f"the row LSE disagrees with float64 ({name})")
        del exact
        got = viterbi.row_lse_bwd(h, w, b, lse, gl)
        ref = viterbi.row_lse_bwd_plain(h.double(), w.double(), b.double(), lse.double(),
                                        gl.double())
        rels = [rel_l2(x, y) for x, y in zip(got, ref)]
        errs = [(x.double() - y).abs().max().item() for x, y in zip(got, ref)]
        same = all(torch.equal(x, y) for x, y in zip(got, viterbi.row_lse_bwd(h, w, b, lse, gl)))
        del ref, got
        ok = max(rels) <= 1e-5 and same
        log(f"[train-lse-bwd] {name}: la_row_lse_bwd rel_l2 dh/dw/db "
            f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} (<= 1e-5 against float64), max_abs "
            f"{max(errs):.3e}; two runs bit-equal: {same} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the row LSE backward disagrees with float64 ({name})")
        timed[name] = (w, b, lse)
        errs_all.append(max(errs))

    # times at the CE slice: the forward, then the backward's plan and times
    w, b, lse = timed["CE w[1:21128]"]
    cols = w.shape[0]
    flops = 2.0 * ROWS_FUSED * 768 * cols
    ms = time_ms(lambda: viterbi.row_lse(h, w, b), reps=5)
    lib_ms = time_ms(lambda: torch.logsumexp(h @ w.T + b, dim=-1), reps=3)
    nbytes = 4 * (h.numel() + w.numel() + b.numel() + ROWS_FUSED)
    f32_ms, _ = bound(flops, PEAK_F32, nbytes)
    tf32_ms, bound_by = bound(3 * flops, PEAK_TF32, nbytes)
    log(f"[train-lse-bwd] row_lse (la_row_lse) rows={ROWS_FUSED} feat=768 cols={cols}: "
        f"kernel_ms={ms:.4f} library_ms={lib_ms:.4f} (logsumexp(h @ W.T + b)) "
        f"bound_ms={min(f32_ms, tf32_ms):.4f} ({bound_by}, 3xTF32; float32 CUDA cores "
        f"{f32_ms:.4f}); {min(f32_ms, tf32_ms) / ms:.3f} of the bound")

    lib = kernels.library()
    plan = (ctypes.c_longlong * 7)()
    if lib.la_row_lse_bwd_plan(ROWS_FUSED, 768, cols, plan) != 0:
        raise AssertionError("la_row_lse_bwd_plan failed")
    sms, chunks, chunk, p_items, dh_ranges, dh_items, dw_items = list(plan)
    scratch_mb = 4 * lib.la_row_lse_bwd_scratch_floats(ROWS_FUSED, 768, cols) / 1e6
    log(f"[train-lse-bwd] la_row_lse_bwd plan on {sms} SMs: {chunks} chunks of {chunk} "
        f"columns (the last {cols - (chunks - 1) * chunk}); a full chunk's p kernel "
        f"{p_items} items of 128 x 128 ({p_items / sms:.2f} waves), dh {dh_items} items of "
        f"128 x 64 in {dh_ranges} K ranges ({dh_items / sms:.2f} waves), dw {dw_items} items "
        f"of 128 x 64 ({dw_items / sms:.2f} waves); scratch {scratch_mb:.1f} MB")
    for part in ("p", "dh", "dw, db"):
        log(f"[train-lse-bwd] ptxas {part}: "
            f"{ptxas_report('lse.cu', LSE_BWD_PARTS[part][1])}")

    def route_dh():
        dh = torch.zeros_like(h)
        for c0 in range(0, cols, viterbi.LSE_CHUNK):
            wc = w[c0:c0 + viterbi.LSE_CHUNK]
            dh += torch.exp(h @ wc.T + b[c0:c0 + viterbi.LSE_CHUNK] - lse[:, None]) * gl[:, None] @ wc
        return dh

    def route_dw():
        dw, db = torch.empty_like(w), torch.empty_like(b)
        for c0 in range(0, cols, viterbi.LSE_CHUNK):
            wc = w[c0:c0 + viterbi.LSE_CHUNK]
            p = torch.exp(h @ wc.T + b[c0:c0 + viterbi.LSE_CHUNK] - lse[:, None]) * gl[:, None]
            dw[c0:c0 + viterbi.LSE_CHUNK] = p.T @ h
            db[c0:c0 + viterbi.LSE_CHUNK] = p.sum(0)
        return dw, db

    plain_ms = time_ms(lambda: viterbi.row_lse_bwd_plain(h, w, b, lse, gl), reps=3)
    route_ms = {"dh alone": time_ms(route_dh, reps=3), "dw, db alone": time_ms(route_dw, reps=3)}
    route_ms["dh, dw, db"] = route_ms["dh alone"] + route_ms["dw, db alone"]
    in_bytes = 4 * (h.numel() + w.numel() + b.numel() + 2 * ROWS_FUSED)
    times = {}
    # (outputs, needs, the products they take, their bytes)
    for label, needs, products, out_bytes in (
            ("dh, dw, db", (True, True, True), 3, 4 * (ROWS_FUSED * 768 + cols * 769)),
            ("dh alone", (True, False, False), 2, 4 * ROWS_FUSED * 768),
            ("dw, db alone", (False, True, True), 2, 4 * cols * 769)):
        k_ms = time_ms(lambda: viterbi.row_lse_bwd(h, w, b, lse, gl, needs), reps=5)
        f32_ms, _ = bound(products * flops, PEAK_F32, in_bytes + out_bytes)
        tf32_ms, by = bound(3 * products * flops, PEAK_TF32, in_bytes + out_bytes)
        times[label] = (k_ms, min(f32_ms, tf32_ms), by)
        log(f"[train-lse-bwd] la_row_lse_bwd {label} rows={ROWS_FUSED} feat=768 cols={cols}: "
            f"kernel_ms={k_ms:.4f} chunked cuBLAS route ms={route_ms[label]:.4f} "
            f"({route_ms[label] / k_ms:.2f}x) plain_ms={plain_ms:.4f} "
            f"bound_ms={min(f32_ms, tf32_ms):.4f} ({by}, {products} products in 3xTF32; "
            f"float32 CUDA cores {f32_ms:.4f}); {products * flops / k_ms / 1e9:.1f} TFLOP/s, "
            f"{min(f32_ms, tf32_ms) / k_ms:.3f} of the bound")
    pair_ms, pair_bound, pair_by = times["dh, dw, db"]
    try:
        trace = _device_trace(lambda: viterbi.row_lse_bwd(h, w, b, lse, gl))
    except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
        log(f"[train-lse-bwd] kernels of one call: not measured: {type(exc).__name__}: {exc}")
        trace = None
    if trace is not None:
        busy, by_name = trace
        parts = {}
        for kname, (k_ms, n) in by_name.items():
            part = _lse_bwd_part(kname) or kname[:60]
            t, c = parts.get(part, (0.0, 0))
            parts[part] = (t + k_ms, c + n)
        log(f"[train-lse-bwd] kernels of one call (torch.profiler device ms, launches): "
            f"{json.dumps({k: [round(t, 4), c] for k, (t, c) in parts.items()})}; device busy "
            f"{busy:.4f} ms")
    return [dict(name="row_lse_bwd", route="cuda", source="lyricalignment_tpu_torch/csrc/lse.cu",
                 replaces="lyricalignment_tpu/ops/viterbi.py:245 (jax.checkpoint over "
                          "_chunked_lse's scan, differentiated by autodiff)",
                 max_abs_err=max(errs_all), ms=pair_ms, plain_ms=plain_ms, library_ms=None,
                 route_ms=route_ms["dh, dw, db"], bound_ms=pair_bound, bound_by=pair_by)]


def _ctc_inputs(dev, b, t, n, kinds, seed):
    """Reduced emissions (normalised-looking log-probs) and targets, one
    kind a sample: "train" (24 of 48 positions, a repeated pair), "empty"
    (all padding), "infeasible" (every position, more than the frames). The
    label columns of a repeated label are equal, as the fused path gathers
    them from one class."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(torch.randn(b, t, n + 1, device=dev, generator=g) * 2, -1)
    blank, label = lp[..., 0].contiguous(), lp[..., 1:].contiguous()
    labels = torch.randint(2, 400, (b, n), device=dev, generator=g, dtype=torch.int32)
    valid = torch.zeros(b, n, dtype=torch.bool, device=dev)
    for i, kind in enumerate(kinds):
        valid[i, :{"train": N_CTC_VALID, "empty": 0, "infeasible": n}[kind]] = True
        labels[i, 5] = labels[i, 4]
    for j in range(1, n):
        repeat = labels[:, j] == labels[:, j - 1]
        label[:, :, j] = torch.where(repeat[:, None], label[:, :, j - 1], label[:, :, j])
    return blank, label, labels, valid


def _ctc_library_args(blank, label, labels, valid):
    """``F.ctc_loss``'s arguments for the reduced CTC's own function: the
    [T, B, 1 + N] reduced emissions as its log-probs and each position's
    column as its target, a repeat taking the column before it (so that
    the library's skip rule sees it, and the columns are equal). Its NLL is
    the reduced recursion's on targets that fit (its gradient is not: it
    assumes normalised columns)."""
    import torch

    b, t, n = label.shape
    lp = torch.cat([blank[..., None], label], dim=-1).transpose(0, 1)
    cols = torch.arange(1, n + 1, device=label.device).expand(b, n).clone()
    repeat = torch.zeros_like(valid)
    repeat[:, 1:] = labels[:, 1:] == labels[:, :-1]
    for i in range(1, n):
        cols[:, i] = torch.where(repeat[:, i], cols[:, i - 1], cols[:, i])
    lengths = valid.sum(dim=1)
    return lp, cols, torch.full((b,), t, device=label.device, dtype=torch.long), lengths


def phase_train_ctc(dev):
    """(a''): the reduced CTC forward and backward against the plain
    recursions at the training shape (B = 2, T = 1500, N = 48, 24 valid
    with a repeated pair), and at B = 3, T = 40 for an all-padding target and
    one that cannot fit beside a normal one: NLL rtol 1e-5, alphas rtol 1e-5,
    gradients rel-L2 1e-5, two runs bit-equal; the plan and the ptxas lines
    of the three kernels; times beside each kernel's own chain floor (a
    one-warp probe's cycles a dependent step, times T), the forward beside
    ``F.ctc_loss`` on the same reduced emissions and the backward beside
    ``F.ctc_loss`` forward and backward (not the same function)."""
    import torch
    import torch.nn.functional as F

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.ops import ctc

    rows = []
    for b, t, kinds in ((TRAIN_B, TRAIN_T, ["train", "train"]),
                        (3, 40, ["train", "empty", "infeasible"])):
        blank, label, labels, valid = _ctc_inputs(dev, b, t, N_CTC, kinds, seed=t)
        nll, alphas = ctc.ctc_reduced_fwd(blank, label, labels, valid)
        ref_nll, ref_alphas = ctc.ctc_reduced_fwd_plain(blank, label, labels, valid)
        gl = torch.ones(b, device=dev) / N_CTC_VALID
        grads = ctc.ctc_reduced_bwd(alphas, labels, valid, gl)
        ref_grads = ctc.ctc_reduced_bwd_plain(ref_alphas, labels, valid, gl)
        nll_rel = ((nll - ref_nll).abs() / ref_nll.abs()).max().item()
        alpha_rel = ((alphas - ref_alphas).abs() / ref_alphas.abs().clamp(min=1)).max().item()
        rels = [rel_l2(x, y) for x, y in zip(grads, ref_grads)]
        again = ctc.ctc_reduced_bwd(alphas, labels, valid, gl)
        same = (torch.equal(nll, ctc.ctc_reduced_fwd(blank, label, labels, valid)[0])
                and all(torch.equal(x, y) for x, y in zip(grads, again)))
        ok = nll_rel <= 1e-5 and alpha_rel <= 1e-5 and max(rels) <= 1e-5 and same
        log(f"[train-ctc] B={b} T={t} N={N_CTC} {kinds}: nll {[round(x, 4) for x in nll.tolist()]}"
            f" (rel diff {nll_rel:.2e}), alphas rel {alpha_rel:.2e}, rel_l2 d_blank/d_label "
            f"{rels[0]:.2e}/{rels[1]:.2e}; two runs bit-equal: {same} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the reduced CTC kernels disagree with the plain recursions "
                                 f"at B={b} T={t}")
        if "infeasible" in kinds and not (nll[2].item() > 1e29 and grads[1][2].abs().max() > 0):
            raise AssertionError("the target that cannot fit lost its sentinel NLL or gradient")

    # times at the training shape
    b, t, s_dim = TRAIN_B, TRAIN_T, 2 * N_CTC + 1
    plan = ctc.ctc_plan(t, N_CTC)
    scratch_mb = 4 * kernels.library().la_ctc_bwd_scratch_floats(b, t, N_CTC) / 1e6
    log(f"[train-ctc] plan at T={t} N={N_CTC}: {json.dumps(plan)}; the backward's weights "
        f"{scratch_mb:.2f} MB of scratch")
    blank, label, labels, valid = _ctc_inputs(dev, b, t, N_CTC, ["train", "train"], seed=t)
    nll, alphas = ctc.ctc_reduced_fwd(blank, label, labels, valid)
    _, ref_alphas = ctc.ctc_reduced_fwd_plain(blank, label, labels, valid)
    gl = torch.ones(b, device=dev) / N_CTC_VALID
    grads = ctc.ctc_reduced_bwd(alphas, labels, valid, gl)
    ref_grads = ctc.ctc_reduced_bwd_plain(ref_alphas, labels, valid, gl)
    lib_args = _ctc_library_args(blank, label, labels, valid)
    with torch.no_grad():
        lib_nll = F.ctc_loss(*lib_args, blank=0, reduction="none")
    lib_rel = ((lib_nll - nll).abs() / nll.abs()).max().item()
    log(f"[train-ctc] F.ctc_loss on the same reduced emissions (the forward's library call): "
        f"nll rel diff {lib_rel:.2e} from the kernel's (<= 1e-5) {'OK' if lib_rel <= 1e-5 else 'FAIL'}")
    if lib_rel > 1e-5:
        raise AssertionError("F.ctc_loss does not compute the reduced CTC's NLL here")

    def library_fwd():
        with torch.no_grad():
            return F.ctc_loss(*lib_args, blank=0, reduction="none")

    lib_lp = lib_args[0].detach().requires_grad_()

    def library_fwd_bwd():
        lib = F.ctc_loss(lib_lp, *lib_args[1:], blank=0, reduction="none")
        return torch.autograd.grad(lib, lib_lp, grad_outputs=gl)

    cycles = ctc_step_cycles()
    mhz = sm_clock_mhz()
    io = {"ctc_reduced_fwd": 4 * (b * t + b * t * N_CTC + 2 * b * N_CTC + b * t * s_dim + b),
          "ctc_reduced_bwd": 4 * (b * t * s_dim + 2 * b * N_CTC + b + b * t + b * t * N_CTC)}
    # the forward: _lse3 and the add, about 10 operations a state a frame;
    # the backward: the weights (three _lse3 sums, three exponentials and
    # divides) and the recurrence's three FMAs, about 20
    ops = {"ctc_reduced_fwd": 10.0 * b * t * s_dim, "ctc_reduced_bwd": 20.0 * b * t * s_dim}
    # the backward has no library call: F.ctc_loss's gradient assumes
    # normalised columns, which the reduced emissions are not; its forward
    # and backward are timed beside it as a route to a gradient
    for kernel, fn, plain, err, library, route, chain in (
            ("ctc_reduced_fwd", lambda: ctc.ctc_reduced_fwd(blank, label, labels, valid),
             lambda: ctc.ctc_reduced_fwd_plain(blank, label, labels, valid),
             (alphas - ref_alphas).abs().max().item(), library_fwd, None, "forward"),
            ("ctc_reduced_bwd", lambda: ctc.ctc_reduced_bwd(alphas, labels, valid, gl),
             lambda: ctc.ctc_reduced_bwd_plain(alphas, labels, valid, gl),
             max((x - y).abs().max().item() for x, y in zip(grads, ref_grads)), None,
             library_fwd_bwd, "backward")):
        ms = time_ms(fn, reps=10)
        plain_ms = time_ms(plain, reps=1, warmup=0)
        lib_ms = time_ms(library, reps=10) if library else None
        route_ms = time_ms(route, reps=10) if route else None
        bound_ms, bound_by = bound(ops[kernel], PEAK_F32, io[kernel])
        floor_ms = t * cycles[chain] / (mhz * 1e3)
        ptxas = "; ".join(f"{k}: {ptxas_report('ctc.cu', k)}" for k in CTC_KERNELS[f"la_{kernel}"])
        log(f"[train-ctc] {kernel} B={b} T={t} N={N_CTC} (S={s_dim}): kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
            f"(F.ctc_loss){'' if route_ms is None else f' route_ms={route_ms:.4f} (F.ctc_loss forward and backward: not the same function, its gradient assumes normalised columns)'} "
            f"bound_ms={bound_ms:.5f} ({bound_by}); {chain} chain floor {floor_ms:.4f} ms ({t} "
            f"frames x {cycles[chain]:.1f} cycles a step at {mhz:.0f} MHz), "
            f"{floor_ms / ms:.3f} of the kernel's time; ptxas: {ptxas}")
        rows.append(dict(name=kernel, route="cuda", source="lyricalignment_tpu_torch/csrc/ctc.cu",
                         replaces="lyricalignment_tpu/train/losses.py:216 (_ctc_nll_single's "
                                  "lax.scan, differentiated by autodiff)",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         route_ms=route_ms, bound_ms=bound_ms, bound_by=bound_by,
                         chain_floor_ms=floor_ms, step_cycles=cycles[chain]))
    return rows


def _train_batch(rng, accum, b, n_vocab_dec, classes, dec_len=40, n_ctc=24):
    """bench_train's stacked micro-batches: noise audio, 24 CTC labels, 30%
    labelled frames, random decoder tokens; numpy [accum, b, ...]."""
    import numpy as np

    n_samples = SECONDS * 16000
    return {
        "audio": (rng.standard_normal((accum, b, n_samples)) * 0.05).astype(np.float32),
        "ctc_labels": np.pad(rng.integers(2, classes, (accum, b, n_ctc)).astype(np.int32),
                             ((0, 0), (0, 0), (0, n_ctc)), constant_values=-100),
        "frame_labels": np.where(rng.random((accum, b, 1500)) < 0.3,
                                 rng.integers(2, classes, (accum, b, 1500)),
                                 -100).astype(np.int32),
        "label_lengths": np.full((accum, b), n_ctc, np.int32),
        "has_alignment": np.ones((accum, b), bool),
        "decoder_input": rng.integers(0, n_vocab_dec, (accum, b, dec_len)).astype(np.int32),
        "decoder_output": rng.integers(0, n_vocab_dec, (accum, b, dec_len)).astype(np.int32),
    }


def phase_train_tiny(dev):
    """(b): one make_train_step of a tiny float32 model on the GPU and on the
    CPU plain path; losses and per-group parameter updates compared."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WhisperConfig
    from lyricalignment_tpu_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    wcfg = WhisperConfig(n_vocab=64, n_audio_state=64, n_audio_head=1, n_audio_layer=2,
                         n_text_ctx=64, n_text_state=64, n_text_head=1, n_text_layer=1)
    # dropout 0: the CPU and CUDA generators draw different masks
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=32, output_dim=421, dropout=0.0,
                           train_transcript=True)
    tcfg = TrainConfig(accum_grad_steps=2, use_ctc=True, vocab_size=420, warmup_steps=0,
                       total_steps=10, head_lr=5e-3, backbone_lr=1e-3)
    stacked = _train_batch(np.random.default_rng(6), 2, 2, 64, 400, dec_len=12)
    stacked["has_alignment"][:, 1] = False  # a transcript-only sample in each micro-batch
    cpu_model = AlignModel(cfg)
    init_weights(cpu_model, torch.Generator().manual_seed(7))
    gpu_model = AlignModel(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev)
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    results = {}
    for name, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        state, tx = init_train_state(model, tcfg)
        kernels.reset_launch_counts()
        _, losses = make_train_step(tcfg, tx)(state, stacked)
        results[name] = ({k: float(v) for k, v in losses.items()}, dict(kernels.launches),
                         {n: p.detach().cpu() for n, p in model.named_parameters()})
    (l_cpu, _, p_cpu), (l_gpu, counts, p_gpu) = results["cpu"], results["gpu"]
    loss_rel = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-6) for k in l_cpu)
    worst = {}
    for group, lr in (("head", tcfg.head_lr), ("backbone", tcfg.backbone_lr)):
        names = [n for n in before if n.startswith("align_rnn.") == (group == "head")]
        d_cpu = torch.cat([(p_cpu[n] - before[n]).flatten() for n in names]).double()
        d_gpu = torch.cat([(p_gpu[n] - before[n]).flatten() for n in names]).double()
        # Adam's first step is close to lr * sign(g): a gradient at the
        # level of float32 noise can flip its entry, so count the entries
        # whose update differs by more than 2e-2 lr
        worst[group] = ((d_gpu - d_cpu).abs() > 2e-2 * lr).double().mean().item()
        moved = (d_gpu.abs() > 0.5 * lr).double().mean().item()
        log(f"[train-tiny] {group}: update rel_l2 GPU vs CPU "
            f"{((d_gpu - d_cpu).norm() / d_cpu.norm()).item():.2e}, share of entries off by "
            f"> 2e-2 lr {worst[group]:.2e} (<= 1e-3), {moved:.3f} of the entries moved by "
            f"> lr/2")
    log(f"[train-tiny] losses CPU {json.dumps(l_cpu)}; GPU max rel diff {loss_rel:.2e} "
        f"(<= 1e-4); GPU launches {counts}")
    if loss_rel > 1e-4 or max(worst.values()) > 1e-3:
        raise AssertionError("GPU train step disagrees with the CPU plain path")
    for name in TRAIN_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the GPU train step")


def phase_train_medium(dev, card, medium):
    """(c): whisper-medium at bench_train's operating point; fills
    ``medium`` with what (e) reuses: the model, the batch, the config, the
    peak memory and the mean step."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
    from lyricalignment_tpu_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        make_train_step,
        to_device,
    )

    t0 = time.perf_counter()
    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=C_CTC,
                           train_transcript=True)
    with torch.device(dev):
        model = AlignModel(cfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    # warmup_steps 1: the untimed first update has lr 0, the timed ones lr > 0
    tcfg = TrainConfig(accum_grad_steps=ACCUM, use_ctc=True, vocab_size=C_CTC - 1,
                       warmup_steps=1, total_steps=2000, grad_accum_dtype=torch.bfloat16,
                       adam_mu_dtype=torch.bfloat16)
    state, tx = init_train_state(model, tcfg)
    step_fn = make_train_step(tcfg, tx)
    stacked = to_device(_train_batch(np.random.default_rng(0), ACCUM, TRAIN_B,
                                     wcfg.n_vocab, 400), dev)
    n_params = sum(p.numel() for p in model.parameters())
    watch = ("whisper_model.encoder.blocks.0.attn.query.weight",
             "whisper_model.decoder.blocks.23.mlp.0.weight", "align_rnn.fc.weight")
    params = dict(model.named_parameters())
    log(f"[train-medium] {n_params / 1e6:.1f} M parameters, set up in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = step_fn(state, stacked)
    torch.cuda.synchronize()
    log(f"[train-medium] warm-up step (lr 0) {time.perf_counter() - t0:.3f} s, losses "
        f"{json.dumps({k: round(float(v), 5) for k, v in losses.items()})}")
    snap = {n: params[n].detach().clone() for n in watch}
    steps = TRAIN_STEPS
    kernels.reset_launch_counts()
    times, all_losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, losses = step_fn(state, stacked)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_losses.append({k: float(v) for k, v in losses.items()})
    counts = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [round(x * 1e3, 1) for x in times]
    mean_s = sum(times) / steps
    rate = ACCUM * TRAIN_B * SECONDS / mean_s
    moved = {n: (params[n].detach() - snap[n]).abs().max().item() for n in watch}
    log(f"[train-medium] whisper-medium bf16, {ACCUM} x {TRAIN_B} x {SECONDS} s, CTC "
        f"{C_CTC}, align CE + CTC + transcript CE: step ms {step_ms} (mean "
        f"{mean_s * 1e3:.1f}), {rate:.2f} trained audio-s/s, max_memory_allocated "
        f"{peak_gb:.2f} GB on {card}; launches in {steps} steps {counts}")
    log(f"[train-medium] losses {json.dumps(all_losses)}; max |update| of {json.dumps(moved)}")
    expected = {name: steps * ACCUM * n for name, n in TRAIN_KERNELS.items()}
    if counts != expected:
        raise AssertionError(f"train steps launched {counts}, expected {expected}")
    if not all(math.isfinite(v) for row in all_losses for v in row.values()):
        raise AssertionError("non-finite training loss")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"parameters did not move: {moved}")
    medium.update(model=model, stacked=stacked, tcfg=tcfg, peak_gb=peak_gb, step_ms=mean_s * 1e3)

    try:
        trace = _device_trace(lambda: step_fn(state, stacked))
    except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
        log(f"[train-trace] not measured: {type(exc).__name__}: {exc}")
        trace = None
    if trace is None:
        log("[train-trace] not measured: the profiler recorded no device activity")
    else:
        busy, by_name = trace
        n_kernels = sum(n for _, n in by_name.values())
        # the align head's recurrence: cuDNN/cuBLAS kernels per time step
        gru = sum(n for name, (_, n) in by_name.items()
                  if "RNN" in name or "GRU" in name or "gemmSN" in name)
        log(f"[train-trace] one step: device busy {busy:.1f} ms of the {mean_s * 1e3:.1f} ms "
            f"mean step, idle share {1 - busy / (mean_s * 1e3):.3f}; {n_kernels} device "
            f"kernels and copies, {gru} of them the GRU's per-time-step kernels; top device "
            f"kernels (ms, count):")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
            log(f"[train-trace]   {ms:9.3f} {n:6d}  {name[:110]}")
    return counts


def phase_train_cli(dev, tmp):
    """(d): the train CLI for 2 steps of whisper-tiny, then align with the
    model it wrote."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.cli.common import load_model_dir
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    vocab, table = _vocab_and_table()
    lengths = [6.0, 9.5, 12.0, 14.5]
    requests = _write_requests(tmp, lengths, seed=3)
    records = []
    for (path, lyric), sec in zip(requests, lengths):
        step = (sec - 0.5) / len(lyric)
        records.append({"song_path": path, "lyric": lyric,
                        "on_offset": [[0.2 + i * step, 0.2 + (i + 0.8) * step]
                                      for i in range(len(lyric))]})
    data = os.path.join(tmp, "train.json")
    with open(data, "w", encoding="utf-8") as f:
        json.dump(records, f, ensure_ascii=False)
    vocab_path = os.path.join(tmp, "vocab.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(tok for tok, _ in sorted(vocab.items(), key=lambda kv: kv[1])))
    save = os.path.join(tmp, "result")
    cmd = [sys.executable, "-m", "lyricalignment_tpu_torch.cli.train_multitask",
           "--train-data", data, "--dev-data", data, "--whisper-model", "tiny",
           "--train-alignment", "--train-transcript", "--use-ctc-loss", "--bf16",
           "--fast-gelu", "--train-batch-size", "2", "--dev-batch-size", "4",
           "--accum-grad-steps", "2", "--train-steps", "2", "--eval-steps", "1",
           "--warmup-steps", "0", "--bert-vocab", vocab_path, "--save-dir", save,
           "--fused-losses", "--profile-at-step", "2", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    log(f"[train-cli] {' '.join(cmd[1:4])} ... exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-12:]:
        log(f"[train-cli]   {line}")
    if proc.returncode != 0:
        raise AssertionError("the train CLI failed")
    if not os.path.exists(os.path.join(save, "best_model.pt")):
        raise AssertionError("the train CLI wrote no best_model.pt")
    _report_cli_trace(os.path.join(save, "profile", "trace.json"))
    _, model, _ = load_model_dir(save, "best", use_bf16=True, device=str(dev))
    aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table, use_ctc=True,
                           batch_size=4)
    results = aligner.align_many(requests)
    _check_segments(results, requests, lengths)
    log(f"[train-cli] best_model loaded and aligned {len(results)} requests "
        f"({sum(len(r) for r in results)} characters)")


FUSED_STEPS = 2
# a micro-batch of the fused losses adds the row LSE twice (CE with
# the silence head, CTC), its backward entry twice, and the reduced CTC
# once each way
FUSED_KERNELS = dict(TRAIN_KERNELS, la_row_lse=2, la_row_lse_bwd=2, la_ctc_reduced_fwd=1,
                     la_ctc_reduced_bwd=1)


def _ctc_against_float64(model, micro, vocab):
    """The align CTC of a micro-batch three ways, on the model's hidden
    (no dropout): fused (the reduced CTC kernels), unfused (``F.ctc_loss``
    on float32 log-softmax) and the plain reduced recursion in float64 on
    float64 logits; with each float32 way's gradient of the CTC group mean
    with respect to the fc weight against autograd through ``F.ctc_loss`` in
    float64. Returns ({way: per-sample losses}, {way: grad rel-L2})."""
    import torch
    import torch.nn.functional as F

    from lyricalignment_tpu_torch.models.align_model import forward_from_audio
    from lyricalignment_tpu_torch.ops import viterbi
    from lyricalignment_tpu_torch.ops.ctc import ctc_reduced_fwd_plain
    from lyricalignment_tpu_torch.train import losses

    with torch.no_grad():
        h, _ = forward_from_audio(model, micro["audio"], trim_to_input_length=False,
                                  align_head_output="hidden")
    fc = model.align_rnn.fc
    labels = micro["ctc_labels"]
    valid = labels != losses.IGNORE_ID
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    tlen = valid.sum(dim=1).clamp(min=1)
    b, t = h.shape[:2]
    w64 = fc.weight.detach().double().requires_grad_()
    lp64 = torch.log_softmax(h.double() @ w64[:vocab].T + fc.bias.detach()[:vocab].double(), -1)
    nll64 = F.ctc_loss(lp64.transpose(0, 1), safe, torch.full((b,), t, device=h.device),
                       valid.sum(dim=1), blank=0, reduction="none") / tlen
    (g64,) = torch.autograd.grad(nll64.mean(), w64)
    with torch.no_grad():
        lab = torch.gather(lp64, 2, safe[:, None, :].expand(b, t, safe.shape[1]))
        red64 = ctc_reduced_fwd_plain(lp64[..., 0], lab, safe, valid)[0] / tlen
        # the float32 pieces of the fused path against float64, and its
        # recursion alone on the float64 emissions rounded to float32
        w, bias = fc.weight, fc.bias
        lse = viterbi.class_lse(h, w[:vocab], bias[:vocab])
        lse64 = torch.logsumexp(h.double() @ w[:vocab].double().T + bias[:vocab].double(), -1)
        blank32 = (h @ w[0] + bias[0]) - lse
        label32 = viterbi.gather_label_logits(h, w, bias, safe) - lse[..., None]
        errs = {"lse": (lse.double() - lse64).abs().max().item(),
                "blank_lp": (blank32.double() - lp64[..., 0]).abs().max().item(),
                "label_lp": (label32.double() - lab).abs().max().item()}
        rec32 = losses.ctc_reduced_nll(lp64[..., 0].float(), lab.float(), safe, valid) / tlen
        log(f"[train-fused] fused emissions' max abs error against float64 {json.dumps(errs)} "
            f"(lse <= 2e-5); the reduced CTC kernel on float64 emissions rounded to float32: "
            f"{[round(x, 5) for x in rec32.tolist()]}")
        if errs["lse"] > 2e-5:
            raise AssertionError("the row LSE on trained weights is far from float64")
    del lp64, lab
    per, rel = {"float64": red64, "float64 F.ctc_loss": nll64.detach()}, {}
    for way in ("fused", "unfused"):
        fc.weight.grad = None
        if way == "fused":
            nll = losses.ctc_per_example_fused(h, fc, labels, vocab)
        else:
            nll = losses.ctc_per_example(fc(h)[:, :, :vocab], labels, micro["ctc_frames_needed"])
        (g,) = torch.autograd.grad(nll.mean(), fc.weight)
        per[way] = nll.detach()
        rel[way] = rel_l2(g, g64)
    return per, rel


def phase_train_fused(dev, card, medium):
    """(e): whisper-medium at (c)'s operating point with ``fused_losses``.
    First, on (c)'s weights and first micro-batch without dropout: the row
    LSE against float64 (atol 2e-5: trained weights give logits whose
    products share a sign, where truncating adds drift), the align CTC
    fused, unfused and in float64 (the fused within rtol 1e-4 of
    float64, its fc gradient within rel-L2 2e-3 of float64's: float32
    emissions and alpha recursion over 1500 frames); the whole fused losses
    against the unfused ones (CE and CTC rtol 1e-4) and the gradients of the
    head's fc and of one encoder weight (rel-L2 2e-3 each: the two float32
    CTC gradients' errors add, and the encoder's backward rounds in bf16). Then one warm-up step and FUSED_STEPS timed
    ones with a fresh optimizer state: step ms, peak memory beside (c)'s and
    the launch counts."""
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.train.trainer import (
        init_train_state,
        make_train_step,
        multitask_losses,
    )

    model, stacked, tcfg = medium["model"], medium["stacked"], medium["tcfg"]
    fused_cfg = dataclasses.replace(tcfg, fused_losses=True)
    micro = {k: v[0] for k, v in stacked.items()}
    per, ctc_rel = _ctc_against_float64(model, micro, tcfg.vocab_size)
    ctc_loss_rel = {way: ((per[way].double() - per["float64"]).abs()
                          / per["float64"].abs()).max().item() for way in ("fused", "unfused")}
    ref_gap = ((per["float64 F.ctc_loss"] - per["float64"]).abs() / per["float64"].abs()).max()
    ok = ctc_loss_rel["fused"] <= 1e-4 and ctc_rel["fused"] <= 2e-3
    log(f"[train-fused] align CTC of the first micro-batch, per sample: "
        f"{json.dumps({k: [round(x, 5) for x in v.tolist()] for k, v in per.items()})}; rel diff "
        f"from float64 fused {ctc_loss_rel['fused']:.2e} (<= 1e-4), unfused "
        f"{ctc_loss_rel['unfused']:.2e} (float64's two ways {ref_gap.item():.1e}); fc-weight "
        f"gradient rel_l2 from float64 F.ctc_loss fused {ctc_rel['fused']:.2e} (<= 2e-3), unfused "
        f"{ctc_rel['unfused']:.2e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused CTC is far from its float64 value")
    del per
    watch = ("align_rnn.fc.weight", "whisper_model.encoder.blocks.23.mlp.0.weight")
    params = dict(model.named_parameters())
    runs = {}
    for name, cfg in (("unfused", tcfg), ("fused", fused_cfg)):
        for p in params.values():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        total, losses = multitask_losses(model, cfg, micro, None)
        total.backward()
        torch.cuda.synchronize()
        runs[name] = ({k: float(v.detach()) for k, v in losses.items()},
                      {n: params[n].grad.detach().float().clone() for n in watch},
                      torch.cuda.max_memory_allocated() / 1e9)
    for p in params.values():
        p.grad = None
    (lu, gu, mu), (lf, gf, mf) = runs["unfused"], runs["fused"]
    loss_rel = {k: abs(lf[k] - lu[k]) / max(abs(lu[k]), 1e-12) for k in ("align_ce", "align_ctc")}
    grad_rel = {n: rel_l2(gf[n], gu[n]) for n in watch}
    bounds = {watch[0]: 2e-3, watch[1]: 2e-3}
    ok = max(loss_rel.values()) <= 1e-4 and all(grad_rel[n] <= bounds[n] for n in watch)
    log(f"[train-fused] first micro-batch, fused vs unfused: losses {json.dumps(lf)} vs "
        f"{json.dumps(lu)}, rel diff {json.dumps({k: f'{v:.2e}' for k, v in loss_rel.items()})} "
        f"(<= 1e-4); grad rel_l2 "
        f"{json.dumps({n: f'{v:.2e}' for n, v in grad_rel.items()})} "
        f"(<= {json.dumps(bounds)}); one micro-batch's forward + backward peak "
        f"{mf:.2f} GB fused, {mu:.2f} GB unfused {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused losses disagree with the unfused ones")
    del gu, gf

    state, tx = init_train_state(model, fused_cfg)
    step_fn = make_train_step(fused_cfg, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = step_fn(state, stacked)
    torch.cuda.synchronize()
    log(f"[train-fused] warm-up step {time.perf_counter() - t0:.3f} s, losses "
        f"{json.dumps({k: round(float(v), 5) for k, v in losses.items()})}")
    kernels.reset_launch_counts()
    times, all_losses = [], []
    for _ in range(FUSED_STEPS):
        t0 = time.perf_counter()
        state, losses = step_fn(state, stacked)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_losses.append({k: float(v) for k, v in losses.items()})
    counts = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_s = sum(times) / FUSED_STEPS
    log(f"[train-fused] whisper-medium bf16, {ACCUM} x {TRAIN_B} x {SECONDS} s, fused losses: "
        f"step ms {[round(x * 1e3, 1) for x in times]} (mean {mean_s * 1e3:.1f}; unfused (c) "
        f"{medium['step_ms']:.1f}), {ACCUM * TRAIN_B * SECONDS / mean_s:.2f} trained audio-s/s, "
        f"max_memory_allocated {peak_gb:.2f} GB (unfused (c) {medium['peak_gb']:.2f} GB) on "
        f"{card}; launches in {FUSED_STEPS} steps {counts}")
    log(f"[train-fused] losses {json.dumps(all_losses)}")
    expected = {name: FUSED_STEPS * ACCUM * n for name, n in FUSED_KERNELS.items()}
    if counts != expected:
        raise AssertionError(f"fused train steps launched {counts}, expected {expected}")
    if not all(math.isfinite(v) for row in all_losses for v in row.values()):
        raise AssertionError("non-finite fused training loss")
    try:
        trace = _device_trace(lambda: step_fn(state, stacked))
    except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
        log(f"[train-fused] traced step: not measured: {type(exc).__name__}: {exc}")
        trace = None
    if trace is not None:
        busy, by_name = trace
        parts = {}
        for kname, (k_ms, n) in by_name.items():
            part = _fused_part(kname)
            if part is not None:
                t, c = parts.get(part, (0.0, 0))
                parts[part] = (t + k_ms, c + n)
        log(f"[train-fused] one traced fused step: device busy {busy:.1f} ms; the fused losses' "
            f"kernels {sum(t for t, _ in parts.values()):.2f} ms (device ms, launches: "
            f"{json.dumps({k: [round(t, 3), c] for k, (t, c) in parts.items()})})")
    del state, step_fn, tx
    return counts


def _fused_part(name):
    """The fused losses' kernel that a profiler name belongs to, or None."""
    flat = name.replace(" ", "")
    for part, keys in (("la_row_lse", ("row_lse_kernel", "merge_kernel")), *CTC_KERNELS.items()):
        if any(k in flat for k in keys):
            return part
    part = _lse_bwd_part(name)
    if part == "w_lo":
        return "w_lo (la_row_lse and la_row_lse_bwd)"
    return None if part is None else f"la_row_lse_bwd {part}"


def _report_cli_trace(path):
    """The train CLI's profile of its step 2: the host spans ``data`` and
    ``train_step`` and the device's busy time in that step."""
    if not os.path.exists(path):
        raise AssertionError(f"the train CLI wrote no profile at {path}")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in ("data", "train_step"):
            spans[e["name"]] = spans.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy_us, end_us = 0.0, -math.inf
    for t0, t1 in device:
        busy_us += max(0.0, t1 - max(t0, end_us))
        end_us = max(end_us, t1)
    log(f"[train-cli] profile of step 2 ({os.path.getsize(path) / 1e6:.1f} MB, {len(events)} "
        f"events): host spans {json.dumps({k: round(v, 3) for k, v in spans.items()})} ms, "
        f"device busy {busy_us / 1e3:.3f} ms in {len(device)} kernels and copies")
    if set(spans) != {"data", "train_step"}:
        raise AssertionError(f"the profile lacks the data / train_step spans: {sorted(spans)}")


# ---------------------------------------------------------------------------
# Phase "int8": the int8 encoder and the int8 cross K/V at whisper-medium
# ---------------------------------------------------------------------------

INT8_DECODE_NEW = 24   # beam steps a timed int8 / bf16 decode may take


def phase_int8(dev, card, model, tmp):
    """whisper-medium bf16, B = 16 x 30 s, L = 48, CTC, the serving model's
    weights: the alignment batch with the int8 encoder on ``int8_resident``
    weights beside the bf16 one (audio-s/s of each, bf16, int8, int8, bf16),
    the encoder output's rel-L2 and the share of onsets and offsets within
    one 20 ms frame of the bf16 path's; a trace of the int8 encoder, whose
    int8 GEMMs must show; then ``beam_search`` of 8 windows with int8 cross
    K/V beside bf16: decode ms a step, the first step's logits rel-L2 and
    the cross K/V cache bytes."""
    import re

    import torch

    from lyricalignment_tpu_torch import EMBED_FRAMES, N_FRAMES
    from lyricalignment_tpu_torch.cli.inference_transcript import suppress_token_ids
    from lyricalignment_tpu_torch.decode import beam as beam_mod
    from lyricalignment_tpu_torch.models.align_model import AlignModel, forward_from_audio
    from lyricalignment_tpu_torch.models.whisper import (
        init_decode_cache,
        int8_resident,
        prime_decode_cache,
    )
    from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim
    from lyricalignment_tpu_torch.ops.viterbi import viterbi_align_fused
    from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    t_start = time.perf_counter()
    cfg8 = dataclasses.replace(model.cfg, whisper=dataclasses.replace(model.cfg.whisper,
                                                                      int8_encoder=True))
    with torch.device("meta"):
        model8 = AlignModel(cfg8)
    # the bf16 model's tensors, shared; then the encoder linears int8-resident
    model8.load_state_dict(model.state_dict(), assign=True)
    int8_resident(model8.whisper_model).eval()
    g = torch.Generator(device=dev).manual_seed(5)
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    frames = torch.full((B,), EMBED_FRAMES, dtype=torch.int32, device=dev)
    labels = torch.randint(2, 400, (B, L_BENCH), device=dev, generator=g, dtype=torch.int32)
    num_labels = torch.full((B,), L_BENCH, dtype=torch.int32, device=dev)

    @torch.inference_mode()
    def align(m):
        h, _ = forward_from_audio(m, audio, frame_lengths=frames, mel_lengths=2 * frames,
                                  align_head_output="hidden")
        fc = m.align_rnn.fc
        return viterbi_align_fused(h, fc.weight, fc.bias, labels, num_labels, frames, "ctc")

    walls = {"bf16": [], "int8": []}
    outs = {}
    for name in ("bf16", "int8", "int8", "bf16", "bf16", "int8"):
        m = model if name == "bf16" else model8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = align(m)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    rates = {k: [round(B * SECONDS / x, 1) for x in v[1:]] for k, v in walls.items()}
    with torch.inference_mode():
        mel = pad_or_trim(log_mel(audio, n_mels=80), N_FRAMES)
        enc16 = model.whisper_model.embed_audio(mel)
        enc8 = model8.whisper_model.embed_audio(mel)
    enc_rel = rel_l2(enc8, enc16)
    (on16, off16), (on8, off8) = outs["bf16"], outs["int8"]
    within = torch.cat([(on8 - on16).abs() <= 1, (off8 - off16).abs() <= 1]).double().mean().item()
    exact = torch.cat([on8 == on16, off8 == off16]).double().mean().item()
    log(f"[int8] medium bf16 B={B} {SECONDS} s L={L_BENCH} CTC alignment: audio-s/s bf16 "
        f"{rates['bf16']} int8-encoder {rates['int8']} (each after a first batch) on {card}; "
        f"encoder output rel_l2 int8 vs bf16 {enc_rel:.3e} (<= 0.1); onsets/offsets within one "
        f"20 ms frame of bf16's {within:.4f}, equal {exact:.4f}")
    if not (bool(torch.isfinite(enc8.float()).all()) and enc_rel <= 0.1):
        raise AssertionError("the int8 encoder is far from the bf16 one")

    try:
        trace = _device_trace(lambda: model8.whisper_model.embed_audio(mel))
    except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
        log(f"[int8-trace] not measured: {type(exc).__name__}: {exc}")
        trace = None
    if trace is not None:
        busy, by_name = trace
        int8_names = {n: v for n, v in by_name.items()
                      if re.search(r"s8|i8|int8|imma|igemm", n, re.IGNORECASE)}
        n_int8 = sum(n for _, n in int8_names.values())
        log(f"[int8-trace] one int8 encoder forward (B={B}): device busy {busy:.2f} ms; "
            f"{n_int8} launches of int8 GEMM kernels ({sum(ms for ms, _ in int8_names.values()):.2f}"
            f" ms), 6 a layer expected ({6 * cfg8.whisper.n_audio_layer}); top device kernels:")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"[int8-trace]   {ms:9.3f} {n:5d}  {name[:110]}")
        if n_int8 < 6 * cfg8.whisper.n_audio_layer:
            raise AssertionError("the int8 GEMMs do not show in the encoder's trace")
    del model8, enc8

    # int8 cross K/V: beam_search of 8 windows beside bf16
    whisper = model.whisper_model
    wcfg = whisper.cfg
    cfg_kv = dataclasses.replace(wcfg, int8_cross_kv=True)
    tok = WhisperTokenizer(bpe_path=_write_ranks(tmp))
    suppress_ids, begin_suppress_ids = suppress_token_ids(tok)
    prompt = torch.tensor([list(tok.sot_sequence) + [tok.no_timestamps]] * TR_WINDOWS, device=dev)
    xa = enc16[:TR_WINDOWS].contiguous()
    steps = [0]
    real_step = beam_mod.decode_step

    def counted_step(*a):
        steps[0] += 1
        return real_step(*a)

    @torch.no_grad()
    def decode(cfg):
        steps[0] = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tokens, _ = beam_mod.beam_search(whisper, cfg, xa, prompt, beam_size=TR_BEAM,
                                         max_new_tokens=INT8_DECODE_NEW, eot=tok.eot,
                                         suppress_ids=suppress_ids,
                                         begin_suppress_ids=begin_suppress_ids)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), steps[0]

    beam_mod.decode_step = counted_step
    try:
        step_ms = {"bf16": [], "int8": []}
        for name in ("bf16", "int8", "int8", "bf16", "bf16", "int8"):
            ms, n = decode(wcfg if name == "bf16" else cfg_kv)
            step_ms[name].append(round(ms / max(n, 1), 3))
    finally:
        beam_mod.decode_step = real_step
    with torch.no_grad():
        caches, first = {}, {}
        for name, cfg in (("bf16", wcfg), ("int8", cfg_kv)):
            caches[name] = init_decode_cache(whisper, cfg, xa, prompt.shape[1], 8, TR_BEAM)
            first[name], _, _ = prime_decode_cache(whisper, cfg, prompt, caches[name])
    cross_bytes = {name: sum(t.numel() * t.element_size() for blk in c["blocks"]
                             for k, t in blk.items() if k.startswith("cross_"))
                   for name, c in caches.items()}
    logit_rel = rel_l2(first["int8"], first["bf16"])
    log(f"[int8-decode] beam_search beam {TR_BEAM}, {TR_WINDOWS} windows, up to "
        f"{INT8_DECODE_NEW} new tokens: ms a step (each after the first call) bf16 "
        f"{step_ms['bf16'][1:]} int8 cross K/V {step_ms['int8'][1:]}; first step's logits rel_l2 "
        f"int8 vs bf16 {logit_rel:.3e} (<= 5e-2); cross K/V cache {cross_bytes['bf16'] / 1e6:.1f} "
        f"MB bf16, {cross_bytes['int8'] / 1e6:.1f} MB int8 with scales, on {card}")
    if not logit_rel <= 5e-2:
        raise AssertionError("the int8 cross K/V logits are far from bf16's")
    del caches, enc16, xa
    torch.cuda.empty_cache()
    log(f"[int8] phase passed in {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------------------
# Phase 7: transcription (KV-cached decoding, beam search, long-form)
# ---------------------------------------------------------------------------

TR_WINDOWS, TR_BEAM, TR_MAX_NEW = 8, 5, 224   # the transcript CLI's defaults, 8 windows
# a batch of TR_WINDOWS windows: the log-mel once, encoder attention once a layer
TRANSCRIBE_KERNELS = {"la_log10_mel": 1, "la_bias_attention": 24}
TR_SECONDS = (12.0, 30.0, 70.0)


def _tiny_whisper(dev, seed):
    """A float32 whisper of width 64 (one head of 64, the attention
    kernel's width) with the real vocabulary and a 64-token context, in
    eval mode on ``dev``; random weights from ``seed``, the decoder's
    positions and token embedding made larger so its picks do not tie."""
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WhisperConfig

    wcfg = WhisperConfig(n_vocab=51865, n_audio_state=64, n_audio_head=1, n_audio_layer=2,
                         n_text_ctx=64, n_text_state=64, n_text_head=1, n_text_layer=2,
                         onepass_encoder=True)
    model = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=32, output_dim=64))
    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    dec = model.whisper_model.decoder
    with torch.no_grad():
        dec.positional_embedding.normal_(0.0, 0.5, generator=g)
        dec.token_embedding.weight.mul_(20.0)
    return model.whisper_model.to(dev).eval()


def _write_ranks(tmp):
    """A synthetic byte-level BPE ranks file (each byte its own token) in
    ``tmp``: nothing is downloaded. Returns its path."""
    import base64

    ranks = os.path.join(tmp, "ranks.tiktoken")
    if not os.path.exists(ranks):
        with open(ranks, "w") as f:
            f.write("\n".join(base64.b64encode(bytes([i])).decode() + f" {i}"
                              for i in range(256)))
    return ranks


def _transcript_args(**kw):
    from types import SimpleNamespace

    base = dict(is_mixture=0, batch_size=4, beam_size=TR_BEAM, max_new_tokens=16,
                use_groundtruth=True, temperature_fallback=False, fast_windows=False,
                length_penalty=None, patience=None, no_condition_on_previous_text=False,
                seed=114514, decode_group=1)
    return SimpleNamespace(**{**base, **kw})


def phase_transcribe_tiny(dev, tmp):
    """(a): a tiny float32 model through transcribe_records (beam 5 with
    long-form, greedy with --fast-windows) and transcribe_longform on the
    GPU and on the CPU plain path; tokens and segments must be equal. Then
    the 70 s song's whole-song log-mel (120 s padded, 12,000 frames) from
    the kernel against its plain version."""
    import torch

    from lyricalignment_tpu_torch import HOP_LENGTH, kernels
    from lyricalignment_tpu_torch.cli.inference_transcript import transcribe_records
    from lyricalignment_tpu_torch.data.audio_io import load_audio_file
    from lyricalignment_tpu_torch.data.records import Record
    from lyricalignment_tpu_torch.decode import longform
    from lyricalignment_tpu_torch.ops import mel
    from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    requests = _write_requests(tmp, TR_SECONDS, seed=4)
    records = [Record(audio_path=p, text=t) for p, t in requests]
    tok = WhisperTokenizer()     # no ranks: texts are the token ids themselves
    models = {"cpu": _tiny_whisper(torch.device("cpu"), 9), "gpu": _tiny_whisper(dev, 9)}
    cases = {"beam5+longform": _transcript_args(),
             "greedy+fast-windows": _transcript_args(beam_size=1, fast_windows=True)}
    song = load_audio_file(requests[-1][0], 0)["speech"]
    out, counts = {}, {}
    for name, model in models.items():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        texts = {case: [r["inference"] for r in transcribe_records(
            records, model, model.cfg, tok, args)] for case, args in cases.items()}
        kernels_records = dict(kernels.launches)
        kernels.reset_launch_counts()
        result = longform.transcribe_longform(model, model.cfg, song, tok, beam_size=TR_BEAM,
                                              temperatures=(0.0,), max_new_tokens=16)
        counts[name] = (kernels_records, dict(kernels.launches))
        segs = [(s["start"], s["end"], s["tokens"]) for s in result["segments"]]
        out[name] = (texts, segs)
        log(f"[transcribe-tiny] {name}: transcribe_records x{len(cases)} + one long-form song "
            f"in {time.perf_counter() - t0:.1f} s; {len(segs)} segments")
    (t_cpu, s_cpu), (t_gpu, s_gpu) = out["cpu"], out["gpu"]
    for case in cases:
        for path, a, b in zip(TR_SECONDS, t_cpu[case], t_gpu[case]):
            log(f"[transcribe-tiny]   {case} {path:.0f} s: equal={a == b} {b[:70]}")
    (rec_counts, song_counts) = counts["gpu"]
    n_windows = song_counts.get("la_bias_attention", 0) // 2
    log(f"[transcribe-tiny] GPU launches: transcribe_records {rec_counts}; the 70 s long-form "
        f"song {song_counts} ({n_windows} windows of 2 layers)")
    if t_cpu != t_gpu or s_cpu != s_gpu:
        raise AssertionError("GPU transcription tokens differ from the CPU plain path's")
    if not s_gpu or len({a for a in t_gpu["beam5+longform"]}) < 2:
        raise AssertionError("the transcription produced no segments or constant text")
    for name in TRANSCRIBE_KERNELS:
        if rec_counts.get(name, 0) <= 0 or song_counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the transcription path")
    if song_counts["la_log10_mel"] != 1:
        raise AssertionError("the long-form song's log-mel is not one launch")

    # the whole-song log-mel: 70 s padded to whole windows plus one
    padded_len = ((len(song) + 480000) + 480000 - 1) // 480000 * 480000
    audio = torch.zeros((1, padded_len), device=dev)
    audio[0, : len(song)] = torch.from_numpy(song).to(dev)
    padded = mel.reflect_pad(audio).contiguous()
    n_frames = padded_len // HOP_LENGTH
    got = mel.log10_mel(padded, n_frames, 80)
    # the plain version run in float64 (its float32 dense DFT rounds the
    # small bins of a long input by ~2e-4 in log10); compared where the
    # path keeps the mel, within 8 decades of the peak (log_mel's clamp)
    ref = mel.log10_mel_plain(padded.double(), n_frames, 80)
    floor = ref.max() - 8.0
    err = (torch.maximum(got.double(), floor) - torch.maximum(ref, floor)).abs().max().item()
    plain32_err = (torch.maximum(mel.log10_mel_plain(padded, n_frames, 80).double(), floor)
                   - torch.maximum(ref, floor)).abs().max().item()
    ms = time_ms(lambda: mel.log10_mel(padded, n_frames, 80), reps=20)
    plain_ms = time_ms(lambda: mel.log10_mel_plain(padded, n_frames, 80), reps=20)
    log(f"[transcribe-mel] whole-song log-mel [1, {padded.shape[1]}] -> 80 x {n_frames} "
        f"frames: kernel vs the float64 plain version {err:.3e} within 8 decades of the "
        f"peak (atol 1e-4; the float32 plain version {plain32_err:.3e}); kernel {ms:.4f} ms, "
        f"float32 plain {plain_ms:.4f} ms")
    if got.shape != (1, 80, n_frames) or not err <= 1e-4:
        raise AssertionError("the whole-song log-mel disagrees with its plain version")
    return {"song_windows": n_windows, "song_counts": song_counts}


def phase_transcribe_medium(dev, card, tmp):
    """(b): whisper-medium, full width and depth, bf16, tanh GELU, random
    weights from a seed: 8 windows of 30 s encoded, then ``beam_search``
    (beam 5, 224 new tokens), then ``greedy_decode`` of the same batch, with
    the suppress ids ``transcribe_records`` passes (a synthetic ranks file)."""
    import torch

    from lyricalignment_tpu_torch import N_FRAMES, kernels
    from lyricalignment_tpu_torch.cli.inference_transcript import suppress_token_ids
    from lyricalignment_tpu_torch.decode import beam as beam_mod
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import (
        WHISPER_CONFIGS,
        bf16_resident,
        decode_step,
        init_decode_cache,
        prime_decode_cache,
    )
    from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim
    from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    t0 = time.perf_counter()
    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True, onepass_encoder=True)
    with torch.device(dev):
        align = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=64))
    align.to(dev)
    init_weights(align, torch.Generator(device=dev).manual_seed(0))
    model = bf16_resident(align.whisper_model).eval()
    tok = WhisperTokenizer(bpe_path=_write_ranks(tmp))
    eot = tok.eot
    suppress_ids, begin_suppress_ids = suppress_token_ids(tok)
    prompt_ids = list(tok.sot_sequence) + [tok.no_timestamps]
    prompt = torch.tensor([prompt_ids] * TR_WINDOWS, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    audio = torch.randn(TR_WINDOWS, 480000, device=dev, generator=g) * 0.1
    log(f"[transcribe-medium] whisper-medium bf16 built in {time.perf_counter() - t0:.1f} s; "
        f"{len(suppress_ids)} suppressed ids, {len(begin_suppress_ids)} at the first step")

    steps = [0]
    real_step = beam_mod.decode_step

    def counted_step(*a):
        steps[0] += 1
        return real_step(*a)

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    @torch.no_grad()
    def decode(kind, xa, max_new):
        """``beam_search`` or ``greedy_decode`` as ``transcribe_records``
        calls them; the decode steps it ran."""
        kw = dict(max_new_tokens=max_new, eot=eot, suppress_ids=suppress_ids,
                  begin_suppress_ids=begin_suppress_ids)
        steps[0] = 0
        if kind == "beam":
            tokens, _ = beam_mod.beam_search(model, wcfg, xa, prompt, beam_size=TR_BEAM, **kw)
        else:
            tokens = beam_mod.greedy_decode(model, wcfg, xa, prompt, **kw)
        return tokens, steps[0]

    @torch.no_grad()
    def run(kind, max_new=TR_MAX_NEW, xa=None):
        """encode (unless ``xa``) then decode, CUDA-event ms of each and
        the host wall of both; then a prime alone on the same windows, whose
        ms the decode's include (decode ms = the call's less the prime's)."""
        marks = {name: events() for name in ("call", "prime")}
        t0 = time.perf_counter()
        if xa is None:
            marks["encode"] = events()
            marks["encode"][0].record()
            xa = model.embed_audio(pad_or_trim(log_mel(audio, n_mels=80), N_FRAMES))
            marks["encode"][1].record()
        marks["call"][0].record()
        tokens, n_steps = decode(kind, xa, max_new)
        marks["call"][1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        marks["prime"][0].record()
        cache = init_decode_cache(model, wcfg, xa, prompt.shape[1], max_new,
                                  beam_size=TR_BEAM if kind == "beam" else 1)
        prime_decode_cache(model, wcfg, prompt, cache)
        marks["prime"][1].record()
        torch.cuda.synchronize()
        ms = {name: s.elapsed_time(e) for name, (s, e) in marks.items()}
        ms["decode"] = ms["call"] - ms["prime"]
        return xa, tokens, ms, n_steps, wall

    beam_mod.decode_step = counted_step
    try:
        run("beam", max_new=4)                          # first-use allocations
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        xa, tokens, ms, n_steps, wall = run("beam")
        counts = dict(kernels.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        kernels.reset_launch_counts()
        _, g_tokens, g_ms, g_steps, _ = run("greedy", xa=xa)
        g_counts = dict(kernels.launches)

        # a few steps under the profiler: device busy a step and the idle share
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_traced = decode("beam", xa, 11)[1]
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3
        try:
            trace = _device_trace(lambda: decode("beam", xa, 11))
        except Exception as exc:  # noqa: BLE001 - CUPTI may be unavailable
            log(f"[transcribe-trace] not measured: {type(exc).__name__}: {exc}")
            trace = None
    finally:
        beam_mod.decode_step = real_step
    n_tokens = int((tokens != eot).sum()) + TR_WINDOWS
    dec_s = ms["call"] / 1e3
    log(f"[transcribe-medium] beam_search, beam {TR_BEAM}, {TR_WINDOWS} windows of 30 s, "
        f"max_new_tokens {TR_MAX_NEW}: encode {ms['encode']:.2f} ms, beam_search "
        f"{ms['call']:.1f} ms = prime {ms['prime']:.2f} ms (timed alone) + decode "
        f"{ms['decode']:.1f} ms in {n_steps} steps = {ms['decode'] / max(n_steps, 1):.3f} ms a "
        f"step; {n_tokens} generated tokens (best beams' tokens + eot) = "
        f"{n_tokens / dec_s:.1f} tokens/s over the beam_search call; {TR_WINDOWS / wall:.3f} "
        f"windows/s ({wall:.3f} s wall, encode + beam_search); max_memory_allocated "
        f"{peak_gb:.2f} GB on {card}; launches {counts}")
    log(f"[transcribe-medium] greedy_decode on the same batch: {g_ms['call']:.1f} ms = prime "
        f"{g_ms['prime']:.2f} ms + decode {g_ms['decode']:.1f} ms in {g_steps} steps = "
        f"{g_ms['decode'] / max(g_steps, 1):.3f} ms a step; launches {g_counts}")
    log(f"[transcribe-medium] first tokens of each best beam: "
        f"{tokens[:, :6].tolist()}; greedy {g_tokens[:, :6].tolist()}")
    if counts != TRANSCRIBE_KERNELS:
        raise AssertionError(f"the beam batch launched {counts}, expected {TRANSCRIBE_KERNELS}")
    if g_counts:
        raise AssertionError(f"greedy decoding of encoded windows launched {g_counts}")
    if tokens.shape != (TR_WINDOWS, TR_MAX_NEW) or g_tokens.shape != tokens.shape:
        raise AssertionError("decode output shapes")
    if not (0 < n_steps < TR_MAX_NEW and 0 < g_steps < TR_MAX_NEW):
        raise AssertionError(f"decode ran {n_steps} / {g_steps} steps")

    # one step's logits against the teacher-forced bf16 decoder of the same
    # prefix: the greedy tokens fed back through the cache
    with torch.no_grad():
        n_fed = 5
        cache = init_decode_cache(model, wcfg, xa, prompt.shape[1], n_fed + 1)
        _, _, cache = prime_decode_cache(model, wcfg, prompt, cache)
        for i in range(n_fed + 1):
            step_logits, cache = decode_step(model, wcfg, g_tokens[:, i: i + 1], cache)
        full = model.decoder_logits(torch.cat([prompt, g_tokens[:, : n_fed + 1]], 1), xa)
        ref = full[:, -1].double()
        rel = ((step_logits.double() - ref).norm() / ref.norm()).item()
    log(f"[transcribe-medium] decode step {n_fed + 1} logits vs teacher-forced bf16 "
        f"decoder_logits: rel_l2 {rel:.3e} (bound 3e-2)")
    if not rel <= 3e-2:
        raise AssertionError("the KV-cached step disagrees with the teacher-forced decoder")

    if trace is None:
        log("[transcribe-trace] not measured: the profiler recorded no device activity")
    else:
        busy, by_name = trace
        n_kernels = sum(n for _, n in by_name.values())
        log(f"[transcribe-trace] prime + {n_traced} beam steps (8 x 5 rows): device busy "
            f"{busy:.2f} ms of {traced_wall:.2f} ms wall untraced, idle share "
            f"{1 - busy / traced_wall:.3f}; {n_kernels} device kernels and copies; top device "
            f"ops (ms, count):")
        for name, (ms_, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
            log(f"[transcribe-trace]   {ms_:9.3f} {n:6d}  {name[:110]}")
    del model, xa
    return counts


def phase_transcribe_cli(dev, tmp):
    """(c): the transcript CLI on whisper-tiny (random weights, a synthetic
    byte-level ranks file), then the evaluation CLI on its output."""
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS

    model_dir = os.path.join(tmp, "tiny_model")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "args.json"), "w") as f:
        json.dump({"whisper_model": "tiny"}, f)
    with open(os.path.join(model_dir, "model_args.json"), "w") as f:
        json.dump({"output_dim": 403}, f)
    model = AlignModel(AlignModelConfig(whisper=WHISPER_CONFIGS["tiny"], hidden_dim=384,
                                        output_dim=403))
    init_weights(model, torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), os.path.join(model_dir, "best_model.pt"))
    ranks = _write_ranks(tmp)
    requests = _write_requests(tmp, TR_SECONDS, seed=5)
    data = os.path.join(tmp, "transcribe.json")
    with open(data, "w", encoding="utf-8") as f:
        json.dump([{"song_path": p, "lyric": t} for p, t in requests], f, ensure_ascii=False)
    out = os.path.join(tmp, "transcript", "result.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    cmds = [
        [sys.executable, "-m", "lyricalignment_tpu_torch.cli.inference_transcript", "-f", data,
         "--model-dir", model_dir, "-o", out, "--whisper-bpe", ranks, "--use-groundtruth",
         "--bf16", "--fast-gelu", "--max-new-tokens", "48", "--device", dev.type],
        [sys.executable, "-m", "lyricalignment_tpu_torch.cli.evaluate_transcript", "-f", out],
    ]
    for cmd in cmds:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=600)
        log(f"[transcribe-cli] {cmd[2]} ... exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        for line in (proc.stdout + proc.stderr).strip().splitlines()[-10:]:
            log(f"[transcribe-cli]   {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{cmd[2]} failed")
    with open(out, encoding="utf-8") as f:
        results = json.load(f)
    if len(results) != len(requests) or not all("inference" in r for r in results):
        raise AssertionError("the transcript CLI wrote no result for every record")
    if "PER:" not in proc.stdout or "CER:" not in proc.stdout:
        raise AssertionError("the evaluation CLI printed no CER and PER")


# ---------------------------------------------------------------------------
# Phase 8: checkpoint interop and the JSONL service at whisper-medium
# ---------------------------------------------------------------------------

SERVE_ALIGN = (8.0, 11.5, 14.2, 17.3, 21.0, 24.6, 29.4, 45.0)
SERVE_STEREO = (1, 4, 7)             # 44.1 kHz stereo: the native resampler runs
SERVE_TRANSCRIBE = (9.0, 17.5, 26.0)
SERVE_MAX_NEW = 8


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _write_vocab(path, vocab):
    """``vocab`` (token -> id, ids 0..n-1) as a bert vocab.txt, a token a
    line in id order, for ``--bert-vocab``."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tok for tok, _ in sorted(vocab.items(), key=lambda kv: kv[1])))


def phase_serve(dev, card, tmp):
    """Phase 8 (see the module docstring). Returns the serve run's launch
    counts by kernel."""
    import contextlib
    import io
    import shutil

    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.cli import convert_checkpoint, serve
    from lyricalignment_tpu_torch.data import native_loader
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
    from lyricalignment_tpu_torch.train.checkpoints import export_reference_pt, save_json

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if not native_loader.available():
        raise AssertionError("the native WAV loader did not build (g++)")

    # a whisper-medium model dir with random weights from a seed
    t0 = time.perf_counter()
    src_dir, hf_dir, model_dir = (os.path.join(tmp, d) for d in ("source", "hf", "model"))
    os.makedirs(src_dir)
    save_json(os.path.join(src_dir, "args.json"), {"whisper_model": "medium", "use_ctc_loss": True})
    save_json(os.path.join(src_dir, "model_args.json"), {"output_dim": C_CTC})
    with torch.device(dev):
        model = AlignModel(AlignModelConfig(whisper=WHISPER_CONFIGS["medium"], hidden_dim=384,
                                            output_dim=C_CTC))
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    source = {k: v.cpu() for k, v in model.whisper_model.state_dict().items()}
    export_reference_pt(model, os.path.join(src_dir, "best_model.pt"))
    del model
    torch.cuda.empty_cache()
    src_bytes = _dir_bytes(src_dir)
    t_src = time.perf_counter() - t0

    # la-convert export-hf, then import-hf into the model dir that is served
    t0 = time.perf_counter()
    convert_checkpoint.main(["export-hf", "--model-dir", src_dir, "--output-dir", hf_dir])
    t_export = time.perf_counter() - t0
    hf_bytes = _dir_bytes(hf_dir)
    shutil.rmtree(src_dir)
    t0 = time.perf_counter()
    convert_checkpoint.main(["import-hf", "--hf-dir", hf_dir, "--output-dir", model_dir,
                             "--use-ctc-loss", "--seed", "1"])
    t_import = time.perf_counter() - t0
    model_bytes = _dir_bytes(model_dir)
    shutil.rmtree(hf_dir)
    with open(os.path.join(model_dir, "args.json")) as f:
        if json.load(f)["whisper_model"] != "medium":
            raise AssertionError("import-hf did not recognise whisper-medium")
    imported = torch.load(os.path.join(model_dir, "best_model.pt"), map_location="cpu",
                          weights_only=True)
    differ = [k for k, v in source.items() if not torch.equal(imported[f"whisper_model.{k}"], v)]
    del imported
    log(f"[serve] whisper-medium model dir written in {t_src:.1f} s ({src_bytes / 1e9:.3f} GB); "
        f"la-convert export-hf {t_export:.1f} s -> {hf_bytes / 1e9:.3f} GB, import-hf "
        f"{t_import:.1f} s -> {model_bytes / 1e9:.3f} GB; imported backbone bit-equal to the "
        f"source: {not differ} ({len(source) - len(differ)} of {len(source)} tensors)")
    if differ:
        raise AssertionError(f"import-hf changed the backbone: {differ[:4]}")

    # the service, loaded as serve.main loads it
    vocab, _ = _vocab_and_table()
    vocab_path = os.path.join(tmp, "vocab.txt")
    _write_vocab(vocab_path, vocab)
    args = serve.parse_args([
        "--model-dir", model_dir, "--use-ctc-loss", "--bert-vocab", vocab_path, "--bf16",
        "--max-batch", "8", "--batch-window-ms", "2000", "--max-new-tokens",
        str(SERVE_MAX_NEW), "--device", dev.type])
    t0 = time.perf_counter()
    aligner = serve.load_aligner(args)
    t_load = time.perf_counter() - t0
    resident = aligner.model.whisper_model.state_dict()
    if not all(torch.equal(v.cpu(), source[k].to(v.dtype)) for k, v in resident.items()):
        raise AssertionError("the served backbone is not the source's, cast to its dtype")
    del source, resident

    wav_dir = os.path.join(tmp, "wavs")
    os.makedirs(wav_dir)
    align = _write_requests(wav_dir, SERVE_ALIGN, seed=8, stereo=SERVE_STEREO)
    trans_dir = os.path.join(tmp, "transcribe_wavs")
    os.makedirs(trans_dir)
    trans = [p for p, _ in _write_requests(trans_dir, SERVE_TRANSCRIBE, seed=9)]
    bad_wav = os.path.join(tmp, "bad_bits.wav")
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 4)  # PCM of 4 bits: no such width
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 32) + bytes(32))
    with open(bad_wav, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    # first batch: the 8 alignments; second: 3 transcriptions, the bad WAV,
    # a bad line and two more alignments
    reqs = [{"song_path": p, "lyric": t, "id": f"a{i}"} for i, (p, t) in enumerate(align)]
    reqs += [{"song_path": p, "task": "transcribe", "id": f"t{i}"} for i, p in enumerate(trans)]
    extra = [(align[0][0], align[2][1]), (align[5][0], align[3][1])]
    reqs += [{"song_path": bad_wav, "lyric": align[1][1], "id": "bad-wav"}, "{not json",
             {"song_path": extra[0][0], "lyric": extra[0][1], "id": "a8"},
             {"song_path": extra[1][0], "lyric": extra[1][1], "id": "a9"}]
    stream = "".join((json.dumps(r, ensure_ascii=False) if isinstance(r, dict) else r) + "\n"
                     for r in reqs)

    calls = []  # (requests, raised) of every align_many the service makes
    real_align_many = aligner.align_many

    def spy(requests):
        try:
            out = real_align_many(requests)
        except Exception:
            calls.append((list(requests), True))
            raise
        calls.append((list(requests), False))
        return out

    aligner.align_many = spy
    stdout, stderr = io.StringIO(), io.StringIO()
    aligner.align_many(align[:1])  # first-use allocations outside the window
    calls.clear()
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(stderr):
        serve.serve(aligner, args, stdin=io.StringIO(stream), stdout=stdout)
    sync()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    aligner.align_many = real_align_many

    out = [json.loads(line) for line in stdout.getvalue().splitlines()]
    by_id = {r.get("id"): r for r in out}
    errors = {r.get("id"): r["error"] for r in out if "error" in r}
    answered = [r for r in out if "error" not in r]
    seconds = (sum(SERVE_ALIGN) + sum(SERVE_TRANSCRIBE) + SERVE_ALIGN[0] + SERVE_ALIGN[5])
    log(f"[serve] serve() answered {len(answered)} of {len(out)} lines ({seconds:.1f} s of audio "
        f"in the well-formed requests) in {wall:.3f} s on {card} (model dir loaded in "
        f"{t_load:.1f} s); align_many calls (requests, raised): "
        f"{[(len(r), e) for r, e in calls]}; launches {counts}")
    log(f"[serve] errors {errors}; service stderr: {stderr.getvalue().strip()[:300]!r}")
    for r in out:
        if "inference" in r:
            log(f"[serve]   {r['id']}: {r['inference'][:60]!r}")

    if len(out) != len(reqs) or set(errors) != {"bad-wav", None}:
        raise AssertionError(f"a well-formed request got an error, or a bad one did not: {errors}")
    # the first call is the fused batch of 8; a call raises iff it holds
    # the bad WAV (its batch of 3, then its retry alone)
    if calls[0] != (align, False) or sum(raised for _, raised in calls) != 2 or any(
            raised != any(p == bad_wav for p, _ in r) for r, raised in calls):
        raise AssertionError(f"the batch with no bad request fell back, or the one with it "
                             f"did not: {[(len(r), e) for r, e in calls]}")
    if stderr.getvalue().count("batched alignment failed") != 1 or \
            "batched transcription failed" in stderr.getvalue():
        raise AssertionError("the service retried a batch with no bad request")
    # the served alignments against align_many on the same requests
    want = real_align_many(align)
    for i in range(len(align)):
        if by_id[f"a{i}"]["alignment"] != want[i]:
            raise AssertionError(f"served alignment a{i} differs from align_many's")
    for i, (p, t) in zip((8, 9), extra):
        if by_id[f"a{i}"]["alignment"] != real_align_many([(p, t)])[0]:
            raise AssertionError(f"served alignment a{i} differs from align_many's")
    _check_segments(want, align, SERVE_ALIGN)
    texts = aligner.transcribe_many(trans, beam_size=args.beam_size, max_new_tokens=SERVE_MAX_NEW,
                                    batch_size=min(8, args.max_batch))
    if [by_id[f"t{i}"]["inference"] for i in range(len(trans))] != texts:
        raise AssertionError("served transcriptions differ from transcribe_many's")
    for name in SERVING_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the service")
    del aligner
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 9: scale-out (parallel/mesh.py) on the one card
# ---------------------------------------------------------------------------

MESH_B = 16                  # the alignment batch of parts (a) and (b): 16 x 30 s
MESH_SPAWN_TIMEOUT = 420     # seconds for both ranks of parts (b) and (c)


def _medium_align_model(dev, seed=0, compute_dtype=None):
    """whisper-medium AlignModel for inference: bf16-resident, tanh GELU,
    the CTC head of 21129 classes, random weights from ``seed`` (the same
    on every process) with the head's fc scaled up (sharp emissions: few
    near-ties), the key-bias route off as under any mesh. ``compute_dtype``
    float32: the same bf16-rounded weights computed in float32."""
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, bf16_resident

    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True)
    with torch.device(dev):
        model = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=C_CTC))
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    with torch.no_grad():
        model.align_rnn.fc.weight.mul_(8.0)
    bf16_resident(model.whisper_model)
    if compute_dtype is not None:
        f32 = AlignModel(dataclasses.replace(model.cfg, whisper=dataclasses.replace(
            wcfg, compute_dtype=compute_dtype))).to(dev)
        f32.load_state_dict(model.state_dict())
        model = f32
    return model.eval()


def _mesh_tiny_model(dev):
    """A float32 model with 2 heads of 64 (one a rank under --mesh-model 2),
    sharp emissions, random weights from a fixed seed."""
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WhisperConfig

    wcfg = WhisperConfig(n_vocab=64, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                         n_text_ctx=16, n_text_state=128, n_text_head=2, n_text_layer=1)
    with torch.device(dev):
        model = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=32, output_dim=C_CTC))
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(11))
    with torch.no_grad():
        model.align_rnn.fc.weight.mul_(8.0)  # sharp emissions: no near-ties
    return model.eval()


def _mesh_train_setup(dev):
    """Part (c)'s whisper-tiny train step: float32, dropout drawn, two
    micro-batches of 2 whose align and transcript samples fall on different
    data ranks."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
    from lyricalignment_tpu_torch.train.trainer import TrainConfig

    cfg = AlignModelConfig(whisper=WHISPER_CONFIGS["tiny"], hidden_dim=384, output_dim=421,
                           train_transcript=True)
    with torch.device(dev):
        model = AlignModel(cfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(5))
    tcfg = TrainConfig(accum_grad_steps=2, use_ctc=True, vocab_size=420, warmup_steps=0,
                       total_steps=10, head_lr=5e-3, backbone_lr=1e-3)
    stacked = _train_batch(np.random.default_rng(8), 2, 2, WHISPER_CONFIGS["tiny"].n_vocab,
                           400, dec_len=12)
    stacked["has_alignment"][0, 1] = stacked["has_alignment"][1, 0] = False
    return model, tcfg, stacked


def _mesh_args(**mesh):
    import types

    return types.SimpleNamespace(use_ctc_loss=True, is_mixture=0, bucket_seconds=5.0,
                                 max_label_len=L_BENCH, batch_size=MESH_B, **mesh)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_inputs(tmp, dev):
    """The 16 x 30 s WAV records (written once by the parent) and a fixed
    mel batch for the encoder checks."""
    import torch

    from lyricalignment_tpu_torch.data.records import Record
    from lyricalignment_tpu_torch.ops.mel import log_mel

    with open(os.path.join(tmp, "mesh_requests.json"), encoding="utf-8") as f:
        requests = json.load(f)
    records = [Record(audio_path=p, text=lyric) for p, lyric in requests]
    g = torch.Generator(device=dev).manual_seed(21)
    mel = log_mel(torch.randn(MESH_B, SECONDS * 16000, device=dev, generator=g) * 0.1)
    return records, mel


def _align(model, records, **mesh):
    """``cli.inference_alignment.align_records`` on ``records`` (each
    kernel's launches counted from zero): (segments, launches, wall s)."""
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.cli.inference_alignment import align_records
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    vocab, table = _vocab_and_table()
    bert = BertWordPieceTokenizer(vocab=vocab)
    dev = next(model.parameters()).device
    _sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    segs = [s for _, s in align_records(records, model, table, bert, _mesh_args(**mesh))]
    _sync(dev)
    return segs, dict(kernels.launches), time.perf_counter() - t0


def _check_pairs(segments, records):
    """Each record's [onset, offset] pairs: one a character, finite, ordered
    and inside the 30 s window."""
    for record, segs in zip(records, segments):
        assert len(segs) == len(record.text), (record.audio_path, len(segs))
        prev = 0.0
        for on, off in segs:
            assert math.isfinite(on) and prev - 1e-9 <= on < off <= SECONDS + 0.04, (on, off)
            prev = off


def _frame_flips(a, b):
    """(positions whose onset or offset differs, the largest difference in s)."""
    flips, worst = 0, 0.0
    for x, y in zip(a, b):
        for (s0, e0), (s1, e1) in zip(x, y):
            flips += (s0 != s1) + (e0 != e1)
            worst = max(worst, abs(s0 - s1), abs(e0 - e1))
    return flips, worst


def _within_frame(a, b):
    """The share of onsets and offsets of ``a`` within one 20 ms frame of
    ``b``'s."""
    pairs = [(u, v) for x, y in zip(a, b) for p, q in zip(x, y) for u, v in zip(p, q)]
    return sum(abs(u - v) <= 0.02 + 1e-9 for u, v in pairs) / len(pairs)


def _train_once(model, tcfg, stacked, mesh=None, encode_fn=None, decode_fn=None):
    """One make_train_step: (losses, launches, the parameters after)."""
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.train.trainer import init_train_state, make_train_step

    state, tx = init_train_state(model, tcfg)
    dev = next(model.parameters()).device
    _sync(dev)
    kernels.reset_launch_counts()
    _, losses = make_train_step(tcfg, tx, mesh, encode_fn, decode_fn)(state, stacked, 3)
    _sync(dev)
    return ({k: float(v) for k, v in losses.items()}, dict(kernels.launches),
            {n: p.detach().clone() for n, p in model.named_parameters()})


def phase_mesh_world_of_one(dev, card, tmp):
    """(a): a world of one over nccl, whisper-medium. The alignment batch of
    16 x 30 s unmeshed, through the CLI's mesh path with --mesh-data 1 (data
    rows, the segment gather; equal bit for bit), and tensor-parallel on a
    model axis of one (every f / g / gather collective on nccl; bf16 rounds
    the row-parallel sums and biases in another order: within one frame).
    Then one bf16 train step at bench_train's micro-batch unmeshed and over
    the world-of-one mesh (global counts and the gradient all-reduce on
    nccl): equal losses and parameters, bit for bit. Returns the unmeshed
    segments and encoder output, which part (b) is held to."""
    import torch
    import torch.distributed as dist

    from lyricalignment_tpu_torch.cli.common import init_distributed
    from lyricalignment_tpu_torch.models.align_model import AlignModel
    from lyricalignment_tpu_torch.models.whisper import bf16_resident
    from lyricalignment_tpu_torch.parallel.mesh import make_mesh, shard_align_params

    t0 = time.perf_counter()
    init_distributed(dev.type)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != backend or dist.get_world_size() != 1:
        raise AssertionError(f"part (a) runs a world of one over {backend}, got "
                             f"{dist.get_backend()} x {dist.get_world_size()}")
    records, mel = _mesh_inputs(tmp, dev)
    base = _medium_align_model(dev)
    weights = {k: v.clone() for k, v in base.state_dict().items()}
    expected = {"la_log10_mel": 1, "la_bias_attention": base.cfg.whisper.n_audio_layer,
                "la_row_lse": 1, "la_viterbi": 1}
    _align(base, records[:2])  # first-use allocations outside the comparison
    runs = {}
    for name in ("unmeshed", "data1", "tp1"):
        model = base
        if name != "unmeshed":
            model = AlignModel(base.cfg).to(dev).eval()
            model.load_state_dict(weights)
            bf16_resident(model.whisper_model)
        if name == "tp1":
            shard_align_params(model, make_mesh(1, 1, dev.type), tp=True)
        with torch.inference_mode():
            enc = model.whisper_model.embed_audio(mel)
        segs, counts, wall = _align(model, records, **({} if name == "unmeshed" else
                                                        {"mesh_data": 1}))
        runs[name] = (segs, enc, counts, wall)
        if counts != expected:
            raise AssertionError(f"(a) {name}: launches {counts}, expected {expected}")
        del model
    (u_segs, u_enc, _, u_wall), (d_segs, d_enc, _, d_wall), (t_segs, t_enc, _, t_wall) = (
        runs["unmeshed"], runs["data1"], runs["tp1"])
    _check_pairs(u_segs, records)
    t_flips, t_worst = _frame_flips(t_segs, u_segs)
    t_rel = rel_l2(t_enc, u_enc)
    log(f"[mesh-a] world of one over {backend}, whisper-medium bf16, B={MESH_B} x {SECONDS} s: "
        f"align_records unmeshed {u_wall:.3f} s, --mesh-data 1 {d_wall:.3f} s (segments "
        f"equal: {d_segs == u_segs}; encoder equal: {bool(torch.equal(d_enc, u_enc))}), "
        f"tensor-parallel on a model axis of 1 {t_wall:.3f} s (encoder rel-L2 {t_rel:.2e}, "
        f"<= 5e-3; {t_flips} onsets/offsets moved, at most {t_worst:.3f} s, <= 0.02); "
        f"launches a batch {expected}")
    if d_segs != u_segs or not torch.equal(d_enc, u_enc):
        raise AssertionError("(a) --mesh-data 1 differs from the unmeshed run")
    if t_rel > 5e-3 or t_worst > 0.02 + 1e-9:
        raise AssertionError("(a) the tensor-parallel path differs beyond bf16 rounding")
    del base, weights, runs
    torch.cuda.empty_cache()

    # one bf16 train step at bench_train's micro-batch (2 x 30 s)
    model, tcfg, stacked = _medium_train_setup(dev)
    wcfg = model.cfg.whisper
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    _train_once(model, tcfg, stacked)  # warm-up: first-use allocations
    model.load_state_dict(weights)
    t1 = time.perf_counter()
    u_loss, u_counts, u_after = _train_once(model, tcfg, stacked)
    u_ms = (time.perf_counter() - t1) * 1e3
    model.load_state_dict(weights)
    mesh = make_mesh(1, 1, dev.type)
    shard_align_params(model, mesh, tp=False)
    t1 = time.perf_counter()
    m_loss, m_counts, m_after = _train_once(model, tcfg, stacked, mesh)
    m_ms = (time.perf_counter() - t1) * 1e3
    same = all(torch.equal(m_after[n], u_after[n]) for n in u_after)
    n_layer = wcfg.n_audio_layer
    expected = {"la_log10_mel": 1, "la_attention_fwd": n_layer, "la_attention_dkdv": n_layer,
                "la_attention_dq": n_layer}
    log(f"[mesh-a] train step whisper-medium bf16, 1 x {TRAIN_B} x {SECONDS} s: unmeshed "
        f"{u_ms:.1f} ms, over the world-of-one mesh {m_ms:.1f} ms (losses equal: "
        f"{m_loss == u_loss}, parameters equal: {same}); losses {json.dumps(u_loss)}; "
        f"launches {m_counts}")
    if m_loss != u_loss or not same:
        raise AssertionError("(a) the meshed train step differs from the unmeshed one")
    if m_counts != expected or u_counts != expected:
        raise AssertionError(f"(a) train launches {m_counts}, expected {expected}")
    del model, weights, u_after, m_after
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"[mesh-a] part (a) passed in {time.perf_counter() - t0:.1f} s on {card}")
    return u_segs, u_enc


def _mesh_rank(rank, tmp, device_type):
    """One of part (b) and (c)'s two processes on the card, over gloo;
    writes ``mesh_rank{rank}.json``."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=rank, world_size=2)
    try:
        from lyricalignment_tpu_torch import kernels
        from lyricalignment_tpu_torch.parallel.mesh import make_mesh, shard_align_params

        if dev.type == "cuda":
            kernels.library()
        out = {}
        # (b): whisper-medium alignment tensor-parallel over the two ranks
        t0 = time.perf_counter()
        records, mel = _mesh_inputs(tmp, dev)
        model = _medium_align_model(dev)
        mesh = make_mesh(1, 2, dev.type)
        shard_align_params(model, mesh, tp=True)
        out["heads"] = model.whisper_model.encoder.blocks[0].attn.n_head
        _align(model, records[:2], mesh_model=2)  # first-use allocations
        segs, out["b_counts"], out["b_wall"] = _align(model, records, mesh_model=2)
        with torch.inference_mode():
            enc = model.whisper_model.embed_audio(mel)
        torch.save(enc.cpu(), os.path.join(tmp, f"mesh_enc_rank{rank}.pt"))
        out["b_segs"] = segs
        del model, enc
        tiny = _mesh_tiny_model(dev)
        shard_align_params(tiny, mesh, tp=True)
        out["tiny_segs"], out["tiny_counts"], _ = _align(tiny, records, mesh_model=2)
        out["b_seconds"] = time.perf_counter() - t0
        del tiny
        torch.cuda.empty_cache()
        # (c): whisper-tiny train step data-parallel over the two ranks
        t0 = time.perf_counter()
        model, tcfg, stacked = _mesh_train_setup(dev)
        shard_align_params(model, make_mesh(2, 1, dev.type), tp=False)
        out["c_losses"], out["c_counts"], _ = _train_once(model, tcfg, stacked,
                                                           model.mesh)
        out["c_seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _spawn_ranks(target, tmp, dev, name):
    """Two processes of ``target(rank, tmp, device_type)`` (spawned after the
    parent freed its models), each of which writes ``{name}_rank{rank}.json``;
    killed if they outlast ``MESH_SPAWN_TIMEOUT``. Returns what they wrote
    and the seconds from spawn to exit."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(target, args=(tmp, dev.type), nprocs=2, join=False,
                             start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_SPAWN_TIMEOUT:
                raise AssertionError(f"the two {name} processes did not end in "
                                     f"{MESH_SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for rank in range(2):
        with open(os.path.join(tmp, f"{name}_rank{rank}.json")) as f:
            outs.append(json.load(f))
    return outs, time.perf_counter() - t0


def _check_shared_card(dev, card, tag):
    """Fail loudly when the card's compute mode lets one process at a time
    use it: two ranks cannot then share it."""
    mode = "no card" if dev.type != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[{tag}] compute mode {mode!r} on {card}")
    if "exclusive" in mode.lower():
        raise AssertionError(f"compute mode {mode}: two processes cannot share the card")


def phase_mesh(dev, card, tmp):
    """Phase 9 (see the module docstring): (a) in this process, then (b)
    and (c) in two spawned processes that share the card over gloo. Returns
    rank 0's launches of (b) and of (c)."""
    import torch

    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS

    _check_shared_card(dev, card, "mesh")
    requests = _write_requests(tmp, [float(SECONDS)] * MESH_B, seed=9)
    with open(os.path.join(tmp, "mesh_requests.json"), "w", encoding="utf-8") as f:
        json.dump(requests, f)
    u_segs, u_enc = phase_mesh_world_of_one(dev, card, tmp)

    # the single-process references: (b)'s encoder and segments computed in
    # float32 on the same bf16-rounded weights (what bf16 rounding is
    # measured against), (b)'s tiny model, (c)'s train step
    records, mel = _mesh_inputs(tmp, dev)
    model = _medium_align_model(dev, compute_dtype=torch.float32)
    with torch.inference_mode():
        enc32 = model.whisper_model.embed_audio(mel)
    segs32, _, _ = _align(model, records)
    del model, mel
    tiny_segs, _, _ = _align(_mesh_tiny_model(dev), records)
    model, tcfg, stacked = _mesh_train_setup(dev)
    c_ref, _, _ = _train_once(model, tcfg, stacked)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    outs, wall = _spawn_ranks(_mesh_rank, tmp, dev, "mesh")
    medium = WHISPER_CONFIGS["medium"]
    expected = {"la_log10_mel": 1, "la_bias_attention": medium.n_audio_layer, "la_row_lse": 1,
                "la_viterbi": 1}
    base32 = rel_l2(u_enc, enc32)
    base_share = _within_frame(u_segs, segs32)
    for rank, out in enumerate(outs):
        enc = torch.load(os.path.join(tmp, f"mesh_enc_rank{rank}.pt")).to(dev)
        rel16, rel32 = rel_l2(enc, u_enc), rel_l2(enc, enc32)
        share16, share32 = _within_frame(out["b_segs"], u_segs), _within_frame(out["b_segs"], segs32)
        t_flips, t_worst = _frame_flips(out["tiny_segs"], tiny_segs)
        log(f"[mesh-b] rank {rank}: whisper-medium bf16 --mesh-model 2 over gloo, "
            f"{out['heads']} of {medium.n_audio_head} heads a block, B={MESH_B} x {SECONDS} s: "
            f"align_records {out['b_wall']:.3f} s; encoder rel-L2 against float32 on the same "
            f"weights {rel32:.3e} (the single bf16 process's {base32:.3e}; <= 1.1x), against "
            f"the single bf16 process {rel16:.3e}; onsets/offsets within a frame of float32's "
            f"{share32:.4f} (the single bf16 process's {base_share:.4f}; at most 0.01 below), "
            f"of the single bf16 process's {share16:.4f}; tiny float32 model {t_flips} moved, "
            f"at most {t_worst:.2e} s (<= 1e-4); launches {out['b_counts']}; part (b) "
            f"{out['b_seconds']:.1f} s")
        if out["heads"] != medium.n_audio_head // 2 or out["b_counts"] != expected:
            raise AssertionError(f"(b) rank {rank}: {out['heads']} heads, launches "
                                 f"{out['b_counts']}, expected {medium.n_audio_head // 2} "
                                 f"and {expected}")
        if rel32 > 1.1 * base32 or share32 < base_share - 0.01 or t_worst > 1e-4:
            raise AssertionError(f"(b) rank {rank}: tensor parallelism adds error beyond the "
                                 f"bf16 rounding of one process")
        rel = max(abs(out["c_losses"][k] - v) / max(abs(v), 1e-6) for k, v in c_ref.items())
        log(f"[mesh-c] rank {rank}: whisper-tiny train step --mesh-data 2 over gloo, 2 x 2 "
            f"x {SECONDS} s, align and transcript samples on different ranks: losses max "
            f"rel diff {rel:.2e} against the single-process step (<= 1e-4); launches "
            f"{out['c_counts']}; part (c) {out['c_seconds']:.1f} s")
        if rel > 1e-4:
            raise AssertionError(f"(c) rank {rank}: losses {out['c_losses']} against {c_ref}")
        for name in TRAIN_KERNELS:
            if out["c_counts"].get(name, 0) <= 0:
                raise AssertionError(f"(c) rank {rank}: kernel {name} was not launched")
    log(f"[mesh] parts (b) and (c): two processes on {card}, {wall:.1f} s from spawn to exit")
    return outs[0]["b_counts"], outs[0]["c_counts"]


# ---------------------------------------------------------------------------
# Phase 10: pipeline parallelism (parallel/pipeline.py) on the one card
# ---------------------------------------------------------------------------

PIPE_MICRO = 2               # micro-batches of parts (a) and (b), the CLIs' default


def _medium_train_setup(dev):
    """Part (b)'s step and phase "mesh" (a)'s: whisper-medium bf16 (tanh
    GELU, CTC head of 21129 classes, align CE + CTC + transcript CE, bf16
    accumulation and Adam mu) at bench_train's micro-batch of 2 x 30 s, one
    micro-batch a step, a transcript-only sample in it; random weights from
    a seed."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
    from lyricalignment_tpu_torch.train.trainer import TrainConfig

    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=C_CTC, train_transcript=True)
    tcfg = TrainConfig(accum_grad_steps=1, use_ctc=True, vocab_size=C_CTC - 1, warmup_steps=0,
                       total_steps=2000, grad_accum_dtype=torch.bfloat16,
                       adam_mu_dtype=torch.bfloat16)
    stacked = _train_batch(np.random.default_rng(0), 1, TRAIN_B, wcfg.n_vocab, 400)
    stacked["has_alignment"][0, 1] = False
    with torch.device(dev):
        model = AlignModel(cfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    return model, tcfg, stacked


def _block_bytes(model, sides=("encoder", "decoder")):
    """Bytes of the parameters of the whisper blocks of ``sides`` that a
    process holds (a pipelined model's other stages sit on the meta
    device)."""
    return sum(p.numel() * p.element_size() for n, p in model.whisper_model.named_parameters()
               if n.split(".")[0] in sides and n.split(".")[1] == "blocks" and not p.is_meta)


def _peak_reset(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def _pipe_rank(rank, tmp, device_type):
    """One of phase "pipe"'s two processes on the card, over gloo: stage
    ``rank`` of the pipeline; writes ``pipe_rank{rank}.json``."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=rank, world_size=2)
    try:
        from lyricalignment_tpu_torch import kernels
        from lyricalignment_tpu_torch.parallel.mesh import make_mesh, shard_align_params
        from lyricalignment_tpu_torch.parallel.pipeline import (
            make_pipeline_encode_fn,
            make_pipeline_logits_fn,
            pipeline_encode_audio,
            stage_align_params,
        )

        if dev.type == "cuda":
            kernels.library()
        out = {}
        # (a): whisper-medium alignment through the CLI's --mesh-pipe 2 path
        t0 = time.perf_counter()
        records, mel = _mesh_inputs(tmp, dev)
        model = _medium_align_model(dev)
        _align(model, records[:2], mesh_pipe=2)  # stages the model; first-use allocations
        out["block_bytes"] = _block_bytes(model, ("encoder",))
        _peak_reset(dev)
        out["a_segs"], out["a_counts"], out["a_wall"] = _align(model, records, mesh_pipe=2)
        out["a_peak_gb"] = _peak_gb(dev)
        with torch.inference_mode():
            enc = pipeline_encode_audio(model.whisper_model, mel, model.mesh, PIPE_MICRO)
        torch.save(enc.cpu(), os.path.join(tmp, f"pipe_enc_rank{rank}.pt"))
        del model, enc
        tiny = _mesh_tiny_model(dev)
        out["tiny_segs"], _, _ = _align(tiny, records, mesh_pipe=2)
        out["a_seconds"] = time.perf_counter() - t0
        del tiny
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # (b): train steps with both halves staged, the tiny float32 model's
        # then whisper-medium's (a first step, then one timed)
        for name, setup in (("tiny", _mesh_train_setup), ("medium", _medium_train_setup)):
            t0 = time.perf_counter()
            model, tcfg, stacked = setup(dev)
            mesh = make_mesh(1, 2, dev.type)
            shard_align_params(model, mesh, tp=False)
            stage_align_params(model, mesh, ("encoder", "decoder"))
            fns = (make_pipeline_encode_fn(mesh, PIPE_MICRO),
                   make_pipeline_logits_fn(mesh, PIPE_MICRO))
            out[f"{name}_block_bytes"] = _block_bytes(model)
            if name == "tiny":
                state = {k: v.clone() for k, v in model.state_dict().items()}
                _, grads, after = _train_capture(model, tcfg, stacked, mesh, *fns)
                if rank == 0:
                    torch.save((grads, after), os.path.join(tmp, "pipe_tiny_step.pt"))
                model.load_state_dict(state)
            _peak_reset(dev)
            out[f"{name}_losses"], out[f"{name}_counts"], _ = _train_once(
                model, tcfg, stacked, mesh, *fns)
            out[f"{name}_peak_gb"] = _peak_gb(dev)
            t1 = time.perf_counter()
            _train_once(model, tcfg, stacked, mesh, *fns)
            out[f"{name}_step_ms"] = (time.perf_counter() - t1) * 1e3
            out[f"{name}_seconds"] = time.perf_counter() - t0
            del model, stacked
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"pipe_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _train_capture(model, tcfg, stacked, mesh=None, encode_fn=None, decode_fn=None):
    """One make_train_step: (losses, the gradients the optimizer got and the
    parameters after, both full (a pipelined model's gathered from each
    stage) on the host)."""
    import torch

    from lyricalignment_tpu_torch.parallel.mesh import gather_state_dict, gather_tensors
    from lyricalignment_tpu_torch.train.trainer import init_train_state, make_train_step

    state, tx = init_train_state(model, tcfg)
    grads, update = {}, tx.update

    def spy(params, got, opt_state):
        local = {n: torch.empty_like(p) if p.is_meta else
                 (got[n] if got.get(n) is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()}
        grads.update({n: g.cpu() for n, g in gather_tensors(model, local).items()})
        return update(params, got, opt_state)

    tx.update = spy
    _, losses = make_train_step(tcfg, tx, mesh, encode_fn, decode_fn)(state, stacked, 3)
    after = {n: t.cpu() for n, t in gather_state_dict(model).items()}
    return {k: float(v) for k, v in losses.items()}, grads, after


def _micro_batched(n_micro):
    """(encode_fn, decode_fn) of one process that run the whisper blocks on
    ``n_micro`` micro-batches one after another and concatenate them: the
    pipeline's arithmetic without its stages and transport."""
    import torch

    from lyricalignment_tpu_torch.models.whisper import decoder_blocks, encoder_blocks

    def encode_fn(whisper, mel, remat=False):
        enc = whisper.encoder
        return enc(mel, remat=remat, run_blocks=lambda x, remat: torch.cat(
            [encoder_blocks(enc.blocks, enc.cfg, h, remat) for h in x.chunk(n_micro)]))

    def decode_fn(whisper, tokens, audio_features, remat=False):
        dec = whisper.decoder
        return dec(tokens, audio_features, remat=remat, run_blocks=lambda x, xa, remat: torch.cat(
            [decoder_blocks(dec.blocks, h, a, remat)
             for h, a in zip(x.chunk(n_micro), xa.chunk(n_micro))]))

    return encode_fn, decode_fn


def _rel(got, want):
    return max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())


def phase_pipe(dev, card, tmp):
    """Phase 10 (see the module docstring): the single-process references in
    this process, then two spawned processes, the pipeline's two stages,
    sharing the card over gloo. Returns rank 0's launches of (a) and (b)."""
    import torch

    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS

    _check_shared_card(dev, card, "pipe")
    requests = _write_requests(tmp, [float(SECONDS)] * MESH_B, seed=9)
    with open(os.path.join(tmp, "mesh_requests.json"), "w", encoding="utf-8") as f:
        json.dump(requests, f)

    # one process: (a)'s bf16 encoder, segments, peak memory and block bytes,
    # the same in float32 on the bf16-rounded weights, the tiny model's
    # segments; (b)'s single steps, the tiny one also with the pipeline's
    # micro-batches
    records, mel = _mesh_inputs(tmp, dev)
    model = _medium_align_model(dev)
    _align(model, records[:2])
    single_bytes = _block_bytes(model, ("encoder",))
    _peak_reset(dev)
    u_segs, u_counts, u_wall = _align(model, records)
    u_peak = _peak_gb(dev)
    with torch.inference_mode():
        u_enc = model.whisper_model.embed_audio(mel)
    del model
    model = _medium_align_model(dev, compute_dtype=torch.float32)
    with torch.inference_mode():
        enc32 = model.whisper_model.embed_audio(mel)
    segs32, _, _ = _align(model, records)
    del model, mel
    tiny_segs, _, _ = _align(_mesh_tiny_model(dev), records)
    model, tcfg, stacked = _mesh_train_setup(dev)
    tiny_lr = {"align_rnn.": tcfg.head_lr, "whisper_model.": tcfg.backbone_lr}
    tiny_loss, tiny_grads, tiny_after = _train_capture(model, tcfg, stacked)
    model, tcfg, stacked = _mesh_train_setup(dev)
    split_loss, split_grads, split_after = _train_capture(model, tcfg, stacked, None,
                                                          *_micro_batched(PIPE_MICRO))
    model, tcfg, stacked = _medium_train_setup(dev)
    single_train_bytes = _block_bytes(model)
    _peak_reset(dev)
    m_loss, m_counts, _ = _train_once(model, tcfg, stacked)
    m_peak = _peak_gb(dev)
    t1 = time.perf_counter()
    _train_once(model, tcfg, stacked)
    m_ms = (time.perf_counter() - t1) * 1e3
    del model, stacked
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[pipe] one process: whisper-medium bf16 align_records of {MESH_B} x {SECONDS} s "
        f"{u_wall:.3f} s, max_memory_allocated {u_peak:.2f} GB, block parameters "
        f"{single_bytes / 1e6:.1f} MB (encoder); the bf16 train step of {TRAIN_B} x {SECONDS} s "
        f"{m_ms:.1f} ms, max_memory_allocated {m_peak:.2f} GB, block parameters "
        f"{single_train_bytes / 1e6:.1f} MB, losses {json.dumps(m_loss)}")

    outs, wall = _spawn_ranks(_pipe_rank, tmp, dev, "pipe")
    medium = WHISPER_CONFIGS["medium"]
    # each stage runs half the encoder's blocks on each micro-batch
    per_stage = medium.n_audio_layer // 2 * PIPE_MICRO
    expected_a = {"la_log10_mel": 1, "la_bias_attention": per_stage, "la_row_lse": 1,
                  "la_viterbi": 1}
    expected_b = {"la_log10_mel": 1, "la_attention_fwd": per_stage,
                  "la_attention_dkdv": per_stage, "la_attention_dq": per_stage}
    base32 = rel_l2(u_enc, enc32)
    base_share = _within_frame(u_segs, segs32)
    grads, after = torch.load(os.path.join(tmp, "pipe_tiny_step.pt"))
    for rank, out in enumerate(outs):
        enc = torch.load(os.path.join(tmp, f"pipe_enc_rank{rank}.pt")).to(dev)
        equal = bool(torch.equal(enc, u_enc)) and out["a_segs"] == u_segs
        rel16, rel32 = rel_l2(enc, u_enc), rel_l2(enc, enc32)
        share32 = _within_frame(out["a_segs"], segs32)
        t_flips, t_worst = _frame_flips(out["tiny_segs"], tiny_segs)
        log(f"[pipe-a] rank {rank}: whisper-medium bf16 --mesh-pipe 2 over gloo "
            f"(broadcasts over the pair's group), {PIPE_MICRO} micro-batches of {MESH_B // PIPE_MICRO}, "
            f"B={MESH_B} x {SECONDS} s: align_records {out['a_wall']:.3f} s (one process "
            f"{u_wall:.3f}); encoder block parameters {out['block_bytes'] / 1e6:.1f} MB of "
            f"{single_bytes / 1e6:.1f}; max_memory_allocated {out['a_peak_gb']:.2f} GB (one "
            f"process {u_peak:.2f}); encoder and segments equal to one process's: {equal} "
            f"(rel-L2 {rel16:.3e}; against float32 on the same weights {rel32:.3e}, one "
            f"process {base32:.3e}; onsets/offsets within a frame of float32's {share32:.4f}, "
            f"one process {base_share:.4f}); tiny float32 model {t_flips} moved, at most "
            f"{t_worst:.2e} s (<= 1e-4); launches {out['a_counts']}; part (a) "
            f"{out['a_seconds']:.1f} s")
        if out["a_counts"] != expected_a or 2 * out["block_bytes"] != single_bytes:
            raise AssertionError(f"(a) rank {rank}: launches {out['a_counts']} (expected "
                                 f"{expected_a}), block bytes {out['block_bytes']} of "
                                 f"{single_bytes}")
        if not equal and (rel32 > 1.1 * base32 or share32 < base_share - 0.01):
            raise AssertionError(f"(a) rank {rank}: the pipeline adds error beyond the bf16 "
                                 f"rounding of one process")
        if t_worst > 1e-4:
            raise AssertionError(f"(a) rank {rank}: the tiny float32 model's segments moved")
        tiny_rel = _rel(out["tiny_losses"], tiny_loss)
        m_rel = _rel(out["medium_losses"], m_loss)
        log(f"[pipe-b] rank {rank}: train steps with both halves staged, {PIPE_MICRO} "
            f"micro-batches: whisper-medium bf16 {TRAIN_B} x {SECONDS} s: losses max rel diff "
            f"{m_rel:.2e} against one process (<= 1e-3), step {out['medium_step_ms']:.1f} ms "
            f"(one process {m_ms:.1f}), max_memory_allocated {out['medium_peak_gb']:.2f} GB "
            f"(one process {m_peak:.2f}), block parameters "
            f"{out['medium_block_bytes'] / 1e6:.1f} MB of {single_train_bytes / 1e6:.1f}, "
            f"launches {out['medium_counts']}; tiny float32 losses max rel diff "
            f"{tiny_rel:.2e} (<= 1e-5), launches {out['tiny_counts']}; part (b) "
            f"{out['tiny_seconds'] + out['medium_seconds']:.1f} s")
        if out["medium_counts"] != expected_b or out["tiny_counts"].keys() != expected_b.keys():
            raise AssertionError(f"(b) rank {rank}: launches {out['medium_counts']} / "
                                 f"{out['tiny_counts']}, expected {expected_b}")
        if 2 * out["medium_block_bytes"] != single_train_bytes:
            raise AssertionError(f"(b) rank {rank}: block bytes {out['medium_block_bytes']}")
        if m_rel > 1e-3 or tiny_rel > 1e-5:
            raise AssertionError(f"(b) rank {rank}: losses {out['medium_losses']} / "
                                 f"{out['tiny_losses']} against {m_loss} / {tiny_loss}")
    # the tiny float32 step's gradients and updates, held to one process
    # that runs the same micro-batches one after another (the pipeline's
    # arithmetic without its transport). Beside it, how far the micro-batches
    # alone move one process's step (cuBLAS picks its algorithms by the
    # rows), and the pipelined step's distance to the unsplit process: at
    # most 1.1x that, plus 1e-5. Adam's first step is about lr * sign(g): an
    # entry whose gradient is at the level of float32 noise may flip, so the
    # updates are held at 1e-5 where |g| is at least 1e-3 of its tensor's
    # largest, and elsewhere at most 1 in 1000 entries of a tensor may be
    # off by more than 2e-2 of the rate
    grads, after = torch.load(os.path.join(tmp, "pipe_tiny_step.pt"))
    log(f"[pipe-b] tiny float32 step, one process with {PIPE_MICRO} micro-batches against "
        f"unsplit: losses max rel diff {_rel(split_loss, tiny_loss):.2e}")
    failed = []
    for prefix, lr in tiny_lr.items():
        names = [n for n in tiny_grads if n.startswith(prefix)]

        def flat(d):
            return torch.cat([d[n].flatten() for n in names])

        g_split = rel_l2(flat(grads), flat(split_grads))
        g_unsplit, split_unsplit = (rel_l2(flat(grads), flat(tiny_grads)),
                                    rel_l2(flat(split_grads), flat(tiny_grads)))
        firm = {n: split_grads[n].abs() >= 1e-3 * split_grads[n].abs().max() for n in names}
        diff = {n: (after[n] - split_after[n]).abs() for n in names}
        off = sum(int((diff[n][firm[n]] > 1e-5).sum()) for n in names)
        n_firm = sum(int(firm[n].sum()) for n in names)
        share = {n: float((diff[n] > 2e-2 * lr).double().mean()) for n in names}
        worst = max(share, key=share.get)

        def flips(a, b):
            return sum(int(((a[n] - b[n]).abs() > 2e-2 * lr).sum()) for n in names)

        log(f"[pipe-b] tiny float32 step, {prefix[:-1]}: against one process with the same "
            f"micro-batches: gradients rel-L2 {g_split:.2e} (<= 1e-5); {off} of the {n_firm} "
            f"entries with |g| >= 1e-3 of their tensor's largest off by more than 1e-5 (none "
            f"allowed); entries off by more than 2e-2 lr: at most {share[worst]:.2e} of a "
            f"tensor, in {worst} (<= 1e-3). Against the unsplit process: gradients rel-L2 "
            f"{g_unsplit:.2e}, the micro-batched process's {split_unsplit:.2e} (<= 1.1x + "
            f"1e-5); entries off by more than 2e-2 lr {flips(after, tiny_after)}, the "
            f"micro-batched process's {flips(split_after, tiny_after)}")
        if (g_split > 1e-5 or off or share[worst] > 1e-3
                or g_unsplit > 1.1 * split_unsplit + 1e-5):
            failed.append(prefix[:-1])
    if failed:
        raise AssertionError(f"(b) the pipelined tiny step's {failed} gradients or parameters "
                             f"differ from one process's")
    log(f"[pipe] two processes on {card}, {wall:.1f} s from spawn to exit")
    return outs[0]["a_counts"], outs[0]["medium_counts"]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from lyricalignment_tpu_torch import kernels
        from lyricalignment_tpu_torch.cli.common import resolve_device
    except ImportError as exc:
        print(f"chip_smoke: the lyricalignment_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2

    try:
        dev = resolve_device("cuda")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        card = smi[0].strip() if smi else torch.cuda.get_device_name(0)
        log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

        t0 = time.perf_counter()
        kernels.library()
        log(f"[build] kernels {'reused' if kernels.build_info.get('cached') else 'built'} and "
            f"loaded in {time.perf_counter() - t0:.1f} s ({kernels.build_info.get('path')})")
        log(str(kernels.build_info.get("log", "")).strip())

        rows = phase_kernels(dev)
        with tempfile.TemporaryDirectory() as tmp:
            model, counts = phase_serving(dev, tmp)
            phase_tiny_reference(dev, tmp)
            phase_throughput(dev, model, card)
            phase_int8(dev, card, model, tmp)
        del model
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        train_rows = phase_train_kernels(dev)
        fused_rows = phase_train_lse_bwd(dev) + phase_train_ctc(dev)
        torch.cuda.empty_cache()
        phase_train_tiny(dev)
        medium = {}
        train_counts = phase_train_medium(dev, card, medium)
        torch.cuda.empty_cache()
        fused_counts = phase_train_fused(dev, card, medium)
        medium.clear()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_cli(dev, tmp)
        log(f"[train] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            song = phase_transcribe_tiny(dev, tmp)
            transcribe_counts = phase_transcribe_medium(dev, card, tmp)
            torch.cuda.empty_cache()
            phase_transcribe_cli(dev, tmp)
        log(f"[transcribe] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            serve_counts = phase_serve(dev, card, tmp)
        log(f"[serve] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            mesh_tp_counts, mesh_dp_counts = phase_mesh(dev, card, tmp)
        log(f"[mesh] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            pipe_counts, pipe_train_counts = phase_pipe(dev, card, tmp)
        log(f"[pipe] phase passed in {time.perf_counter() - t0:.1f} s")
    except Exception:  # report any failed phase and exit non-zero
        traceback.print_exc()
        return 1

    # launches: each path's own run (serving for the serving kernels, the
    # timed whisper-medium train steps for the training kernels)
    launchers = {"log10_mel": "la_log10_mel", "bias_attention": "la_bias_attention",
                 "row_lse": "la_row_lse", "viterbi": "la_viterbi"}
    for row in rows:
        row["launches"] = counts[launchers[row["name"]]]
    for row in train_rows:
        row["launches"] = train_counts[f"la_{row['name']}"]
        log(f"[kernel] {row['name']}: {row['launches']} launches in {TRAIN_STEPS} train steps, "
            f"{row['launches'] // TRAIN_STEPS} a step")
    # the kernels the fused losses add: their launches in the fused steps of
    # (e)
    for row in fused_rows:
        row["launches"] = fused_counts[f"la_{row['name']}"]
        log(f"[kernel] {row['name']}: {row['launches']} launches in {FUSED_STEPS} fused train "
            f"steps, {row['launches'] // FUSED_STEPS} a step")
    rows += train_rows + fused_rows
    # the transcription path: one whisper-medium batch of 8 windows at beam
    # 5, and the tiny model's 70 s long-form song
    # and the JSONL service's run (phase "serve"), and the fused train
    # steps of (e) (the row LSE forward is on that path too)
    for row in rows:
        launcher = launchers.get(row["name"], f"la_{row['name']}")
        row["fused_train_launches"] = fused_counts.get(launcher, 0)
        row["transcribe_launches"] = transcribe_counts.get(launcher, 0)
        row["longform_song_launches"] = song["song_counts"].get(launcher, 0)
        row["serve_launches"] = serve_counts.get(launcher, 0)
        # each rank's launches in phase "mesh": (b) the alignment batch under
        # --mesh-model 2, (c) the train step under --mesh-data 2
        row["mesh_model2_rank_launches"] = mesh_tp_counts.get(launcher, 0)
        row["mesh_data2_rank_launches"] = mesh_dp_counts.get(launcher, 0)
        # and in phase "pipe": (a) the alignment batch under --mesh-pipe 2,
        # (b) the whisper-medium train step with both halves staged
        row["mesh_pipe2_rank_launches"] = pipe_counts.get(launcher, 0)
        row["mesh_pipe2_train_rank_launches"] = pipe_train_counts.get(launcher, 0)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
