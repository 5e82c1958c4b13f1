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
   runs' equal bits and ptxas' line, and the pair with its backward at feat
   766 (zero-padded to 768 by the wrappers) against the plain versions; for
   the log-mel its share of the bound,
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

   Phase "longform": ``transcribe_longform_batched`` at bench.py's
   long-form operating point (whisper-medium bf16, 12 slots a group, beam
   5, decode group 3, 64 new tokens, the quality gates off) on 36 songs of
   90 s, 34 staged by ``prepare_longform_audio`` and 2 raw, with one group
   and then two (a thread and a CUDA stream each): every song's result
   identical between the two; each arm's audio-s/s, windows/s, the
   device's idle share in a 2 s window (NVML's kernel-busy percentage,
   sampled every 100 ms: a torch.profiler trace started beside the
   groups' threads once ended the process with SIGSEGV, and slowed the
   arm by ~60%) and its launches (the log-mel once a raw song, encoder
   attention once a layer a round); each raw song loaded by the prefetch
   pool while still queued (G = 2).

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
       each rank;
   (d) three spawned processes over gloo, the sequence-parallel encode
       (``encode_audio(sequence_sharding=...)``) of whisper-medium bf16 at B
       = 4 x 1499 frames with both axes uneven (heads 6 / 5 / 5, frames 500
       / 500 / 499): every rank's features equal, their rel-L2 to float32 on
       the same weights at most 1.1x the single bf16 process's, 24
       attention launches a rank, the all-to-alls' bytes printed; a tiny
       float32 model with 2 heads (one rank holds none and launches
       nothing) within 1e-5 of one process.

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

11. phase "orbax", the JAX package's orbax checkpoints read without orbax,
   tensorstore, zstandard, msgpack or ml_dtypes (the phase fails if one is
   imported):
   (a) builds the hand-written zstd decoder (``native/zstd.cpp``) with g++,
       reads the committed tiny full-state dir (``tests/data/torch_orbax``,
       written by ``scripts/torch_orbax_fixtures.py``) through
       ``load_model_dir`` on the card (its state dict bit for bit the JAX
       ``export_reference_pt`` of the same weights) and its train state
       through ``restore_train_state`` (count and step as recorded, the
       bf16 Adam mu bit for bit);
   (b) reads the committed whisper-medium import dir (tiled weights, full
       width and depth) through ``load_model_dir(device="cuda",
       use_bf16=True)``, checks every leaf against the SHA-256 the JAX
       package recorded, and aligns 16 x 30 s with ``align_many`` (the four
       serving kernels launched, every onset and offset finite), equal to
       the same weights reloaded from a ``.pt`` model dir that the phase
       writes with ``export_reference_pt``;
   (c) prints the decoder's MB/s (one thread, the 212 MB token embedding;
       and ``restore_pytree`` of the whole dir on its thread pool), the
       wall time of ``load_model_dir`` for the orbax and the ``.pt`` route
       and of the CPU build of the float32 model that both start with,
       beside the card's name and power limit.

12. phase "large", the large family at full width and depth (random
   weights from a seed; each part's models freed before the next; every
   part logs its launches, asserts their counts, its seconds and its peak
   memory beside the card's name and power limit):
   (a) whisper-large alignment at bench.py's align_large point (bf16, tanh
       GELU, the one-pass encoder, B = 16 x 30 s, 48 labels, CTC head of
       21129 classes, ``viterbi_align_fused``; 1 / 32 / 1 / 1 launches a
       batch) and whisper-medium on the same inputs, each against its
       bf16-rounded weights computed in float32: large's encoder rel-L2 at
       most 2x medium's, its onsets and offsets within a frame of float32's
       at most 0.02 below medium's share, all finite and ordered; the
       audio-s/s of 3 timed batches;
   (b) a large-v3 model dir (128 mel bands, vocabulary 51866) written as
       ``la-convert`` writes one, through ``load_model_dir`` (its CPU build
       timed apart) and ``LyricAligner.align_many`` on the card; then the
       128-band log-mel kernel at B = 16 x 30 s against the plain version in
       float64 (atol 1e-4 within 8 decades of the peak), timed beside its
       bound and ``torch.stft`` + mel;
   (c) large-v3-turbo at bench.py's transcribe point: 16 windows, beam 5, 64
       new tokens, decode group 3, the <|notimestamps|> prompt in the v3
       layout (<|transcribe|> and <|notimestamps|> one above v2's);
       windows/s and ms a step; greedy tokens of 2 windows against float32
       on the same weights (tokens agreeing before the first divergence; a
       KV-cached step's logits within rel-L2 3e-2 of the teacher-forced
       float32 and bf16 decoders);
   (d) the one-card large recipe (bench.py:240-259): freeze + remat, the
       frozen encoder bf16-resident, 8 micro-batches of 2 x 30 s, bf16
       accumulation and Adam mu, unfused losses; a warm-up and 2 timed
       steps: finite losses, the encoder bit-unchanged and without
       optimizer state, every other tensor moved, launches 8 / 256 a step
       (the log-mel; the frozen encoder's attention under no_grad, through
       the launcher that writes no row statistics); then one step with the
       fused losses (their align CE and CTC within 1e-4 of the unfused ones
       on the first micro-batch; the row LSE and its backward 16 a step,
       each reduced CTC kernel 8);
   (e) the same batch unfrozen with remat, one step (launches 8 / 512 / 256
       / 256 of the log-mel, the attention forward (remat runs it again in
       the backward), dK/dV and dQ), held to a step without remat on the
       same weights (losses rtol 1e-5; both peaks printed);
   (f) the train CLI at ``--whisper-model large-v3-turbo --freeze-encoder
       --bf16`` for 2 updates, its ``best_model`` then through the
       alignment CLI (1 / 32 / 1 / 1 launches);
   then la_bias_attention at B x H = 16 x 20 and the training trio at 2 x
   20 (T = 1500, bf16) against their plain versions, timed beside their
   bounds and SDPA.

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
# la_attention_fwd, la_attention_dkdv and la_attention_dq, and runs the
# head's bi-GRU through cuDNN instead of la_gru_recurrence)
SERVING_KERNELS = ("la_log10_mel", "la_bias_attention", "la_gru_recurrence", "la_row_lse",
                   "la_viterbi")
GRU_LAYERS = 2  # la_gru_recurrence launches an alignment batch: one a bi-GRU layer


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


# One cluster of 16 blocks of 384 threads (the GRU kernel's at H = 384)
# timing `steps` rounds of the recurrence kernel's exchange alone: 16
# threads each st.async 16 bytes into one peer's buffer, counted on its
# mbarrier; every thread waits for its own buffer's 256 bytes; one block
# barrier. out[0] = block 0's clock64 cycles for all of them.
_EXCHANGE_PROBE = r"""
#include <cooperative_groups.h>
#include "hopper.cuh"
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(384, 1) exchange_kernel(int steps, long long* out) {
  __shared__ __align__(16) float buf[2][16][4];
  __shared__ __align__(8) uint64_t bars[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const uint32_t tx = 16 * 16;
  if (tid == 0) {
    la::hopper::mbar_init(&bars[0], 1);
    la::hopper::mbar_init(&bars[1], 1);
    la::hopper::fence_barrier_init();
    la::hopper::mbar_arrive_expect_tx(&bars[0], tx);
    la::hopper::mbar_arrive_expect_tx(&bars[1], tx);
  }
  cluster.sync();
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    const int nb = (s & 1) ^ 1;
    if (tid < 16) {
      uint32_t dst, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst)
                   : "r"(la::hopper::smem_u32(&buf[nb][cluster.block_rank()][0])), "r"(tid));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(bar)
                   : "r"(la::hopper::smem_u32(&bars[nb])), "r"(tid));
      const float v = static_cast<float>(s);
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
                   "[%0], {%1, %2, %3, %4}, [%5];" :: "r"(dst), "f"(v), "f"(v), "f"(v), "f"(v),
                   "r"(bar) : "memory");
    }
    const uint32_t addr = la::hopper::smem_u32(&bars[nb]);
    uint32_t done;
    do {
      asm volatile("{\n.reg .pred p;\n"
                   "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done)
                   : "r"(addr), "r"((s >> 1) & 1) : "memory");
    } while (!done);
    if (tid == 0) la::hopper::mbar_arrive_expect_tx(&bars[nb], tx);
    __syncthreads();
  }
  const long long t1 = clock64();
  if (tid == 0 && cluster.block_rank() == 0) out[0] = t1 - t0;
  cluster.sync();
}

extern "C" int exchange_cycles(int steps, long long* out) {
  cudaError_t err = cudaFuncSetAttribute(exchange_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(384);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 16;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, exchange_kernel, steps, out);
}
"""


def gru_exchange_cycles(steps: int = 20000) -> float:
    """SM cycles of one round of the GRU kernel's exchange between the 16
    blocks of a cluster (its chain's floor a step), from ``_EXCHANGE_PROBE``
    built beside the kernel library."""
    import ctypes

    import torch

    from lyricalignment_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src, so = os.path.join(tmp, "exchange_probe.cu"), os.path.join(tmp, "exchange_probe.so")
        with open(src, "w") as f:
            f.write(_EXCHANGE_PROBE)
        subprocess.run([build._nvcc()] + build.ARCH_FLAGS + build.COMMON_FLAGS
                       + ["-I", str(build.CSRC_DIR), "-shared", "-o", so, src],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(so)
        out = torch.zeros(1, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        if lib.exchange_cycles(steps, ctypes.c_void_p(out.data_ptr())) != 0:
            raise AssertionError("the exchange probe did not launch")
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

def _mel_work(padded, n_frames: int, n_mels: int):
    """(operations, bytes) of the least work of the log-mel of ``padded``
    [B, N + 400]: a real FFT of 5/2 N log2 N a frame, the power (3 a bin)
    and the filterbank's nonzero weights; bytes of the padded audio in, the
    weights and the log-mel out."""
    from lyricalignment_tpu_torch import N_FFT
    from lyricalignment_tpu_torch.ops import mel

    nnz = int((mel.mel_filterbank(n_mels=n_mels) != 0).sum())
    batch = padded.shape[0]
    ops = batch * n_frames * (2.5 * N_FFT * math.log2(N_FFT) + 3 * 201 + 2 * nnz)
    return ops, 4 * (padded.numel() + nnz + batch * n_mels * n_frames)


def _stft_mel(audio, n_mels: int):
    """The library route to the same log-mel: ``torch.stft``, the power,
    the filterbank product and the log10 floor, as a callable."""
    import torch

    from lyricalignment_tpu_torch import HOP_LENGTH, N_FFT
    from lyricalignment_tpu_torch.ops import mel

    window = torch.hann_window(N_FFT, periodic=True, device=audio.device)
    fb = torch.from_numpy(mel.mel_filterbank(n_mels=n_mels)).to(audio.device)

    def stft_mel():
        spec = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, center=True,
                          pad_mode="reflect", return_complex=True)[..., :-1]
        return torch.log10(torch.clamp(fb @ spec.abs() ** 2, min=1e-10))
    return stft_mel


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from lyricalignment_tpu_torch import HOP_LENGTH
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
    ops, nbytes = _mel_work(padded, n_frames, n_mels)
    ms = time_ms(lambda: mel.log10_mel(padded, n_frames, n_mels), reps=20)
    stft_ms = time_ms(_stft_mel(audio, n_mels), reps=20)
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

    # a feature width the tensor maps cannot take (766, not a multiple of
    # 4): the wrappers zero-pad h and w to 768, exact; the forward against
    # the plain version, the backward against the plain version in float64
    rows_h, feat = 3000, 766
    h = torch.randn(rows_h, feat, device=dev, generator=g) * 0.5
    w = (torch.rand(C_CTC - 2, feat, device=dev, generator=g) * 2 - 1) / math.sqrt(feat)
    b = (torch.rand(C_CTC - 2, device=dev, generator=g) * 2 - 1) / math.sqrt(feat)
    got = viterbi.row_lse(h, w, b)
    ref = viterbi.row_lse_plain(h, w, b)
    err = (got - ref).abs().max().item()
    gout = torch.randn(rows_h, device=dev, generator=g)
    grads = viterbi.row_lse_bwd(h, w, b, got, gout)
    refs = viterbi.row_lse_bwd_plain(h.double(), w.double(), b.double(), got.double(),
                                     gout.double())
    rels = [rel_l2(x, y) for x, y in zip(grads, refs)]
    log(f"[kernel] row_lse at feat {feat} (zero-padded to 768 by the wrappers), {rows_h} rows "
        f"x {w.shape[0]} columns: max abs err {err:.2e} against the plain version "
        f"(rtol 1e-5 / atol 1e-4); backward dh / dw / db rel-L2 against float64 "
        f"{rels[0]:.2e} / {rels[1]:.2e} / {rels[2]:.2e} (<= 1e-5), shapes "
        f"{[tuple(x.shape) for x in grads]}")
    if not (bool(((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all()) and max(rels) <= 1e-5
            and grads[0].shape == h.shape and grads[1].shape == w.shape):
        raise AssertionError(f"row_lse at feat {feat} disagrees with its plain version")
    del h, w, b, got, ref, gout, grads, refs

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

    # --- kernel 5: one bi-GRU layer's recurrence, the align head's at the
    # serving batch (B = 16, T = 1500, H = 384, input 1024), ragged lengths
    phase_kernels_gru(dev, g, report)
    return rows


def phase_kernels_gru(dev, g, report):
    """la_gru_recurrence against its plain version on the same input
    products (its own float32 sums in another order: 1e-5); cuDNN's packed
    float32 layer (TF32 off, its input product included) as the library
    call; the bound: the live steps' recurrent FLOPs at the CUDA cores' peak
    or the bytes, beside the chain floor of 1500 dependent exchanges."""
    import torch
    import torch.nn.functional as F
    from torch import nn
    from torch.nn.utils.rnn import pack_padded_sequence

    from lyricalignment_tpu_torch.ops import gru

    t, h, n_in = 1500, 384, 1024
    torch.manual_seed(5)
    rnn = nn.GRU(n_in, h, bidirectional=True, batch_first=True).to(dev)
    x = torch.randn(B, t, n_in, device=dev, generator=g)
    lengths = [t, 1, 2, t - 1] + [int(v) for v in torch.linspace(700, t, B - 4)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sfx = ("", "_reverse")
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        gi = F.linear(x, torch.cat([getattr(rnn, f"weight_ih_l0{s}") for s in sfx]),
                      torch.cat([getattr(rnn, f"bias_ih_l0{s}") for s in sfx]))
        w_hh = torch.stack([getattr(rnn, f"weight_hh_l0{s}") for s in sfx]).contiguous()
        b_hh = torch.stack([getattr(rnn, f"bias_hh_l0{s}") for s in sfx]).contiguous()
        got = gru.gru_recurrence(gi, w_hh, b_hh, lens)
        ref = gru.gru_recurrence_plain(gi, w_hh, b_hh, lens)
        err = (got - ref).abs().max().item()
        again = torch.equal(got, gru.gru_recurrence(gi, w_hh, b_hh, lens))
        ms = time_ms(lambda: gru.gru_recurrence(gi, w_hh, b_hh, lens), reps=10)
        plain_ms = time_ms(lambda: gru.gru_recurrence_plain(gi, w_hh, b_hh, lens), reps=1,
                           warmup=0)
        packed = pack_padded_sequence(x, torch.tensor(lengths), batch_first=True,
                                      enforce_sorted=False)
        lib_ms = time_ms(lambda: rnn(packed), reps=5)
    live = sum(lengths)  # each row's steps, in each direction
    flops = 2 * 2 * live * 3 * h * h
    nbytes = 4 * (2 * live * 3 * h + B * t * 2 * h + 2 * (3 * h * h + 3 * h) + B)
    bound_ms, bound_by = bound(flops, PEAK_F32, nbytes)
    cycles = gru_exchange_cycles()
    mhz = sm_clock_mhz()
    floor_ms = t * cycles / (mhz * 1e3)
    plan = gru.gru_plan(B, t, h, 2)
    log(f"[kernel] gru_recurrence B={B} T={t} H={h}: kernel_ms={ms:.4f} "
        f"({ms / t * 1e3:.3f} us a step) plain_ms={plain_ms:.4f} cuDNN packed layer "
        f"{lib_ms:.4f} ms; bound_ms={bound_ms:.4f} ({bound_by}: {flops / 1e9:.1f} GFLOP at "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s); chain floor {floor_ms:.4f} ms ({t} steps x "
        f"{cycles:.0f} cycles of the cluster's exchange at {mhz:.0f} MHz, {2 * t} steps "
        f"{2 * floor_ms:.4f} ms for the head's two layers); plan {plan}; two runs bit-equal: "
        f"{again}; ptxas {ptxas_report('gru.cu', 'gru_kernelILi6ELi3E')}")
    report("gru_recurrence", "lyricalignment_tpu_torch/csrc/gru.cu",
           "none (lyricalignment_tpu/ops/gru.py:36-88 is a lax.scan)", err, "1e-5",
           err <= 1e-5 and again, ms, plain_ms, lib_ms, max(bound_ms, floor_ms),
           f"{bound_by} {bound_ms:.4f}, chain floor {floor_ms:.4f}")


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
    spans = _trace_spans(prof)
    if not spans:
        return None
    return _busy_ms(spans), _by_name(spans)


def _trace_spans(prof):
    """(start us, end us, name) of each device kernel, copy and memset of a
    finished profile, in start order, from the profiler's own events: the
    same spans as its chrome trace, whose JSON took ~4x as long to write
    and read (on an H100, 0.76 s against 0.20 s for the 12,804 spans of a
    whisper-medium alignment batch)."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())


def _busy_ms(spans) -> float:
    """The union of the spans' intervals (streams may overlap), in ms."""
    busy_us, end_us = 0.0, -math.inf
    for t0, t1, _ in spans:
        busy_us += max(0.0, t1 - max(t0, end_us))
        end_us = max(end_us, t1)
    return busy_us / 1e3


def _by_name(spans) -> dict:
    by_name = {}
    for t0, t1, name in spans:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t1 - t0) / 1e3, n + 1)
    return by_name


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
                 "la_gru_recurrence": GRU_LAYERS, "la_row_lse": 1, "la_viterbi": 1}
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


def _train_attention_work(b, t, h, d=64):
    """{kernel: (operations, peak rate, bytes)} of the three training
    attention kernels on bf16 [B, T, H, d]: the forward's two T x T x d
    products, dK/dV's four and dQ's three; each bf16 tensor and float32 row
    statistic it reads or writes once."""
    product = 2 * b * h * t * t * d   # one T x T x d product
    tensor = 2 * b * t * h * d        # one bf16 [B, T, H, d] tensor
    stats = 4 * b * h * t             # one f32 [B, H, T] row statistic
    return {"attention_fwd": (2 * product, PEAK_BF16, 4 * tensor + stats),
            "attention_dkdv": (4 * product, PEAK_BF16, 6 * tensor + 2 * stats),
            "attention_dq": (3 * product, PEAK_BF16, 5 * tensor + 2 * stats)}


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

    work = _train_attention_work(b, t, h)
    rows = []
    for name, ms, plain_ms, lib_ms, replaces in (
            ("attention_fwd", fwd_ms, plain_fwd_ms, sdpa_fwd_ms,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:758 "
             "_flash_attention_kernel)"),
            ("attention_dkdv", dkdv_ms, plain_bwd_ms, sdpa_bwd_ms,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:1121 "
             "_flash_attention_dkv_kernel)"),
            ("attention_dq", dq_ms, plain_bwd_ms, sdpa_bwd_ms,
             "lyricalignment_tpu/ops/attention.py:47 (library flash_attention.py:1456 "
             "_flash_attention_dq_kernel)")):
        bound_ms, bound_by = bound(*work[name])
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
            report_rate(name, ms, work[name][0], bound_ms, lib_ms, src, "ILb0ELb1E",
                        "SDPA forward")
        else:
            report_rate(name, ms, work[name][0], bound_ms, lib_ms, src,
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
        # the align head's recurrence with grad enabled: cuDNN/cuBLAS kernels
        # per time step (without grad it is la_gru_recurrence, one a layer)
        gru = sum(n for name, (_, n) in by_name.items()
                  if "RNN" in name or "GRU" in name or "gemmSN" in name)
        log(f"[train-trace] one step: device busy {busy:.1f} ms of the {mean_s * 1e3:.1f} ms "
            f"mean step, idle share {1 - busy / (mean_s * 1e3):.3f}; {n_kernels} device "
            f"kernels and copies, {gru} of them the training GRU's per-time-step cuDNN "
            f"kernels; top device kernels (ms, count):")
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
# Phase "longform": the batched long-form loop's overlap groups and prefetch
# ---------------------------------------------------------------------------

# bench.py's long-form operating point (bench_longform): whisper-medium
# bf16, beam 5, 12 slots a group, decode group 3, 64 new tokens, 90 s songs,
# the quality gates off
LF_SECONDS, LF_BATCH, LF_DECODE_GROUP, LF_BEAM, LF_MAX_NEW = 90.0, 12, 3, 5, 64
LF_SONGS = 36          # more than G = 2's 24 slots: slots refill, the pool loads ahead
# songs given raw (the rest staged): queued right behind G = 2's 24 slots, so
# group 1's first turn puts them in the prefetch pool
LF_RAW = (24, 25)
LF_TRACE_AT, LF_TRACE_S = 8.0, 2.0   # the sampled window of each arm: start, length (s)


def _nvml_busy(seconds_fn):
    """NVML's ``utilization.gpu`` of card 0 (the percentage of each sample
    period in which a kernel ran), sampled every 100 ms by ``nvidia-smi``
    while ``seconds_fn()`` runs: (mean busy share, samples), or None when
    no sample came. No CUDA call is made here, and nothing is hooked into
    the threads that launch."""
    cmd = ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
           "--format=csv,noheader,nounits", "-lms", "100"]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                text=True)
    except OSError:
        seconds_fn()
        return None
    try:
        seconds_fn()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    samples = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    return (sum(samples) / len(samples) / 100.0, len(samples)) if samples else None


def _lf_arm(run, groups):
    """One arm of phase "longform": ``run(groups)`` in a thread of its own
    while this one samples the device's busy share for ``LF_TRACE_S``
    seconds of it from ``LF_TRACE_AT`` on. (results, wall s, (busy share,
    samples) of the window or None)."""
    import threading

    import torch

    out = {}

    def go():
        try:
            out["results"] = run(groups)
        except BaseException as exc:  # noqa: BLE001 - raised below
            out["error"] = exc

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worker = threading.Thread(target=go)
    worker.start()
    worker.join(LF_TRACE_AT)
    busy = _nvml_busy(lambda: worker.join(LF_TRACE_S)) if worker.is_alive() else None
    worker.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if "error" in out:
        raise out["error"]
    return out["results"], wall, busy


def phase_longform(dev, card, tmp):
    """``transcribe_longform_batched`` at bench.py's long-form operating
    point, ``LF_SONGS`` songs of 90 s (all staged by
    ``prepare_longform_audio`` but ``LF_RAW``), with one group (G = 1) and
    then two (G = 2, a thread and a CUDA stream each) on the same songs:
    (a) every song's text and segments identical between the arms; (b) each
    arm's audio-s/s, the device's idle share in a sampled window, and its
    launches (the log-mel once a raw song, encoder attention once a layer
    a round); (c) each raw song loaded by the prefetch pool: its log-mel
    made while it was still queued, with window decodes between that and
    its slot (G = 2). Returns the G = 2 arm's launches."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.decode import longform
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, bf16_resident
    from lyricalignment_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    t0 = time.perf_counter()
    wcfg = dataclasses.replace(WHISPER_CONFIGS["medium"], compute_dtype=torch.bfloat16,
                               fast_gelu=True, onepass_encoder=True)
    with torch.device(dev):
        align = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=64))
    align.to(dev)
    init_weights(align, torch.Generator(device=dev).manual_seed(0))
    model = bf16_resident(align.whisper_model).eval()
    del align
    tok = WhisperTokenizer(bpe_path=_write_ranks(tmp))
    rng = np.random.default_rng(90)
    audios = [(rng.standard_normal(int(LF_SECONDS * 16000)) * 0.1).astype(np.float32)
              for _ in range(LF_SONGS)]
    songs = [a if i in LF_RAW else longform.prepare_longform_audio(a, wcfg.n_mels, device=dev)
             for i, a in enumerate(audios)]
    torch.cuda.synchronize()
    log(f"[longform] whisper-medium bf16 built and {LF_SONGS - len(LF_RAW)} of {LF_SONGS} "
        f"songs of {LF_SECONDS:.0f} s staged in {time.perf_counter() - t0:.1f} s")

    # the loop's own steps, in the order they ran (any group's thread)
    events = []
    real = {name: getattr(longform, name) for name in
            ("_prep_mel", "_new_song_state", "_window_decode", "_encode",
             "_apply_window_result")}
    raw_ids = {id(songs[i]): i for i in LF_RAW}

    def watch(name, tag):
        def call(*a, **kw):
            if name == "_prep_mel":
                if id(a[0]) in raw_ids:
                    events.append(("load", raw_ids[id(a[0])]))
            else:
                events.append((tag, a[0] if name == "_new_song_state" else None))
            return real[name](*a, **kw)
        return call

    def run(groups):
        return longform.transcribe_longform_batched(
            model, wcfg, songs, tok, batch_size=LF_BATCH, overlap_groups=groups,
            decode_group=LF_DECODE_GROUP, beam_size=LF_BEAM, temperatures=(0.0,),
            max_new_tokens=LF_MAX_NEW, compression_ratio_threshold=1e9,
            logprob_threshold=-1e9, no_speech_threshold=2.0)

    arms = {}
    for name, tag in (("_prep_mel", "load"), ("_new_song_state", "take"),
                      ("_window_decode", "decode"), ("_encode", "encode"),
                      ("_apply_window_result", "window")):
        setattr(longform, name, watch(name, tag))
    try:
        for groups in (1, 2):
            events.clear()
            kernels.reset_launch_counts()
            results, wall, busy = _lf_arm(run, groups)
            counts = dict(kernels.launches)
            arms[groups] = (results, counts, list(events))
            n_enc = sum(kind == "encode" for kind, _ in events)
            n_win = sum(kind == "window" for kind, _ in events)
            idle = ("not measured (no NVML sample)" if busy is None
                    else f"{1 - busy[0]:.3f} (NVML utilization.gpu, mean of {busy[1]} samples "
                         f"every 100 ms over {LF_TRACE_S:.0f} s from {LF_TRACE_AT:.0f} s in)")
            log(f"[longform] G = {groups} x {LF_BATCH} slots, beam {LF_BEAM}, decode group "
                f"{LF_DECODE_GROUP}, {LF_MAX_NEW} new tokens: {LF_SONGS} songs x "
                f"{LF_SECONDS:.0f} s in {wall:.2f} s = "
                f"{LF_SONGS * LF_SECONDS / wall:.1f} audio-s/s; {n_win} windows in {n_enc} "
                f"rounds ({n_win / wall:.2f} windows/s); device idle share {idle}; launches "
                f"{counts} on {card}")
            want = {"la_log10_mel": len(LF_RAW), "la_bias_attention": wcfg.n_audio_layer * n_enc}
            if counts != want:
                raise AssertionError(f"G = {groups}: launches {counts}, expected {want}")
            if len(results) != LF_SONGS or any(not r["segments"] for r in results):
                raise AssertionError(f"G = {groups}: a song has no result or no segment")
            for i in LF_RAW if groups == 2 else ():   # (c): loaded while queued
                kinds = [kind for kind, _ in events]
                load, take = events.index(("load", i)), events.index(("take", i))
                if not (load < take and "decode" in kinds[load:take]):
                    raise AssertionError(f"G = {groups}: raw song {i} did not go through "
                                         f"the prefetch pool")
    finally:
        for name, fn in real.items():
            setattr(longform, name, fn)
    same = [a == b for a, b in zip(arms[1][0], arms[2][0])]
    n_tok = sum(len(s["tokens"]) for r in arms[2][0] for s in r["segments"])
    log(f"[longform] (a) G = 2 against G = 1: {sum(same)} of {LF_SONGS} songs identical "
        f"(text, every segment's times, tokens and scores; {n_tok} tokens in "
        f"{sum(len(r['segments']) for r in arms[2][0])} segments); (c) raw songs {LF_RAW}: "
        f"each loaded once by the prefetch pool while queued")
    if not all(same):
        raise AssertionError(f"G = 2 differs from G = 1 on songs "
                             f"{[i for i, ok in enumerate(same) if not ok]}")
    del model, songs
    torch.cuda.empty_cache()
    return arms[2][1]


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


def _align_model(dev, seed=0, compute_dtype=None, name="medium", onepass=False):
    """A whisper ``name`` (medium unless said) AlignModel for inference:
    bf16-resident, tanh GELU, the CTC head of 21129 classes, random weights
    from ``seed`` (the same on every process) with the head's fc scaled up
    (sharp emissions: few near-ties), the key-bias route off as under any
    mesh unless ``onepass``. ``compute_dtype`` float32: the same
    bf16-rounded weights computed in float32."""
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, bf16_resident

    wcfg = dataclasses.replace(WHISPER_CONFIGS[name], compute_dtype=torch.bfloat16,
                               fast_gelu=True, onepass_encoder=onepass)
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
    base = _align_model(dev)
    weights = {k: v.clone() for k, v in base.state_dict().items()}
    expected = {"la_log10_mel": 1, "la_bias_attention": base.cfg.whisper.n_audio_layer,
                "la_gru_recurrence": GRU_LAYERS, "la_row_lse": 1, "la_viterbi": 1}
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
        model = _align_model(dev)
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


def _spawn_ranks(target, tmp, dev, name, n=2):
    """``n`` processes of ``target(rank, tmp, device_type)`` (spawned after
    the parent freed its models), each of which writes
    ``{name}_rank{rank}.json``; killed if they outlast
    ``MESH_SPAWN_TIMEOUT``. Returns what they wrote and the seconds from
    spawn to exit."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(target, args=(tmp, dev.type), nprocs=n, join=False,
                             start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_SPAWN_TIMEOUT:
                raise AssertionError(f"the {n} {name} processes did not end in "
                                     f"{MESH_SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for rank in range(n):
        with open(os.path.join(tmp, f"{name}_rank{rank}.json")) as f:
            outs.append(json.load(f))
    return outs, time.perf_counter() - t0


# part (d): the sequence-parallel encode over three processes, both axes
# uneven at whisper-medium (16 heads: 6 / 5 / 5; 1499 frames: 500 / 500 /
# 499) and 2 heads of a tiny float32 model (1 / 1 / 0)
MESH_SEQ_RANKS, MESH_SEQ_B, MESH_SEQ_MEL = 3, 4, 2998


def _seq_mel(dev):
    """Part (d)'s input: the log-mel of ``MESH_SEQ_B`` seeded clips of
    ``MESH_SEQ_MEL`` frames (1499 after the stem)."""
    import torch

    from lyricalignment_tpu_torch.ops.mel import log_mel

    g = torch.Generator(device=dev).manual_seed(23)
    return log_mel(torch.randn(MESH_SEQ_B, MESH_SEQ_MEL * 160, device=dev, generator=g) * 0.1)


def _seq_exchange_bytes(b, t, heads, n_layer, m):
    """Bytes the sequence-parallel encode's all-to-alls move between ranks
    (each rank's own chunk stays): 4 a block (q, k, v to heads; the output
    back), each chunk r -> j of B x T_r x H_j x 64 in bf16."""
    from lyricalignment_tpu_torch.parallel.mesh import frame_split, head_split

    runs, hs = frame_split(t, m), head_split(heads, m)
    chunk = sum(b * runs[r] * hs[j] * 64 * 2 for r in range(m) for j in range(m) if r != j)
    return 4 * n_layer * chunk


def _mesh_seq_rank(rank, tmp, device_type):
    """One of part (d)'s three processes on the card, over gloo: the
    sequence-parallel encode of whisper-medium bf16 and of a tiny float32
    model; writes ``seq_rank{rank}.json`` and the encodes."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv_seq", rank=rank,
                            world_size=MESH_SEQ_RANKS)
    try:
        from lyricalignment_tpu_torch import kernels
        from lyricalignment_tpu_torch.models.whisper import encode_audio
        from lyricalignment_tpu_torch.parallel.mesh import make_mesh, sequence_sharding

        if dev.type == "cuda":
            kernels.library()
        seq = sequence_sharding(make_mesh(1, MESH_SEQ_RANKS, dev.type))
        out = {}
        for name, model in (("medium", _align_model(dev).whisper_model),
                            ("tiny", _mesh_tiny_model(dev).whisper_model)):
            with torch.inference_mode():
                encode_audio(model, _seq_mel(dev), sequence_sharding=seq)  # first use
                _sync(dev)
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                enc = encode_audio(model, _seq_mel(dev), sequence_sharding=seq)
                _sync(dev)
            out[f"{name}_wall"] = time.perf_counter() - t0
            out[f"{name}_counts"] = dict(kernels.launches)
            torch.save(enc.cpu(), os.path.join(tmp, f"seq_{name}_rank{rank}.pt"))
            del model, enc
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"seq_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_mesh_sequence(dev, card, tmp):
    """(d): the sequence-parallel encode over ``MESH_SEQ_RANKS`` processes
    sharing the card over gloo (``all_to_all_single`` with uneven splits on
    CUDA tensors), against one process: whisper-medium bf16 within 1.1x the
    single bf16 process's rel-L2 from float32 on the same weights, every
    rank's gathered features equal; the tiny float32 model within 1e-5
    (rel-L2). Returns rank 0's launches of the medium encode."""
    import torch

    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
    from lyricalignment_tpu_torch.parallel.mesh import frame_split, head_split

    refs = {}
    with torch.inference_mode():
        for name, kw in (("bf16", {}), ("f32", {"compute_dtype": torch.float32})):
            model = _align_model(dev, **kw).whisper_model
            model.embed_audio(_seq_mel(dev))   # first use
            _sync(dev)
            t0 = time.perf_counter()
            refs[name] = model.embed_audio(_seq_mel(dev))
            _sync(dev)
            refs[f"{name}_wall"] = time.perf_counter() - t0
            del model
        refs["tiny"] = _mesh_tiny_model(dev).whisper_model.embed_audio(_seq_mel(dev))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    outs, wall = _spawn_ranks(_mesh_seq_rank, tmp, dev, "seq", n=MESH_SEQ_RANKS)
    medium = WHISPER_CONFIGS["medium"]
    t = refs["bf16"].shape[1]
    m = MESH_SEQ_RANKS
    base32 = rel_l2(refs["bf16"], refs["f32"])
    exchange = _seq_exchange_bytes(MESH_SEQ_B, t, medium.n_audio_head, medium.n_audio_layer, m)
    gather = refs["bf16"].numel() * 2
    log(f"[mesh-d] whisper-medium bf16, B = {MESH_SEQ_B} x {MESH_SEQ_MEL} mel frames ({t} "
        f"after the stem) over {m} processes: frames {frame_split(t, m)}, heads "
        f"{head_split(medium.n_audio_head, m)} a rank; the all-to-alls move "
        f"{exchange / 1e6:.1f} MB an encode between ranks ({4 * medium.n_audio_layer} of "
        f"them), the features' gather is an all-reduce of {gather / 1e6:.2f} MB; one "
        f"process: bf16 {refs['bf16_wall'] * 1e3:.1f} ms, float32 "
        f"{refs['f32_wall'] * 1e3:.1f} ms")
    first = None
    for rank, out in enumerate(outs):
        enc = torch.load(os.path.join(tmp, f"seq_medium_rank{rank}.pt")).to(dev)
        tiny = torch.load(os.path.join(tmp, f"seq_tiny_rank{rank}.pt")).to(dev)
        rel32, rel16 = rel_l2(enc, refs["f32"]), rel_l2(enc, refs["bf16"])
        rel_tiny = rel_l2(tiny, refs["tiny"])
        equal = first is None or torch.equal(enc, first)
        first = enc if first is None else first
        log(f"[mesh-d] rank {rank}: encode {out['medium_wall'] * 1e3:.1f} ms over gloo; "
            f"rel-L2 against float32 on the same weights {rel32:.3e} (the single bf16 "
            f"process's {base32:.3e}; <= 1.1x), against the single bf16 process {rel16:.3e}; "
            f"equal to rank 0's: {equal}; launches {out['medium_counts']}; tiny float32 "
            f"model (heads {head_split(2, m)}): rel-L2 {rel_tiny:.2e} against one process "
            f"(<= 1e-5), launches {out['tiny_counts']}")
        want = {"la_log10_mel": 1, "la_bias_attention": medium.n_audio_layer}
        want_tiny = {"la_log10_mel": 1}
        if head_split(2, m)[rank]:
            want_tiny["la_bias_attention"] = 2
        if out["medium_counts"] != want or out["tiny_counts"] != want_tiny:
            raise AssertionError(f"(d) rank {rank}: launches {out['medium_counts']} / "
                                 f"{out['tiny_counts']}, expected {want} / {want_tiny}")
        if rel32 > 1.1 * base32 or rel_tiny > 1e-5 or not equal or enc.shape != refs["bf16"].shape:
            raise AssertionError(f"(d) rank {rank}: the sequence-parallel encode is off")
    log(f"[mesh-d] {m} processes on {card}, {wall:.1f} s from spawn to exit")
    return outs[0]["medium_counts"]


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
    model = _align_model(dev, compute_dtype=torch.float32)
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
    expected = {"la_log10_mel": 1, "la_bias_attention": medium.n_audio_layer,
                "la_gru_recurrence": GRU_LAYERS, "la_row_lse": 1, "la_viterbi": 1}
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
    return outs[0]["b_counts"], outs[0]["c_counts"], phase_mesh_sequence(dev, card, tmp)


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
        model = _align_model(dev)
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
    model = _align_model(dev)
    _align(model, records[:2])
    single_bytes = _block_bytes(model, ("encoder",))
    _peak_reset(dev)
    u_segs, u_counts, u_wall = _align(model, records)
    u_peak = _peak_gb(dev)
    with torch.inference_mode():
        u_enc = model.whisper_model.embed_audio(mel)
    del model
    model = _align_model(dev, compute_dtype=torch.float32)
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
    expected_a = {"la_log10_mel": 1, "la_bias_attention": per_stage,
                  "la_gru_recurrence": GRU_LAYERS, "la_row_lse": 1, "la_viterbi": 1}
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


# ---------------------------------------------------------------------------
# Phase 11: the JAX package's orbax checkpoints, read with no orbax
# ---------------------------------------------------------------------------

ORBAX_DIR = os.path.join(REPO, "tests", "data", "torch_orbax")


def _leaf_sha256(value) -> str:
    import hashlib

    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        value = value.view(torch.int16).numpy()
    return hashlib.sha256(np.ascontiguousarray(value).tobytes()).hexdigest()


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def phase_orbax_tiny(dev):
    """(a) the decoder built with the host's g++; the committed tiny
    full-state dir through ``load_model_dir`` on the card, its state dict
    bit for bit the JAX ``export_reference_pt`` of the same weights; its
    train state through ``restore_train_state``: count and step as
    recorded, the bf16 Adam mu read as bf16, bit for bit the tree's."""
    import io
    import lzma

    import torch

    from lyricalignment_tpu_torch.cli.common import load_model_dir
    from lyricalignment_tpu_torch.data import zstd
    from lyricalignment_tpu_torch.train.checkpoints import restore_pytree, restore_train_state
    from lyricalignment_tpu_torch.train.trainer import TrainConfig, init_train_state

    for name in ("orbax", "tensorstore", "zstandard", "msgpack", "ml_dtypes", "jax"):
        if name in sys.modules:
            raise AssertionError(f"{name} is imported: phase orbax must run without it")
    t0 = time.perf_counter()
    lib = zstd._lib()
    log(f"[orbax-a] zstd decoder built with g++ and loaded in {time.perf_counter() - t0:.2f} s "
        f"({lib._name})")
    tiny = os.path.join(ORBAX_DIR, "tiny")
    with open(os.path.join(ORBAX_DIR, "tiny.json"), encoding="utf-8") as f:
        record = json.load(f)
    _, model, _ = load_model_dir(tiny, device=str(dev))
    with lzma.open(os.path.join(tiny, "best_model.pt.xz")) as f:
        want = torch.load(io.BytesIO(f.read()), weights_only=True)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    assert set(sd) == set(want), sorted(set(sd) ^ set(want))[:5]
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    state, _ = init_train_state(model.train(), TrainConfig(adam_mu_dtype=torch.bfloat16))
    restore_train_state(os.path.join(tiny, "best_model"), state)
    assert state.step == record["step"] and state.opt_state.count == record["count"], \
        (state.step, state.opt_state.count, record["step"], record["count"])
    tree = restore_pytree(os.path.join(tiny, "best_model"))
    mu = tree["opt_state"][1]["inner_states"]["head"]["inner_state"][0]["mu"]["align_head"]
    got = state.opt_state.mu["align_rnn.fc.weight"]
    assert got.dtype == torch.bfloat16 and got.device.type == dev.type
    assert torch.equal(got.cpu(), mu["fc"]["w"].T), "restored Adam mu differs"
    for name, v in _flat_leaves(tree):
        assert _leaf_sha256(v) == record["leaves"][name]["sha256"], name
    log(f"[orbax-a] tiny: state dict equal to the JAX export bit for bit ({len(want)} tensors), "
        f"train state count {state.opt_state.count} step {state.step} (recorded "
        f"{record['count']} / {record['step']}), {len(record['leaves'])} leaves' SHA-256 equal, "
        f"Adam mu {got.dtype} on {got.device}")


def phase_orbax(dev, card, tmp):
    """Phase 11 (see the module docstring): (a) ``phase_orbax_tiny``; (b)
    the committed whisper-medium import dir through ``load_model_dir`` on
    the card in bf16, every leaf against its recorded SHA-256, then
    ``align_many`` of 16 x 30 s with the serving kernels launched, equal to
    the same weights reloaded through a ``.pt`` model dir; (c) the
    decoder's MB/s and both routes' load times. Returns the launches of
    (b)'s orbax batch."""
    import shutil

    import numpy as np
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.cli.common import build_model_config, load_model_dir
    from lyricalignment_tpu_torch.data import zstd
    from lyricalignment_tpu_torch.models.align_model import AlignModel
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer
    from lyricalignment_tpu_torch.train.checkpoints import (
        export_reference_pt,
        load_json,
        params_state_dict,
    )
    from lyricalignment_tpu_torch.train.orbax import OcdbtStore, restore_pytree

    phase_orbax_tiny(dev)

    medium = os.path.join(ORBAX_DIR, "medium")
    ckpt = os.path.join(medium, "best_model")
    with open(os.path.join(ORBAX_DIR, "medium.json"), encoding="utf-8") as f:
        record = json.load(f)["leaves"]
    on_disk = _dir_bytes(ckpt)
    # (c) the decoder alone, one thread: the largest chunk (the token
    # embedding, 212 MB), then the whole tree on the reader's thread pool
    embedding = "params.whisper.decoder.token_embedding"
    with OcdbtStore(ckpt) as store:
        frame = store.get(f"{embedding}/0.0")
    out = np.empty(int(np.prod(record[embedding]["shape"])) * 4, np.uint8)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        zstd.decompress_into(frame, out)
        rates.append(out.nbytes / (time.perf_counter() - t0) / 1e6)
    t0 = time.perf_counter()
    tree = restore_pytree(ckpt)
    restore_s = time.perf_counter() - t0
    leaves = dict(_flat_leaves(tree))
    decoded = sum(v.nbytes if isinstance(v, np.ndarray) else v.numel() * v.element_size()
                  for v in leaves.values())
    bad = [n for n, v in leaves.items() if _leaf_sha256(v) != record[n]["sha256"]]
    assert set(leaves) == set(record) and not bad, (sorted(set(leaves) ^ set(record))[:3], bad[:3])
    log(f"[orbax-c] decoder, one thread, the token embedding ({out.nbytes / 1e6:.1f} MB) from "
        f"{len(frame)} bytes: "
        f"{max(rates):.0f} MB/s (best of 3; {', '.join(f'{r:.0f}' for r in rates)}); "
        f"restore_pytree of whisper-medium: {decoded / 1e9:.3f} GB from {on_disk / 1e6:.3f} MB on "
        f"disk in {restore_s:.2f} s = {decoded / restore_s / 1e6:.0f} MB/s "
        f"({min(8, os.cpu_count() or 1)} threads); {card}")
    log(f"[orbax-b] all {len(leaves)} leaves of the medium dir equal their recorded SHA-256")

    # the .pt route: the same weights, put into a float32 model (built on
    # the meta device and given the tensors) and written by
    # export_reference_pt into a model dir of their own
    pt_dir = os.path.join(tmp, "medium_pt")
    os.makedirs(pt_dir)
    for name in ("args.json", "model_args.json"):
        shutil.copy(os.path.join(medium, name), pt_dir)
    train_args = load_json(os.path.join(medium, "args.json"))
    mcfg = build_model_config(
        train_args["whisper_model"], whisper_dims=train_args.get("whisper_dims"),
        output_dim=load_json(os.path.join(medium, "model_args.json"))["output_dim"])
    with torch.device("meta"):
        m32 = AlignModel(mcfg)
    m32.load_state_dict(params_state_dict(tree["params"], mcfg.whisper.n_audio_ctx),
                        strict=True, assign=True)
    del tree, leaves
    export_reference_pt(m32, os.path.join(pt_dir, "best_model.pt"))
    # the part of either load that is neither route's: load_model_dir builds
    # (and randomly initialises) the float32 model on the CPU first
    t0 = time.perf_counter()
    m32 = AlignModel(mcfg)
    build_s = time.perf_counter() - t0
    del m32

    def timed_load(model_dir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, model, _ = load_model_dir(model_dir, device=str(dev), use_bf16=True)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    vocab, table = _vocab_and_table()
    tok = BertWordPieceTokenizer(vocab=vocab)
    requests = _write_requests(tmp, [float(SECONDS)] * B, seed=11)
    results, counts, loads, walls = {}, None, {}, {}
    for route, model_dir in (("orbax", medium), ("pt", pt_dir)):
        model, loads[route] = timed_load(model_dir)
        aligner = LyricAligner(model, tok, table, use_ctc=True, batch_size=B)
        aligner.align_many(requests[:1])
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        results[route] = aligner.align_many(requests)
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        if route == "orbax":
            counts = dict(kernels.launches)
        del aligner, model
        torch.cuda.empty_cache()
    _check_segments(results["orbax"], requests, [float(SECONDS)] * B)
    for name in SERVING_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the orbax model's batch")
    assert results["orbax"] == results["pt"], "orbax and .pt routes align differently"
    n_seg = sum(len(r) for r in results["orbax"])
    log(f"[orbax-b] whisper-medium bf16 from the orbax dir: align_many of {B} x {SECONDS} s in "
        f"{walls['orbax']:.3f} s ({walls['pt']:.3f} s from the .pt reload), {n_seg} segments, "
        f"every onset and offset finite, equal to the .pt route's; launches {counts}")
    log(f"[orbax-c] load_model_dir(device=cuda, use_bf16=True): orbax route "
        f"{loads['orbax']:.2f} s, .pt route {loads['pt']:.2f} s "
        f"({os.path.getsize(os.path.join(pt_dir, 'best_model.pt')) / 1e9:.3f} GB .pt); building "
        f"the float32 AlignModel on the CPU, which both do first: {build_s:.2f} s; {card}")
    return counts


# ---------------------------------------------------------------------------
# Phase 12: the large family (whisper-large, large-v3, large-v3-turbo)
# ---------------------------------------------------------------------------

LARGE_ITERS = 3          # timed alignment batches of part (a), after one warm-up
LARGE_STEPS = 2          # timed train steps of part (d), after one warm-up
LARGE_SERVE = (9.0, 17.5, 26.0, 29.4, 45.0)  # part (b)'s WAV requests, seconds
# bench.py's transcribe point (bench.py:161-214): 16 windows, beam 5, 64 new
# tokens, decode group 3; greedy tokens of the first 2 held to float32
TURBO_BEAM, TURBO_MAX_NEW, TURBO_GROUP, TURBO_HELD = 5, 64, 3, 2


def _large_counts(counts, expected, part):
    if counts != expected:
        raise AssertionError(f"{part} launched {counts}, expected {expected}")


def phase_large_align(dev, card):
    """(a): whisper-large at bench.py's align_large point (bf16-resident,
    tanh GELU, the one-pass encoder, B = 16 x 30 s, 48 labels, the CTC head
    of 21129 classes, viterbi_align_fused), and whisper-medium on the same
    inputs; each against its bf16-rounded weights computed in float32.
    Returns the launches of the timed large batches."""
    import torch

    from lyricalignment_tpu_torch import EMBED_FRAMES, N_FRAMES, kernels
    from lyricalignment_tpu_torch.models.align_model import forward_from_audio
    from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim
    from lyricalignment_tpu_torch.ops.viterbi import frames_to_seconds, viterbi_align_fused

    g = torch.Generator(device=dev).manual_seed(31)
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    frames = torch.full((B,), EMBED_FRAMES, dtype=torch.int32, device=dev)
    labels = torch.randint(2, 400, (B, L_BENCH), device=dev, generator=g, dtype=torch.int32)
    num_labels = torch.full((B,), L_BENCH, dtype=torch.int32, device=dev)

    @torch.inference_mode()
    def align_batch(model):
        # the serving path's own calls, as phase "throughput" makes them
        h, _ = forward_from_audio(model, audio, frame_lengths=frames, mel_lengths=2 * frames,
                                  align_head_output="hidden")
        fc = model.align_rnn.fc
        on, off = viterbi_align_fused(h, fc.weight, fc.bias, labels, num_labels, frames, "ctc")
        return frames_to_seconds(on, off)

    stats = {}
    for name in ("medium", "large"):
        t0 = time.perf_counter()
        out = {}
        for kind, dtype in (("f32", torch.float32), ("bf16", None)):
            model = _align_model(dev, compute_dtype=dtype, name=name, onepass=True)
            with torch.inference_mode():
                enc = model.whisper_model.embed_audio(pad_or_trim(log_mel(audio), N_FRAMES))
            out[kind] = (enc, align_batch(model))
            if kind == "f32":
                del model
                torch.cuda.empty_cache()
        (enc32, seg32), (enc16, seg16) = out["f32"], out["bf16"]
        stats[name] = (rel_l2(enc16, enc32), _within_frame(seg16.tolist(), seg32.tolist()))
        del out, enc32, enc16, seg32
        log(f"[large-a] whisper-{name} bf16: encoder rel-L2 against float32 on the same "
            f"bf16-rounded weights {stats[name][0]:.3e}, onsets/offsets within a frame of "
            f"float32's {stats[name][1]:.4f} ({time.perf_counter() - t0:.1f} s with the builds)")
        if name == "medium":
            del model
            torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(LARGE_ITERS):
        seg16 = align_batch(model)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(kernels.launches)
    n_layer = model.cfg.whisper.n_audio_layer
    n_params = sum(p.numel() for p in model.parameters())
    on, off = seg16[..., 0].double(), seg16[..., 1].double()
    ordered = bool(torch.isfinite(seg16).all() and (on < off).all()
                   and (on[:, 1:] >= off[:, :-1] - 1e-9).all())
    log(f"[large-a] whisper-large ({n_params / 1e6:.1f} M parameters) bf16 B={B} x {SECONDS} s "
        f"L={L_BENCH} CTC: {LARGE_ITERS * B * SECONDS / elapsed:.2f} audio-s/s "
        f"({elapsed / LARGE_ITERS * 1e3:.1f} ms a batch, mean of {LARGE_ITERS} after a "
        f"warm-up), max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB on "
        f"{card}; encoder rel-L2 {stats['large'][0]:.3e} (medium's {stats['medium'][0]:.3e}, "
        f"ratio {stats['large'][0] / stats['medium'][0]:.3f}; <= 2); within a frame "
        f"{stats['large'][1]:.4f} (medium's {stats['medium'][1]:.4f}; at most 0.02 below); "
        f"onsets finite and ordered: {ordered}; launches in {LARGE_ITERS} batches {counts}")
    _large_counts(counts, {"la_log10_mel": LARGE_ITERS, "la_bias_attention": n_layer * LARGE_ITERS,
                           "la_gru_recurrence": GRU_LAYERS * LARGE_ITERS,
                           "la_row_lse": LARGE_ITERS, "la_viterbi": LARGE_ITERS}, "(a)")
    if not ordered or stats["large"][0] > 2 * stats["medium"][0] or (
            stats["large"][1] < stats["medium"][1] - 0.02):
        raise AssertionError("(a): whisper-large bf16 strays from float32 beyond medium's")
    return counts


def phase_large_serve(dev, card, tmp):
    """(b): a large-v3 model dir (seeded weights, written as la-convert
    writes one) through ``load_model_dir`` and ``LyricAligner.align_many``
    on the card; then the 128-band log-mel kernel at B = 16 x 30 s against
    the plain version in float64, and its time beside the bound and
    ``torch.stft`` + mel. Returns (the requests' launches, the log-mel's
    numbers)."""
    import torch

    from lyricalignment_tpu_torch import HOP_LENGTH, kernels
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.cli.common import build_model_config, load_model_dir
    from lyricalignment_tpu_torch.cli.convert_checkpoint import _write_model_dir
    from lyricalignment_tpu_torch.models.align_model import AlignModel, init_weights
    from lyricalignment_tpu_torch.ops import mel
    from lyricalignment_tpu_torch.text.bert_tokenizer import BertWordPieceTokenizer

    mcfg = build_model_config("large-v3", output_dim=C_CTC)
    model_dir = os.path.join(tmp, "large_v3")
    t0 = time.perf_counter()
    with torch.device(dev):
        model = AlignModel(mcfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    _write_model_dir(model_dir, "large-v3", True, model.state_dict(), "best")
    write_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    # what load_model_dir does first: the float32 model built on the CPU
    t0 = time.perf_counter()
    model = AlignModel(mcfg)
    build_s = time.perf_counter() - t0
    del model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, model, _ = load_model_dir(model_dir, device=str(dev), use_bf16=True, fast_gelu=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    wcfg = model.cfg.whisper

    vocab, table = _vocab_and_table()
    aligner = LyricAligner(model, BertWordPieceTokenizer(vocab=vocab), table, use_ctc=True,
                           batch_size=4)
    requests = _write_requests(tmp, LARGE_SERVE, seed=13)
    aligner.align_many(requests[:1])  # first-use allocations outside the window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = aligner.align_many(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    _check_segments(results, requests, LARGE_SERVE)
    size = os.path.getsize(os.path.join(model_dir, "best_model.pt"))
    log(f"[large-b] large-v3 ({wcfg.n_mels} mel bands, vocabulary {wcfg.n_vocab}) model dir: "
        f"built on the card and written in {write_s:.2f} s ({size / 1e9:.3f} GB .pt); "
        f"load_model_dir(cuda, bf16) "
        f"{load_s:.2f} s, of which the float32 AlignModel's CPU build {build_s:.2f} s; "
        f"align_many of {len(requests)} requests ({sum(LARGE_SERVE):.1f} s of audio) in "
        f"{wall:.3f} s, max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"on {card}; launches {counts}")
    # one launch of each a batch, the attention one a layer
    batches = counts.get("la_log10_mel", 0)
    _large_counts(counts, {"la_log10_mel": batches, "la_row_lse": batches, "la_viterbi": batches,
                           "la_bias_attention": wcfg.n_audio_layer * batches,
                           "la_gru_recurrence": GRU_LAYERS * batches}, "(b)'s requests")
    if not batches:
        raise AssertionError("(b): the requests launched no kernel")
    del aligner, model
    torch.cuda.empty_cache()

    # the 128-band log-mel of the large-v3 frontend at the batch's shape,
    # against the plain version run in float64 within 8 decades of the peak
    # (log_mel's clamp), as phase "transcribe" (a) holds the whole-song one
    n_mels = wcfg.n_mels
    g = torch.Generator(device=dev).manual_seed(17)
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    padded = mel.reflect_pad(audio).contiguous()
    n_frames = audio.shape[1] // HOP_LENGTH
    got = mel.log10_mel(padded, n_frames, n_mels)
    ref = mel.log10_mel_plain(padded.double(), n_frames, n_mels)
    floor = ref.max() - 8.0
    err = (torch.maximum(got.double(), floor) - torch.maximum(ref, floor)).abs().max().item()
    plain32_err = (torch.maximum(mel.log10_mel_plain(padded, n_frames, n_mels).double(), floor)
                   - torch.maximum(ref, floor)).abs().max().item()
    del ref
    ops, nbytes = _mel_work(padded, n_frames, n_mels)
    bound_ms, bound_by = bound(ops, PEAK_F32, nbytes)
    ms = time_ms(lambda: mel.log10_mel(padded, n_frames, n_mels), reps=20)
    lib_ms = time_ms(_stft_mel(audio, n_mels), reps=20)
    log(f"[large-b] log10_mel {B} x {SECONDS} s -> {n_mels} x {n_frames}: kernel vs the "
        f"float64 plain version {err:.3e} within 8 decades of the peak (atol 1e-4; the "
        f"float32 plain version {plain32_err:.3e}); kernel_ms={ms:.4f} bound_ms="
        f"{bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), "
        f"{bound_ms / ms:.3f} of the bound; torch.stft + mel {lib_ms:.4f} ms; {card}")
    if got.shape != (B, n_mels, n_frames) or not err <= 1e-4:
        raise AssertionError("(b): the 128-band log-mel disagrees with its float64 version")
    shape = f"[{B}, {padded.shape[1]}] -> [{B}, {n_mels}, {n_frames}]"
    return counts, {"log10_mel": dict(large_shape=shape, large_ms=ms, large_bound_ms=bound_ms,
                                      large_library_ms=lib_ms, large_max_abs_err=err)}


def phase_large_turbo(dev, card, tmp):
    """(c): large-v3-turbo at bench.py's transcribe point (16 windows of 30
    s, beam 5, 64 new tokens, decode group 3, a <|notimestamps|> prompt in
    the v3 layout), bf16-resident; then greedy tokens of 2 windows against
    the same weights in float32. Returns the launches of the beam batch."""
    import torch

    from lyricalignment_tpu_torch import N_FRAMES, kernels
    from lyricalignment_tpu_torch.decode import beam as beam_mod
    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import (
        WHISPER_CONFIGS,
        Whisper,
        bf16_resident,
        decode_step,
        init_decode_cache,
        prime_decode_cache,
    )
    from lyricalignment_tpu_torch.ops.mel import log_mel, pad_or_trim
    from lyricalignment_tpu_torch.text.whisper_tokenizer import (
        WhisperTokenizer,
        num_languages_for_vocab,
    )

    t0 = time.perf_counter()
    wcfg = dataclasses.replace(WHISPER_CONFIGS["large-v3-turbo"], compute_dtype=torch.bfloat16,
                               fast_gelu=True, onepass_encoder=True)
    with torch.device(dev):
        align = AlignModel(AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=64))
    align.to(dev)
    init_weights(align, torch.Generator(device=dev).manual_seed(0))
    model = bf16_resident(align.whisper_model).eval()
    del align
    ranks = _write_ranks(tmp)
    tok = WhisperTokenizer(bpe_path=ranks, num_languages=num_languages_for_vocab(wcfg.n_vocab))
    v2 = WhisperTokenizer(bpe_path=ranks)
    # yue, the 100th language, shifts every special id after the language
    # block up by one; sot, eot and <|zh|> (in the block) keep theirs
    ids = {name: (tok.special_tokens[name], v2.special_tokens[name])
           for name in ("<|startoftranscript|>", "<|zh|>", "<|transcribe|>",
                        "<|notimestamps|>")}
    shift = {name: a - b for name, (a, b) in ids.items()}
    if tok.n_vocab != wcfg.n_vocab or tok.eot != v2.eot or shift != {
            "<|startoftranscript|>": 0, "<|zh|>": 0, "<|transcribe|>": 1, "<|notimestamps|>": 1}:
        raise AssertionError(f"(c): the v3 special ids {ids} against v2's")
    prompt_ids = list(tok.sot_sequence) + [tok.no_timestamps]
    prompt = torch.tensor([prompt_ids] * B, device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    audio = torch.randn(B, SECONDS * 16000, device=dev, generator=g) * 0.1
    log(f"[large-c] large-v3-turbo bf16 ({wcfg.n_audio_layer} encoder, {wcfg.n_text_layer} "
        f"decoder layers) built in {time.perf_counter() - t0:.1f} s; prompt {prompt_ids}; "
        f"(v3, v2) ids {ids}")

    steps = [0]
    real_step = beam_mod.decode_step

    def counted_step(*a):
        steps[0] += 1
        return real_step(*a)

    def encode(whisper, n=B):
        mel = log_mel(audio[:n], n_mels=wcfg.n_mels)
        return whisper.embed_audio(pad_or_trim(mel, N_FRAMES))

    @torch.no_grad()
    def run(max_new):
        """encode then beam_search: CUDA-event ms of each, a prime alone on
        the same windows, the steps run and the host wall."""
        marks = {n: (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for n in ("encode", "call", "prime")}
        steps[0] = 0
        t0 = time.perf_counter()
        marks["encode"][0].record()
        xa = encode(model)
        marks["encode"][1].record()
        marks["call"][0].record()
        tokens, _ = beam_mod.beam_search(model, wcfg, xa, prompt, beam_size=TURBO_BEAM,
                                         max_new_tokens=max_new, eot=tok.eot, group=TURBO_GROUP)
        marks["call"][1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_steps = steps[0]
        marks["prime"][0].record()
        cache = init_decode_cache(model, wcfg, xa, prompt.shape[1], max_new, beam_size=TURBO_BEAM)
        prime_decode_cache(model, wcfg, prompt, cache)
        marks["prime"][1].record()
        torch.cuda.synchronize()
        ms = {n: s.elapsed_time(e) for n, (s, e) in marks.items()}
        return xa, tokens, ms, n_steps, wall

    beam_mod.decode_step = counted_step
    try:
        run(4)  # first-use allocations
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        xa, tokens, ms, n_steps, wall = run(TURBO_MAX_NEW)
        counts = dict(kernels.launches)
    finally:
        beam_mod.decode_step = real_step
    decode_ms = ms["call"] - ms["prime"]
    log(f"[large-c] beam_search beam {TURBO_BEAM}, {B} windows of {SECONDS} s, "
        f"max_new_tokens {TURBO_MAX_NEW}, decode group {TURBO_GROUP}: encode {ms['encode']:.2f} "
        f"ms, beam_search {ms['call']:.1f} ms = prime {ms['prime']:.2f} ms (timed alone) + "
        f"decode {decode_ms:.1f} ms in {n_steps} steps = {decode_ms / max(n_steps, 1):.3f} ms a "
        f"step; {B / wall:.3f} windows/s ({wall:.3f} s wall, encode + beam_search); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}; "
        f"launches {counts}")
    _large_counts(counts, {"la_log10_mel": 1, "la_bias_attention": wcfg.n_audio_layer}, "(c)")
    if tokens.shape != (B, TURBO_MAX_NEW) or not 0 < n_steps <= TURBO_MAX_NEW:
        raise AssertionError(f"(c): tokens {tuple(tokens.shape)} in {n_steps} steps")

    # greedy tokens of 2 windows, bf16 against the same weights in float32
    with torch.device(dev):
        f32 = Whisper(dataclasses.replace(wcfg, compute_dtype=torch.float32))
    f32.to(dev).load_state_dict(model.state_dict())
    f32.eval()
    held = {}
    with torch.no_grad():
        xa32 = encode(f32, TURBO_HELD)
        for name, whisper, feats in (("bf16", model, xa[:TURBO_HELD]), ("f32", f32, xa32)):
            held[name] = beam_mod.greedy_decode(whisper, wcfg, feats, prompt[:TURBO_HELD],
                                                max_new_tokens=TURBO_MAX_NEW, eot=tok.eot)
        same = held["bf16"] == held["f32"]
        agree = [int(row.long().cumprod(0).sum()) for row in same]
        # phase "transcribe" (b)'s check: a KV-cached bf16 step's logits
        # against the teacher-forced decoder on the same prefix (the bf16
        # greedy tokens), here the float32 one on the float32 features
        n_fed = min(5, TURBO_MAX_NEW - 1)
        tokens16 = held["bf16"]
        cache = init_decode_cache(model, wcfg, xa[:TURBO_HELD], prompt.shape[1], n_fed + 1)
        _, _, cache = prime_decode_cache(model, wcfg, prompt[:TURBO_HELD], cache)
        for i in range(n_fed + 1):
            step_logits, cache = decode_step(model, wcfg, tokens16[:, i: i + 1], cache)
        fed = torch.cat([prompt[:TURBO_HELD], tokens16[:, : n_fed + 1]], 1)
        ref16 = model.decoder_logits(fed, xa[:TURBO_HELD])[:, -1]
        ref32 = f32.decoder_logits(fed, xa32)[:, -1]
        rel16, rel32 = rel_l2(step_logits, ref16), rel_l2(step_logits, ref32)
    log(f"[large-c] greedy_decode of {TURBO_HELD} windows, bf16 against float32 on the same "
        f"weights: {agree} of {TURBO_MAX_NEW} tokens agree before the first divergence "
        f"(bf16 {tokens16[:, :8].tolist()}, float32 {held['f32'][:, :8].tolist()}); decode "
        f"step {n_fed + 1} logits vs teacher-forced decoder_logits on the bf16 prefix: float32 "
        f"rel_l2 {rel32:.3e}, bf16 {rel16:.3e} (bound 3e-2)")
    if not (rel16 <= 3e-2 and rel32 <= 3e-2):
        raise AssertionError("(c): the KV-cached step strays from the teacher-forced decoder")
    del model, f32, xa, xa32
    torch.cuda.empty_cache()
    return counts


def _large_train_model(dev, freeze):
    """whisper-large at bench_train's recipe (bf16 compute, tanh GELU, the
    CTC head of 21129 classes, align CE + CTC + transcript CE), random
    weights from a seed; ``freeze``: the encoder frozen and bf16-resident,
    as bench.py's one-chip large recipe has it."""
    import torch

    from lyricalignment_tpu_torch.models.align_model import (
        AlignModel,
        AlignModelConfig,
        init_weights,
    )
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS, bf16_resident

    wcfg = dataclasses.replace(WHISPER_CONFIGS["large"], compute_dtype=torch.bfloat16,
                               fast_gelu=True)
    cfg = AlignModelConfig(whisper=wcfg, hidden_dim=384, output_dim=C_CTC,
                           train_transcript=True, freeze_encoder=freeze)
    with torch.device(dev):
        model = AlignModel(cfg)
    model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    if freeze:
        bf16_resident(model.whisper_model.encoder)
    return model


def phase_large_train(dev, card, medium_peak_gb=None):
    """(d): the one-card large recipe (bench.py:240-259): freeze + remat, a
    bf16-resident frozen encoder, 8 micro-batches of 2 x 30 s, bf16
    accumulation and Adam mu, unfused losses; a warm-up step, then 2 timed;
    then (d') one step of it with the fused losses. (e): the same batch
    unfrozen with remat, one step, held to a step without remat on the
    same weights. Returns the launches of (d), (d') and (e)."""
    import numpy as np
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.models.align_model import init_weights
    from lyricalignment_tpu_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        make_eval_step,
        make_train_step,
        to_device,
    )

    t0 = time.perf_counter()
    model = _large_train_model(dev, freeze=True)
    n_layer = model.cfg.whisper.n_audio_layer
    # warmup_steps 1: the untimed first update has lr 0, the timed ones lr > 0
    tcfg = TrainConfig(accum_grad_steps=ACCUM, use_ctc=True, vocab_size=C_CTC - 1,
                       warmup_steps=1, total_steps=2000, remat=True,
                       grad_accum_dtype=torch.bfloat16, adam_mu_dtype=torch.bfloat16,
                       freeze_encoder=True)
    state, tx = init_train_state(model, tcfg)
    step_fn = make_train_step(tcfg, tx)
    stacked = to_device(_train_batch(np.random.default_rng(0), ACCUM, TRAIN_B,
                                     model.cfg.whisper.n_vocab, 400), dev)
    encoder = "whisper_model.encoder."
    params = dict(model.named_parameters())
    stateful = [n for n in (*state.opt_state.mu, *state.opt_state.nu) if n.startswith(encoder)]
    frozen = {n: p.detach().clone() for n, p in params.items() if n.startswith(encoder)}
    log(f"[large-d] whisper-large, frozen bf16 encoder: {len(params)} tensors "
        f"({sum(p.numel() for p in params.values()) / 1e6:.1f} M parameters), "
        f"{len(state.opt_state.mu)} with Adam state, set up in {time.perf_counter() - t0:.1f} s")
    if stateful or len(state.opt_state.mu) != len(params) - len(frozen):
        raise AssertionError(f"(d): optimizer state for the frozen encoder: {stateful[:3]}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = step_fn(state, stacked)
    torch.cuda.synchronize()
    log(f"[large-d] warm-up step (lr 0) {time.perf_counter() - t0:.3f} s, losses "
        f"{json.dumps({k: round(float(v), 5) for k, v in losses.items()})}")
    trained = {n: p.detach().clone() for n, p in params.items() if n not in frozen}
    kernels.reset_launch_counts()
    times, all_losses = [], []
    for _ in range(LARGE_STEPS):
        t0 = time.perf_counter()
        state, losses = step_fn(state, stacked)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_losses.append({k: float(v) for k, v in losses.items()})
    counts = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_s = sum(times) / LARGE_STEPS
    unchanged = [n for n, p in frozen.items() if not torch.equal(params[n], p)]
    still = [n for n, p in trained.items() if torch.equal(params[n], p)]
    log(f"[large-d] freeze + remat, {ACCUM} x {TRAIN_B} x {SECONDS} s: step ms "
        f"{[round(x * 1e3, 1) for x in times]} (mean {mean_s * 1e3:.1f}), "
        f"{ACCUM * TRAIN_B * SECONDS / mean_s:.2f} trained audio-s/s, max_memory_allocated "
        f"{peak_gb:.2f} GB on {card}; losses {json.dumps(all_losses)}; encoder tensors changed "
        f"{len(unchanged)} of {len(frozen)}, trained tensors unmoved {len(still)} of "
        f"{len(trained)} {still[:3]}; launches in {LARGE_STEPS} steps {counts}")
    # the frozen encoder runs under no_grad: its attention forward takes the
    # launcher that writes no row statistics (la_bias_attention, no bias),
    # and remat recomputes nothing of it
    _large_counts(counts, {"la_log10_mel": LARGE_STEPS * ACCUM,
                           "la_bias_attention": LARGE_STEPS * ACCUM * n_layer}, "(d)")
    if not all(math.isfinite(v) for row in all_losses for v in row.values()):
        raise AssertionError("(d): non-finite training loss")
    if unchanged or still:
        raise AssertionError(f"(d): encoder changed {unchanged[:3]}, unmoved {still[:3]}")
    del frozen, trained

    # (d') the recipe with the fused losses (phase "train" (e)'s check of
    # the align losses, fused against unfused on the first micro-batch),
    # then one fused step: the row LSE, its backward and the reduced CTC
    # kernels on the large head's hidden
    fused_cfg = dataclasses.replace(tcfg, fused_losses=True)
    micro = {k: v[0] for k, v in stacked.items()}
    evals = {name: {k: float(v) for k, v in make_eval_step(cfg)(model, micro).items()}
             for name, cfg in (("fused", fused_cfg), ("unfused", tcfg))}
    loss_rel = {k: abs(evals["fused"][k] - evals["unfused"][k]) / abs(evals["unfused"][k])
                for k in ("align_ce", "align_ctc")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = make_train_step(fused_cfg, tx)(state, stacked)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    fused_counts = dict(kernels.launches)
    log(f"[large-d] fused losses, first micro-batch: align CE / CTC rel diff to unfused "
        f"{loss_rel['align_ce']:.2e} / {loss_rel['align_ctc']:.2e} (<= 1e-4); one fused step "
        f"{fused_ms:.1f} ms, max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB on {card}; losses {json.dumps({k: float(v) for k, v in losses.items()})}; "
        f"launches {fused_counts}")
    _large_counts(fused_counts, {
        "la_log10_mel": ACCUM, "la_bias_attention": ACCUM * n_layer,
        **{name: ACCUM * n for name, n in FUSED_KERNELS.items() if name not in TRAIN_KERNELS}},
        "(d') the fused step")
    if max(loss_rel.values()) > 1e-4 or not all(math.isfinite(float(v))
                                                for v in losses.values()):
        raise AssertionError("(d'): the fused losses disagree with the unfused ones")
    del model, state, tx, step_fn, params
    torch.cuda.empty_cache()

    # (e) unfrozen, the same batch: one step with remat, then one without on
    # the same weights (the same seed drawn again) and the same dropout
    model = _large_train_model(dev, freeze=False)
    watch = ("whisper_model.encoder.blocks.0.attn.query.weight",
             f"whisper_model.decoder.blocks.{model.cfg.whisper.n_text_layer - 1}.mlp.0.weight",
             "align_rnn.fc.weight")
    runs = {}
    for remat in (True, False):
        init_weights(model, torch.Generator(device=dev).manual_seed(0))
        etcfg = dataclasses.replace(tcfg, warmup_steps=0, remat=remat, freeze_encoder=False)
        state, tx = init_train_state(model, etcfg)
        params = dict(model.named_parameters())
        before = {n: params[n].detach().clone() for n in watch}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            state, losses = make_train_step(etcfg, tx)(state, stacked)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            if remat:
                raise
            log(f"[large-e] the step without remat does not fit: "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated at the failure")
            break
        runs[remat] = dict(ms=(time.perf_counter() - t0) * 1e3, counts=dict(kernels.launches),
                           peak=torch.cuda.max_memory_allocated() / 1e9,
                           losses={k: float(v) for k, v in losses.items()},
                           update={n: params[n].detach() - before[n] for n in watch})
        if remat:
            # the optimizer update alone, given float32 gradients as the step
            # gives it them: how far its temporaries lift the peak
            grads = {n: torch.zeros_like(p) for n, p in params.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tx.update(params, grads, state.opt_state)
            torch.cuda.synchronize()
            runs[remat]["update_gb"] = ((torch.cuda.max_memory_allocated() - base) / 1e9,
                                        base / 1e9)
            del grads
        del state, tx, params, before
        torch.cuda.empty_cache()
    r = runs[True]
    medium_text = (f"medium's {medium_peak_gb:.2f} GB in phase \"train\" (c)" if medium_peak_gb
                   else "medium's not measured in this run")
    log(f"[large-e] unfrozen + remat, {ACCUM} x {TRAIN_B} x {SECONDS} s, one step: "
        f"{r['ms']:.1f} ms, {ACCUM * TRAIN_B * SECONDS / r['ms'] * 1e3:.2f} trained audio-s/s, "
        f"max_memory_allocated {r['peak']:.2f} GB ({medium_text}) on {card}; the optimizer "
        f"update alone lifts the peak {r['update_gb'][0]:.2f} GB above the {r['update_gb'][1]:.2f} "
        f"GB it is given (parameters, moments and float32 gradients); losses "
        f"{json.dumps(r['losses'])}; launches {r['counts']}")
    _large_counts(r["counts"], {"la_log10_mel": ACCUM,
                                "la_attention_fwd": 2 * ACCUM * n_layer,
                                "la_attention_dkdv": ACCUM * n_layer,
                                "la_attention_dq": ACCUM * n_layer}, "(e) with remat")
    if not all(math.isfinite(v) for v in r["losses"].values()):
        raise AssertionError("(e): non-finite training loss")
    if False in runs:
        n = runs[False]
        loss_rel = max(abs(r["losses"][k] - v) / max(abs(v), 1e-6) for k, v in n["losses"].items())
        upd = {k: rel_l2(r["update"][k], n["update"][k]) for k in watch}
        log(f"[large-e] without remat on the same weights and batch: {n['ms']:.1f} ms, "
            f"max_memory_allocated {n['peak']:.2f} GB (remat {r['peak']:.2f} GB); losses max "
            f"rel diff {loss_rel:.2e} (<= 1e-5), equal: {r['losses'] == n['losses']}; update "
            f"rel-L2 remat vs not {json.dumps({k: f'{v:.2e}' for k, v in upd.items()})}; "
            f"launches {n['counts']}")
        _large_counts(n["counts"], {"la_log10_mel": ACCUM, "la_attention_fwd": ACCUM * n_layer,
                                    "la_attention_dkdv": ACCUM * n_layer,
                                    "la_attention_dq": ACCUM * n_layer}, "(e) without remat")
        if loss_rel > 1e-5:
            raise AssertionError("(e): remat changes the step's losses")
    del model, runs, stacked
    torch.cuda.empty_cache()
    return counts, fused_counts, r["counts"]


def phase_large_cli(dev, card, tmp):
    """(f): the train CLI at large-v3-turbo with a frozen bf16 encoder for 2
    updates on synthetic songs, then its best_model through the alignment
    CLI."""
    import torch

    from lyricalignment_tpu_torch import kernels
    from lyricalignment_tpu_torch.cli import inference_alignment
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS

    vocab, _ = _vocab_and_table()
    lengths = [6.0, 9.5, 12.0, 14.5]
    requests = _write_requests(tmp, lengths, seed=23)
    records = []
    for (path, lyric), sec in zip(requests, lengths):
        step = (sec - 0.5) / len(lyric)
        records.append({"song_path": path, "lyric": lyric,
                        "on_offset": [[0.2 + i * step, 0.2 + (i + 0.8) * step]
                                      for i in range(len(lyric))]})
    data, one = os.path.join(tmp, "turbo_train.json"), os.path.join(tmp, "turbo_one.json")
    for path, recs in ((data, records), (one, records[:1])):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(recs, f, ensure_ascii=False)
    vocab_path = os.path.join(tmp, "vocab.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])))
    save = os.path.join(tmp, "turbo_result")
    cmd = [sys.executable, "-m", "lyricalignment_tpu_torch.cli.train_multitask",
           "--train-data", data, "--dev-data", data, "--whisper-model", "large-v3-turbo",
           "--freeze-encoder", "--bf16", "--fast-gelu", "--bf16-grad-accum", "--bf16-adam-mu",
           "--train-alignment", "--train-transcript", "--use-ctc-loss",
           "--train-batch-size", "2", "--dev-batch-size", "4", "--accum-grad-steps", "2",
           "--train-steps", "2", "--eval-steps", "2", "--warmup-steps", "0",
           "--bert-vocab", vocab_path, "--save-dir", save, "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    log(f"[large-f] {' '.join(cmd[1:3])} --whisper-model large-v3-turbo --freeze-encoder "
        f"--bf16 ... exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-10:]:
        log(f"[large-f]   {line}")
    if proc.returncode != 0:
        raise AssertionError("(f): the train CLI failed")
    if not os.path.exists(os.path.join(save, "best_model.pt")):
        raise AssertionError("(f): the train CLI wrote no best_model.pt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mae = inference_alignment.main(["-f", one, "--model-dir", save, "--use-ctc-loss", "--bf16",
                                    "--fast-gelu", "--bert-vocab", vocab_path,
                                    "--device", dev.type])
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    n_layer = WHISPER_CONFIGS["large-v3-turbo"].n_audio_layer
    log(f"[large-f] alignment CLI on the written best_model: {time.perf_counter() - t0:.1f} s "
        f"with the load, MAE {mae:.4f} s on a {lengths[0]} s song, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}; launches {counts}")
    _large_counts(counts, {"la_log10_mel": 1, "la_bias_attention": n_layer,
                           "la_gru_recurrence": GRU_LAYERS, "la_row_lse": 1, "la_viterbi": 1},
                  "(f)'s alignment CLI")
    if not math.isfinite(mae):
        raise AssertionError("(f): the served checkpoint's MAE is not finite")


def phase_large_kernels(dev, card):
    """The attention kernels at the large family's shapes: la_bias_attention
    at B x H = 16 x 20, T = 1500 (an alignment batch), the training trio at
    B x H = 2 x 20 (a train micro-batch), each against its plain version,
    timed beside its bound and SDPA. Returns {row name: numbers}."""
    import torch
    import torch.nn.functional as F

    from lyricalignment_tpu_torch.ops import attention

    h, t, d = 20, 1500, 64
    g = torch.Generator(device=dev).manual_seed(41)
    bias = torch.zeros(1, t, device=dev)
    q, k, v = (torch.randn(B, t, h, d, device=dev, generator=g).mul_(0.35).to(torch.bfloat16)
               for _ in range(3))
    got = attention.onepass_self_attention(q, k, v, bias)
    ref = attention.einsum_bias_attention(q, k, v, bias)
    rel, err = rel_l2(got, ref), (got.float() - ref.float()).abs().max().item()
    del got, ref
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(lambda: attention.onepass_self_attention(q, k, v, bias), reps=20)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias.to(torch.bfloat16), scale=1.0), reps=20)
    bound_ms, bound_by = bound(4 * B * h * t * t * d, PEAK_BF16, 2 * 4 * q.numel() + 4 * t)
    out = {"bias_attention": dict(large_shape=f"bf16 B={B} H={h} T={t}", large_ms=ms,
                                  large_bound_ms=bound_ms, large_library_ms=lib_ms,
                                  large_max_abs_err=err)}
    log(f"[large-kernels] bias_attention bf16 B={B} H={h} T={t}: rel_l2 {rel:.3e} against the "
        f"plain version (<= 1e-2); kernel_ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}), "
        f"{bound_ms / ms:.3f} of the bound; SDPA {lib_ms:.4f} ms; {card}")
    if rel > 1e-2:
        raise AssertionError("bias_attention at 20 heads disagrees with its plain version")
    del q, k, v, qt, kt, vt

    errs, rels = _attention_case(dev, TRAIN_B, t, h, torch.bfloat16, False, seed=43)
    log(f"[large-kernels] training trio bf16 B={TRAIN_B} H={h} T={t} against autograd "
        f"through the plain einsum: max_abs {json.dumps(errs)} rel_l2 {json.dumps(rels)} "
        f"(rel-L2 <= 1e-2, lse <= 1e-4)")
    if errs["lse"] > 1e-4 or max(rels[n] for n in ("out", "dq", "dk", "dv")) > 1e-2:
        raise AssertionError("the training attention kernels disagree at 20 heads")
    q, k, v, dout = (torch.randn(TRAIN_B, t, h, d, device=dev, generator=g).mul_(0.4)
                     .to(torch.bfloat16) for _ in range(4))
    o, lse = attention.attention_forward(q, k, v, None, with_lse=True)
    delta = attention.attention_delta(o, dout)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0), reps=20)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
    dout_t = dout.transpose(1, 2)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                                   retain_graph=True), reps=20)
    work = _train_attention_work(TRAIN_B, t, h, d)
    for name, fn, lib_ms, err_key in (
            ("attention_fwd", lambda: attention.attention_forward(q, k, v, None, with_lse=True),
             sdpa_fwd, "out"),
            ("attention_dkdv", lambda: attention.attention_dkdv(q, k, v, dout, lse, delta),
             sdpa_bwd, "dk"),
            ("attention_dq", lambda: attention.attention_dq(q, k, v, dout, lse, delta),
             sdpa_bwd, "dq")):
        ms = time_ms(fn, reps=20)
        bound_ms, bound_by = bound(*work[name])
        out[name] = dict(large_shape=f"bf16 B={TRAIN_B} H={h} T={t}", large_ms=ms,
                         large_bound_ms=bound_ms, large_library_ms=lib_ms,
                         large_max_abs_err=errs[err_key])
        log(f"[large-kernels] {name} bf16 B={TRAIN_B} H={h} T={t}: kernel_ms={ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}), {bound_ms / ms:.3f} of the bound; "
            f"{'SDPA forward' if name == 'attention_fwd' else 'SDPA backward (dq, dk, dv)'} "
            f"{lib_ms:.4f} ms; {card}")
    return out


# the parts whose launches each row of the kernels line carries
LARGE_PARTS = ("large_align", "large_v3_serve", "turbo_transcribe", "large_train_freeze",
               "large_train_fused", "large_train_remat")


def phase_large(dev, card, tmp, medium_peak_gb=None):
    """Phase 12 (see the module docstring): parts (a)-(f), then the
    attention kernels at the large shapes; each part's models are freed
    before the next. Returns ({part of LARGE_PARTS: launches}, {row name:
    the kernel's numbers at the large shape})."""
    import torch

    def part(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.empty_cache()
        log(f"[large] part {name} passed in {time.perf_counter() - t0:.1f} s")
        return result

    counts = {"large_align": part("a", phase_large_align, dev, card)}
    counts["large_v3_serve"], numbers = part("b", phase_large_serve, dev, card, tmp)
    counts["turbo_transcribe"] = part("c", phase_large_turbo, dev, card, tmp)
    (counts["large_train_freeze"], counts["large_train_fused"],
     counts["large_train_remat"]) = part("d, e", phase_large_train, dev, card, medium_peak_gb)
    part("f", phase_large_cli, dev, card, tmp)
    numbers.update(part("kernels", phase_large_kernels, dev, card))
    return counts, numbers


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
        medium_peak_gb = medium["peak_gb"]
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
            longform_counts = phase_longform(dev, card, tmp)
        log(f"[longform] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            serve_counts = phase_serve(dev, card, tmp)
        log(f"[serve] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            mesh_tp_counts, mesh_dp_counts, mesh_seq_counts = phase_mesh(dev, card, tmp)
        log(f"[mesh] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            pipe_counts, pipe_train_counts = phase_pipe(dev, card, tmp)
        log(f"[pipe] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            orbax_counts = phase_orbax(dev, card, tmp)
        log(f"[orbax] phase passed in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            large_counts, large_numbers = phase_large(dev, card, tmp, medium_peak_gb)
        log(f"[large] phase passed in {time.perf_counter() - t0:.1f} s")
    except Exception:  # report any failed phase and exit non-zero
        traceback.print_exc()
        return 1

    # launches: each path's own run (serving for the serving kernels, the
    # timed whisper-medium train steps for the training kernels)
    launchers = {"log10_mel": "la_log10_mel", "bias_attention": "la_bias_attention",
                 "row_lse": "la_row_lse", "viterbi": "la_viterbi",
                 "gru_recurrence": "la_gru_recurrence"}
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
        # phase "longform": the G = 2 arm (36 songs of 90 s, two raw); phase
        # "mesh" (d): rank 0's sequence-parallel medium encode
        row["longform_batched_launches"] = longform_counts.get(launcher, 0)
        row["mesh_seq3_rank_launches"] = mesh_seq_counts.get(launcher, 0)
        # phase "orbax" (b): the batch of the model read from the JAX
        # package's orbax dir
        row["orbax_launches"] = orbax_counts.get(launcher, 0)
        # phase "large": each part's launches, and the kernel's numbers at
        # the large family's shape (rows 1, 2 and 5a-5c; null elsewhere)
        for part in LARGE_PARTS:
            row[f"{part}_launches"] = large_counts[part].get(launcher, 0)
        row.update(large_numbers.get(row["name"], dict.fromkeys(
            ("large_shape", "large_ms", "large_bound_ms", "large_library_ms",
             "large_max_abs_err"))))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
