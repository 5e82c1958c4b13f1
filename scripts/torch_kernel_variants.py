#!/usr/bin/env python3
"""Times variants of the port's row log-sum-exp kernel
(``lyricalignment_tpu_torch/csrc/lse.cu``), log-mel kernel (``csrc/mel.cu``)
and Viterbi DP (``csrc/viterbi.cu``) on one NVIDIA GPU, at the alignment
main path's shapes (the DP also at 16 x 3000 frames x 128 labels), and of
the row log-sum-exp's backward (``la_row_lse_bwd``, the ``bwd`` family) and
the reduced CTC pair (``csrc/ctc.cu``, the ``ctc`` family) at the fused
training shapes (3000 rows, feat 768, 21127 columns; B = 2, T = 1500,
N = 48):

    python3 scripts/torch_kernel_variants.py [lse | mel | viterbi | bwd | ctc | VARIANT ...]

Each variant is the kernel source with the text substitutions listed in
``VARIANTS`` below, compiled on its own (one nvcc each, all started
together) from a copy of ``csrc/`` with the source's own flags. ``lse`` /
``mel`` / ``viterbi`` name every variant of one source; with no arguments
every variant runs. A variant is checked against the kernel's plain version
(``row_lse_plain``, ``log10_mel_plain``, ``viterbi_dp_plain``: exactly;
``row_lse_bwd_plain`` in float64 at rel-L2 1e-5; ``ctc_reduced_fwd_plain``
at NLL and alphas rtol 1e-5 and ``ctc_reduced_bwd_plain``, given the plain
alphas, at rel-L2 1e-5) and
then timed in two rounds, beside the one PyTorch call that computes the
same function where there is one. The variants marked "timed only" leave
out a part of the work to show what it costs; their outputs are wrong on purpose. ptxas'
register and spill lines of each variant's kernels are printed. With
``lse_as_built`` among the variants, the kernel is also run 80 times back to
back with the card's clock and power draw sampled every 10 calls.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tf32_wgmma(n: int, a_from: str) -> str:
    """Source of a TF32 m64n<n>k8 product helper for hopper.cuh, A from
    registers ("rs") or from shared memory ("ss"), as the variants need them
    beside the one the kernel is built with."""
    nd = n // 2
    ops = [f"%{i}" for i in range(nd)]
    d_rows = [", ".join(ops[i:i + 16]) for i in range(0, nd, 16)]
    d_text = "\n".join(f'      "{"{" if i == 0 else ""}{row}{"}, " if i == len(d_rows) - 1 else ", "}"'
                       for i, row in enumerate(d_rows))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(nd))
    if a_from == "rs":
        a_arg, a_ops = "const uint32_t (&a)[4]", '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])'
        a_text, n_a = f"{{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}", 4
    else:
        a_arg, a_ops = "uint64_t desc_a", '"l"(desc_a)'
        a_text, n_a = f"%{nd}", 1
    return f"""
__device__ __forceinline__ void wgmma_m64n{n}k8_tf32_{a_from}(float (&d)[{nd}], {a_arg},
                                                        uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + n_a + 1}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
{d_text}
      "{a_text}, %{nd + n_a}, p, 1, 1;\\n}}\\n"
      : {outs}
      : {a_ops}, "l"(desc_b), "r"(scale_d));
}}
"""


_HELPERS_AT = "__device__ __forceinline__ float ex2_ftz(float x) {"
_STAGES = "constexpr int kStages = 4; "
# A read by the tensor cores from the stage's h tile (hi and lo alike: timed
# only); the forward's call site alone (its indentation), the backward keeps
# issue_half
_A_SMEM = [
    ("hopper.cuh", _HELPERS_AT, tf32_wgmma(128, "ss") + _HELPERS_AT),
    ("// run += acc, rounded to nearest",
     "__device__ __forceinline__ void issue_half_ss(float (&acc)[64], uint64_t desc_a,\n"
     "                                              uint64_t desc_hi, uint64_t desc_lo, int kk0,\n"
     "                                              int accumulate) {\n"
     "  fence_regs(acc);\n  wgmma_fence();\n"
     "#pragma unroll\n  for (int j = 0; j < 2; ++j) {\n    const int kk = kk0 + j;\n"
     "    wgmma_m64n128k8_tf32_ss(acc, desc_a + 2 * kk, desc_hi + 2 * kk, accumulate || j > 0);\n"
     "    wgmma_m64n128k8_tf32_ss(acc, desc_a + 2 * kk, desc_lo + 2 * kk, 1);\n"
     "    wgmma_m64n128k8_tf32_ss(acc, desc_a + 2 * kk, desc_hi + 2 * kk, 1);\n  }\n"
     "  wgmma_commit();\n}\n\n// run += acc, rounded to nearest"),
    ("          const char* row_ptr =",
     "          const uint64_t desc_a = sw128_desc(sm.h[st] + 64 * (wg - 1) * kBK, 16, 1024);\n"
     "          const char* row_ptr ="),
    ("            issue_half(acc, a_hi[half], a_lo[half], desc_hi,",
     "            issue_half_ss(acc, desc_a, desc_hi,"),
]
# one TF32 product in place of three (in issue_half: the backward's too)
_LO_PRODUCTS = [("    wgmma_tf32(acc, lo[j], desc_hi + 2 * kk, accumulate || j > 0);\n"
                 "    wgmma_tf32(acc, hi[j], desc_lo + 2 * kk, 1);\n"
                 "    wgmma_tf32(acc, hi[j], desc_hi + 2 * kk, 1);",
                 "    wgmma_tf32(acc, hi[j], desc_hi + 2 * kk, accumulate || j > 0);")]
# a tile's products summed in the wgmma accumulator, as the kernel was
# before each group started a fresh one (the tensor cores' truncating adds;
# the wait after each group stays)
_ONE_ACCUMULATOR = [
    ("              add_group(run, acc);\n", ""),
    ("            issue_half(acc, a_hi[half], a_lo[half], desc_hi, desc_lo, 2 * half, 0);",
     "            issue_half(acc, a_hi[half], a_lo[half], desc_hi, desc_lo, 2 * half,\n"
     "                       c > 0 || half > 0);")]

# the scratch-size function of a variant that keeps more after the packed
# backpointers: the packed words whether or not they flush, then `extra`
def _scratch_words(extra):
    return ("  if (batch <= 0 || make_plan(frames, l_max, &p) != cudaSuccess || !p.flush) "
            "return 0;\n"
            "  return (long long)batch * p.groups * p.gw;",
            "  if (batch <= 0 || make_plan(frames, l_max, &p) != cudaSuccess) return 0;\n"
            f"  return (long long)batch * p.groups * p.gw + {extra};")


_RING = "constexpr int kRing = 2;"
_CTC_FWD_K = "constexpr int kFwdStatesALane = 1;"
_CTC_BWD_K = "constexpr int kBwdStatesALane = 2;"


def _ctc_producer_warps(warps):
    """The backward with `warps` producer warps in the chain's block that
    write each chunk's weight rows into the ring, in place of the grid-wide
    weight pass and the bulk copies: the ring's slots hand over on "full"
    (the producers' arrivals) and "empty" (the chain's) mbarriers, and the
    chain's barriers become named barrier 1 over its own warps."""
    chain_bar = 'asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory")'
    return [
        ("constexpr int kRingBytes = 128 * 1024;  // the most a ring may take\n",
         "constexpr int kRingBytes = 128 * 1024;  // the most a ring may take\n"
         f"constexpr int kProducerWarps = {warps};\n"),
        ("__launch_bounds__(1024 / K)\nctc_bwd_kernel(", "__launch_bounds__(1024)\nctc_bwd_kernel("),
        ("edges + 2 * p.warps);          // [kBwdRing]\n",
         "edges + 2 * p.warps);          // [kBwdRing]\n  uint64_t* empty = full + kBwdRing;\n"),
        ("    for (int r = 0; r < kBwdRing; ++r) mbar_init(full + r, 1);\n"
         "    fence_barrier_init();\n"
         "    for (int r = 0; r < kBwdRing && r < nchunks; ++r) load_chunk(r);\n"
         "  }\n  __syncthreads();\n",
         "    for (int r = 0; r < kBwdRing; ++r) {\n"
         "      mbar_init(full + r, 32 * kProducerWarps);\n"
         "      mbar_init(empty + r, nthreads);\n    }\n"
         "    fence_barrier_init();\n  }\n  __syncthreads();\n"
         "  if (tid >= nthreads) {\n"
         "    const int* labels = labels_all + (size_t)b * n;\n"
         "    for (int ch = 0; ch < nchunks; ++ch) {\n"
         "      if (ch >= kBwdRing) mbar_wait(empty + ch % kBwdRing, (ch / kBwdRing - 1) & 1);\n"
         "      const int t_hi = t_max - 1 - ch * cf, nf = min(cf, t_hi);\n"
         "      for (int j = 0; j < nf; ++j)\n"
         "        weight_row(alphas + ((size_t)b * t_max + t_hi - nf + j) * s_dim, labels, s_dim,\n"
         "                   p.s_pad, tid - nthreads, 32 * kProducerWarps,\n"
         "                   ring + (ch % kBwdRing) * slot_f + j * row_f);\n"
         "      la::hopper::mbar_arrive(full + ch % kBwdRing);\n"
         "    }\n    return;\n  }\n"),
        ("(ch / kBwdRing) & 1);\n    if (multi) __syncthreads();",
         f"(ch / kBwdRing) & 1);\n    if (multi) {chain_bar};"),
        ("      publish((t - 1) & 1);\n      if (multi) __syncthreads();",
         f"      publish((t - 1) & 1);\n      if (multi) {chain_bar};"),
        ("    sample_sync(multi);\n"
         "    if (tid == 0 && ch + kBwdRing < nchunks) load_chunk(ch + kBwdRing);\n",
         f"    if (multi) {chain_bar}; else __syncwarp();\n"
         "    la::hopper::mbar_arrive(empty + ch % kBwdRing);\n"),
        ("  if (t_max > 1) {", "  if (t_max < 0) {"),
        ("  if ((err = allow_smem(kernel, p.smem)) != cudaSuccess) return err;\n"
         "  kernel<<<batch, 32 * p.warps, p.smem, s>>>(",
         "  if ((err = allow_smem(kernel, p.smem + 8 * kBwdRing)) != cudaSuccess) return err;\n"
         "  kernel<<<batch, 32 * (p.warps + kProducerWarps), p.smem + 8 * kBwdRing, s>>>("),
    ]

_CLOCKS = [
    _scratch_words("4ll * batch"),
    ("  const int live = min(max(num_frames[b], 0), frames);\n",
     "  const int live = min(max(num_frames[b], 0), frames);\n"
     "  const long long clk0 = clock64();\n"),
    ("  const int nl = num_labels[b];\n",
     "  const long long clk1 = clock64();\n  const int nl = num_labels[b];\n"),
    ("  if (tid == 0 && (cur & 1)) {\n",
     "  if (tid == 0) {\n"
     "    uint32_t* clk = scratch + (size_t)batch * p.groups * p.gw + 4 * b;\n"
     "    clk[0] = (uint32_t)(clk1 - clk0);\n"
     "    clk[1] = (uint32_t)(clock64() - clk1);\n"
     "    clk[2] = (uint32_t)live;\n"
     "  }\n"
     "  if (tid == 0 && (cur & 1)) {\n")]

# name -> (source, timed only?, [(text, replacement) or (file, text, replacement), ...])
VARIANTS = {
    "lse_as_built": ("lse.cu", False, []),
    # 128-column tiles: a stage is 48 KB, so rings of 2 to 4 fit (a ring of 1
    # cannot run: a stage is released only once the next one's products are
    # issued)
    "lse_ring_2": ("lse.cu", False, [(_STAGES, "constexpr int kStages = 2; ")]),
    "lse_ring_3": ("lse.cu", False, [(_STAGES, "constexpr int kStages = 3; ")]),
    "lse_one_accumulator": ("lse.cu", False, _ONE_ACCUMULATOR),
    "lse_a_from_smem": ("lse.cu", True, _A_SMEM),
    "lse_no_epilogue": ("lse.cu", True, [
        ("merge_tile(run, m, s, bias, tile * kBN, cols, lane);",
         "m[0] = m[1] = 0.f; s[0] += run[0]; s[1] += run[kBN / 2 - 1];")]),
    # one TF32 product in place of three, w_lo still loaded / not loaded
    "lse_no_lo_products": ("lse.cu", True, _LO_PRODUCTS),
    "lse_no_lo_loads": ("lse.cu", True, _LO_PRODUCTS + [
        ("            tma_load_2d(sm.w_lo[s], &tm_lo, &sm.full[s], c * kBK, tile * kBN);\n", ""),
        ("constexpr int kStageBytes = (kBM + 2 * kBN)", "constexpr int kStageBytes = (kBM + kBN)")]),
    "lse_one_range": ("lse.cu", False, [
        ("const int ranges = plan_ranges(row_tiles, col_tiles, sms);", "const int ranges = 1;")]),
    "lse_16_ranges": ("lse.cu", False, [
        ("const int ranges = plan_ranges(row_tiles, col_tiles, sms);",
         "const int ranges = col_tiles < kMaxRanges ? col_tiles : kMaxRanges;")]),
    # the backward (la_row_lse_bwd): its dh or dw product on 128-column
    # tiles, dh in one K range, one accumulator a tile in its products (the
    # numerics its groups of six repair), without p's epilogue (timed only)
    "bwd_as_built": ("lse.cu", False, []),
    "bwd_dh_n128": ("lse.cu", False, [("constexpr int kDhN = 64; ", "constexpr int kDhN = 128; ")]),
    "bwd_dw_n128": ("lse.cu", False, [("constexpr int kDwN = 64; ", "constexpr int kDwN = 128; ")]),
    "bwd_dh_one_range": ("lse.cu", False, [
        ("  for (int r = 1; r <= cap && r <= stages; ++r) {", "  for (int r = 1; r <= 1; ++r) {")]),
    "bwd_one_accumulator": ("lse.cu", True, [
        ("            add_group(run, acc);\n            if (half == 0) {",
         "            if (half == 0) {"),
        ("\n          issue_half(acc, a_hi[half], a_lo[half], desc_hi, desc_lo, 2 * half, 0);",
         "\n          issue_half(acc, a_hi[half], a_lo[half], desc_hi, desc_lo, 2 * half,\n"
         "                     s > first || half > 0);")]),
    "bwd_no_p_epilogue": ("lse.cu", True, [
        ("        store_p(run, ep, r0, c0, m, n);",
         "        if (run[0] == 1234.5f) ep.p[r0] = run[1];")]),
    # p by ex2.approx of the scaled exponent in place of expf (tried and left
    # out: no gain, p's epilogue is its stores)
    "bwd_p_ex2": ("lse.cu", False, [
        ("gg[i] * expf(run[4 * j + 2 * i] + b0 - lg[i])",
         "gg[i] * ex2_ftz((run[4 * j + 2 * i] + b0 - lg[i]) * kLog2e)"),
        ("gg[i] * expf(run[4 * j + 2 * i + 1] + b1 - lg[i])",
         "gg[i] * ex2_ftz((run[4 * j + 2 * i + 1] + b1 - lg[i]) * kLog2e)")]),
    # rings of 4 stages for the 64-column products (as the 128-column ones)
    "bwd_ring_4": ("lse.cu", False, [("kStages = kTN == 128 ? 4 : 6;", "kStages = 4;")]),
    "mel_as_built": ("mel.cu", False, []),
    # frames a block: 16 (40 KB of shared memory), 64 (148 KB: one block an SM)
    "mel_tile_16": ("mel.cu", False, [("constexpr int kTile = 32; ", "constexpr int kTile = 16; ")]),
    "mel_tile_64": ("mel.cu", False, [("constexpr int kTile = 32; ", "constexpr int kTile = 64; ")]),
    "mel_threads_128": ("mel.cu", False, [("constexpr int kThreads = 256;",
                                           "constexpr int kThreads = 128;")]),
    "mel_no_projection": ("mel.cu", True, [
        ("    for (int j = lo; j < hi; ++j)\n      acc = fmaf(bin_power(sm.z[f], sm.post, j), "
         "__ldg(mel_t + j * n_mels + m), acc);\n", "    acc = sm.z[f][lo].x + hi;\n")]),
    # tried and left out: no gain (as was a power spectrum formed in place
    # from the bin pairs k, 200 - k ahead of the projection)
    "mel_projection_unroll_4": ("mel.cu", False, [
        ("    for (int j = lo; j < hi; ++j)\n      acc = fmaf(bin_power(",
         "#pragma unroll 4\n    for (int j = lo; j < hi; ++j)\n      acc = fmaf(bin_power(")]),
    "mel_no_transform": ("mel.cu", True, [("    dft8(v);\n", ""), ("    dft25(v);\n", "")]),
    "mel_no_transform_no_projection": ("mel.cu", True, [
        ("    dft8(v);\n", ""), ("    dft25(v);\n", ""),
        ("    for (int j = lo; j < hi; ++j)\n      acc = fmaf(bin_power(sm.z[f], sm.post, j), "
         "__ldg(mel_t + j * n_mels + m), acc);\n", "    acc = sm.z[f][lo].x + hi;\n")]),
    # 32 KB of unused shared memory: two blocks an SM in place of three
    "mel_two_blocks_an_sm": ("mel.cu", False, [
        ("  float x[kSpan]; ", "  float x[kSpan + 8192]; "),
        ("static_assert(3 * (sizeof(Smem) + 1024) <= 228 * 1024 || kTile != 32",
         "static_assert(3 * (sizeof(Smem) + 1024) > 228 * 1024 || kTile != 32")]),
    "viterbi_as_built": ("viterbi.cu", False, []),
    # emissions loaded from device memory inside the chain, no ring
    "viterbi_emissions_global": ("viterbi.cu", False, [
        ("dp[s] = __fadd_rn(val, (s & 1) ? labrow[lab_base + (s >> 1)] : silv);",
         "dp[s] = __fadd_rn(val, ((k0 + s) & 1) ? lab_b[(size_t)t * l_max + min((k0 + s) / 2, "
         "l_max - 1)] : sil_b[t]);"),
        ("    if (r < nchunks) load_chunk(r);\n", ""),
        ("    if (ch + kRing < nchunks) load_chunk(ch + kRing);\n", "")]),
    # a byte a state and step in device memory (after the packed scratch and
    # the clock words), walked from there
    "viterbi_bt_global_bytes": ("viterbi.cu", False, [
        _scratch_words("4ll * batch + ((long long)batch * frames * (2 * l_max + 1) + 3) / 4"),
        ("  uint32_t* scratch_b = scratch + (size_t)b * p.groups * p.gw;\n",
         "  uint32_t* scratch_b = scratch + (size_t)b * p.groups * p.gw;\n"
         "  unsigned char* bt8 = reinterpret_cast<unsigned char*>(\n"
         "      scratch + (size_t)batch * p.groups * p.gw + 4 * batch);\n"),
        ("        v[(2 * s) / 32] |= code << ((2 * s) % 32);",
         "        if (k0 + s < n_states)\n"
         "          bt8[((size_t)b * frames + t) * n_states + k0 + s] = (unsigned char)code;"),
        ("      const int code = static_cast<int>((w >> (bit & 31)) & 3u);",
         "      const int code = bt8[((size_t)b * frames + u + 1) * n_states + cur];")]),
    # at least four warps (128 threads at K = 97, 79 of them past K)
    "viterbi_block_sync_4_warps": ("viterbi.cu", False, [
        ("  q.warps = (k + 32 * q.s - 1) / (32 * q.s);",
         "  q.warps = max(4, (k + 32 * q.s - 1) / (32 * q.s));")]),
    # one warp a sequence where one holds K (S = 4 at K = 97, 16 at K = 257):
    # more states a lane, a one-warp barrier a step
    "viterbi_one_warp": ("viterbi.cu", False, [
        ("  while (q.s < kMaxS && k > 32 * 32 * q.s) q.s *= 2;",
         "  while (q.s < kMaxS && k > 32 * q.s) q.s *= 2;")]),
    "viterbi_ring_1": ("viterbi.cu", False, [(_RING, "constexpr int kRing = 1;")]),
    "viterbi_ring_4": ("viterbi.cu", False, [(_RING, "constexpr int kRing = 4;")]),
    # the forward pass alone: no walk, so no onsets or offsets
    "viterbi_no_walk": ("viterbi.cu", True, [("    if (tid != 0) continue;", "    continue;")]),
    # no emission loads (the ring holds whatever it held) / no backpointer stores
    "viterbi_no_loads": ("viterbi.cu", True, [
        ("    if (r < nchunks) load_chunk(r);\n", ""),
        ("    if (ch + kRing < nchunks) load_chunk(ch + kRing);\n", "")]),
    "viterbi_no_bt_stores": ("viterbi.cu", True, [
        ("        for (int n = 0; n < NW; ++n) bt_s[wi * p.gw + tid * NW + n] = word[n];",
         "        for (int n = 0; n < NW; ++n) if (word[n] == 0xdeadbeefu) bt_s[0] = 0;")]),
    # as built, with clock64 around the forward pass and the walk of each
    # sequence written after the packed scratch (cycles, cycles, live frames)
    "viterbi_phase_clocks": ("viterbi.cu", False, _CLOCKS),
    # the reduced CTC pair: the forward's K = 1 state a lane in four warps
    # at N = 48 (as built) against 2 in two and 4 in one (no block barrier);
    # the backward's K = 2 in two warps against 1 in four and 4 in one
    "ctc_as_built": ("ctc.cu", False, []),
    "ctc_fwd_k2": ("ctc.cu", False, [(_CTC_FWD_K, "constexpr int kFwdStatesALane = 2;")]),
    "ctc_fwd_k4": ("ctc.cu", False, [(_CTC_FWD_K, "constexpr int kFwdStatesALane = 4;")]),
    "ctc_bwd_k1": ("ctc.cu", False, [(_CTC_BWD_K, "constexpr int kBwdStatesALane = 1;")]),
    "ctc_bwd_k4": ("ctc.cu", False, [(_CTC_BWD_K, "constexpr int kBwdStatesALane = 4;")]),
    # the backward's weights by 2 or 4 producer warps of its block, a chunk
    # ahead into the ring, in place of the grid-wide weight pass
    "ctc_producer_warps_2": ("ctc.cu", False, _ctc_producer_warps(2)),
    "ctc_producer_warps_4": ("ctc.cu", False, _ctc_producer_warps(4)),
    # ring depths (forward 3, backward 2 as built; both at 2, both at 3,
    # both at 4) and frames a chunk
    "ctc_rings_2": ("ctc.cu", False, [("constexpr int kFwdRing = 3;", "constexpr int kFwdRing = 2;")]),
    "ctc_rings_3": ("ctc.cu", False, [("constexpr int kBwdRing = 2;", "constexpr int kBwdRing = 3;")]),
    "ctc_rings_4": ("ctc.cu", False, [("constexpr int kFwdRing = 3;", "constexpr int kFwdRing = 4;"),
                                      ("constexpr int kBwdRing = 2;", "constexpr int kBwdRing = 4;")]),
    "ctc_chunk_16": ("ctc.cu", False, [("constexpr int kChunk = 64;",
                                        "constexpr int kChunk = 16;")]),
    "ctc_chunk_32": ("ctc.cu", False, [("constexpr int kChunk = 64;",
                                        "constexpr int kChunk = 32;")]),
    # ex2.approx / lg2.approx in the forward's _lse3 and the weights' sums
    # (adopted only if they hold the tolerances)
    "ctc_fast_math": ("ctc.cu", False, [
        ("(m + logf(expf(a[i] - m) + expf(a1 - m) + expf(a2 - m)));",
         "(m + __logf(__expf(a[i] - m) + __expf(a1 - m) + __expf(a2 - m)));"),
        ("  sum = expf(a0 - m) + expf(a1 - m) + expf(a2 - m);",
         "  sum = __expf(a0 - m) + __expf(a1 - m) + __expf(a2 - m);")]),
    # ablations (timed only): the forward without its alpha stores, without
    # its _lse3 math (a max in its place), without emission loads (the ring
    # holds whatever it held); the backward without its weight pass (the
    # chain on whatever the scratch holds), its d label_lp stores, its
    # d blank_lp partials and reduce
    "ctc_no_alpha_stores": ("ctc.cu", True, [
        ("        if ((stored >> i) & 1) out[i] = a[i];", "        if (a[i] == 1234.5f) out[i] = a[i];")]),
    "ctc_no_lse3_math": ("ctc.cu", True, [
        ("(m + logf(expf(a[i] - m) + expf(a1 - m) + expf(a2 - m)));", "m;")]),
    "ctc_no_emission_loads": ("ctc.cu", True, [
        ("    if (r < nchunks) load_chunk(r);\n", ""),
        ("    if (ch + kFwdRing < nchunks) load_chunk(ch + kFwdRing);\n", "")]),
    "ctc_no_weight_pass": ("ctc.cu", True, [
        ("  if (t_max > 1) {", "  if (t_max < 0) {")]),
    "ctc_no_label_stores": ("ctc.cu", True, [
        ("      if ((stored >> i) & 1) dl[pos[i]] = v;", "      if (v == 1234.5f) dl[pos[i]] = v;")]),
    "ctc_no_blank_reduce": ("ctc.cu", True, [
        ("      *part_out = emit(false);", "      if (emit(false) == 1234.5f) *part_out = 0.f;"),
        ("    for (int j = tid; j < nf; j += nthreads) {\n      const float* r",
         "    for (int j = tid; j < 0; j += nthreads) {\n      const float* r")]),
}
LAUNCHERS = {"lse.cu": "la_row_lse", "mel.cu": "la_log10_mel", "viterbi.cu": "la_viterbi",
             "ctc.cu": "la_ctc_reduced_fwd"}
KERNEL_NAMES = ("row_lse_kernel", "bwd_gemm_kernel", "log10_mel_kernel", "viterbi_kernel",
                "ctc_fwd_kernel", "ctc_bwd_weights_kernel", "ctc_bwd_kernel")
FAMILIES = ("lse", "mel", "viterbi", "bwd", "ctc")


def launcher(name: str) -> str:
    return "la_row_lse_bwd" if name.startswith("bwd_") else LAUNCHERS[VARIANTS[name][0]]


def patched_csrc(name: str, root: str) -> str:
    """A copy of csrc/ under ``root`` with the variant's substitutions
    applied (to its source unless a substitution names another file)."""
    from lyricalignment_tpu_torch.kernels import build

    source, _, subs = VARIANTS[name]
    dst = os.path.join(root, name)
    shutil.copytree(build.CSRC_DIR, dst)
    for sub in subs:
        fname, old, new = sub if len(sub) == 3 else (source,) + tuple(sub)
        path = os.path.join(dst, fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} is not in {fname}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return dst


def compile_variants(names, root):
    """name -> ctypes library with the launcher of the variant's source."""
    from lyricalignment_tpu_torch.kernels import build

    procs = {}
    for name in names:
        source = VARIANTS[name][0]
        csrc = patched_csrc(name, root)
        so = os.path.join(csrc, "variant.so")
        cmd = ([build._nvcc()] + build.ARCH_FLAGS + build.COMMON_FLAGS
               + build.PER_SOURCE_FLAGS.get(source, [])
               + ["-shared", "-I", csrc, "-o", so, os.path.join(csrc, source)])
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        lines, found = out.splitlines(), []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(k in line for k in KERNEL_NAMES):
                found.append(" ".join(x.strip().replace("ptxas info    : ", "")
                                      for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x))
        print(f"[{name}] ptxas: {found}", flush=True)
        lib = ctypes.CDLL(so)
        fn = getattr(lib, launcher(name))
        fn.argtypes = build.SIGNATURES[launcher(name)]
        fn.restype = ctypes.c_int
        if name.startswith("bwd_"):
            lib.la_row_lse_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
            lib.la_row_lse_bwd_scratch_floats.restype = ctypes.c_longlong
            lib.la_row_lse_bwd_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        if VARIANTS[name][0] == "viterbi.cu":
            lib.la_viterbi_scratch_words.argtypes = [ctypes.c_int] * 3
            lib.la_viterbi_scratch_words.restype = ctypes.c_longlong
        if VARIANTS[name][0] == "ctc.cu":
            lib.la_ctc_reduced_bwd.argtypes = build.SIGNATURES["la_ctc_reduced_bwd"]
            lib.la_ctc_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
            lib.la_ctc_bwd_scratch_floats.restype = ctypes.c_longlong
            lib.la_ctc_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def time_lse(libs):
    import torch

    from chip_smoke import C_CTC, time_ms
    from lyricalignment_tpu_torch.ops import viterbi

    g = torch.Generator(device="cuda").manual_seed(0)
    rows, feat = 16 * 1500, 768
    h = torch.randn(rows, feat, device="cuda", generator=g) * 0.5
    s = 1.0 / math.sqrt(feat)
    w = ((torch.rand(C_CTC, feat, device="cuda", generator=g) * 2 - 1) * s)[1:-1]
    b = ((torch.rand(C_CTC, device="cuda", generator=g) * 2 - 1) * s)[1:-1]
    cols = w.shape[0]
    ref = viterbi.row_lse_plain(h, w, b)
    out = torch.empty(rows, device="cuda")
    scratch = torch.empty(cols * feat + 2 * 16 * rows, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ops = 2 * rows * feat * cols
    times = {}
    for rnd in range(2):
        for name, lib in libs.items():
            def call():
                return lib.la_row_lse(h.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                      scratch.data_ptr(), rows, feat, cols, stream)
            out.zero_()
            if call() != 0:
                raise RuntimeError(f"variant {name}: launch refused")
            torch.cuda.synchronize()
            if rnd == 0:
                err = (out - ref).abs().max().item()
                ok = bool(((out - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
                timed_only = VARIANTS[name][1]
                print(f"[{name}] max_abs_err {err:.3e} "
                      f"{'(timed only)' if timed_only else 'OK' if ok else 'FAIL'}", flush=True)
                if not ok and not timed_only:
                    raise AssertionError(f"variant {name} disagrees with row_lse_plain")
            times.setdefault(name, []).append(time_ms(call, reps=5, warmup=1))
    lib_ms = time_ms(lambda: torch.logsumexp(h @ w.T + b, dim=-1), reps=3)
    print(f"[logsumexp(h @ w.T + b)] {lib_ms:.3f} ms")
    if "lse_as_built" in libs:
        # back to back, as no caller runs it: the card's clock and power
        # under a sustained tensor-core load, beside each 10 calls' mean
        lib = libs["lse_as_built"]
        for i in range(8):
            ms = time_ms(lambda: lib.la_row_lse(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                out.data_ptr(), scratch.data_ptr(), rows, feat,
                                                cols, stream), reps=10, warmup=0)
            smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader"], capture_output=True, text=True)
            print(f"[lse_as_built] sustained, calls {10 * i + 1}-{10 * i + 10}: {ms:.3f} ms; "
                  f"{smi.stdout.strip()}")
    for name, ms in times.items():
        print(f"[{name}] ms {[round(x, 3) for x in ms]} -> {ops / min(ms) / 1e9:.1f} TFLOP/s "
              f"of the function's {ops / 1e9:.1f} GFLOP")


def time_mel(libs):
    import torch

    from chip_smoke import time_ms
    from lyricalignment_tpu_torch.ops import mel

    g = torch.Generator(device="cuda").manual_seed(0)
    audio = torch.randn(16, 30 * 16000, device="cuda", generator=g) * 0.1
    padded = mel.reflect_pad(audio).contiguous()
    n_frames, n_mels = audio.shape[1] // 160, 80
    ref = mel.log10_mel_plain(padded, n_frames, n_mels)
    out = torch.empty(ref.shape, device="cuda")  # ref is a transposed view
    tables = mel._fft_constants(padded.device) + mel._constants(padded.device, n_mels)[2:]
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for rnd in range(2):
        for name, lib in libs.items():
            def call():
                return lib.la_log10_mel(padded.data_ptr(), *(t.data_ptr() for t in tables),
                                        out.data_ptr(), 16, padded.shape[1], n_frames, n_mels,
                                        stream)
            out.zero_()
            if call() != 0:
                raise RuntimeError(f"variant {name}: launch refused")
            torch.cuda.synchronize()
            if rnd == 0:
                err = (out - ref).abs().max().item()
                timed_only = VARIANTS[name][1]
                print(f"[{name}] max_abs_err {err:.3e} "
                      f"{'(timed only)' if timed_only else 'OK' if err <= 1e-4 else 'FAIL'}",
                      flush=True)
                if err > 1e-4 and not timed_only:
                    raise AssertionError(f"variant {name} disagrees with log10_mel_plain")
            times.setdefault(name, []).append(time_ms(call, reps=20, warmup=3))
    window = torch.hann_window(400, periodic=True, device="cuda")
    fb = torch.from_numpy(mel.mel_filterbank(n_mels=n_mels)).cuda()

    def stft_mel():
        spec = torch.stft(audio, 400, 160, window=window, center=True, pad_mode="reflect",
                          return_complex=True)[..., :-1]
        return torch.log10(torch.clamp(fb @ spec.abs() ** 2, min=1e-10))

    print(f"[torch.stft + mel] {time_ms(stft_mel, reps=20, warmup=3):.4f} ms")
    for name, ms in times.items():
        print(f"[{name}] ms {[round(x, 4) for x in ms]}")


def time_viterbi(libs):
    """Each variant at the main path's shape (16 x 1500 frames x 48 labels)
    and at 16 x 3000 x 128, exact against viterbi_dp_plain, timed in two
    rounds."""
    import torch

    from chip_smoke import time_ms
    from lyricalignment_tpu_torch.ops import viterbi

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for t, l_max in ((1500, 48), (3000, 128)):
        b = 16
        logp = torch.log_softmax(torch.randn(b, t, l_max + 1, device="cuda", generator=g) * 3, -1)
        lab = logp[..., :l_max].clamp(min=-1000.0).contiguous()
        sil = logp[..., l_max].clamp(min=-1000.0).contiguous()
        labels = torch.randint(2, 400, (b, l_max), device="cuda", generator=g, dtype=torch.int32)
        labels[:, 5] = labels[:, 4]
        nl = torch.full((b,), l_max, dtype=torch.int32, device="cuda")
        nf = torch.full((b,), t, dtype=torch.int32, device="cuda")
        nf[1], nf[3] = t * 4 // 5, 60
        ref = viterbi.viterbi_dp_plain(lab, sil, labels, nl, nf)
        on, off = torch.empty_like(ref[0]), torch.empty_like(ref[1])
        for rnd in range(2):
            for name, lib in libs.items():
                # the variant's scratch (its clock words last, where it has them)
                words = lib.la_viterbi_scratch_words(b, t, l_max)
                scratch = torch.zeros(max(words, 1), dtype=torch.int32, device="cuda")

                def call():
                    return lib.la_viterbi(lab.data_ptr(), sil.data_ptr(), labels.data_ptr(),
                                          nl.data_ptr(), nf.data_ptr(), scratch.data_ptr(),
                                          on.data_ptr(), off.data_ptr(), b, t, l_max, stream)
                if call() != 0:
                    raise RuntimeError(f"variant {name}: launch refused")
                torch.cuda.synchronize()
                if rnd == 0:
                    exact = torch.equal(on, ref[0]) and torch.equal(off, ref[1])
                    timed_only = VARIANTS[name][1]
                    print(f"[{name}] T={t} L={l_max}: "
                          f"{'(timed only)' if timed_only else 'exact' if exact else 'FAIL'}",
                          flush=True)
                    if not exact and not timed_only:
                        raise AssertionError(f"variant {name} disagrees with viterbi_dp_plain")
                    if name == "viterbi_phase_clocks":
                        clk = scratch[words - 4 * b:words].view(b, 4)[:, :3].cpu().tolist()
                        for i, (fwd, walk, live) in enumerate(clk):
                            steps = max(live - 1, 1)
                            print(f"[{name}] T={t} sequence {i}: {live} frames, forward "
                                  f"{fwd} cycles ({fwd / steps:.1f} a step), walk {walk} cycles "
                                  f"({walk / steps:.1f} a step)")
                times.setdefault((name, t), []).append(time_ms(call, reps=10, warmup=2))
    for (name, t), ms in times.items():
        print(f"[{name}] T={t}: ms {[round(x, 4) for x in ms]}")


def time_bwd(libs):
    """Each backward variant at the fused training shape (3000 rows, feat
    768, the CE slice's 21127 columns): dh, dw and db against
    row_lse_bwd_plain in float64 (rel-L2 1e-5), its plan, then timed in two
    rounds beside the chunked cuBLAS routes of chip_smoke.py."""
    import torch

    from chip_smoke import C_CTC, ROWS_FUSED, rel_l2, time_ms
    from lyricalignment_tpu_torch.ops import viterbi

    g = torch.Generator(device="cuda").manual_seed(21)
    rows, feat = ROWS_FUSED, 768
    h = torch.randn(rows, feat, device="cuda", generator=g) * 0.5
    w = (torch.randn(C_CTC, feat, device="cuda", generator=g) * feat ** -0.5)[1:-1]
    b = torch.randn(C_CTC, device="cuda", generator=g)[1:-1]
    gl = torch.randn(rows, device="cuda", generator=g) / rows
    cols = w.shape[0]
    lse = viterbi.row_lse(h, w, b)
    ref = viterbi.row_lse_bwd_plain(h.double(), w.double(), b.double(), lse.double(), gl.double())
    outs = (torch.empty_like(h), torch.empty_like(w), torch.empty_like(b))
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for rnd in range(2):
        for name, lib in libs.items():
            scratch = torch.empty(lib.la_row_lse_bwd_scratch_floats(rows, feat, cols),
                                  device="cuda")

            def call():
                return lib.la_row_lse_bwd(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                                          lse.data_ptr(), gl.data_ptr(),
                                          *(x.data_ptr() for x in outs), scratch.data_ptr(),
                                          rows, feat, cols, stream)
            if call() != 0:
                raise RuntimeError(f"variant {name}: launch refused")
            torch.cuda.synchronize()
            if rnd == 0:
                rels = [rel_l2(x, y) for x, y in zip(outs, ref)]
                ok = max(rels) <= 1e-5
                plan = (ctypes.c_longlong * 7)()
                lib.la_row_lse_bwd_plan(rows, feat, cols, plan)
                timed_only = VARIANTS[name][1]
                print(f"[{name}] rel_l2 dh/dw/db {rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} "
                      f"{'(timed only)' if timed_only else 'OK' if ok else 'FAIL'}; plan (SMs, "
                      f"chunks, chunk, p items, dh ranges, dh items, dw items) {list(plan)}",
                      flush=True)
                if not ok and not timed_only:
                    raise AssertionError(f"variant {name} disagrees with row_lse_bwd_plain")
            times.setdefault(name, []).append(time_ms(call, reps=5, warmup=1))
    ops = 3 * 2.0 * rows * feat * cols
    for name, ms in times.items():
        print(f"[{name}] ms {[round(x, 4) for x in ms]} -> {ops / min(ms) / 1e9:.1f} TFLOP/s "
              f"of the function's {ops / 1e9:.1f} GFLOP")


def time_ctc(libs):
    """Each reduced CTC variant at the fused training shape (B = 2, T =
    1500, N = 48, 24 valid with a repeated pair): the forward against
    ctc_reduced_fwd_plain (NLL and alphas rtol 1e-5), the backward on the
    plain alphas against ctc_reduced_bwd_plain (rel-L2 1e-5), the plan,
    then both timed in two rounds."""
    import torch

    from chip_smoke import N_CTC, N_CTC_VALID, TRAIN_B, TRAIN_T, _ctc_inputs, rel_l2, time_ms
    from lyricalignment_tpu_torch.ops import ctc

    b, t, n = TRAIN_B, TRAIN_T, N_CTC
    blank, label, labels, valid = _ctc_inputs("cuda", b, t, n, ["train", "train"], seed=t)
    ref_nll, ref_alphas = ctc.ctc_reduced_fwd_plain(blank, label, labels, valid)
    gl = torch.ones(b, device="cuda") / N_CTC_VALID
    ref_grads = ctc.ctc_reduced_bwd_plain(ref_alphas, labels, valid, gl)
    nll, alphas = torch.empty_like(ref_nll), torch.empty_like(ref_alphas)
    grads = (torch.empty_like(ref_grads[0]), torch.empty_like(ref_grads[1]))
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for rnd in range(2):
        for name, lib in libs.items():
            scratch = torch.empty(max(lib.la_ctc_bwd_scratch_floats(b, t, n), 1), device="cuda")

            def fwd():
                return lib.la_ctc_reduced_fwd(blank.data_ptr(), label.data_ptr(),
                                              labels.data_ptr(), valid.data_ptr(),
                                              alphas.data_ptr(), nll.data_ptr(), b, t, n, stream)

            def bwd():
                return lib.la_ctc_reduced_bwd(ref_alphas.data_ptr(), labels.data_ptr(),
                                              valid.data_ptr(), gl.data_ptr(), scratch.data_ptr(),
                                              grads[0].data_ptr(), grads[1].data_ptr(), b, t, n,
                                              stream)
            if fwd() != 0 or bwd() != 0:
                raise RuntimeError(f"variant {name}: launch refused")
            torch.cuda.synchronize()
            if rnd == 0:
                nll_rel = ((nll - ref_nll).abs() / ref_nll.abs()).max().item()
                alpha_rel = ((alphas - ref_alphas).abs()
                             / ref_alphas.abs().clamp(min=1)).max().item()
                rels = [rel_l2(x, y) for x, y in zip(grads, ref_grads)]
                ok = nll_rel <= 1e-5 and alpha_rel <= 1e-5 and max(rels) <= 1e-5
                plan = (ctypes.c_int * 11)()
                lib.la_ctc_plan(t, n, plan)
                timed_only = VARIANTS[name][1]
                print(f"[{name}] nll rel {nll_rel:.2e}, alphas rel {alpha_rel:.2e}, rel_l2 "
                      f"d_blank/d_label {rels[0]:.2e}/{rels[1]:.2e} "
                      f"{'(timed only)' if timed_only else 'OK' if ok else 'FAIL'}; plan "
                      f"{dict(zip(ctc.PLAN_FIELDS, plan))}", flush=True)
                if not ok and not timed_only:
                    raise AssertionError(f"variant {name} disagrees with the plain recursions")
            times.setdefault((name, "fwd"), []).append(time_ms(fwd, reps=10, warmup=2))
            times.setdefault((name, "bwd"), []).append(time_ms(bwd, reps=10, warmup=2))
    for (name, part), ms in times.items():
        print(f"[{name}] {part} ms {[round(x, 4) for x in ms]}")


def main(argv) -> int:
    import torch

    families = {f: [n for n in VARIANTS if n.startswith(f + "_")] for f in FAMILIES}
    names = [n for arg in (argv or list(families)) for n in families.get(arg, [arg])]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as root:
        libs = compile_variants(names, root)
        lse = {n: lib for n, lib in libs.items() if n.startswith("lse_")}
        bwd = {n: lib for n, lib in libs.items() if n.startswith("bwd_")}
        mel = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "mel.cu"}
        if lse:
            time_lse(lse)
        if bwd:
            time_bwd(bwd)
        if mel:
            time_mel(mel)
        dp = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "viterbi.cu"}
        if dp:
            time_viterbi(dp)
        pair = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "ctc.cu"}
        if pair:
            time_ctc(pair)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
