// Tiling shared by the encoder attention kernels (attention.cu: forward,
// attention_bwd.cu: dK/dV and dQ). q, k, v, out and their gradients keep
// the callers' [B, T, H, 64] layout, read with row stride H x 64; the row
// statistics (log-sum-exp, delta) are float32 [B, H, T]. Every kernel works
// on 64-row tiles and masks rows past `seq` itself, so T needs no padding.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace la {
namespace attn {

constexpr int kD = 64;        // head width (every Whisper size)
constexpr int kTile = 64;     // queries or keys per tile
constexpr int kLd = kD + 1;   // float row stride: conflict-free column reads
constexpr int kThreads = 256; // float32 kernels: 16 x 16 threads, 4 x 4 tile each

namespace tc {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;              // one 16-row strip each
constexpr int kThreads = 32 * kWarps;
constexpr int kLdh = kD + 8;           // bf16 row stride: 16-byte rows, ldm % 8 == 0
constexpr int kLdf = kTile + 4;        // float row stride: ldm % 4 == 0
static_assert(kTile == 16 * kWarps && kD == kTile, "one stride serves every tile");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 64 rows of 64 bf16 (8 x 16 bytes a row) from rows t0.. of a [.., T, H, 64]
// tensor into shared memory; rows past seq are zero
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t base,
                                          size_t row_stride, int t0, int seq) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < seq) val = *reinterpret_cast<const uint4*>(src + base + t * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = val;
  }
}

// the warp's 16-row strip of a shared tile as four 16 x 16 A operands
__device__ __forceinline__ void load_strip(FragA (&a)[kD / 16], const bf16* tile, int warp) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wmma::load_matrix_sync(a[kk], tile + warp * 16 * kLdh + kk * 16, kLdh);
}

}  // namespace tc

// float32: 64 rows of a [.., T, H, 64] tensor into a [64][kLd] shared tile
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, size_t base,
                                              size_t row_stride, int t0, int seq) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, c = i % kD, t = t0 + r;
    dst[r * kLd + c] = t < seq ? src[base + t * row_stride + c] : 0.f;
  }
}

}  // namespace attn
}  // namespace la
