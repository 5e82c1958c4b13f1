// Streaming row log-sum-exp of a linear layer's logits:
// out[r] = log sum_c exp(h[r] . w[c] + b[c]), without writing the
// [rows, cols] logits anywhere.
//
// Replaces the TPU kernel lyricalignment_tpu/ops/viterbi.py:_lse_kernel
// (launched by _chunked_lse_pallas): the class normaliser of the fused
// CE/CTC emissions. The TPU carried the running (max, sum) across a
// sequential grid axis of column blocks; here blocks run in parallel, so the
// column loop lives inside the block: one block per 64-row tile of h walks
// all 128-column tiles of w, merging each tile's row max and exp-sum into a
// running (m, s) and writing m + log(s) at the end. w is nn.Linear's
// [cols, feat] weight, so each logit is a dot of two rows that are both
// contiguous along feat; the feat loop is staged through shared memory in
// chunks of 32. Columns past `cols` contribute exactly 0 (the NEG_INF bias
// pad of viterbi.py:314-316), and the CTC slice w[1:-1] is taken by the
// caller's pointer offset and count, with no copy.
//
// Bound on H100: operations. At the main path (B = 16 x 1500 rows,
// feat 768, 21127 columns) that is 2 x 24000 x 768 x 21127 = 779 GFLOP in
// full float32 (no TF32, viterbi.py:283): 11.6 ms at the 67 TFLOP/s of the
// CUDA cores. The design keeps those cores fed: a block covers 64 rows and
// streams 128-column tiles, each of its 128 threads holds an 8 x 8 register
// tile of logits, and every step over feat costs four 16-byte shared loads
// for 64 FMAs (h and w are staged feat-major in shared memory). A tensor
// core split (3xTF32 or bf16x3) is later work.
#include "common.cuh"

namespace {

constexpr int kBR = 64;                // rows of h per block
constexpr int kBC = 128;               // columns of w per tile
constexpr int kBF = 32;                // feat chunk staged in shared memory
constexpr int kTX = 16, kTY = 8;
constexpr int kThreads = kTX * kTY;    // 128 threads, 8 x 8 logits each

// thread (ty, tx) owns rows ty*4 + {0..3} and 32 + ty*4 + {0..3}, columns
// tx*4 + {0..3} and 64 + tx*4 + {0..3} of the tile: 16-byte shared loads
// that are conflict-free (columns) or broadcast (rows)
__device__ __forceinline__ int row_of(int ty, int i) { return (i < 4 ? 0 : 32) + ty * 4 + (i & 3); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

// stage rows [first, first + n) x feat [f0, f0 + kBF) of a [*, feat] matrix
// feat-major into dst[kBF][n]; rows past `limit` and feat past `feat` are 0
template <int n>
__device__ __forceinline__ void stage(float (*dst)[n], const float* __restrict__ src,
                                      int first, int limit, int f0, int feat) {
  for (int i = threadIdx.x; i < n * (kBF / 4); i += kThreads) {
    const int r = i % n, f = (i / n) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < limit && f0 + f < feat)
      v = *reinterpret_cast<const float4*>(src + (size_t)(first + r) * feat + f0 + f);
    dst[f][r] = v.x;
    dst[f + 1][r] = v.y;
    dst[f + 2][r] = v.z;
    dst[f + 3][r] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads)
row_lse_kernel(const float* __restrict__ h, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out, int rows,
               int feat, int cols) {
  __shared__ __align__(16) float hs[kBF][kBR];
  __shared__ __align__(16) float ws[kBF][kBC];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int r0 = blockIdx.x * kBR;

  float m[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }

  for (int c0 = 0; c0 < cols; c0 += kBC) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int f0 = 0; f0 < feat; f0 += kBF) {
      __syncthreads();
      stage<kBR>(hs, h, r0, rows, f0, feat);
      stage<kBC>(ws, w, c0, cols, f0, feat);
      __syncthreads();
#pragma unroll
      for (int f = 0; f < kBF; ++f) {
        const float4 h0 = *reinterpret_cast<const float4*>(&hs[f][ty * 4]);
        const float4 h1 = *reinterpret_cast<const float4*>(&hs[f][32 + ty * 4]);
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[f][tx * 4]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[f][64 + tx * 4]);
        const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
    }

    float bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + col_of(tx, j);
      bj[j] = c < cols ? bias[c] : -INFINITY;
    }
    // merge the tile into the running (m, s) of each row; the 16 lanes
    // sharing a row are one half-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x[8], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = acc[i][j] + bj[j];
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[i], la::half_warp_max(mx));  // column c0 is live
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) e += expf(x[j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + la::half_warp_sum(e);
      m[i] = m_new;
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + row_of(ty, i);
      if (r < rows) out[r] = m[i] + logf(s[i]);
    }
  }
}

}  // namespace

// h f32[rows, feat]; w f32 rows [cols, feat] and b f32[cols] point at the
// first column of the slice; out f32[rows]. feat % 4 == 0 and h, w 16-byte
// aligned (the wrapper checks).
LA_API int la_row_lse(const void* h, const void* w, const void* b, void* out, int rows,
                      int feat, int cols, void* stream) {
  if (rows <= 0) return cudaSuccess;
  row_lse_kernel<<<(rows + kBR - 1) / kBR, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), rows, feat, cols);
  return cudaGetLastError();
}
