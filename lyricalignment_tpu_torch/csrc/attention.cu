// Non-causal multi-head self-attention for the Whisper encoder, forward:
// out = softmax(q k^T + bias) v per (batch, head), with q and k already
// scaled by d_h^-0.25, an optional additive key bias, and the softmax
// statistics in float32. Optionally also writes the float32 row
// log-sum-exp (m + log l, [B, H, T]) that the backward kernels
// (attention_bwd.cu) recompute the probabilities from.
//
// Replaces two TPU kernels:
// * lyricalignment_tpu/ops/attention.py:_onepass_kernel (the pad-once
//   serving path, onepass_self_attention: key bias, no LSE);
// * the forward of the library flash attention that
//   lyricalignment_tpu/ops/attention.py:self_attention calls on the
//   training path (jax/experimental/pallas/ops/tpu/flash_attention.py
//   _flash_attention_kernel, which also saves the row statistics l, m for
//   its backward): no bias, LSE written.
// The TPU kept a whole 1536-wide score row in VMEM and did one pass; a
// 64 x 1500 float32 score tile does not fit in 227 KB of shared memory, so
// this kernel streams 64-key tiles of K and V through shared memory with the
// online-softmax recurrence (running row max and sum in float32, accumulator
// rescaled per tile). Keys past `seq` (the ragged last tile) are masked, so
// T = 1500 needs no padding to a multiple of 128 (the library pads to 1536
// and masks with segment ids). q, k, v and out keep the callers'
// [B, T, H, 64] layout, read with row stride H x 64, so no transposes. One
// block per (64-query tile, b x h).
//
// Bound on H100: operations. Per encoder layer at whisper-medium, B = 16,
// H = 16, T = 1500, d_h = 64: 4 x 256 x 1500^2 x 64 = 147 GFLOP of QK^T and
// PV, on bf16 inputs (989 TFLOP/s dense on the tensor cores).
// * bf16 (the main path): tensor cores through WMMA (mma.sync) 16x16x16
//   fragments with float32 accumulators, as the TPU kernel's bf16 MXU dots
//   with f32 accumulation; each of 4 warps owns a 16-query strip. S and the
//   output accumulator are staged through shared memory (WMMA fragments
//   have no row-addressable layout), so shared-memory traffic, not the
//   tensor cores, bounds it; p is rounded to bf16 before P V and the row sum
//   is taken in float32 before that rounding, as on the TPU
//   (attention.py:126-130). A wgmma/TMA version is later work.
// * float32: the CUDA cores, each thread holding a 4 x 4 register tile of
//   scores and of the output (full float32, no TF32).
// The bias and the LSE output are template switches, so the serving
// instantiation (bias, no LSE) runs the same code as before they existed.
#include "attention.cuh"

namespace {

using namespace la::attn;

constexpr int kSmemBytes = (3 * kTile * kLd + kTile * kD) * sizeof(float);

// ---- float32 on the CUDA cores -----------------------------------------

template <bool kBias, bool kLse>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ lse, int seq, int heads) {
  extern __shared__ float smem[];
  float* qs = smem;               // [kTile][kLd]
  float* ks = qs + kTile * kLd;   // [kTile][kLd]
  float* ps = ks + kTile * kLd;   // [kTile][kLd]  probabilities of the tile
  float* vs = ps + kTile * kLd;   // [kTile][kD]

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_f32(qs, q, base, row_stride, q0, seq);

  // rows ty + 16 i, output / key columns tx + 16 j
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
      const int r = i / kD, c = i % kD, t = k0 + r;
      const bool in = t < seq;
      ks[r * kLd + c] = in ? k[base + t * row_stride + c] : 0.f;
      vs[r * kD + c] = in ? v[base + t * row_stride + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < kD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      const float bj = (kBias && t < seq) ? bias[t] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = t < seq ? s[i][j] + bj : -INFINITY;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], la::half_warp_max(mx));  // key 0 is live
      const float scale = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * scale + la::half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= scale;
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kLd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[kk * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[base + t * row_stride + tx + 16 * j] = acc[i][j] * inv;
    if (kLse && tx == 0) lse[(size_t)blockIdx.y * seq + t] = m[i] + logf(l[i]);
  }
}

// ---- bf16 on the tensor cores ------------------------------------------

namespace tcf {

namespace wmma = nvcuda::wmma;
using tc::bf16;
using tc::FragA;
using tc::FragAcc;
using tc::FragBCol;
using tc::FragBRow;
using tc::kLdf;
using tc::kLdh;
using tc::load_strip;
using tc::load_tile;
constexpr int kThreads = tc::kThreads;

constexpr int kSmemBytes = 4 * kTile * kLdh * sizeof(bf16)     // Q, K, V, P
                           + 2 * kTile * kLdf * sizeof(float);  // S, O

template <bool kBias, bool kLse>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, int seq, int heads) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * kLdh;
  bf16* vs = ks + kTile * kLdh;
  bf16* ps = vs + kTile * kLdh;                            // probabilities, bf16
  float* ss = reinterpret_cast<float*>(ps + kTile * kLdh);  // scores
  float* os = ss + kTile * kLdf;                           // output accumulator

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // softmax bookkeeping: lane owns columns 2j + half of row `row`
  const int row = warp * 16 + lane / 2, half = lane % 2;

  load_tile(qs, q, base, row_stride, q0, seq);
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) os[(i / kD) * kLdf + i % kD] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // Q / O ready; the previous tile's K and V consumed
    load_tile(ks, k, base, row_stride, k0, seq);
    load_tile(vs, v, base, row_stride, k0, seq);
    __syncthreads();

    FragA a[kD / 16];
    load_strip(a, qs, warp);
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      FragAcc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBCol kb;
        wmma::load_matrix_sync(kb, ks + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(s, a[kk], kb, s);
      }
      wmma::store_matrix_sync(ss + warp * 16 * kLdf + n * 16, s, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

    float x[kTile / 2], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = 2 * j + half, t = k0 + c;
      x[j] = t < seq ? ss[row * kLdf + c] + (kBias ? bias[t] : 0.f) : -INFINITY;
      mx = fmaxf(mx, x[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // key 0 is live
    const float scale = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const float p = expf(x[j] - m_new);
      ps[row * kLdh + 2 * j + half] = __float2bfloat16_rn(p);
      rs += p;
      os[row * kLdf + 2 * j + half] *= scale;
    }
    l = l * scale + rs + __shfl_xor_sync(0xffffffffu, rs, 1);
    m = m_new;
    __syncwarp();

    load_strip(a, ps, warp);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      FragAcc o;
      float* o_ptr = os + warp * 16 * kLdf + n * 16;
      wmma::load_matrix_sync(o, o_ptr, kLdf, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragBRow vb;
        wmma::load_matrix_sync(vb, vs + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(o, a[kk], vb, o);
      }
      wmma::store_matrix_sync(o_ptr, o, kLdf, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = q0 + row;
  if (t < seq) {
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) {
      const int c = 2 * j + half;
      out[base + t * row_stride + c] = __float2bfloat16_rn(os[row * kLdf + c] / l);
    }
    if (kLse && half == 0) lse[(size_t)blockIdx.y * seq + t] = m + logf(l);
  }
}

}  // namespace tcf

template <bool kBias, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* lse, int batch, int seq, int heads, bool is_bf16, cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  cudaError_t err;
  if (is_bf16) {
    auto kernel = tcf::attention_fwd_kernel<kBias, kLse>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tcf::kSmemBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::kThreads, tcf::kSmemBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), seq, heads);
  } else {
    auto kernel = attention_fwd_kernel<kBias, kLse>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(lse),
        seq, heads);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out [batch, seq, heads, 64] in float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); bias f32[seq] or null (no bias). Serving and evaluation:
// no row statistics.
LA_API int la_bias_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int batch, int seq, int heads, int is_bf16,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bias ? launch<true, false>(q, k, v, bias, out, nullptr, batch, seq, heads, is_bf16, s)
              : launch<false, false>(q, k, v, bias, out, nullptr, batch, seq, heads, is_bf16, s);
}

// As la_bias_attention, and also writes lse f32[batch, heads, seq], the row
// log-sum-exp of the (biased) scores, for the backward kernels.
LA_API int la_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                            void* out, void* lse, int batch, int seq, int heads, int is_bf16,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bias ? launch<true, true>(q, k, v, bias, out, lse, batch, seq, heads, is_bf16, s)
              : launch<false, true>(q, k, v, bias, out, lse, batch, seq, heads, is_bf16, s);
}
