// Non-causal multi-head self-attention with an additive key bias, for the
// Whisper encoder: out = softmax(q k^T + bias) v per (batch, head), with q
// and k already scaled by d_h^-0.25 and the softmax statistics in float32.
//
// Replaces the TPU kernel lyricalignment_tpu/ops/attention.py:_onepass_kernel
// (launched by _onepass_fwd_impl / onepass_self_attention). The TPU kept a
// whole 1536-wide score row in VMEM and did one pass; a 64 x 1500 float32
// score tile does not fit in 227 KB of shared memory, so this kernel streams
// 64-key tiles of K and V through shared memory with the online-softmax
// recurrence (running row max and sum in float32, accumulator rescaled per
// tile). The key bias is added per key; keys past `seq` (the ragged last
// tile) are masked, so T = 1500 needs no padding to a multiple of 128.
// q, k, v and out keep the callers' [B, T, H, 64] layout, read with row
// stride H x 64, so no transposes. One block per (64-query tile, b x h).
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
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head width (every Whisper size)
constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per streamed tile
constexpr int kLd = kD + 1;   // padded shared-memory row: conflict-free columns
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 tile each
constexpr int kSmemBytes = (3 * kBQ * kLd + kBK * kD) * sizeof(float);

// ---- float32 on the CUDA cores -----------------------------------------

__global__ void __launch_bounds__(kThreads)
bias_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, int seq, int heads) {
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;    // [kBK][kLd]
  float* ps = ks + kBK * kLd;    // [kBQ][kLd]  probabilities of the tile
  float* vs = ps + kBQ * kLd;    // [kBK][kD]

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBQ;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int i = threadIdx.x; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, c = i % kD, t = q0 + r;
    qs[r * kLd + c] = t < seq ? q[base + t * row_stride + c] : 0.f;
  }

  // rows ty + 16 i, output / key columns tx + 16 j
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = threadIdx.x; i < kBK * kD; i += kThreads) {
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
      const float bj = t < seq ? bias[t] : 0.f;
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

    for (int kk = 0; kk < kBK; ++kk) {
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
  }
}

// ---- bf16 on the tensor cores ------------------------------------------

namespace tc {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;              // one 16-query strip each
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;       // 64 queries per block
constexpr int kLdh = kD + 8;           // bf16 row stride: 16-byte rows, ldm % 8 == 0
constexpr int kLdf = kBK + 4;          // float row stride: ldm % 4 == 0
constexpr int kSmemBytes = 4 * kBQ * kLdh * sizeof(bf16)   // Q, K, V, P
                           + 2 * kBQ * kLdf * sizeof(float);  // S, O
static_assert(kBK == kBQ && kD == kBK, "one stride serves Q, K, V, P, S and O");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t base,
                                          size_t row_stride, int t0, int seq) {
  // 64 rows of 64 bf16 = 8 x 16 bytes a row; rows past seq are zero
  for (int i = threadIdx.x; i < kBK * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < seq) val = *reinterpret_cast<const uint4*>(src + base + t * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
bias_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ out, int seq, int heads) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * kLdh;
  bf16* vs = ks + kBK * kLdh;
  bf16* ps = vs + kBK * kLdh;                         // probabilities, bf16
  float* ss = reinterpret_cast<float*>(ps + kBQ * kLdh);  // scores
  float* os = ss + kBQ * kLdf;                        // output accumulator

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBQ;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // softmax bookkeeping: lane owns columns 2j + half of row `row`
  const int row = warp * 16 + lane / 2, half = lane % 2;

  load_tile(qs, q, base, row_stride, q0, seq);
  for (int i = threadIdx.x; i < kBQ * kD; i += kThreads) os[(i / kD) * kLdf + i % kD] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();  // Q / O ready; the previous tile's K and V consumed
    load_tile(ks, k, base, row_stride, k0, seq);
    load_tile(vs, v, base, row_stride, k0, seq);
    __syncthreads();

    FragA a[kD / 16];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wmma::load_matrix_sync(a[kk], qs + warp * 16 * kLdh + kk * 16, kLdh);
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      FragAcc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(s, a[kk], kb, s);
      }
      wmma::store_matrix_sync(ss + warp * 16 * kLdf + n * 16, s, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

    float x[kBK / 2], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int c = 2 * j + half, t = k0 + c;
      x[j] = t < seq ? ss[row * kLdf + c] + bias[t] : -INFINITY;
      mx = fmaxf(mx, x[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // key 0 is live
    const float scale = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const float p = expf(x[j] - m_new);
      ps[row * kLdh + 2 * j + half] = __float2bfloat16_rn(p);
      rs += p;
      os[row * kLdf + 2 * j + half] *= scale;
    }
    l = l * scale + rs + __shfl_xor_sync(0xffffffffu, rs, 1);
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wmma::load_matrix_sync(a[kk], ps + warp * 16 * kLdh + kk * 16, kLdh);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      FragAcc o;
      float* o_ptr = os + warp * 16 * kLdf + n * 16;
      wmma::load_matrix_sync(o, o_ptr, kLdf, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
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
  }
}

}  // namespace tc

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int batch, int seq, int heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tc::bias_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + tc::kBQ - 1) / tc::kBQ, batch * heads);
  tc::bias_attention_kernel<<<grid, tc::kThreads, tc::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), seq, heads);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias,
                       void* out, int batch, int seq, int heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bias_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  bias_attention_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), seq, heads);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out [batch, seq, heads, 64] in float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); bias f32[seq]
LA_API int la_bias_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int batch, int seq, int heads, int is_bf16,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(q, k, v, bias, out, batch, seq, heads, s)
                 : launch_f32(q, k, v, bias, out, batch, seq, heads, s);
}
