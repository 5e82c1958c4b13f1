// Backward of the encoder self-attention (attention.cu): given q, k, v, the
// output gradient dO, the forward's float32 row log-sum-exp L and
// delta = rowsum(O * dO) (float32, [B, H, T]), and the optional additive key
// bias b, with P = exp(q k^T + b - L) the forward's probabilities:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  dK = dS^T Q,  dQ = dS K.
//
// Replaces the backward of the library flash attention that
// lyricalignment_tpu/ops/attention.py:self_attention runs on the TPU
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
// * attention_dkdv_kernel <- _flash_attention_dkv_kernel: one block per
//   (64-key tile, b x h) loops over the query tiles, recomputes S and P from
//   the saved L and accumulates dK and dV of its keys in registers;
// * attention_dq_kernel <- _flash_attention_dq_kernel: one block per
//   (64-query tile, b x h) loops over the key tiles and accumulates dQ.
// The library splits dK/dV from dQ the same way. Every output element is
// owned by one block, so there are no atomics and the gradients are
// bit-reproducible from run to run. The TPU carried dK/dV (and dQ) in VMEM
// scratch across a sequential grid axis; blocks here run in parallel, so
// that axis is a loop inside the block. Rows past `seq` (the ragged last
// tile) are masked: they get zero probability and are never written, so
// T = 1500 is not padded. Masked keys (bias -1e9) get zero probability and
// so zero gradient.
//
// Bound on H100: operations. 5 products of 2 B H T^2 d_h each (S recomputed
// twice, once per kernel, as the library does; dV, dP and dK in dK/dV, dP
// and dQ in dQ): per layer at whisper-medium training, B = 2, H = 16,
// T = 1500, 46 GFLOP of bf16 products at 989 TFLOP/s = 0.047 ms.
// * bf16: WMMA 16x16x16 fragments with float32 accumulators; P and dS are
//   rounded to bf16 before their products, as the library rounds them
//   (flash_attention.py:900, :918, :1258). S and dP are staged through shared
//   memory (WMMA fragments have no row-addressable layout); the dK, dV and dQ
//   accumulators stay in registers across the whole loop.
// * float32: the CUDA cores, 4 x 4 register tiles per thread (no TF32).
// A wgmma/TMA version is later work.
#include "attention.cuh"

namespace {

using namespace la::attn;

// ---- float32 on the CUDA cores -----------------------------------------

constexpr int kSmemDkv = (6 * kTile * kLd + 2 * kTile) * sizeof(float);
constexpr int kSmemDq = (5 * kTile * kLd + kTile) * sizeof(float);

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ bias, float* __restrict__ dk,
                      float* __restrict__ dv, int seq, int heads) {
  extern __shared__ float smem[];
  float* ks = smem;                // [kTile][kLd] this block's keys
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;    // the current query tile
  float* dos = qs + kTile * kLd;
  float* pt = dos + kTile * kLd;   // P^T  [key][query]
  float* dst = pt + kTile * kLd;   // dS^T [key][query]
  float* lse_s = dst + kTile * kLd;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const size_t stat = (size_t)blockIdx.y * seq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_f32(ks, k, base, row_stride, k0, seq);
  load_tile_f32(vs, v, base, row_stride, k0, seq);
  // this thread's keys ty + 16 i
  float kb[4];
  bool key_live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    key_live[i] = key < seq;
    kb[i] = (kBias && key_live[i]) ? bias[key] : 0.f;
  }
  // dK / dV of keys ty + 16 i at head columns tx + 16 j
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile_f32(qs, q, base, row_stride, q0, seq);
    load_tile_f32(dos, dout, base, row_stride, q0, seq);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < seq;
      lse_s[i] = in ? lse[stat + q0 + i] : 0.f;
      delta_s[i] = in ? delta[stat + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for keys ty + 16 i, queries tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < kD; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * kLd + d];
        vv[i] = vs[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * kLd + d];
        ov[j] = dos[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (key_live[i] && q0 + c < seq) ? expf(s[i][j] + kb[i] - lse_s[c]) : 0.f;
        pt[(ty + 16 * i) * kLd + c] = p;
        dst[(ty + 16 * i) * kLd + c] = p * (dp[i][j] - delta_s[c]);
      }
    __syncthreads();

    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], sv[4], ov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty + 16 * i) * kLd + qq];
        sv[i] = dst[(ty + 16 * i) * kLd + qq];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ov[j] = dos[qq * kLd + tx + 16 * j];
        qv[j] = qs[qq * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
          dka[i][j] = fmaf(sv[i], qv[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!key_live[i]) continue;
    const size_t r = base + (size_t)(k0 + ty + 16 * i) * row_stride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[r + tx + 16 * j] = dka[i][j];
      dv[r + tx + 16 * j] = dva[i][j];
    }
  }
}

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ bias, float* __restrict__ dq, int seq,
                    int heads) {
  extern __shared__ float smem[];
  float* qs = smem;                // [kTile][kLd] this block's queries
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;   // the current key tile
  float* vs = ks + kTile * kLd;
  float* dss = vs + kTile * kLd;   // dS [query][key]
  float* bias_s = dss + kTile * kLd;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const size_t stat = (size_t)blockIdx.y * seq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_f32(qs, q, base, row_stride, q0, seq);
  load_tile_f32(dos, dout, base, row_stride, q0, seq);
  // this thread's queries ty + 16 i
  float row_lse[4], row_delta[4];
  bool q_live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    q_live[i] = t < seq;
    row_lse[i] = q_live[i] ? lse[stat + t] : 0.f;
    row_delta[i] = q_live[i] ? delta[stat + t] : 0.f;
  }
  float dqa[4][4];  // queries ty + 16 i, head columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[i][j] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_tile_f32(ks, k, base, row_stride, k0, seq);
    load_tile_f32(vs, v, base, row_stride, k0, seq);
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      bias_s[i] = (kBias && k0 + i < seq) ? bias[k0 + i] : 0.f;
    __syncthreads();

    // S and dP for queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < kD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * kLd + d];
        ov[i] = dos[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * kLd + d];
        vv[j] = vs[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (q_live[i] && k0 + c < seq) ? expf(s[i][j] + bias_s[c] - row_lse[i]) : 0.f;
        dss[(ty + 16 * i) * kLd + c] = p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float sv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty + 16 * i) * kLd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dqa[i][j] = fmaf(sv[i], kv[j], dqa[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!q_live[i]) continue;
    const size_t r = base + (size_t)(q0 + ty + 16 * i) * row_stride;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[r + tx + 16 * j] = dqa[i][j];
  }
}

// ---- bf16 on the tensor cores ------------------------------------------

namespace tcb {

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

constexpr int kSmemDkv = 6 * kTile * kLdh * sizeof(bf16)     // K, V, Q, dO, P^T, dS^T
                         + 2 * kTile * kLdf * sizeof(float)   // S^T, dP^T
                         + 2 * kTile * sizeof(float);         // L, delta of the query tile
constexpr int kSmemDq = 5 * kTile * kLdh * sizeof(bf16)      // Q, dO, K, V, dS
                        + 2 * kTile * kLdf * sizeof(float)    // S, dP
                        + kTile * sizeof(float);              // bias of the key tile

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ bias, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int seq, int heads) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // this block's keys
  bf16* vs = ks + kTile * kLdh;
  bf16* qs = vs + kTile * kLdh;                  // the current query tile
  bf16* dos = qs + kTile * kLdh;
  bf16* pt = dos + kTile * kLdh;                 // P^T  [key][query], bf16
  bf16* dst = pt + kTile * kLdh;                 // dS^T [key][query], bf16
  float* st = reinterpret_cast<float*>(dst + kTile * kLdh);  // S^T
  float* dpt = st + kTile * kLdf;                            // dP^T
  float* lse_s = dpt + kTile * kLdf;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const size_t stat = (size_t)blockIdx.y * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // elementwise work: lane owns columns 2j + half of key row `row`
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const int key = k0 + row;
  const bool key_live = key < seq;
  const float key_bias = (kBias && key_live) ? bias[key] : 0.f;

  load_tile(ks, k, base, row_stride, k0, seq);
  load_tile(vs, v, base, row_stride, k0, seq);
  __syncthreads();
  FragA ka[kD / 16], va[kD / 16];  // the warp's 16 keys, for S^T and dP^T
  load_strip(ka, ks, warp);
  load_strip(va, vs, warp);
  FragAcc dka[kD / 16], dva[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::fill_fragment(dka[n], 0.f);
    wmma::fill_fragment(dva[n], 0.f);
  }

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(qs, q, base, row_stride, q0, seq);
    load_tile(dos, dout, base, row_stride, q0, seq);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < seq;
      lse_s[i] = in ? lse[stat + q0 + i] : 0.f;
      delta_s[i] = in ? delta[stat + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 64 queries
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      FragAcc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBCol qb, ob;
        wmma::load_matrix_sync(qb, qs + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(s, ka[kk], qb, s);
        wmma::load_matrix_sync(ob, dos + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(dp, va[kk], ob, dp);
      }
      wmma::store_matrix_sync(st + warp * 16 * kLdf + n * 16, s, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(dpt + warp * 16 * kLdf + n * 16, dp, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = 2 * j + half;
      const float p = (key_live && q0 + c < seq)
                          ? expf(st[row * kLdf + c] + key_bias - lse_s[c]) : 0.f;
      pt[row * kLdh + c] = __float2bfloat16_rn(p);
      dst[row * kLdh + c] = __float2bfloat16_rn(p * (dpt[row * kLdf + c] - delta_s[c]));
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q over this query tile
    FragA pa[kTile / 16], sa[kTile / 16];
    load_strip(pa, pt, warp);
    load_strip(sa, dst, warp);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragBRow ob, qb;
        wmma::load_matrix_sync(ob, dos + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dva[n], pa[kk], ob, dva[n]);
        wmma::load_matrix_sync(qb, qs + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dka[n], sa[kk], qb, dka[n]);
      }
    }
  }

  // stage the warp's 16 rows of dK and dV through its rows of S^T and dP^T
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::store_matrix_sync(st + warp * 16 * kLdf + n * 16, dka[n], kLdf, wmma::mem_row_major);
    wmma::store_matrix_sync(dpt + warp * 16 * kLdf + n * 16, dva[n], kLdf, wmma::mem_row_major);
  }
  __syncwarp();
  if (key_live) {
    const size_t r = base + (size_t)key * row_stride;
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) {
      const int c = 2 * j + half;
      dk[r + c] = __float2bfloat16_rn(st[row * kLdf + c]);
      dv[r + c] = __float2bfloat16_rn(dpt[row * kLdf + c]);
    }
  }
}

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ bias, bf16* __restrict__ dq, int seq,
                    int heads) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // this block's queries
  bf16* dos = qs + kTile * kLdh;
  bf16* ks = dos + kTile * kLdh;                 // the current key tile
  bf16* vs = ks + kTile * kLdh;
  bf16* dss = vs + kTile * kLdh;                 // dS [query][key], bf16
  float* ss = reinterpret_cast<float*>(dss + kTile * kLdh);  // S
  float* dps = ss + kTile * kLdf;                            // dP
  float* bias_s = dps + kTile * kLdf;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * kD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // elementwise work: lane owns columns 2j + half of query row `row`
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const int t = q0 + row;
  const bool q_live = t < seq;
  const size_t stat = (size_t)blockIdx.y * seq + t;
  const float row_lse = q_live ? lse[stat] : 0.f;
  const float row_delta = q_live ? delta[stat] : 0.f;

  load_tile(qs, q, base, row_stride, q0, seq);
  load_tile(dos, dout, base, row_stride, q0, seq);
  __syncthreads();
  FragA qa[kD / 16], oa[kD / 16];  // the warp's 16 queries, for S and dP
  load_strip(qa, qs, warp);
  load_strip(oa, dos, warp);
  FragAcc dqa[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(dqa[n], 0.f);

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_tile(ks, k, base, row_stride, k0, seq);
    load_tile(vs, v, base, row_stride, k0, seq);
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      bias_s[i] = (kBias && k0 + i < seq) ? bias[k0 + i] : 0.f;
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 queries x 64 keys
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      FragAcc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBCol kb, vb;
        wmma::load_matrix_sync(kb, ks + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(s, qa[kk], kb, s);
        wmma::load_matrix_sync(vb, vs + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(dp, oa[kk], vb, dp);
      }
      wmma::store_matrix_sync(ss + warp * 16 * kLdf + n * 16, s, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(dps + warp * 16 * kLdf + n * 16, dp, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = 2 * j + half;
      const float p = (q_live && k0 + c < seq)
                          ? expf(ss[row * kLdf + c] + bias_s[c] - row_lse) : 0.f;
      dss[row * kLdh + c] = __float2bfloat16_rn(p * (dps[row * kLdf + c] - row_delta));
    }
    __syncwarp();

    // dQ += dS K over this key tile
    FragA sa[kTile / 16];
    load_strip(sa, dss, warp);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragBRow kb;
        wmma::load_matrix_sync(kb, ks + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dqa[n], sa[kk], kb, dqa[n]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kD / 16; ++n)
    wmma::store_matrix_sync(ss + warp * 16 * kLdf + n * 16, dqa[n], kLdf, wmma::mem_row_major);
  __syncwarp();
  if (q_live) {
    const size_t r = base + (size_t)t * row_stride;
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) {
      const int c = 2 * j + half;
      dq[r + c] = __float2bfloat16_rn(ss[row * kLdf + c]);
    }
  }
}

}  // namespace tcb

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool kBias>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* bias, void* dk,
                        void* dv, int batch, int seq, int heads, bool is_bf16,
                        cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  const auto* L = static_cast<const float*>(lse);
  const auto* D = static_cast<const float*>(delta);
  const auto* B = static_cast<const float*>(bias);
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    auto kernel = tcb::attention_dkdv_kernel<kBias>;
    if ((err = allow_smem(kernel, tcb::kSmemDkv)) != cudaSuccess) return err;
    kernel<<<grid, tcb::kThreads, tcb::kSmemDkv, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), L, D, B, static_cast<T*>(dk), static_cast<T*>(dv), seq,
        heads);
  } else {
    auto kernel = attention_dkdv_kernel<kBias>;
    if ((err = allow_smem(kernel, kSmemDkv)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmemDkv, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), L, D, B,
        static_cast<float*>(dk), static_cast<float*>(dv), seq, heads);
  }
  return cudaGetLastError();
}

template <bool kBias>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* bias, void* dq,
                      int batch, int seq, int heads, bool is_bf16, cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  const auto* L = static_cast<const float*>(lse);
  const auto* D = static_cast<const float*>(delta);
  const auto* B = static_cast<const float*>(bias);
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    auto kernel = tcb::attention_dq_kernel<kBias>;
    if ((err = allow_smem(kernel, tcb::kSmemDq)) != cudaSuccess) return err;
    kernel<<<grid, tcb::kThreads, tcb::kSmemDq, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), L, D, B, static_cast<T*>(dq), seq, heads);
  } else {
    auto kernel = attention_dq_kernel<kBias>;
    if ((err = allow_smem(kernel, kSmemDq)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmemDq, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), L, D, B,
        static_cast<float*>(dq), seq, heads);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv [batch, seq, heads, 64] in float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); lse, delta f32[batch, heads, seq]; bias f32[seq]
// or null
LA_API int la_attention_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* bias, void* dk,
                             void* dv, int batch, int seq, int heads, int is_bf16,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bias ? launch_dkdv<true>(q, k, v, dout, lse, delta, bias, dk, dv, batch, seq, heads,
                                  is_bf16, s)
              : launch_dkdv<false>(q, k, v, dout, lse, delta, bias, dk, dv, batch, seq, heads,
                                   is_bf16, s);
}

// as la_attention_dkdv, writing dq [batch, seq, heads, 64]
LA_API int la_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* bias, void* dq,
                           int batch, int seq, int heads, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bias ? launch_dq<true>(q, k, v, dout, lse, delta, bias, dq, batch, seq, heads,
                                is_bf16, s)
              : launch_dq<false>(q, k, v, dout, lse, delta, bias, dq, batch, seq, heads,
                                 is_bf16, s);
}
