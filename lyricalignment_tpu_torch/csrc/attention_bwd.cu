// Backward of the encoder self-attention (attention.cu): given q, k, v, the
// output gradient dO, the forward's float32 row log-sum-exp L and
// delta = rowsum(O * dO) (float32, [B, H, T]), and the optional additive key
// bias b, with P = exp(q k^T + b - L) the forward's probabilities:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  dK = dS^T Q,  dQ = dS K.
//
// Replaces the backward of the library flash attention that
// lyricalignment_tpu/ops/attention.py:self_attention runs on the TPU
// (jax/experimental/pallas/ops/tpu/flash_attention.py), and the gradient of
// lyricalignment_tpu/ops/attention.py:onepass_self_attention when a key bias
// is given:
// * attention_dkdv_kernel <- _flash_attention_dkv_kernel: a block owns a tile
//   of keys, loops over the query tiles, recomputes P from the saved L and
//   accumulates dK and dV of its keys in registers;
// * attention_dq_kernel <- _flash_attention_dq_kernel: a block owns a tile of
//   queries, loops over the key tiles and accumulates dQ.
// The library splits dK/dV from dQ the same way. Every output element is
// owned by one block, so there are no atomics and the gradients are
// bit-reproducible from run to run. The TPU carried dK/dV (and dQ) in VMEM
// scratch across a sequential grid axis; blocks here run in parallel, so
// that axis is a loop inside the block. Rows past `seq` (the ragged last
// tile) get zero probability and are never written, so T = 1500 is not
// padded. Masked keys (bias -1e9) get zero probability and so zero gradient.
//
// Bound on H100: operations. dK/dV does 4 products of 2 B H T^2 d_h (S, dP,
// dV, dK), dQ does 3 (S and dP again, as the library does, and dQ): per layer
// at whisper-medium training, B = 2, H = 16, T = 1500, 36.9 and 27.6 GFLOP of
// bf16 products, 0.0373 and 0.0280 ms at 989 TFLOP/s, against 11 and 9 MB of
// tensors (0.003 ms at 3.35 TB/s). Beside the products each score costs one
// exp2 on the 16-a-clock MUFU unit and three float32 operations.
//
// * bf16 (the main path), written for sm_90a from the forward's pieces
//   (hopper.cuh): persistent grids of one block per SM, each a producer
//   warpgroup and consumer warpgroups of 64 rows of the block's own tile,
//   walking work items of (64 rows a consumer, b x h) in steps of the grid;
//   consecutive items share b x h, so the streamed tiles are read from L2 by
//   neighbouring SMs. The producer hands its registers to the consumers
//   (setmaxnreg). S, dP, P and dS never leave the registers: they are formed
//   on the wgmma accumulator fragments and go from there, rounded to bf16,
//   into the register A operand of the next product. All products are wgmma
//   m64n64k16 with A in registers and B in shared memory: with both operands
//   in shared memory a 64-column product reads as many bytes from it a clock
//   as the memory delivers (dK/dV took 0.099 ms that way against 0.079 ms at
//   the training shape on an H100 SXM at 700 W). So the
//   block's own rows are register A operands too, loaded from device memory
//   once an item (32 registers a thread), and only the ring's tiles, written
//   by TMA (tensor maps over {64, H, T, B}, 128-byte swizzle, completion on
//   mbarriers, rows past T as zeros), go through shared memory.
//   - dK/dV (two consumers, setmaxnreg 40 / 232) works on the transposed
//     scores. The producer's first warp keeps a ring of Q and dO tiles of 64
//     queries in flight and puts the queries' -L log2(e) and delta beside
//     each tile with ordinary loads, one tile ahead in registers (a row of
//     [B, H, T] statistics is 16-byte aligned only for some T, so TMA cannot
//     take it), with L = +inf past T: those columns get p = 0 with no
//     masking in the consumers. A consumer holds K and V of its 64 keys and
//     computes S^T = K Q^T and dP^T = V dO^T with the tile [query][d] read
//     K-major. In that fragment a thread's rows are two keys (two bias
//     values) and its columns queries (L and delta read from shared memory
//     by column). P^T = ex2(S^T log2e + (b - L) log2e) and dS^T = P^T (dP^T
//     - delta), packed to bf16, are the A operands of dV += P^T dO and dK +=
//     dS^T Q, with the same dO and Q tiles read MN-major (the transpose
//     flag). The wait for a tile's dV and dK is deferred to the next tile's
//     S^T, so the tensor cores' queue does not drain between tiles. dK and
//     dV stay in registers over the whole query loop and are rounded and
//     stored once.
//   - dQ (three consumers, setmaxnreg 24 / 160) is the forward's loop with
//     one more product: a consumer holds Q and dO of its 64 queries, one
//     producer thread keeps a ring of K, V and key-bias tiles of 64 keys in
//     flight; S = Q K^T and dP = dO V^T read the tiles K-major; L and delta
//     are two values a thread; dS packed to bf16 is the A operand of dQ +=
//     dS K with K read MN-major. Keys past T are masked on the ragged last
//     tile only.
//   Registers set the shapes: dK/dV holds 4 x 32 accumulator registers a
//   thread, 2 x 16 of K and V and 2 x 16 of packed operands, which needs the
//   232 of two consumers; dQ holds 3 x 32 + 2 x 16 + 16 and fits three
//   consumers at 160, whose third warpgroup hides more of the elementwise
//   step.
// * float32: the CUDA cores, 4 x 4 register tiles per thread (no TF32), on
//   64-row tiles, one block per (tile, b x h).
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

// ---- bf16 on Hopper: TMA rings, wgmma, scores in registers ----------------

namespace hb {

using namespace la::hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows of a streamed tile (queries in dK/dV, keys in dQ): 64 or 128
constexpr float kLog2e = 1.4426950408889634f;

// The shape of one kernel: consumer warpgroups of 64 rows of the block's own
// tile each behind one producer warpgroup, the registers a thread once the
// producer has handed its own over, and the tiles in the ring
template <int kConsumers_, int kProducerRegs_, int kConsumerRegs_, int kStages_>
struct Shape {
  static constexpr int kConsumers = kConsumers_;
  static constexpr int kBlockRows = 64 * kConsumers_;  // keys (dK/dV) or queries (dQ) a block
  static constexpr int kThreads = 128 * (kConsumers_ + 1);  // warpgroup 0: the producer
  static constexpr int kProducerRegs = kProducerRegs_, kConsumerRegs = kConsumerRegs_;
  static constexpr int kStages = kStages_;
  static_assert(128 * (kProducerRegs_ + kConsumers_ * kConsumerRegs_) <= 65536, "register file");
  static_assert(kStages_ >= 2, "dK/dV releases a tile's stage while the next tile is in use");
};
using DkdvShape = Shape<2, 40, 232, 4>;
using DqShape = Shape<3, 24, 160, 4>;

// the warpgroup's 64 rows t0 .. t0 + 63 of x [B, T, H, 64] as the register A
// operand of a product along d_h, read from device memory once a work item:
// fragment kk holds columns 16 kk .. 16 kk + 15 of this thread's rows r and
// r + 8 (pairs at columns c and c + 8); rows past seq are zero
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[kD / 16][4], const bf16* x, int b,
                                            int h, int t0, int seq, int heads, int r, int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + r + 8 * i;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(x + (((size_t)b * seq + t) * heads + h) * kD + c);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      a[kk][i] = t < seq ? src[8 * kk] : 0u;
      a[kk][2 + i] = t < seq ? src[8 * kk + 4] : 0u;
    }
  }
}

// D[64 x kRows] = A B^T, one group: A[64 x 64] from registers (load_a_rows),
// B a tile [kRows rows][64] K-major in swizzled shared memory; 4 steps of k16
// along d_h, a step is 32 bytes into the 128-byte rows
template <int kAcc>  // kRows / 2 accumulator registers a thread
__device__ __forceinline__ void issue_scores(float (&d)[kAcc], uint32_t (&a)[kD / 16][4],
                                             const bf16* b_tile) {
  const uint64_t desc_b = sw128_desc(b_tile, 16, 1024);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    if constexpr (kAcc == 64)
      wgmma_m64n128k16_rs(d, a[kk], desc_b + 2 * kk, kk > 0);
    else
      wgmma_m64n64k16_rs(d, a[kk], desc_b + 2 * kk, kk > 0);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) fence_regs(a[kk]);
}

// D[64 x 64] += A B, one group: A[64 x kRows] from registers
// (to_a_fragments), B a tile [kRows rows][64] read MN-major; steps of k16
// along the rows, a step is 16 rows = 2048 bytes
__device__ __forceinline__ void issue_grad(float (&d)[32], uint32_t (&a)[kRows / 16][4],
                                           const bf16* b_tile) {
  const uint64_t desc_b = sw128_desc(b_tile, 1024, 1024);
  fence_regs(d);
  fence_frags(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) wgmma_m64n64k16_rs_tb(d, a[kk], desc_b + 128 * kk);
  wgmma_commit();
}

// a warpgroup's 64 x 64 accumulator (this thread: rows r and r + 8, columns
// 8 j + c, + 1), rounded to bf16, to rows t0 + r (+ 8) of out [B, T, H, 64];
// rows past seq are not stored
__device__ __forceinline__ void store_rows(const float (&acc)[32], bf16* out, int b, int h,
                                           int t0, int seq, int heads, int r, int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + r + 8 * i;
    if (t >= seq) continue;
    bf16* dst = out + (((size_t)b * seq + t) * heads + h) * kD + c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// ---- dK/dV ------------------------------------------------------------------

struct SmemDkdv {
  static constexpr int kStages = DkdvShape::kStages;
  bf16 q[kStages][kRows * kD];  // each tile: rows of 128 bytes, 128-byte swizzle
  bf16 dout[kStages][kRows * kD];
  float nl2[kStages][kRows];    // -L log2(e) of the tile's queries, -inf past T
  float delta[kStages][kRows];
  uint64_t full[kStages], empty[kStages];
};
constexpr int kDkdvSmem = sizeof(SmemDkdv) + 1024;  // + slack to align the base to 1 KB

// P^T = exp(S^T + b - L) in place on the accumulator fragment, whose rows are
// this thread's two keys and whose columns are queries: ex2 of one FMA, the
// key bias (times log2 e) per row and -L log2(e) per column
template <bool kBias>
__device__ __forceinline__ void probs_t(float (&st)[kRows / 2], const float (&kb2)[2],
                                        const float* nl2, int lane) {
  const float2* col2 = reinterpret_cast<const float2*>(nl2);
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const float2 cj = col2[4 * j + lane % 4];  // columns 8 j + c, + 1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      st[4 * j + 2 * i] =
          ex2_ftz(fmaf(st[4 * j + 2 * i], kLog2e, kBias ? kb2[i] + cj.x : cj.x));
      st[4 * j + 2 * i + 1] =
          ex2_ftz(fmaf(st[4 * j + 2 * i + 1], kLog2e, kBias ? kb2[i] + cj.y : cj.y));
    }
  }
}

// dS^T = P^T (dP^T - delta) in place of dP^T, delta per column
__device__ __forceinline__ void dscores_t(float (&dpt)[kRows / 2], const float (&pt)[kRows / 2],
                                          const float* delta, int lane) {
  const float2* col2 = reinterpret_cast<const float2*>(delta);
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const float2 dj = col2[4 * j + lane % 4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dpt[4 * j + 2 * i] = pt[4 * j + 2 * i] * (dpt[4 * j + 2 * i] - dj.x);
      dpt[4 * j + 2 * i + 1] = pt[4 * j + 2 * i + 1] * (dpt[4 * j + 2 * i + 1] - dj.y);
    }
  }
}

template <bool kBias>
__global__ void __launch_bounds__(DkdvShape::kThreads, 1)
attention_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_dout, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ lse,
                      const float* __restrict__ delta, const float* __restrict__ bias,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int heads,
                      int n_work) {
  using S = DkdvShape;
  extern __shared__ unsigned char smem_raw[];
  SmemDkdv& sm =
      *reinterpret_cast<SmemDkdv*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int n_kblocks = (seq + S::kBlockRows - 1) / S::kBlockRows;
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * S::kConsumers);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: the first warp; lane 0 issues every TMA load, all lanes
    // carry the tile's row statistics
    reg_dealloc<S::kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;  // query tiles so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const int bh = w / n_kblocks, b = bh / heads, h = bh % heads;
        const float* row_lse = lse + (size_t)bh * seq;
        const float* row_delta = delta + (size_t)bh * seq;
        // L (+inf past T) and delta of tile t's queries lane, lane + 32, into registers
        auto load_stats = [&](int t, float (&nl)[kRows / 32], float (&dl)[kRows / 32]) {
#pragma unroll
          for (int i = 0; i < kRows / 32; ++i) {
            const int tq = t * kRows + lane + 32 * i;
            nl[i] = tq < seq ? row_lse[tq] : INFINITY;
            dl[i] = tq < seq ? row_delta[tq] : 0.f;
          }
        };
        // the statistics into the stage once it is free, then the tile's loads
        auto publish = [&](int t, const float (&nl)[kRows / 32], const float (&dl)[kRows / 32]) {
          const int s = it % S::kStages;
          if (lane == 0) mbar_wait(&sm.empty[s], ((it / S::kStages) & 1) ^ 1);  // first pass: free
          __syncwarp();
#pragma unroll
          for (int i = 0; i < kRows / 32; ++i) {
            sm.nl2[s][lane + 32 * i] = -kLog2e * nl[i];
            sm.delta[s][lane + 32 * i] = dl[i];
          }
          __syncwarp();  // lane 0's arrival below publishes the whole warp's stores
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[s], 2 * kRows * kD * sizeof(bf16));
            tma_load_4d(sm.q[s], &tm_q, &sm.full[s], 0, h, t * kRows, b);
            tma_load_4d(sm.dout[s], &tm_dout, &sm.full[s], 0, h, t * kRows, b);
          }
          ++it;
        };
        // two register sets in turn, so the next tile's statistics are in
        // flight while this tile waits for its stage
        float nl_a[kRows / 32], dl_a[kRows / 32], nl_b[kRows / 32], dl_b[kRows / 32];
        load_stats(0, nl_a, dl_a);
        for (int t = 0; t < n_tiles; t += 2) {
          if (t + 1 < n_tiles) load_stats(t + 1, nl_b, dl_b);
          publish(t, nl_a, dl_a);
          if (t + 1 < n_tiles) {
            if (t + 2 < n_tiles) load_stats(t + 2, nl_a, dl_a);
            publish(t + 1, nl_b, dl_b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each, K and V held as register A operands
    reg_alloc<S::kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // accumulator fragment: this thread holds rows r and r + 8 of the
    // warpgroup's 64, columns 8 j + c, + 1 of each 8-column group j
    const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
    float dka[32], dva[32], st[kRows / 2], dpt[kRows / 2];
    uint32_t ka[kD / 16][4], va[kD / 16][4], pa[kRows / 16][4], dsa[kRows / 16][4];
    int it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int bh = w / n_kblocks, k0 = (w % n_kblocks) * S::kBlockRows + 64 * (wg - 1);
      const int b = bh / heads, h = bh % heads;
      load_a_rows(ka, k, b, h, k0, seq, heads, r, c);
      load_a_rows(va, v, b, h, k0, seq, heads, r, c);
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
      float kb2[2] = {0.f, 0.f};
      if (kBias) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (k0 + r + 8 * i < seq) kb2[i] = bias[k0 + r + 8 * i] * kLog2e;
      }
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % S::kStages;
        mbar_wait(&sm.full[s], (it / S::kStages) & 1);
        // queued behind the previous tile's dV and dK, which are not waited
        // for until S^T is
        issue_scores(st, ka, sm.q[s]);       // S^T = K Q^T
        issue_scores(dpt, va, sm.dout[s]);   // dP^T = V dO^T
        wgmma_wait<1>();
        fence_regs(st);
        fence_regs(dva);
        fence_regs(dka);
        fence_frags(pa);
        fence_frags(dsa);
        if (t > 0) {  // the previous tile's products are done: its stage may be refilled
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % S::kStages]);
        }
        probs_t<kBias>(st, kb2, sm.nl2[s], lane);
        to_a_fragments<kRows>(st, pa);
        issue_grad(dva, pa, sm.dout[s]);     // dV += P^T dO
        wgmma_wait<1>();
        fence_regs(dpt);
        dscores_t(dpt, st, sm.delta[s], lane);
        to_a_fragments<kRows>(dpt, dsa);
        issue_grad(dka, dsa, sm.q[s]);       // dK += dS^T Q
      }
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_frags(pa);
      fence_frags(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % S::kStages]);
      store_rows(dka, dk, b, h, k0, seq, heads, r, c);
      store_rows(dva, dv, b, h, k0, seq, heads, r, c);
    }
  }
}

// ---- dQ ---------------------------------------------------------------------

struct SmemDq {
  static constexpr int kStages = DqShape::kStages;
  bf16 k[kStages][kRows * kD];
  bf16 v[kStages][kRows * kD];
  float bias[kStages][kRows];
  uint64_t full[kStages], empty[kStages];
};
constexpr int kDqSmem = sizeof(SmemDq) + 1024;

// P = exp(S + b - L) in place on the accumulator fragment (rows: this
// thread's two queries, columns: keys): ex2 of one FMA, -L log2(e) per row
// (-inf past T: p = 0) and the key bias per column
template <bool kBias>
__device__ __forceinline__ void probs(float (&sc)[kRows / 2], const float (&nl2)[2],
                                      const float* bias, int lane) {
  const float2* col2 = reinterpret_cast<const float2*>(bias);
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    float2 bj = make_float2(0.f, 0.f);
    if (kBias) bj = col2[4 * j + lane % 4];  // columns 8 j + c, + 1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sc[4 * j + 2 * i] = ex2_ftz(
          fmaf(sc[4 * j + 2 * i], kLog2e, kBias ? fmaf(bj.x, kLog2e, nl2[i]) : nl2[i]));
      sc[4 * j + 2 * i + 1] = ex2_ftz(
          fmaf(sc[4 * j + 2 * i + 1], kLog2e, kBias ? fmaf(bj.y, kLog2e, nl2[i]) : nl2[i]));
    }
  }
}

// dS = P (dP - delta) in place of P, delta per row; keys past seq (the ragged
// last tile only) get dS = 0
__device__ __forceinline__ void dscores(float (&sc)[kRows / 2], const float (&dp)[kRows / 2],
                                        const float (&dl)[2], int k0, int seq, int lane) {
#pragma unroll
  for (int j = 0; j < kRows / 2; ++j) sc[j] *= dp[j] - dl[(j / 2) % 2];
  if (k0 + kRows > seq) {
    const int c = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * j + c + e >= seq) sc[4 * j + e] = sc[4 * j + 2 + e] = 0.f;
  }
}

template <bool kBias>
__global__ void __launch_bounds__(DqShape::kThreads, 1)
attention_dq_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_bias, const bf16* __restrict__ q,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int seq, int heads,
                    int n_work) {
  using S = DqShape;
  extern __shared__ unsigned char smem_raw[];
  SmemDq& sm =
      *reinterpret_cast<SmemDq*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int n_qblocks = (seq + S::kBlockRows - 1) / S::kBlockRows;
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * S::kConsumers);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load
    reg_dealloc<S::kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;  // key tiles so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const int bh = w / n_qblocks, b = bh / heads, h = bh % heads;
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % S::kStages, k0 = t * kRows;
          mbar_wait(&sm.empty[s], ((it / S::kStages) & 1) ^ 1);  // first pass: free
          mbar_arrive_expect_tx(&sm.full[s], 2 * kRows * kD * sizeof(bf16) +
                                                 (kBias ? kRows * sizeof(float) : 0));
          tma_load_4d(sm.k[s], &tm_k, &sm.full[s], 0, h, k0, b);
          tma_load_4d(sm.v[s], &tm_v, &sm.full[s], 0, h, k0, b);
          if (kBias) tma_load_1d(sm.bias[s], &tm_bias, &sm.full[s], k0);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each, Q and dO held as register A operands
    reg_alloc<S::kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
    float dqa[32], sc[kRows / 2], dp[kRows / 2];
    uint32_t qa[kD / 16][4], oa[kD / 16][4], dsa[kRows / 16][4];
    int it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int bh = w / n_qblocks, q0 = (w % n_qblocks) * S::kBlockRows + 64 * (wg - 1);
      const int b = bh / heads, h = bh % heads;
      load_a_rows(qa, q, b, h, q0, seq, heads, r, c);
      load_a_rows(oa, dout, b, h, q0, seq, heads, r, c);
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
      float nl2[2], dl[2];  // this thread's two queries
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tq = q0 + r + 8 * i;
        nl2[i] = tq < seq ? -kLog2e * lse[(size_t)bh * seq + tq] : -INFINITY;
        dl[i] = tq < seq ? delta[(size_t)bh * seq + tq] : 0.f;
      }
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % S::kStages;
        mbar_wait(&sm.full[s], (it / S::kStages) & 1);
        issue_scores(sc, qa, sm.k[s]);   // S = Q K^T
        issue_scores(dp, oa, sm.v[s]);   // dP = dO V^T
        wgmma_wait<1>();
        fence_regs(sc);
        probs<kBias>(sc, nl2, sm.bias[s], lane);
        wgmma_wait<0>();
        fence_regs(dp);
        dscores(sc, dp, dl, t * kRows, seq, lane);
        to_a_fragments<kRows>(sc, dsa);
        issue_grad(dqa, dsa, sm.k[s]);   // dQ += dS K
        wgmma_wait<0>();
        fence_regs(dqa);
        fence_frags(dsa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[s]);  // the stage may be refilled
      }
      store_rows(dqa, dq, b, h, q0, seq, heads, r, c);
    }
  }
}

inline cudaError_t grid_size(int n_work, int* blocks) {
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  *blocks = n_work < sms ? n_work : sms;
  return cudaSuccess;
}

template <bool kBias>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, const float* bias, void* dk,
                        void* dv, int batch, int seq, int heads, cudaStream_t stream) {
  using S = DkdvShape;
  CUtensorMap maps[2] = {};  // q, dout: the ring's tiles
  cudaError_t err;
  const void* srcs[2] = {q, dout};
  for (int i = 0; i < 2; ++i)
    if ((err = encode_rows(&maps[i], srcs[i], batch, seq, heads, kRows)) != cudaSuccess)
      return err;
  auto kernel = attention_dkdv_kernel<kBias>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return err;
  const int n_work = (seq + S::kBlockRows - 1) / S::kBlockRows * batch * heads;
  int blocks;
  if ((err = grid_size(n_work, &blocks)) != cudaSuccess) return err;
  kernel<<<blocks, S::kThreads, kDkdvSmem, stream>>>(
      maps[0], maps[1], static_cast<const bf16*>(k), static_cast<const bf16*>(v), lse, delta,
      bias, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, heads, n_work);
  return cudaGetLastError();
}

template <bool kBias>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* bias, void* dq,
                      int batch, int seq, int heads, cudaStream_t stream) {
  using S = DqShape;
  CUtensorMap maps[3] = {};  // k, v: the ring's tiles; bias (left zero without one)
  cudaError_t err;
  const void* srcs[2] = {k, v};
  for (int i = 0; i < 2; ++i)
    if ((err = encode_rows(&maps[i], srcs[i], batch, seq, heads, kRows)) != cudaSuccess)
      return err;
  if (kBias && (err = encode_bias(&maps[2], bias, seq, kRows)) != cudaSuccess) return err;
  auto kernel = attention_dq_kernel<kBias>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  const int n_work = (seq + S::kBlockRows - 1) / S::kBlockRows * batch * heads;
  int blocks;
  if ((err = grid_size(n_work, &blocks)) != cudaSuccess) return err;
  kernel<<<blocks, S::kThreads, kDqSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      lse, delta, static_cast<bf16*>(dq), seq, heads, n_work);
  return cudaGetLastError();
}

}  // namespace hb

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool kBias>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* bias, void* dk,
                        void* dv, int batch, int seq, int heads, bool is_bf16,
                        cudaStream_t stream) {
  const auto* L = static_cast<const float*>(lse);
  const auto* D = static_cast<const float*>(delta);
  const auto* B = static_cast<const float*>(bias);
  if (is_bf16)
    return hb::launch_dkdv<kBias>(q, k, v, dout, L, D, B, dk, dv, batch, seq, heads, stream);
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  auto kernel = attention_dkdv_kernel<kBias>;
  cudaError_t err;
  if ((err = allow_smem(kernel, kSmemDkv)) != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemDkv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), L, D, B, static_cast<float*>(dk),
      static_cast<float*>(dv), seq, heads);
  return cudaGetLastError();
}

template <bool kBias>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* bias, void* dq,
                      int batch, int seq, int heads, bool is_bf16, cudaStream_t stream) {
  const auto* L = static_cast<const float*>(lse);
  const auto* D = static_cast<const float*>(delta);
  const auto* B = static_cast<const float*>(bias);
  if (is_bf16)
    return hb::launch_dq<kBias>(q, k, v, dout, L, D, B, dq, batch, seq, heads, stream);
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  auto kernel = attention_dq_kernel<kBias>;
  cudaError_t err;
  if ((err = allow_smem(kernel, kSmemDq)) != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemDq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), L, D, B, static_cast<float*>(dq), seq, heads);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv [batch, seq, heads, 64] in float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1), 16-byte aligned; lse, delta f32[batch, heads, seq];
// bias f32[seq] (16-byte aligned) or null
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
