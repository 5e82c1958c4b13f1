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
// The TPU kept a whole 1536-wide score row in VMEM and did one pass; here
// key tiles stream through shared memory with the online-softmax recurrence
// (running row max and sum in float32, output rescaled per tile). Keys past
// `seq` (the ragged last tile) are masked, so T = 1500 needs no padding (the
// library pads to 1536 and masks with segment ids). q, k, v and out keep
// the callers' [B, T, H, 64] layout, so no transposes.
//
// Bound on H100: operations. At the serving shape (whisper-medium, B = 16,
// H = 16, T = 1500, d_h = 64) QK^T and PV are 4 x 256 x 1500^2 x 64 =
// 147.5 GFLOP of bf16 products a layer: 0.149 ms at 989 TFLOP/s, against
// 25 MB of q, k, v and out (0.007 ms at 3.35 TB/s). The softmax beside the
// products (one exp2 on the 16-a-clock MUFU unit and ~5 float32 operations a
// score) costs about as much again on this card at d_h = 64.
//
// * bf16 (the main path), written for sm_90a: a persistent grid of one
//   block per SM, each of four warpgroups, walking work items of (192
//   queries, b x h) in steps of the grid; consecutive items share b x h, so
//   K and V are read from L2 by the neighbouring SMs.
//   - Warpgroup 0 is the producer: one thread loads each item's Q tile and
//     keeps a ring of kStages K/V (and key-bias) tiles of 128 keys in
//     flight with TMA (tensor maps over {64, H, T, B}, 128-byte swizzle,
//     completion on mbarriers; rows past T arrive as zeros). The ring runs
//     on across items, and the next item's Q is loaded as soon as the
//     current one's last Q K^T has run, so its loads overlap the current
//     item's last softmax, P V and stores. The producer hands its registers
//     to the consumers (setmaxnreg 32 / 160).
//   - Warpgroups 1-3 each own 64 query rows. S = Q K^T by wgmma m64n128k16
//     from shared memory into float32 registers; the online softmax on the
//     accumulator fragment itself: the key bias added before the max, the
//     mask only on the ragged last tile, row max and sum over the 4 lanes
//     that share a row, exp as ex2.approx.ftz with log2(e) folded into one
//     FMA, the row sum taken in float32 before p is rounded to bf16; then
//     O += P V by wgmma m64n64k16 with P as the register A operand and V
//     read MN-major from shared memory. Only the ring goes through shared
//     memory, and the consumers never run __syncthreads.
//   - The output is divided by the row sum and rounded to bf16 once; the
//     log-sum-exp is written in natural log (m + log l) for the backward.
//   Registers set the shape: 512 threads at 128 registers fill the SM's
//   65,536, so one block runs per SM, and three consumer warpgroups (not
//   two) keep enough warps on each scheduler to cover the softmax's
//   latencies. 128-key tiles keep S at 64 registers a thread. The serving
//   shape has 8 x 256 = 2,048 work items, training's B = 2 has 256 (1.94
//   per SM).
// * float32: the CUDA cores, each thread holding a 4 x 4 register tile of
//   scores and of the output (full float32, no TF32), on 64-row tiles.
// The bias and the LSE output are template switches.
#include "attention.cuh"
#include "hopper.cuh"

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

// ---- bf16 on Hopper: TMA ring, wgmma, softmax in registers ---------------

namespace fa {

using namespace la::hopper;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 3;                // warpgroups of 64 query rows
constexpr int kBlockQ = 64 * kConsumers;     // queries a block
constexpr int kRows = 128;                   // keys a tile
constexpr int kStages = 2;                   // K/V tiles in the ring
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroup 0: the producer
// registers a thread once the producer has handed its own over
constexpr int kProducerRegs = 32, kConsumerRegs = 160;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "register file");
constexpr int kTileBytes = kRows * kD * sizeof(bf16);  // 16 KB
constexpr int kBiasBytes = kRows * sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  bf16 q[kBlockQ * kD];  // each tile: rows of 128 bytes, 128-byte swizzle
  bf16 k[kStages][kRows * kD];
  bf16 v[kStages][kRows * kD];
  float bias[kStages][kRows];
  uint64_t q_full, q_empty, full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + slack to align the base to 1 KB

// Bias, mask, running row max and p = exp(s - m) in place on one key tile's
// accumulator fragment (rows r and r + 8, columns 8 j + c, + 1); l (this
// thread's share of the row sums) is rescaled and gains the tile's p in
// float32. `scale` returns exp(m_old - m_new) for the output.
template <bool kBias>
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                               float (&scale)[2], const float* bias, int k0,
                                               int seq, int lane) {
  const int c = 2 * (lane % 4);
  if (kBias) {
    const float2* bias2 = reinterpret_cast<const float2*>(bias);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bj = bias2[4 * j + lane % 4];  // columns 8 j + c, + 1
      sc[4 * j] += bj.x;
      sc[4 * j + 1] += bj.y;
      sc[4 * j + 2] += bj.x;
      sc[4 * j + 3] += bj.y;
    }
  }
  if (k0 + kRows > seq) {  // the ragged last tile: keys past T
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * j + c + e >= seq) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]}, neg[2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    scale[i] = ex2_ftz((m[i] - mx[i]) * kLog2e);
    m[i] = mx[i];
    neg[i] = -mx[i] * kLog2e;
    l[i] *= scale[i];
  }
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    sc[j] = ex2_ftz(fmaf(sc[j], kLog2e, neg[(j / 2) % 2]));
    l[(j / 2) % 2] += sc[j];
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&scale)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= scale[0];
    o[4 * j + 1] *= scale[0];
    o[4 * j + 2] *= scale[1];
    o[4 * j + 3] *= scale[1];
  }
}

// S = Q K^T, issued and committed as one group: 4 steps of k16 along d_h,
// both operands K-major; a step is 32 bytes into the swizzled 128-byte rows
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t desc_q, const bf16* k_tile) {
  const uint64_t desc_k = sw128_desc(k_tile, 16, 1024);
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_m64n128k16_ss(sc, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
  wgmma_commit();
}

// O += P V, one group: 8 steps of k16 along the keys; V [key][d_h] is the
// MN-major B operand, a step is 16 rows = 2048 bytes
__device__ __forceinline__ void issue_pv(float (&o)[32], uint32_t (&pa)[8][4],
                                         const bf16* v_tile) {
  const uint64_t desc_v = sw128_desc(v_tile, 1024, 1024);
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs_tb(o, pa[kk], desc_v + 128 * kk);
  wgmma_commit();
}

template <bool kBias, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_bias, bf16* __restrict__ out,
                     float* __restrict__ lse, int seq, int heads, int n_work) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int n_qblocks = (seq + kBlockQ - 1) / kBlockQ;
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 4 * kConsumers);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * kConsumers);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, n = 0;  // key tiles and work items so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++n) {
        const int bh = w / n_qblocks, q0 = (w % n_qblocks) * kBlockQ;
        const int b = bh / heads, h = bh % heads;
        mbar_wait(&sm.q_empty, (n & 1) ^ 1);  // the previous item's Q K^T are done
        mbar_arrive_expect_tx(&sm.q_full, kBlockQ * kD * sizeof(bf16));
        tma_load_4d(sm.q, &tm_q, &sm.q_full, 0, h, q0, b);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % kStages, k0 = t * kRows;
          mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);  // first pass: free
          mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes + (kBias ? kBiasBytes : 0));
          tma_load_4d(sm.k[s], &tm_k, &sm.full[s], 0, h, k0, b);
          tma_load_4d(sm.v[s], &tm_v, &sm.full[s], 0, h, k0, b);
          if (kBias) tma_load_1d(sm.bias[s], &tm_bias, &sm.full[s], k0);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // accumulator fragment: this thread holds rows r and r + 8 of the
    // warpgroup's 64, columns 8 j + c, + 1 of each 8-column group j
    const int r = 64 * (wg - 1) + 16 * warp + lane / 4, c = 2 * (lane % 4);
    const uint64_t desc_q = sw128_desc(sm.q + 64 * (wg - 1) * kD, 16, 1024);
    float o[32], sc[64], scale[2];
    uint32_t pa[8][4];
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++n) {
      const int bh = w / n_qblocks, q0 = (w % n_qblocks) * kBlockQ;
      const int b = bh / heads, h = bh % heads;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      mbar_wait(&sm.q_full, n & 1);
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(&sm.full[s], (it / kStages) & 1);
        issue_qk(sc, desc_q, sm.k[s]);
        wgmma_wait<0>();
        fence_regs(sc);
        if (t == n_tiles - 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.q_empty);  // the next item's Q may load
        }
        online_softmax<kBias>(sc, m, l, scale, sm.bias[s], t * kRows, seq, lane);
        to_a_fragments<kRows>(sc, pa);
        rescale(o, scale);
        issue_pv(o, pa, sm.v[s]);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[s]);  // the stage may be refilled
      }
      const size_t row_stride = (size_t)heads * kD;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int tq = q0 + r + 8 * i;
        if (tq >= seq) continue;
        bf16* dst = out + ((size_t)b * seq + tq) * row_stride + (size_t)h * kD + c;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] / l[i], o[4 * j + 2 * i + 1] / l[i]);
        if (kLse && lane % 4 == 0) lse[(size_t)bh * seq + tq] = m[i] + logf(l[i]);
      }
    }
  }
}

template <bool kBias, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* lse, int batch, int seq, int heads, cudaStream_t stream) {
  CUtensorMap maps[4] = {};  // q, k, v, bias (left zero without a bias)
  cudaError_t err;
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if ((err = encode_rows(&maps[i], srcs[i], batch, seq, heads, i ? kRows : kBlockQ)) !=
        cudaSuccess)
      return err;
  if (kBias && (err = encode_bias(&maps[3], bias, seq, kRows)) != cudaSuccess) return err;
  auto kernel = attention_fwd_kernel<kBias, kLse>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int n_work = (seq + kBlockQ - 1) / kBlockQ * batch * heads;
  kernel<<<n_work < sms ? n_work : sms, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(out), static_cast<float*>(lse),
      seq, heads, n_work);
  return cudaGetLastError();
}

}  // namespace fa

template <bool kBias, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* lse, int batch, int seq, int heads, bool is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return fa::launch<kBias, kLse>(q, k, v, bias, out, lse, batch, seq, heads, stream);
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  auto kernel = attention_fwd_kernel<kBias, kLse>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(lse), seq,
      heads);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out [batch, seq, heads, 64] in float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1), 16-byte aligned; bias f32[seq] (16-byte aligned) or null
// (no bias). Serving and evaluation: no row statistics.
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
