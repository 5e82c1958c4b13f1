// Streaming row log-sum-exp of a linear layer's logits:
// out[r] = log sum_c exp(h[r] . w[c] + b[c]), without writing the
// [rows, cols] logits anywhere.
//
// Replaces the TPU kernel lyricalignment_tpu/ops/viterbi.py:_lse_kernel
// (launched by _chunked_lse_pallas): the class normaliser of the fused
// CE/CTC emissions. The TPU carried the running (max, sum) across a
// sequential grid axis of column blocks and asked the MXU for
// Precision.HIGHEST, a multi-pass split of each float32 product. Here the
// logits are formed on the tensor cores by the same kind of split, 3xTF32:
//   x = x_hi + x_lo, x_hi = x with its low 13 bits cleared (what the tensor
//   cores read of a 32-bit operand: they truncate), x_lo = x - x_hi rounded
//   to the nearest TF32 value;
//   h . w ~ h_lo . w_hi + h_hi . w_lo + h_hi . w_hi, summed in float32.
// lo is formed against the truncated hi, so hi + lo is the float32 value
// whatever the hardware drops of hi; what is left out is lo . lo and the
// rounding of lo, 2^-22 of a product each. lo is rounded, not left to the
// tensor cores to truncate: a truncated lo has the sign of x, so on a row
// whose products share a sign (the largest logits of trained weights) the
// dropped parts would all pull one way.
//
// The tensor cores' own float32 adds into a wgmma accumulator truncate as
// well, and a sum of all 288 products of a row's 768 feat kept in one
// accumulator drifted toward zero: on trained weights the lse was off by
// 1.5e-4. Each group of six products (16 feat) therefore starts a fresh
// accumulator, which is added into a running float32 sum in registers
// with round-to-nearest adds.
//
// Bound on H100: operations. At the main path (B = 16 x 1500 rows, feat
// 768, 21127 columns) the function is 2 x 24000 x 768 x 21127 = 779 GFLOP:
// 11.6 ms in float32 on the CUDA cores, and three TF32 products of it,
// 2337 GFLOP, are 4.7 ms at the tensor cores' 494.5 TFLOP/s. The design:
// * la_row_lse launches three kernels on the stream: split_lo_kernel writes
//   w_lo once (w_hi is w itself), row_lse_kernel forms partial (max, sum)
//   pairs, merge_kernel combines them.
// * row_lse_kernel is a persistent grid of one block per SM walking work
//   items of (128 rows of h, a range of 128-column tiles of w); consecutive
//   items share their rows, so neighbouring SMs read the same h from L2.
//   Columns are split into ranges so that the items fill the grid's last
//   wave; each item writes its rows' (max, sum) to scratch and the merge
//   runs over the ranges in a fixed order: no atomics, equal bits from run
//   to run.
// * Warpgroup 0 is the producer: one thread keeps a ring of stages in
//   flight with TMA, each 32 feat of the item's 128 rows of h and of the
//   tile's 128 rows of w_hi and w_lo (tensor maps with feat innermost,
//   128-byte rows, 128-byte swizzle; rows, columns and feat past the
//   extents arrive as zeros), completion on full/empty mbarriers. It hands
//   its registers to the consumers (setmaxnreg).
// * Warpgroups 1-2 each own 64 rows. A consumer reads its h fragment from
//   the stage into registers, splits it there, and issues wgmma
//   m64n128k8.tf32 with A from registers and the w tiles as the K-major B
//   operand: 64 float32 accumulators a thread, and 64 more for the running
//   sum. With A in registers a product reads 4 KB of shared memory in its
//   64 tensor-core clocks, half of what the SM can deliver. Products are
//   committed in groups of half a stage (two k-steps, six products) on two
//   sets of A registers, so the next group's fragment is loaded and split
//   while one runs; a group's sum is added into the running sum once it
//   has run, before the next group's first product overwrites it, and the
//   other consumer's products keep the tensor cores busy meanwhile.
// * After a tile's last stage the epilogue runs on the running sum: bias
//   added (-inf for columns past `cols`, whose products are
//   zeros), row max over the thread's 64 values and the quad that shares
//   the row, exp2 of the difference summed into the running (m, s). One
//   consumer's epilogue overlaps the other's products.
// The CTC slice w[1:-1] is taken by the caller's pointer offset and count.
#include "hopper.cuh"

namespace {

using namespace la::hopper;

constexpr int kConsumers = 2;                 // warpgroups of 64 rows of h
constexpr int kBM = 64 * kConsumers;          // rows of h a work item
constexpr int kBN = 128;                      // columns of w a tile (the wgmma's n)
constexpr int kBK = 32;                       // feat a stage: 128-byte rows
constexpr int kStages = 4;                    // stages in the ring
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroup 0: the producer
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "register file");
constexpr int kMaxRanges = 16;                // column ranges an item row is split into
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  float h[kStages][kBM * kBK];  // each tile: rows of 128 bytes, 128-byte swizzle
  float w_hi[kStages][kBN * kBK];
  float w_lo[kStages][kBN * kBK];
  uint64_t full[kStages], empty[kStages];
};
constexpr int kStageBytes = (kBM + 2 * kBN) * kBK * sizeof(float);
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + slack to align the base to 1 KB

// what the tensor cores read of x
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// x rounded to the nearest TF32 value (the tensor cores then read it whole)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

__global__ void split_lo_kernel(const float4* __restrict__ w, float4* __restrict__ lo, size_t n4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = w[i];
    lo[i] = make_float4(__uint_as_float(tf32_rna(v.x - tf32_hi(v.x))),
                        __uint_as_float(tf32_rna(v.y - tf32_hi(v.y))),
                        __uint_as_float(tf32_rna(v.z - tf32_hi(v.z))),
                        __uint_as_float(tf32_rna(v.w - tf32_hi(v.w))));
  }
}

// column tiles [first, last) of range `range` out of `ranges`
__device__ __forceinline__ void tiles_of(int range, int ranges, int col_tiles, int* first,
                                         int* last) {
  *first = (int)((long long)range * col_tiles / ranges);
  *last = (int)((long long)(range + 1) * col_tiles / ranges);
}

// the A fragment of k-step kk (8 feat) of a stage's tile: this thread's rows
// g and g + 8 (row_ptr points at row g, 4 t bytes in; xor16 is the swizzle of
// its 16-byte chunks, 16 (g % 8)), columns t and t + 4: v = {(g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4)}
__device__ __forceinline__ void read_a(float (&v)[4], const char* row_ptr, int xor16, int kk) {
  const int o0 = (32 * kk) ^ xor16, o1 = (32 * kk + 16) ^ xor16;
  v[0] = *reinterpret_cast<const float*>(row_ptr + o0);
  v[1] = *reinterpret_cast<const float*>(row_ptr + 1024 + o0);
  v[2] = *reinterpret_cast<const float*>(row_ptr + o1);
  v[3] = *reinterpret_cast<const float*>(row_ptr + 1024 + o1);
}

// v split for the tensor cores: hi = v truncated, lo = v - hi rounded to TF32
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float top = tf32_hi(v[i]);
    hi[i] = __float_as_uint(top);
    lo[i] = tf32_rna(v[i] - top);
  }
}

__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const char* row_ptr,
                                       int xor16, int kk) {
  float v[4];
  read_a(v, row_ptr, xor16, kk);
  split_a(hi, lo, v);
}

// pins a set of A registers for the compiler: before the fence that orders
// their writes ahead of the products that read them, and again once the
// group that read them has retired (wgmma reads them while it runs, long
// after the asm statement that named them)
__device__ __forceinline__ void fence_a(uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    fence_regs(hi[j]);
    fence_regs(lo[j]);
  }
}

// D (+)= A B on a tile of 128 (R = 64 accumulators a thread) or 64 (R = 32)
// columns
template <int R>
__device__ __forceinline__ void wgmma_tf32(float (&d)[R], const uint32_t (&a)[4], uint64_t desc_b,
                                           int scale_d) {
  static_assert(R == 64 || R == 32, "m64n128k8 or m64n64k8");
  if constexpr (R == 64)
    wgmma_m64n128k8_tf32_rs(d, a, desc_b, scale_d);
  else
    wgmma_m64n64k8_tf32_rs(d, a, desc_b, scale_d);
}

// the three products of k-steps kk0 and kk0 + 1 of a stage, one group; a
// k-step is 32 bytes into the swizzled 128-byte rows
template <int R>
__device__ __forceinline__ void issue_half(float (&acc)[R], uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4], uint64_t desc_hi,
                                           uint64_t desc_lo, int kk0, int accumulate) {
  fence_regs(acc);
  fence_a(hi, lo);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kk = kk0 + j;
    wgmma_tf32(acc, lo[j], desc_hi + 2 * kk, accumulate || j > 0);
    wgmma_tf32(acc, hi[j], desc_lo + 2 * kk, 1);
    wgmma_tf32(acc, hi[j], desc_hi + 2 * kk, 1);
  }
  wgmma_commit();
}

// run += acc, rounded to nearest: a group's products into the running sum
template <int R>
__device__ __forceinline__ void add_group(float (&run)[R], const float (&acc)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) run[j] = __fadd_rn(run[j], acc[j]);
}

// One tile's logits (accumulator fragment: rows g and g + 8, columns
// c0 + 8 j + 2 t, + 1) merged into the running row max m and this thread's
// share s of the row sums of exp(x - m)
__device__ __forceinline__ void merge_tile(float (&acc)[kBN / 2], float (&m)[2], float (&s)[2],
                                           const float* __restrict__ bias, int c0, int cols,
                                           int lane) {
  const int c = c0 + 2 * (lane % 4);
  float mx[2] = {m[0], m[1]}, neg[2];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = c + 8 * j;
    const float b0 = col < cols ? __ldg(bias + col) : -INFINITY;
    const float b1 = col + 1 < cols ? __ldg(bias + col + 1) : -INFINITY;
    acc[4 * j] += b0;
    acc[4 * j + 1] += b1;
    acc[4 * j + 2] += b0;
    acc[4 * j + 3] += b1;
    mx[0] = fmaxf(mx[0], fmaxf(acc[4 * j], acc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));  // finite: column c0 is live
    s[i] *= ex2_ftz((m[i] - mx[i]) * kLog2e);
    m[i] = mx[i];
    neg[i] = -mx[i] * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j)
    s[(j / 2) % 2] += ex2_ftz(fmaf(acc[j], kLog2e, neg[(j / 2) % 2]));
}

__global__ void __launch_bounds__(kThreads, 1)
row_lse_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_lo, const float* __restrict__ bias,
               float2* __restrict__ partial, int rows, int feat, int cols, int ranges,
               int n_items) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int col_tiles = (cols + kBN - 1) / kBN;
  const int n_chunks = (feat + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
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
      int it = 0;  // stages so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int r0 = (w / ranges) * kBM;
        int first, last;
        tiles_of(w % ranges, ranges, col_tiles, &first, &last);
        for (int tile = first; tile < last; ++tile) {
          for (int c = 0; c < n_chunks; ++c, ++it) {
            const int s = it % kStages;
            mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);  // first pass: free
            mbar_arrive_expect_tx(&sm.full[s], kStageBytes);
            tma_load_2d(sm.h[s], &tm_h, &sm.full[s], c * kBK, r0);
            tma_load_2d(sm.w_hi[s], &tm_w, &sm.full[s], c * kBK, tile * kBN);
            tma_load_2d(sm.w_lo[s], &tm_lo, &sm.full[s], c * kBK, tile * kBN);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of h each
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row = 64 * (wg - 1) + 16 * warp + lane / 4;  // and row + 8
    const int row_off = row * 128 + 4 * (lane % 4), xor16 = 16 * (lane / 4);
    float acc[kBN / 2], run[kBN / 2];  // a group's products; their running sum
    uint32_t a_hi[2][2][4] = {}, a_lo[2][2][4] = {};  // [set][k-step][register]
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int r0 = (w / ranges) * kBM, range = w % ranges;
      int first, last;
      tiles_of(range, ranges, col_tiles, &first, &last);
      float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
      for (int tile = first; tile < last; ++tile) {
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) run[j] = 0.f;
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int st = it % kStages;
          mbar_wait(&sm.full[st], (it / kStages) & 1);
          const char* row_ptr = reinterpret_cast<const char*>(sm.h[st]) + row_off;
          const uint64_t desc_hi = sw128_desc(sm.w_hi[st], 16, 1024);
          const uint64_t desc_lo = sw128_desc(sm.w_lo[st], 16, 1024);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            // this group's fragment, while the previous group (the other
            // set of A registers) runs
            load_a(a_hi[half][0], a_lo[half][0], row_ptr, xor16, 2 * half);
            load_a(a_hi[half][1], a_lo[half][1], row_ptr, xor16, 2 * half + 1);
            if (c > 0 || half > 0) {
              wgmma_wait<0>();  // the previous group has run: acc holds its sum
              fence_regs(acc);
              fence_a(a_hi[1 - half], a_lo[1 - half]);
              add_group(run, acc);
              if (half == 0) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % kStages]);  // it may be refilled
              }
            }
            issue_half(acc, a_hi[half], a_lo[half], desc_hi, desc_lo, 2 * half, 0);  // fresh
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_a(a_hi[1], a_lo[1]);
        add_group(run, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % kStages]);
        merge_tile(run, m, s, bias, tile * kBN, cols, lane);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
        const int r = r0 + row + 8 * i;
        if (lane % 4 == 0 && r < rows) partial[(size_t)range * rows + r] = make_float2(m[i], s[i]);
      }
    }
  }
}

// out[r] = log sum over the ranges of s exp(m), in the ranges' order
__global__ void merge_kernel(const float2* __restrict__ partial, float* __restrict__ out, int rows,
                             int ranges) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = -INFINITY, s = 0.f;
  for (int k = 0; k < ranges; ++k) m = fmaxf(m, partial[(size_t)k * rows + r].x);
  for (int k = 0; k < ranges; ++k) {
    const float2 p = partial[(size_t)k * rows + r];
    s += p.y * expf(p.x - m);
  }
  out[r] = m + logf(s);
}

// the number of column ranges that leaves the grid's last wave fullest: the
// least (waves of items) x (tiles an item), the fewest ranges among equals
int plan_ranges(int row_tiles, int col_tiles, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int r = 1; r <= col_tiles && r <= kMaxRanges; ++r) {
    const long long items = (long long)row_tiles * r;
    const long long grid = items < sms ? items : sms;
    const long long cost = ((items + grid - 1) / grid) * ((col_tiles + r - 1) / r);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = r;
    }
  }
  return best;
}

}  // namespace

// floats of scratch la_row_lse needs: w_lo [cols, feat], then the partial
// (max, sum) pairs [ranges, rows, 2]
LA_API long long la_row_lse_scratch_floats(int rows, int feat, int cols) {
  return (long long)cols * feat + 2ll * kMaxRanges * rows;
}

// h f32[rows, feat]; w f32 rows [cols, feat] and b f32[cols] point at the
// first column of the slice; out f32[rows]; scratch f32 of
// la_row_lse_scratch_floats(rows, feat, cols). feat % 4 == 0 and h, w,
// scratch 16-byte aligned (the wrapper checks).
LA_API int la_row_lse(const void* h, const void* w, const void* b, void* out, void* scratch,
                      int rows, int feat, int cols, void* stream) {
  if (rows <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  float* w_lo = static_cast<float*>(scratch);
  float2* partial = reinterpret_cast<float2*>(w_lo + (size_t)cols * feat);
  cudaError_t err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;

  const size_t n4 = (size_t)cols * feat / 4;
  const size_t split_blocks = (n4 + 255) / 256;
  split_lo_kernel<<<(unsigned)(split_blocks < 8u * sms ? split_blocks : 8u * sms), 256, 0, s>>>(
      static_cast<const float4*>(w), reinterpret_cast<float4*>(w_lo), n4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  CUtensorMap tm_h, tm_w, tm_lo;
  if ((err = la::hopper::encode_f32_rows(&tm_h, h, rows, feat, kBM)) != cudaSuccess) return err;
  if ((err = la::hopper::encode_f32_rows(&tm_w, w, cols, feat, kBN)) != cudaSuccess) return err;
  if ((err = la::hopper::encode_f32_rows(&tm_lo, w_lo, cols, feat, kBN)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(row_lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const int row_tiles = (rows + kBM - 1) / kBM, col_tiles = (cols + kBN - 1) / kBN;
  const int ranges = plan_ranges(row_tiles, col_tiles, sms);
  const int n_items = row_tiles * ranges;
  row_lse_kernel<<<n_items < sms ? n_items : sms, kThreads, kSmemBytes, s>>>(
      tm_h, tm_w, tm_lo, static_cast<const float*>(b), partial, rows, feat, cols, ranges,
      n_items);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_kernel<<<(rows + 255) / 256, 256, 0, s>>>(partial, static_cast<float*>(out), rows,
                                                  ranges);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward of the row log-sum-exp, for the fused training losses
// (train/losses.py): given lse[r] and the upstream gradient g[r],
//   p[r, c] = g[r] exp(h[r] . w[c] + b[c] - lse[r]),
//   dh = p w,  dw = p^T h,  db = sum_r p.
// The JAX package takes this gradient by autodiff through jax.checkpoint over
// _chunked_lse's scan (lyricalignment_tpu/ops/viterbi.py:_chunked_lse): no
// Pallas kernel, so this is port work. As that scan's backward does, it holds
// p for one chunk of 4224 columns at a time, never [rows, cols].
//
// Bound on H100: operations. At the training shape (rows 3000 = 2 x 1500,
// feat 768, 21127 or 21128 columns) the function is three products of
// 2 x 3000 x 768 x 21127 = 97.4 GFLOP (the logits, dh, dw): 4.36 ms on the
// float32 CUDA cores at 67 TFLOP/s, 1.77 ms as three TF32 products each on
// the tensor cores (the forward's split). A full feat-768 row of dh or dw
// is 384 accumulators a thread in a 64-row wgmma tile, far past the 255
// registers, so a single pass in the style of flash attention would have to
// form the logits once per feat slice; instead la_row_lse_bwd stages p a
// chunk at a time and runs each product once. It launches, per chunk:
// * split kernels: w_lo of the chunk (the p product's B, as the forward's)
//   and, when dh is wanted, w^T of the chunk as hi and lo copies [feat,
//   chunk]; once a call, when dw or db is wanted, h^T as hi and lo [feat,
//   rows]. TF32 wgmma reads both operands K-major (it has no transpose bit),
//   so the second products need these transposed copies. Their rows are
//   padded with zeros to a multiple of 4 floats (a TMA stride is a multiple
//   of 16 bytes).
// * the p kernel: the forward's main loop on 128 x 128 tiles of logits (h as
//   the register A operand, split there; w and w_lo as K-major B by TMA),
//   then p = g exp(S + b - lse) on the running sums, written as p [rows,
//   chunk] (for dh) and p^T [chunk, rows] (for dw and db), zeros past the
//   extents; a quad's stores are 32-byte runs in both layouts.
// * the dh kernel: dh += p w over the chunk's columns, A = p rows, B = w^T
//   hi / lo, 128 x 64 tiles. Its K (the chunk) is split into ranges so that
//   the items fill the grid's waves (24 x 12 tiles a chunk at the training
//   shape are 2.2 waves of 132 SMs); range q adds into its own partial
//   [rows, feat] in chunk order (into dh itself when there is one range),
//   and a reduce kernel sums the partials in range order at the end.
// * the dw kernel: dw[chunk] = p^T h, A = p^T rows, B = h^T hi / lo, 128 x
//   64 tiles (33 x 12 a chunk: 3 waves), K = rows whole; db[chunk] is the
//   row sums of its A operand, added as the fragments are read.
// All three are one persistent GEMM (a block an SM walking items of (K
// range, 128 rows, a column tile), warpgroup 0 a TMA producer keeping a
// ring of stages in flight, two consumer warpgroups of 64 rows) with the
// forward's numerics: A split in registers, lo halves rounded to the nearest
// TF32, three products a k-step, a fresh accumulator every six products
// added into a running float32 sum with round-to-nearest adds (the tensor
// cores' own adds truncate; dh's K is 21127 columns, dw's 3000 rows). No
// atomics: chunks, ranges and a quad's sums add in a fixed order, and reruns
// give equal bits.
// ---------------------------------------------------------------------------

namespace {

using namespace la::hopper;

constexpr int kChunk = 4224;              // columns a chunk (LSE_CHUNK of ops/viterbi.py)
constexpr int kDhN = 64;                  // columns a tile of the dh product
constexpr int kDwN = 64;                  // columns a tile of the dw product
constexpr int kDhMaxRanges = 16;          // K ranges of the dh product
constexpr long long kDhPartRows = 12288;  // at most ranges x rows of dh partials

enum BwdEpilogueKind { kEpiP, kEpiDh, kEpiDw };

template <int kTN>
struct BwdSmem {
  static constexpr int kStages = kTN == 128 ? 4 : 6;  // ~192 KB either way
  float a[kStages][kBM * kBK];  // each tile: rows of 128 bytes, 128-byte swizzle
  float b_hi[kStages][kTN * kBK];
  float b_lo[kStages][kTN * kBK];
  uint64_t full[kStages], empty[kStages];
};
template <int kTN>
constexpr int bwd_smem_bytes() {
  return sizeof(BwdSmem<kTN>) + 1024;  // + slack to align the base to 1 KB
}

// what an item's epilogue writes; pointers a product does not write are null
struct BwdEpi {
  const float* bias;  // p: the chunk's b
  const float* lse;   // p
  const float* g;     // p
  float* p;           // p: [m, p_ld]
  float* pt;          // p: [n, pt_ld]
  float* out;         // dh: range 0's partial [m, n], range q part_stride further; dw: [m, n]
  float* db;          // dw: [m]
  size_t part_stride;
  int p_ld, pt_ld, accumulate;  // accumulate: dh adds into its partial (chunks after the first)
};

// p = g exp(S + b - lse) of a tile's running sums (this thread's rows r0 and
// r0 + 8, columns c0 + 8 j and + 1), zero past m rows and n columns, into p
// and p^T
__device__ __forceinline__ void store_p(const float (&run)[64], const BwdEpi& ep, int r0, int c0,
                                        int m, int n) {
  float lg[2], gg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    lg[i] = r < m ? __ldg(ep.lse + r) : 0.f;
    gg[i] = r < m ? __ldg(ep.g + r) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + 8 * j;
    const float b0 = c < n ? __ldg(ep.bias + c) : 0.f;
    const float b1 = c + 1 < n ? __ldg(ep.bias + c + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float v0 = r < m && c < n ? gg[i] * expf(run[4 * j + 2 * i] + b0 - lg[i]) : 0.f;
      const float v1 = r < m && c + 1 < n ? gg[i] * expf(run[4 * j + 2 * i + 1] + b1 - lg[i]) : 0.f;
      if (ep.p != nullptr && r < m && c < ep.p_ld)
        *reinterpret_cast<float2*>(ep.p + (size_t)r * ep.p_ld + c) = make_float2(v0, v1);
      if (ep.pt != nullptr && r < ep.pt_ld) {
        if (c < n) ep.pt[(size_t)c * ep.pt_ld + r] = v0;
        if (c + 1 < n) ep.pt[(size_t)(c + 1) * ep.pt_ld + r] = v1;
      }
    }
  }
}

// a tile's running sums into out [m, n] (n even), or added to what it holds
// there, rounded to nearest
template <int R>
__device__ __forceinline__ void store_sums(const float (&run)[R], float* out, int r0, int c0,
                                           int m, int n, bool accumulate) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = c0 + 8 * j;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= m || c >= n) continue;
      float2* dst = reinterpret_cast<float2*>(out + (size_t)r * n + c);
      float2 v = make_float2(run[4 * j + 2 * i], run[4 * j + 2 * i + 1]);
      if (accumulate) {
        const float2 o = *dst;
        v = make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
      }
      *dst = v;
    }
  }
}

// C[m, n] = A[m, k] B[n, k]^T in 3xTF32, A and B row-major with k innermost
// (B given as its hi copy, or the float32 values themselves, which the
// tensor cores truncate, and its lo copy); items (K range q, 128-row tile,
// kTN-column tile), column tiles fastest so that neighbouring SMs read the
// same rows of A; the epilogue writes p (kEpiP), a dh partial (kEpiDh) or dw
// and db (kEpiDw)
template <int kTN, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
bwd_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_b_lo, const BwdEpi ep, int m, int n, int k,
                int ranges, int n_items) {
  using Smem = BwdSmem<kTN>;
  constexpr int kSt = Smem::kStages, kR = kTN / 2;
  constexpr int kBytes = (kBM + 2 * kTN) * kBK * sizeof(float);
  static_assert(kEpi != kEpiP || kTN == 128, "p tiles are 128 columns");
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int m_tiles = (m + kBM - 1) / kBM, n_tiles = (n + kTN - 1) / kTN;
  const int k_stages = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
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
      int it = 0;  // stages so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int nt = w % n_tiles, mt = (w / n_tiles) % m_tiles, q = w / (n_tiles * m_tiles);
        int first, last;
        tiles_of(q, ranges, k_stages, &first, &last);
        for (int s = first; s < last; ++s, ++it) {
          const int st = it % kSt;
          mbar_wait(&sm.empty[st], ((it / kSt) & 1) ^ 1);  // first pass: free
          mbar_arrive_expect_tx(&sm.full[st], kBytes);
          tma_load_2d(sm.a[st], &tm_a, &sm.full[st], s * kBK, mt * kBM);
          tma_load_2d(sm.b_hi[st], &tm_b, &sm.full[st], s * kBK, nt * kTN);
          tma_load_2d(sm.b_lo[st], &tm_b_lo, &sm.full[st], s * kBK, nt * kTN);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of A each
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row = 64 * (wg - 1) + 16 * warp + lane / 4;  // and row + 8
    const int row_off = row * 128 + 4 * (lane % 4), xor16 = 16 * (lane / 4);
    float acc[kR], run[kR];  // a group's products; their running sum
    uint32_t a_hi[2][2][4] = {}, a_lo[2][2][4] = {};  // [set][k-step][register]
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int nt = w % n_tiles, mt = (w / n_tiles) % m_tiles, q = w / (n_tiles * m_tiles);
      int first, last;
      tiles_of(q, ranges, k_stages, &first, &last);
#pragma unroll
      for (int j = 0; j < kR; ++j) run[j] = 0.f;
      float rsum[2] = {0.f, 0.f};  // kEpiDw: this thread's share of rows row, row + 8 of A
      for (int s = first; s < last; ++s, ++it) {
        const int st = it % kSt;
        mbar_wait(&sm.full[st], (it / kSt) & 1);
        const char* row_ptr = reinterpret_cast<const char*>(sm.a[st]) + row_off;
        const uint64_t desc_hi = sw128_desc(sm.b_hi[st], 16, 1024);
        const uint64_t desc_lo = sw128_desc(sm.b_lo[st], 16, 1024);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // this group's fragment, while the previous group (the other set
          // of A registers) runs
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[4];
            read_a(v, row_ptr, xor16, 2 * half + j);
            if (kEpi == kEpiDw) {
              rsum[0] = __fadd_rn(__fadd_rn(rsum[0], v[0]), v[2]);
              rsum[1] = __fadd_rn(__fadd_rn(rsum[1], v[1]), v[3]);
            }
            split_a(a_hi[half][j], a_lo[half][j], v);
          }
          if (s > first || half > 0) {
            wgmma_wait<0>();  // the previous group has run: acc holds its sum
            fence_regs(acc);
            fence_a(a_hi[1 - half], a_lo[1 - half]);
            add_group(run, acc);
            if (half == 0) {
              __syncwarp();
              if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % kSt]);  // it may be refilled
            }
          }
          issue_half(acc, a_hi[half], a_lo[half], desc_hi, desc_lo, 2 * half, 0);  // fresh
        }
      }
      if (first < last) {
        wgmma_wait<0>();
        fence_regs(acc);
        fence_a(a_hi[1], a_lo[1]);
        add_group(run, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % kSt]);
      }
      const int r0 = mt * kBM + row, c0 = nt * kTN + 2 * (lane % 4);
      if constexpr (kEpi == kEpiP) {
        store_p(run, ep, r0, c0, m, n);
      } else if constexpr (kEpi == kEpiDh) {
        store_sums(run, ep.out + (size_t)q * ep.part_stride, r0, c0, m, n, ep.accumulate != 0);
      } else {
        if (ep.out != nullptr) store_sums(run, ep.out, r0, c0, m, n, false);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rsum[i] = __fadd_rn(rsum[i], __shfl_xor_sync(0xffffffffu, rsum[i], 1));
          rsum[i] = __fadd_rn(rsum[i], __shfl_xor_sync(0xffffffffu, rsum[i], 2));
          if (nt == 0 && ep.db != nullptr && lane % 4 == 0 && r0 + 8 * i < m)
            ep.db[r0 + 8 * i] = rsum[i];
        }
      }
    }
  }
}

// hi[f][r] = src[r][f] and lo[f][r] = its low part rounded to TF32, for r <
// rows_n; zeros for r in [rows_n, ld); 32 x 32 tiles through shared memory
__global__ void split_transpose_kernel(const float* __restrict__ src, int rows_n, int feat,
                                       float* __restrict__ hi, float* __restrict__ lo, int ld) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, f = f0 + threadIdx.x;
    tile[i][threadIdx.x] = r < rows_n && f < feat ? __ldg(src + (size_t)r * feat + f) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int f = f0 + i, r = r0 + threadIdx.x;
    if (f >= feat || r >= ld) continue;
    const float v = tile[threadIdx.x][i];
    hi[(size_t)f * ld + r] = v;
    lo[(size_t)f * ld + r] = __uint_as_float(tf32_rna(v - tf32_hi(v)));
  }
}

// dh = sum over the ranges of part, in the ranges' order
__global__ void bwd_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                  size_t n4, int ranges) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 s = part[i];
    for (int q = 1; q < ranges; ++q) {
      const float4 v = part[(size_t)q * n4 + i];
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                      __fadd_rn(s.w, v.w));
    }
    out[i] = s;
  }
}

int round4(int x) { return (x + 3) / 4 * 4; }
int cdiv(int a, int b) { return (a + b - 1) / b; }

// the scratch of la_row_lse_bwd, in floats (every piece a multiple of 4)
struct BwdScratch {
  float *w_lo, *wt_hi, *wt_lo, *ht_hi, *ht_lo, *p, *pt, *part;
  long long floats;
};

// dh partials: at most kDhMaxRanges, and ranges x rows at most kDhPartRows
int dh_ranges_cap(int rows) {
  const long long cap = rows > 0 ? kDhPartRows / rows : kDhMaxRanges;
  return (int)(cap < 1 ? 1 : cap > kDhMaxRanges ? kDhMaxRanges : cap);
}

BwdScratch bwd_scratch(float* base, int rows, int feat, int cols) {
  const long long chunk = cols < kChunk ? cols : kChunk, npad = round4((int)chunk);
  const long long rpad = round4(rows);
  const long long parts = (long long)dh_ranges_cap(rows) * rows * feat;
  const long long sizes[8] = {chunk * feat, feat * npad, feat * npad, feat * rpad,
                              feat * rpad,  rows * npad, chunk * rpad, parts};
  float* ptrs[8];
  long long at = 0;
  for (int i = 0; i < 8; ++i) {
    ptrs[i] = base == nullptr ? nullptr : base + at;
    at += sizes[i];
  }
  return {ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5], ptrs[6], ptrs[7], at};
}

// the number of K ranges of a chunk's dh product that finishes soonest:
// waves of items times an item's time, its stages (a stage of 128 x 64 x 32
// in 3xTF32 is ~0.42 us of an SM's tensor cores) and its epilogue's read
// and write of a 128 x 64 partial (~2.6 us of an SM's share of device
// memory), both in proportion to the tile's width; the fewest ranges among
// equals
int plan_dh_ranges(int tiles, int stages, int cap, int sms) {
  int best = 1;
  double best_cost = -1.0;
  for (int r = 1; r <= cap && r <= stages; ++r) {
    const long long waves = ((long long)tiles * r + sms - 1) / sms;
    const double cost = (double)waves * (cdiv(stages, r) * 0.42 + 2.6) * kDhN / 64;
    if (best_cost < 0 || cost < best_cost - 1e-9) {
      best_cost = cost;
      best = r;
    }
  }
  return best;
}

struct BwdPlan {
  int sms, chunks, chunk, p_items, dh_ranges, dh_items, dw_items;
};

// the plan of a call at this shape on this device (the first, widest chunk)
cudaError_t bwd_plan(int rows, int feat, int cols, BwdPlan* plan) {
  cudaError_t err;
  int device;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&plan->sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  plan->chunk = cols < kChunk ? cols : kChunk;
  plan->chunks = cdiv(cols, kChunk);
  const int m_tiles = cdiv(rows, kBM);
  plan->p_items = m_tiles * cdiv(plan->chunk, 128);
  const int dh_tiles = m_tiles * cdiv(feat, kDhN);
  plan->dh_ranges = plan_dh_ranges(dh_tiles, cdiv(plan->chunk, kBK), dh_ranges_cap(rows),
                                   plan->sms);
  plan->dh_items = dh_tiles * plan->dh_ranges;
  plan->dw_items = cdiv(plan->chunk, kBM) * cdiv(feat, kDwN);
  return cudaSuccess;
}

template <int kTN, int kEpi>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& b_lo,
                        const BwdEpi& ep, int m, int n, int k, int ranges, int sms,
                        cudaStream_t s) {
  const int items = cdiv(m, kBM) * cdiv(n, kTN) * ranges;
  bwd_gemm_kernel<kTN, kEpi><<<items < sms ? items : sms, kThreads, bwd_smem_bytes<kTN>(), s>>>(
      a, b, b_lo, ep, m, n, k, ranges, items);
  return cudaGetLastError();
}

cudaError_t split_transpose(const float* src, int rows_n, int feat, float* hi, float* lo, int ld,
                            cudaStream_t s) {
  split_transpose_kernel<<<dim3(cdiv(ld, 32), cdiv(feat, 32)), dim3(32, 8), 0, s>>>(
      src, rows_n, feat, hi, lo, ld);
  return cudaGetLastError();
}

}  // namespace

// floats of scratch la_row_lse_bwd needs: w_lo of a chunk [chunk, feat], w^T
// hi and lo of a chunk [feat, chunk padded to 4], h^T hi and lo [feat, rows
// padded to 4], p [rows, chunk padded], p^T [chunk, rows padded] and the dh
// partials [ranges, rows, feat]; chunk = min(cols, 4224)
LA_API long long la_row_lse_bwd_scratch_floats(int rows, int feat, int cols) {
  return bwd_scratch(nullptr, rows, feat, cols).floats;
}

// out[0..6] = SMs, chunks, columns of the first chunk, items of the p
// kernel, K ranges and items of the dh kernel, items of the dw kernel (a
// chunk of the first's width)
LA_API int la_row_lse_bwd_plan(int rows, int feat, int cols, long long* out) {
  BwdPlan plan;
  const cudaError_t err = bwd_plan(rows, feat, cols, &plan);
  if (err != cudaSuccess) return err;
  const long long v[7] = {plan.sms,       plan.chunks,    plan.chunk,   plan.p_items,
                          plan.dh_ranges, plan.dh_items, plan.dw_items};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
}

// h f32[rows, feat]; w f32 rows [cols, feat] and b f32[cols] point at the
// slice's first column; lse, g f32[rows]; dh f32[rows, feat], dw f32[cols,
// feat], db f32[cols], each null when it is not wanted; scratch f32 of
// la_row_lse_bwd_scratch_floats. feat % 4 == 0 and h, w, scratch 16-byte
// aligned (the wrapper checks).
LA_API int la_row_lse_bwd(const void* h, const void* w, const void* b, const void* lse,
                          const void* g, void* dh, void* dw, void* db, void* scratch, int rows,
                          int feat, int cols, void* stream) {
  using la::hopper::encode_f32_rows;
  if (cols <= 0 || feat <= 0 || feat % 4) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows <= 0) {  // no rows: the gradients of w and b are zero
    if (dw != nullptr &&
        (err = cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)cols * feat, s)) != cudaSuccess)
      return err;
    if (db != nullptr) return cudaMemsetAsync(db, 0, sizeof(float) * (size_t)cols, s);
    return cudaSuccess;
  }
  if (dh == nullptr && dw == nullptr && db == nullptr) return cudaSuccess;
  BwdPlan plan;
  if ((err = bwd_plan(rows, feat, cols, &plan)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(bwd_gemm_kernel<128, kEpiP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bwd_smem_bytes<128>())) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_gemm_kernel<kDhN, kEpiDh>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bwd_smem_bytes<kDhN>())) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_gemm_kernel<kDwN, kEpiDw>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bwd_smem_bytes<kDwN>())) != cudaSuccess)
    return err;
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const BwdScratch sc = bwd_scratch(static_cast<float*>(scratch), rows, feat, cols);
  const int rpad = round4(rows), sms = plan.sms;
  const bool want_pt = dw != nullptr || db != nullptr;
  const int ranges = dh != nullptr ? plan.dh_ranges : 1;
  float* part = ranges == 1 ? static_cast<float*>(dh) : sc.part;

  CUtensorMap tm_h, tm_ht, tm_ht_lo;
  if ((err = encode_f32_rows(&tm_h, h, rows, feat, kBM)) != cudaSuccess) return err;
  if (want_pt) {
    if ((err = split_transpose(hf, rows, feat, sc.ht_hi, sc.ht_lo, rpad, s)) != cudaSuccess)
      return err;
    if ((err = encode_f32_rows(&tm_ht, sc.ht_hi, feat, rpad, kDwN)) != cudaSuccess ||
        (err = encode_f32_rows(&tm_ht_lo, sc.ht_lo, feat, rpad, kDwN)) != cudaSuccess)
      return err;
  }
  for (int c0 = 0; c0 < cols; c0 += kChunk) {
    const int nc = cols - c0 < kChunk ? cols - c0 : kChunk, npad = round4(nc);
    const float* wc = wf + (size_t)c0 * feat;
    const size_t n4 = (size_t)nc * feat / 4;
    const size_t split_blocks = (n4 + 255) / 256;
    split_lo_kernel<<<(unsigned)(split_blocks < 8u * sms ? split_blocks : 8u * sms), 256, 0, s>>>(
        reinterpret_cast<const float4*>(wc), reinterpret_cast<float4*>(sc.w_lo), n4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    // p (and p^T) of the chunk
    CUtensorMap tm_w, tm_w_lo;
    if ((err = encode_f32_rows(&tm_w, wc, nc, feat, 128)) != cudaSuccess ||
        (err = encode_f32_rows(&tm_w_lo, sc.w_lo, nc, feat, 128)) != cudaSuccess)
      return err;
    BwdEpi ep{};
    ep.bias = bf + c0;
    ep.lse = static_cast<const float*>(lse);
    ep.g = static_cast<const float*>(g);
    ep.p = dh != nullptr ? sc.p : nullptr;
    ep.p_ld = npad;
    ep.pt = want_pt ? sc.pt : nullptr;
    ep.pt_ld = rpad;
    if ((err = launch_gemm<128, kEpiP>(tm_h, tm_w, tm_w_lo, ep, rows, nc, feat, 1, sms, s)) !=
        cudaSuccess)
      return err;

    if (dh != nullptr) {  // dh (its partials) += p w
      if ((err = split_transpose(wc, nc, feat, sc.wt_hi, sc.wt_lo, npad, s)) != cudaSuccess)
        return err;
      CUtensorMap tm_p, tm_wt, tm_wt_lo;
      if ((err = encode_f32_rows(&tm_p, sc.p, rows, npad, kBM)) != cudaSuccess ||
          (err = encode_f32_rows(&tm_wt, sc.wt_hi, feat, npad, kDhN)) != cudaSuccess ||
          (err = encode_f32_rows(&tm_wt_lo, sc.wt_lo, feat, npad, kDhN)) != cudaSuccess)
        return err;
      BwdEpi ed{};
      ed.out = part;
      ed.part_stride = (size_t)rows * feat;
      ed.accumulate = c0 > 0;
      const int stages = cdiv(nc, kBK);
      if ((err = launch_gemm<kDhN, kEpiDh>(tm_p, tm_wt, tm_wt_lo, ed, rows, feat, nc,
                                            ranges < stages ? ranges : stages, sms, s)) !=
          cudaSuccess)
        return err;
    }
    if (want_pt) {  // dw and db of the chunk from p^T
      CUtensorMap tm_pt;
      if ((err = encode_f32_rows(&tm_pt, sc.pt, nc, rpad, kBM)) != cudaSuccess) return err;
      BwdEpi ew{};
      ew.out = dw != nullptr ? static_cast<float*>(dw) + (size_t)c0 * feat : nullptr;
      ew.db = db != nullptr ? static_cast<float*>(db) + c0 : nullptr;
      const int n = dw != nullptr || feat < kDwN ? feat : kDwN;  // db alone: one column tile
      if ((err = launch_gemm<kDwN, kEpiDw>(tm_pt, tm_ht, tm_ht_lo, ew, nc, n, rows, 1, sms, s)) !=
          cudaSuccess)
        return err;
    }
  }
  if (dh == nullptr || ranges == 1) return cudaSuccess;
  const size_t n4 = (size_t)rows * feat / 4;
  const size_t blocks = (n4 + 255) / 256;
  bwd_reduce_kernel<<<(unsigned)(blocks < 8u * sms ? blocks : 8u * sms), 256, 0, s>>>(
      reinterpret_cast<const float4*>(sc.part), static_cast<float4*>(dh), n4, ranges);
  return cudaGetLastError();
}
