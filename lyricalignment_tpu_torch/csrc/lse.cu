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

// the A fragment of k-step kk (8 feat) of a stage's h tile, split: this
// thread's rows g and g + 8 (row_ptr points at row g, 4 t bytes in; xor16 is
// the swizzle of its 16-byte chunks, 16 (g % 8)), columns t and t + 4
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const char* row_ptr,
                                       int xor16, int kk) {
  const int o0 = (32 * kk) ^ xor16, o1 = (32 * kk + 16) ^ xor16;
  const float v[4] = {*reinterpret_cast<const float*>(row_ptr + o0),
                      *reinterpret_cast<const float*>(row_ptr + 1024 + o0),
                      *reinterpret_cast<const float*>(row_ptr + o1),
                      *reinterpret_cast<const float*>(row_ptr + 1024 + o1)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float top = tf32_hi(v[i]);
    hi[i] = __float_as_uint(top);
    lo[i] = tf32_rna(v[i] - top);
  }
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

// the three products of k-steps kk0 and kk0 + 1 of a stage, one group; a
// k-step is 32 bytes into the swizzled 128-byte rows
__device__ __forceinline__ void issue_half(float (&acc)[kBN / 2], uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4], uint64_t desc_hi,
                                           uint64_t desc_lo, int kk0, int accumulate) {
  fence_regs(acc);
  fence_a(hi, lo);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kk = kk0 + j;
    wgmma_m64n128k8_tf32_rs(acc, lo[j], desc_hi + 2 * kk, accumulate || j > 0);
    wgmma_m64n128k8_tf32_rs(acc, hi[j], desc_lo + 2 * kk, 1);
    wgmma_m64n128k8_tf32_rs(acc, hi[j], desc_hi + 2 * kk, 1);
  }
  wgmma_commit();
}

// run += acc, rounded to nearest: a group's products into the running sum
__device__ __forceinline__ void add_group(float (&run)[kBN / 2], const float (&acc)[kBN / 2]) {
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) run[j] = __fadd_rn(run[j], acc[j]);
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
// Pallas kernel, so this pair is port work. Like the forward it never writes
// the [rows, cols] logits or p to device memory: each block recomputes its
// tile of logits.
//
// Bound on H100: operations. At the training shape (rows 3000 = 2 x 1500,
// feat 768, 21127 or 21128 columns) the pair does four products of
// 2 x 3000 x 768 x 21128 = 97.4 GFLOP (the logits twice, dh, dw): 389 GFLOP,
// 5.8 ms on the float32 CUDA cores at 67 TFLOP/s, 2.4 ms as three TF32
// products each on the tensor cores (the forward's split). This first design runs on
// the CUDA cores in plain float32 FMA (no tensor cores), deterministic and
// without atomics:
// * Both kernels are one body: a block keeps 32 rows of one operand X
//   resident in shared memory and streams tiles of 32 rows of the other, Y;
//   for each Y tile it forms S = X Y^T (32 x 32) with the feat split into four
//   slices over the block's 256 threads (a 4 x 4 micro-tile each, summed in
//   slice order), turns S into p, and accumulates acc[x, :] += sum_y p[x, y]
//   Y[y, :] in registers (8 x-rows by 12 feat a thread, 96 floats).
// * la_row_lse_bwd_dh: X = 32 rows of h, Y = tiles of w. The column tiles are
//   split into ranges so that the blocks fill the grid's waves; each range
//   writes its partial dh to scratch and a reduce kernel sums the ranges in
//   order.
// * la_row_lse_bwd_dw: X = 32 columns of w, Y = every tile of 32 rows of h;
//   a block writes its 32 rows of dw and its 32 entries of db.
// * Rows of 768 floats are padded by 4 in shared memory, so that the
//   micro-tile loads of 8 neighbouring rows fall in distinct banks.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBwdTile = 32;        // rows of X and of a Y tile
constexpr int kBwdThreads = 256;
constexpr int kBwdMaxFeat = 768;    // 12 floats of acc a thread per x-row
constexpr int kBwdSlices = 4;       // feat slices of the S product
constexpr int kBwdMaxRanges = 8;

__host__ __device__ constexpr int bwd_stride(int feat) { return feat + 4; }

size_t bwd_smem_bytes(int feat) {
  return sizeof(float) * ((size_t)2 * kBwdTile * bwd_stride(feat)        // X, Y
                          + (size_t)kBwdSlices * kBwdTile * (kBwdTile + 1)  // S partials
                          + (size_t)kBwdTile * kBwdTile);                 // p^T
}

// rows [r0, r0 + 32) of src [n, feat] into dst (padded rows), zeros past n
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0, int n,
                                          int feat) {
  const int f4 = feat / 4, stride = bwd_stride(feat);
  for (int i = threadIdx.x; i < kBwdTile * f4; i += kBwdThreads) {
    const int r = i / f4, c = 4 * (i % f4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * feat + c));
    *reinterpret_cast<float4*>(dst + r * stride + c) = v;
  }
}

// S = X Y^T of the resident tile xs and the streamed tile ys (32 x 32,
// padded rows) into sp as four feat-slice partials [slice][x][y] (y padded
// to 33): a 4 x 4 micro-tile a thread (x rows xa + 8 i, y rows ya + 8 j, so
// the float4 loads of 8 neighbouring rows fall in distinct banks); ends on a
// barrier. The caller sums the slices in order.
__device__ __forceinline__ void tile_scores(const float* xs, const float* ys, float* sp,
                                            int feat) {
  const int tid = threadIdx.x, stride = bwd_stride(feat);
  const int ks = tid / 64, xa = (tid % 64) / 8, ya = tid % 8;
  const int slice = feat / kBwdSlices, k_lo = ks * slice;
  float s[4][4] = {};
  for (int k = k_lo; k < k_lo + slice; k += 4) {
    float4 xv[4], yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xv[i] = *reinterpret_cast<const float4*>(xs + (xa + 8 * i) * stride + k);
      yv[i] = *reinterpret_cast<const float4*>(ys + (ya + 8 * i) * stride + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(xv[i].x, yv[j].x, s[i][j]);
        s[i][j] = fmaf(xv[i].y, yv[j].y, s[i][j]);
        s[i][j] = fmaf(xv[i].z, yv[j].z, s[i][j]);
        s[i][j] = fmaf(xv[i].w, yv[j].w, s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sp[(ks * kBwdTile + xa + 8 * i) * (kBwdTile + 1) + ya + 8 * j] = s[i][j];
  __syncthreads();
}

// S[x][y] with the slices summed in order
__device__ __forceinline__ float tile_score(const float* sp, int x, int y) {
  float sum = sp[x * (kBwdTile + 1) + y];
#pragma unroll
  for (int q = 1; q < kBwdSlices; ++q) sum += sp[(q * kBwdTile + x) * (kBwdTile + 1) + y];
  return sum;
}

// kXRows: X holds rows of h (the dh kernel) rather than columns of w (dw).
// Returns after acc holds sum over the Y tiles [y_first, y_last) of p Y, and
// (dw kernel) db_acc, on threads < 32, the sum of p over those tiles for
// x-row threadIdx.x.
template <bool kXRows>
__device__ void bwd_body(const float* __restrict__ xsrc, const float* __restrict__ ysrc,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         const float* __restrict__ g, int x0, int x_n, int y_first, int y_last,
                         int y_n, int feat, float (&acc)[8][3][4], float& db_acc) {
  extern __shared__ float4 bwd_smem4[];
  float* smem = reinterpret_cast<float*>(bwd_smem4);
  const int stride = bwd_stride(feat);
  float* xs = smem;
  float* ys = xs + kBwdTile * stride;
  float* sp = ys + kBwdTile * stride;                   // [slice][x][y], y padded to 33
  float* pt = sp + kBwdSlices * kBwdTile * (kBwdTile + 1);  // p^T [y][x]
  const int tid = threadIdx.x;
  // the accumulator: x rows 8 xb .. 8 xb + 7, feat 4 fb + 256 j
  const int xb = tid / 64, fb = tid % 64;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  db_acc = 0.f;

  load_rows(xs, xsrc, x0, x_n, feat);
  for (int yt = y_first; yt < y_last; ++yt) {
    const int y0 = yt * kBwdTile;
    __syncthreads();  // the previous tile's ys and pt are no longer read
    load_rows(ys, ysrc, y0, y_n, feat);
    __syncthreads();

    tile_scores(xs, ys, sp, feat);

    // p = g exp(S + b - lse), the slices summed in order; zero past the extents
    for (int e = tid; e < kBwdTile * kBwdTile; e += kBwdThreads) {
      const int x = e / kBwdTile, y = e % kBwdTile;
      float v = 0.f;
      if (x0 + x < x_n && y0 + y < y_n) {
        const float sum = tile_score(sp, x, y);
        const int r = kXRows ? x0 + x : y0 + y, c = kXRows ? y0 + y : x0 + x;
        v = __ldg(g + r) * expf(sum + __ldg(bias + c) - __ldg(lse + r));
      }
      pt[y * kBwdTile + x] = v;
    }
    __syncthreads();
    if (!kXRows && tid < kBwdTile) {
      for (int y = 0; y < kBwdTile; ++y) db_acc += pt[y * kBwdTile + tid];
    }

    // acc[x, f] += sum_y p[x, y] Y[y, f]
    for (int y = 0; y < kBwdTile; ++y) {
      const float4 p0 = *reinterpret_cast<const float4*>(pt + y * kBwdTile + 8 * xb);
      const float4 p1 = *reinterpret_cast<const float4*>(pt + y * kBwdTile + 8 * xb + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int f = 4 * fb + 256 * j;
        if (f < feat) {
          const float4 yv = *reinterpret_cast<const float4*>(ys + y * stride + f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j][0] = fmaf(pv[i], yv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pv[i], yv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pv[i], yv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pv[i], yv.w, acc[i][j][3]);
          }
        }
      }
    }
  }
}

// acc rows 8 xb + i of the block's x tile into out [x_n, feat] (rows past
// x_n dropped)
__device__ __forceinline__ void store_acc(float* __restrict__ out, const float (&acc)[8][3][4],
                                          int x0, int x_n, int feat) {
  const int xb = threadIdx.x / 64, fb = threadIdx.x % 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x = x0 + 8 * xb + i;
    if (x >= x_n) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int f = 4 * fb + 256 * j;
      if (f < feat)
        *reinterpret_cast<float4*>(out + (size_t)x * feat + f) =
            make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
    }
  }
}

// grid (row tiles, ranges): partial dh of range q into part[q] (or dh itself
// when there is one range)
__global__ void __launch_bounds__(kBwdThreads, 1)
row_lse_bwd_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
                      const float* __restrict__ b, const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ part, int rows, int feat,
                      int cols) {
  const int col_tiles = (cols + kBwdTile - 1) / kBwdTile, q = blockIdx.y, ranges = gridDim.y;
  const int first = (int)((long long)q * col_tiles / ranges);
  const int last = (int)((long long)(q + 1) * col_tiles / ranges);
  float acc[8][3][4], db_unused;
  bwd_body<true>(h, w, b, lse, g, blockIdx.x * kBwdTile, rows, first, last, cols, feat, acc,
                 db_unused);
  store_acc(part + (size_t)q * rows * feat, acc, blockIdx.x * kBwdTile, rows, feat);
}

// dh = sum over the ranges of part, in the ranges' order
__global__ void bwd_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                  size_t n4, int ranges) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 s = part[i];
    for (int q = 1; q < ranges; ++q) {
      const float4 v = part[(size_t)q * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// grid (column tiles): rows of dw and entries of db
__global__ void __launch_bounds__(kBwdThreads, 1)
row_lse_bwd_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
                      const float* __restrict__ b, const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ dw,
                      float* __restrict__ db, int rows, int feat, int cols) {
  const int row_tiles = (rows + kBwdTile - 1) / kBwdTile, c0 = blockIdx.x * kBwdTile;
  float acc[8][3][4], db_acc;
  bwd_body<false>(w, h, b, lse, g, c0, cols, 0, row_tiles, rows, feat, acc, db_acc);
  store_acc(dw, acc, c0, cols, feat);
  if (threadIdx.x < kBwdTile && c0 + threadIdx.x < cols) db[c0 + threadIdx.x] = db_acc;
}

// column ranges of the dh kernel: the fewest waves x tiles a block, the
// fewest ranges among equals (one block an SM: its shared memory)
int plan_bwd_ranges(int row_tiles, int col_tiles, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int r = 1; r <= kBwdMaxRanges && r <= col_tiles; ++r) {
    const long long blocks = (long long)row_tiles * r;
    const long long cost = ((blocks + sms - 1) / sms) * ((col_tiles + r - 1) / r);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = r;
    }
  }
  return best;
}

cudaError_t bwd_prepare(int feat, int* sms) {
  if (feat <= 0 || feat % 16 || feat > kBwdMaxFeat) return cudaErrorInvalidValue;
  cudaError_t err;
  int device;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int bytes = (int)bwd_smem_bytes(feat);
  if ((err = cudaFuncSetAttribute(row_lse_bwd_dh_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
      cudaSuccess)
    return err;
  return cudaFuncSetAttribute(row_lse_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// floats of scratch la_row_lse_bwd_dh needs: the ranges' partial dh
LA_API long long la_row_lse_bwd_scratch_floats(int rows, int feat, int cols) {
  (void)cols;
  return (long long)kBwdMaxRanges * rows * feat;
}

// h f32[rows, feat]; w f32 rows [cols, feat] and b f32[cols] point at the
// slice's first column; lse, g f32[rows]; dh f32[rows, feat]; scratch f32 of
// la_row_lse_bwd_scratch_floats. feat % 16 == 0, feat <= 768, 16-byte
// aligned pointers (the wrapper checks).
LA_API int la_row_lse_bwd_dh(const void* h, const void* w, const void* b, const void* lse,
                             const void* g, void* dh, void* scratch, int rows, int feat,
                             int cols, void* stream) {
  if (rows <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  int sms;
  cudaError_t err = bwd_prepare(feat, &sms);
  if (err != cudaSuccess) return err;
  const int row_tiles = (rows + kBwdTile - 1) / kBwdTile;
  const int col_tiles = (cols + kBwdTile - 1) / kBwdTile;
  const int ranges = plan_bwd_ranges(row_tiles, col_tiles, sms);
  float* part = ranges == 1 ? static_cast<float*>(dh) : static_cast<float*>(scratch);
  row_lse_bwd_dh_kernel<<<dim3(row_tiles, ranges), kBwdThreads, bwd_smem_bytes(feat), s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(lse), static_cast<const float*>(g), part, rows, feat, cols);
  if ((err = cudaGetLastError()) != cudaSuccess || ranges == 1) return err;
  const size_t n4 = (size_t)rows * feat / 4;
  const size_t blocks = (n4 + 255) / 256;
  bwd_reduce_kernel<<<(unsigned)(blocks < 8u * sms ? blocks : 8u * sms), 256, 0, s>>>(
      reinterpret_cast<const float4*>(part), static_cast<float4*>(dh), n4, ranges);
  return cudaGetLastError();
}

// as la_row_lse_bwd_dh; dw f32[cols, feat], db f32[cols]
LA_API int la_row_lse_bwd_dw(const void* h, const void* w, const void* b, const void* lse,
                             const void* g, void* dw, void* db, int rows, int feat, int cols,
                             void* stream) {
  if (cols <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  int sms;
  cudaError_t err = bwd_prepare(feat, &sms);
  if (err != cudaSuccess) return err;
  if (rows <= 0) {  // no rows: the gradients are zero
    if ((err = cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)cols * feat, s)) != cudaSuccess)
      return err;
    return cudaMemsetAsync(db, 0, sizeof(float) * (size_t)cols, s);
  }
  row_lse_bwd_dw_kernel<<<(cols + kBwdTile - 1) / kBwdTile, kBwdThreads, bwd_smem_bytes(feat),
                          s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<float*>(dw),
      static_cast<float*>(db), rows, feat, cols);
  return cudaGetLastError();
}
