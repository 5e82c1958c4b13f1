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
//   cores read of a 32-bit operand: they truncate), x_lo = x - x_hi (exact);
//   h . w ~ h_lo . w_hi + h_hi . w_lo + h_hi . w_hi, summed in float32.
// lo is formed against the truncated hi, so hi + lo is the float32 value
// whatever the hardware drops of hi; what is left out is lo . lo and the
// truncation of lo itself, 2^-20 of a product each.
//
// Bound on H100: operations. At the main path (B = 16 x 1500 rows, feat
// 768, 21127 columns) the function is 2 x 24000 x 768 x 21127 = 779 GFLOP:
// 11.6 ms in float32 on the CUDA cores, and three TF32 products of it,
// 2337 GFLOP, are 4.7 ms at the tensor cores' 494.5 TFLOP/s. The design:
// * la_row_lse launches three kernels on the stream: split_lo_kernel writes
//   w_lo once (w_hi is w itself), row_lse_kernel forms partial (max, sum)
//   pairs, merge_kernel combines them.
// * row_lse_kernel is a persistent grid of one block per SM walking work
//   items of (128 rows of h, a range of 256-column tiles of w); consecutive
//   items share their rows, so neighbouring SMs read the same h from L2.
//   Columns are split into ranges so that the items fill the grid's last
//   wave; each item writes its rows' (max, sum) to scratch and the merge
//   runs over the ranges in a fixed order: no atomics, equal bits from run
//   to run.
// * Warpgroup 0 is the producer: one thread keeps a ring of stages in
//   flight with TMA, each 32 feat of the item's 128 rows of h and of the
//   tile's 256 rows of w_hi and w_lo (tensor maps with feat innermost,
//   128-byte rows, 128-byte swizzle; rows, columns and feat past the
//   extents arrive as zeros), completion on full/empty mbarriers. It hands
//   its registers to the consumers (setmaxnreg).
// * Warpgroups 1-2 each own 64 rows. A consumer reads its h fragment from
//   the stage into registers, splits it there, and issues wgmma
//   m64n256k8.tf32 with A from registers and the w tiles as the K-major B
//   operand: 128 float32 accumulators a thread. With A in registers a
//   product reads 8 KB of shared memory in its 128 tensor-core clocks, half
//   of what the SM can deliver. Products are committed in groups of half a
//   stage (two k-steps, six products) on two sets of A registers, so the
//   next group's fragment is loaded and split while one runs.
// * After a tile's last product the epilogue runs on the accumulator
//   fragment: bias added (-inf for columns past `cols`, whose products are
//   zeros), row max over the thread's 64 values and the quad that shares
//   the row, exp2 of the difference summed into the running (m, s). One
//   consumer's epilogue overlaps the other's products.
// The CTC slice w[1:-1] is taken by the caller's pointer offset and count.
#include "hopper.cuh"

namespace {

using namespace la::hopper;

constexpr int kConsumers = 2;                 // warpgroups of 64 rows of h
constexpr int kBM = 64 * kConsumers;          // rows of h a work item
constexpr int kBN = 256;                      // columns of w a tile (the wgmma's n)
constexpr int kBK = 32;                       // feat a stage: 128-byte rows
constexpr int kStages = 2;                    // stages in the ring
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

__global__ void split_lo_kernel(const float4* __restrict__ w, float4* __restrict__ lo, size_t n4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = w[i];
    lo[i] = make_float4(v.x - tf32_hi(v.x), v.y - tf32_hi(v.y), v.z - tf32_hi(v.z),
                        v.w - tf32_hi(v.w));
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
    lo[i] = __float_as_uint(v[i] - top);
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
    wgmma_m64n256k8_tf32_rs(acc, lo[j], desc_hi + 2 * kk, accumulate || j > 0);
    wgmma_m64n256k8_tf32_rs(acc, hi[j], desc_lo + 2 * kk, 1);
    wgmma_m64n256k8_tf32_rs(acc, hi[j], desc_hi + 2 * kk, 1);
  }
  wgmma_commit();
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
    float acc[kBN / 2];
    uint32_t a_hi[2][2][4] = {}, a_lo[2][2][4] = {};  // [set][k-step][register]
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int r0 = (w / ranges) * kBM, range = w % ranges;
      int first, last;
      tiles_of(range, ranges, col_tiles, &first, &last);
      float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
      for (int tile = first; tile < last; ++tile) {
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int st = it % kStages;
          mbar_wait(&sm.full[st], (it / kStages) & 1);
          const char* row_ptr = reinterpret_cast<const char*>(sm.h[st]) + row_off;
          const uint64_t desc_hi = sw128_desc(sm.w_hi[st], 16, 1024);
          const uint64_t desc_lo = sw128_desc(sm.w_lo[st], 16, 1024);
          load_a(a_hi[0][0], a_lo[0][0], row_ptr, xor16, 0);
          load_a(a_hi[0][1], a_lo[0][1], row_ptr, xor16, 1);
          issue_half(acc, a_hi[0], a_lo[0], desc_hi, desc_lo, 0, c > 0);
          wgmma_wait<1>();  // the previous stage's second half has run
          fence_a(a_hi[1], a_lo[1]);
          if (c > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % kStages]);  // it may be refilled
          }
          load_a(a_hi[1][0], a_lo[1][0], row_ptr, xor16, 2);
          load_a(a_hi[1][1], a_lo[1][1], row_ptr, xor16, 3);
          issue_half(acc, a_hi[1], a_lo[1], desc_hi, desc_lo, 2, 1);
          wgmma_wait<1>();  // this stage's first half has run
          fence_a(a_hi[0], a_lo[0]);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_a(a_hi[1], a_lo[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % kStages]);
        merge_tile(acc, m, s, bias, tile * kBN, cols, lane);
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
