// The recurrence of one bi-GRU layer, both directions in one launch, in
// float32, with PyTorch's gate order:
//   r = sigmoid(gi_r + W_hr h + b_hr),  z = sigmoid(gi_z + W_hz h + b_hz),
//   n = tanh(gi_n + r (W_hn h + b_hn)),  h' = (1 - z) n + z h,
// where gi = x W_ih^T + b_ih, the input products of the whole sequence,
// comes from the wrapper (one float32 matmul a layer, the JAX scan's
// hoisted projection). Row b of direction d runs the steps t < len_b in its
// own order: the forward direction t = 0, 1, ...; the reverse one from
// t = len_b - 1 down, from a zero state. Outputs at t >= len_b are zero.
//
// Replaces no TPU kernel: the JAX package runs this as a lax.scan
// (lyricalignment_tpu/ops/gru.py:36-88), and the port had cuDNN's packed
// RNN, one small GEMM and one cell kernel a time step and direction.
//
// Bound on H100: latency. The work is small (at B = 16, H = 384 a step of
// one direction is 16 x 1152 x 384 multiply-adds, 42.5 GFLOP a layer for
// 1500 steps: 0.63 ms at the CUDA cores' 67 TFLOP/s), but each step needs
// the whole state of the step before: 1500 dependent steps a layer. The
// design keeps everything a step needs on chip and its chain short:
// * A thread block cluster a direction and group of at most 8 batch rows,
//   of C = ceil(H / 24) <= 16 blocks (one an SM) that split the hidden
//   units, at most 24 a block. The host makes as many groups as the card
//   holds clusters of that size at once (an H100 holds 7 of 16 blocks:
//   B = 16 runs as 3 groups of 6, 6 and 4 rows a direction on 96 SMs).
// * W_hh stays in registers for all T steps: a unit's three gate rows are
//   split over 16 lanes, each holding every 16th float4 of the columns
//   (H = 384: 72 floats a thread, 384 threads a block). b_hh is in the
//   registers of the lanes that update the cell.
// * The state h_t of the cluster's rows lives, whole, in every block's
//   shared memory, in two buffers. A step reads buffer t % 2 (a float4
//   load serves the 2 units of a warp), forms each lane's 3 gates x rows
//   partial sums, and reduces them over the unit's 16 lanes in a
//   reduce-scatter (each level halves what a lane keeps: 21 shuffles for 6
//   rows), so that 8 lanes of the unit end with one row's three sums each
//   and every row's cell is updated at once. The block's slice of h_{t+1}
//   goes to buffer (t + 1) % 2 of every block of the cluster by st.async
//   into distributed shared memory, each 16 bytes counted on the receiving
//   block's mbarrier: a block waits only for the bytes of the next state,
//   with no cluster-wide barrier. Two buffers and two staging slices keep
//   every write behind the reads it could disturb: a block sends h_{t+2}
//   into a buffer only after every block has sent it h_{t+1}, which each
//   does after its block barrier of step t.
// * gi of step t + 2 is loaded into registers while steps t and t + 1 run,
//   so the chain never waits on device memory.
// * The lengths are read on the device; the host gives only T.
// A step at the cells' shape takes ~4,200 cycles (PERF.md): ~1,900 of
// products, ~800 of waiting for the peers' slices, the rest the reduction,
// the cell, the block barrier and the sends. Sums are float32 fused
// multiply-adds in another order than cuDNN's, and sigmoid and tanh are
// the accurate expf and tanhf: no TF32 anywhere.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 16;       // lanes that split a unit's products (the reduction's 4 levels)
constexpr int kChunk = 2;        // batch rows whose sums a lane's reduction splits
constexpr int kMaxChunks = 4;    // at most 8 rows a cluster
constexpr int kMaxUnits = 24;    // hidden units a block
constexpr int kMaxCluster = 16;  // blocks a cluster (above 8: a non-portable size)
constexpr int kMaxThreads = kLanes * kMaxUnits;

// How a launch lays out its work.
struct Plan {
  int batch, steps, hidden, dirs;
  int cluster;  // blocks a cluster: C = ceil(H / 24)
  int units;    // hidden units a block: ceil(H / C) (the last block may own fewer)
  int units4;   // units rounded up to 4: a block's span of columns in the state
  int nk4;      // float4 columns a lane: the state's width is 4 kLanes nk4 >= C units4
  int width;    // 4 kLanes nk4
  int groups;   // clusters a direction, each over `rows` batch rows
  int rows;     // batch rows a cluster, <= 8
  int chunks;   // ceil(rows / 2)
  int active;   // clusters of this size the card holds at once
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// the shared::cluster address of a shared::cta address in block `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// 16 bytes into a block's shared memory, counted on that block's mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// spins until the phase of the given parity has completed; acquire at
// cluster scope, so that the peers' st.async data is seen. A step takes
// microseconds: a wait of 2^32 cycles (~2 s) is a fault, and traps rather
// than hang the card.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = la::hopper::smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

template <int NK4, int NCH>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gru_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const int* __restrict__ lens,
               float* __restrict__ out, Plan p) {
  constexpr int R = NCH * kChunk;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2];  // bars[b]: every slice of buffer b has landed
  float* hbuf = smem;                     // [2][R][width]: h_t of the cluster's rows
  float* stage = smem + 2 * R * p.width;  // [2][R][units4]: this block's slice of h_{t+1}

  const int c = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / p.cluster;
  const int d = cid % p.dirs;
  const int row0 = (cid / p.dirs) * p.rows;
  const int nrows = min(p.rows, p.batch - row0);
  const int tid = threadIdx.x;
  const int ks = tid % kLanes;
  const int u = tid / kLanes;            // the block's unit
  const int H = p.hidden, H3 = 3 * H, T = p.steps;
  const int j = c * p.units + u;         // the layer's unit
  const bool unit_ok = u < p.units && j < H;
  // after the reduction lanes 2 q and 2 q + 1 of each half of the unit's
  // lanes hold chunk q's sums, the first half of row 0, the second of row 1;
  // the even lane updates that row's cell
  const int rr = ((ks >> 1) & 3) * kChunk + (ks >> 3);
  const bool updates = unit_ok && !(ks & 1) && ((ks >> 1) & 3) < NCH && rr < nrows;

  for (int i = tid; i < 2 * R * (p.width + p.units4); i += blockDim.x) smem[i] = 0.0f;
  // bytes a buffer receives a step: every block's slice of every row
  const uint32_t tx = 4u * p.cluster * nrows * p.units4;
  if (tid == 0) {
    la::hopper::mbar_init(&bars[0], 1);
    la::hopper::mbar_init(&bars[1], 1);
    la::hopper::fence_barrier_init();
    la::hopper::mbar_arrive_expect_tx(&bars[0], tx);
    la::hopper::mbar_arrive_expect_tx(&bars[1], tx);
  }

  // W_hh rows (gate, j), the float4 columns ks + kLanes i of the state's
  // layout: column block * units4 + unit holds unit block * units + unit
  float4 w[3][NK4];
  const float* wd = w_hh + static_cast<size_t>(d) * H3 * H;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < NK4; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (ks + kLanes * i) + e;
        const int cb = col / p.units4, cu = col - cb * p.units4;
        const int k = cb * p.units + cu;
        const bool ok = unit_ok && cu < p.units && cb < p.cluster && k < H;
        v[e] = ok ? wd[static_cast<size_t>(g * H + j) * H + k] : 0.0f;
      }
      w[g][i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  float bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bh[g] = updates ? b_hh[d * H3 + g * H + j] : 0.0f;
  const int len = updates ? lens[row0 + rr] : 0;
  // the 16-byte pieces of the slice this thread sends a step: the float4
  // `off` of the stage to peer `peer`'s buffer 0 at `dst` (buffer 1 lies
  // 4 R width bytes on, bars[1] 8 bytes after bars[0]), counted on its
  // bars[0] at `bar`
  constexpr int kItems = (kMaxCluster * R + 4 * kLanes - 1) / (4 * kLanes);
  const int per_row = p.units4 / 4, n4 = nrows * per_row;
  uint32_t dst[kItems], bar[kItems];
  int off[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int i = tid + m * blockDim.x;
    off[m] = -1;
    if (i < p.cluster * n4) {
      const int peer = i / n4, k = i - peer * n4;
      const int row = k / per_row, c4 = k - row * per_row;
      off[m] = row * p.units4 + 4 * c4;
      dst[m] = peer_addr(la::hopper::smem_u32(hbuf + row * p.width + c * p.units4 + 4 * c4), peer);
      bar[m] = peer_addr(la::hopper::smem_u32(&bars[0]), peer);
    }
  }
  const uint32_t buf_bytes = 4u * R * p.width;

  const size_t gi_row = static_cast<size_t>(p.dirs) * H3;
  auto load_gi = [&](int s, float(&dst_gi)[3]) {
    if (s >= T || !updates) return;
    const int t = d ? T - 1 - s : s;
    const float* src = gi + (static_cast<size_t>(row0 + rr) * T + t) * gi_row + d * H3 + j;
#pragma unroll
    for (int g = 0; g < 3; ++g) dst_gi[g] = __ldg(src + g * H);
  };

  auto step = [&](int s, float(&gv)[3]) {
    const int b = s & 1;
    const int t = d ? T - 1 - s : s;
    if (s > 0) {
      // h_s arrived in the ((s - 1) / 2)-th phase of bars[b]
      wait_cluster(&bars[b], ((s - 1) >> 1) & 1);
      if (tid == 0) la::hopper::mbar_arrive_expect_tx(&bars[b], tx);  // its next phase
    }
    const float* hc = hbuf + b * R * p.width;
    float acc[NCH][kChunk][3];
#pragma unroll
    for (int q = 0; q < NCH; ++q)
#pragma unroll
      for (int r = 0; r < kChunk; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[q][r][g] = 0.0f;
#pragma unroll
    for (int i = 0; i < NK4; ++i) {
      float4 h4[NCH][kChunk];
#pragma unroll
      for (int q = 0; q < NCH; ++q)
#pragma unroll
        for (int r = 0; r < kChunk; ++r)
          h4[q][r] = *reinterpret_cast<const float4*>(hc + (q * kChunk + r) * p.width +
                                                      4 * (ks + kLanes * i));
#pragma unroll
      for (int q = 0; q < NCH; ++q)
#pragma unroll
        for (int r = 0; r < kChunk; ++r)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            acc[q][r][g] = fmaf(w[g][i].x, h4[q][r].x, acc[q][r][g]);
            acc[q][r][g] = fmaf(w[g][i].y, h4[q][r].y, acc[q][r][g]);
            acc[q][r][g] = fmaf(w[g][i].z, h4[q][r].z, acc[q][r][g]);
            acc[q][r][g] = fmaf(w[g][i].w, h4[q][r].w, acc[q][r][g]);
          }
    }
    // reduce the sums over the unit's 16 lanes, halving what each lane
    // keeps at every level: bit 3 of ks keeps a chunk's row 0 or row 1,
    // bit 2 chunks {0, 1} or {2, 3}, bit 1 one of those; bit 0 adds the rest
    float v1[4][3], v2[2][3], sum[3];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (q < NCH) {
          const bool hi = ks & 8;
          const float keep = hi ? acc[q][1][g] : acc[q][0][g];
          const float give = hi ? acc[q][0][g] : acc[q][1][g];
          v1[q][g] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
        } else {
          v1[q][g] = 0.0f;
        }
      }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const bool hi = ks & 4;
        const float keep = hi ? v1[2 + q][g] : v1[q][g];
        const float give = hi ? v1[q][g] : v1[2 + q][g];
        v2[q][g] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
      }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const bool hi = ks & 2;
      const float keep = hi ? v2[1][g] : v2[0][g];
      const float give = hi ? v2[0][g] : v2[1][g];
      sum[g] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
      sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], 1);
    }

    float* sl = stage + b * R * p.units4;
    if (updates) {
      const float h = hc[rr * p.width + c * p.units4 + u];
      const float rg = sigmoid(gv[0] + (sum[0] + bh[0]));
      const float zg = sigmoid(gv[1] + (sum[1] + bh[1]));
      const float ng = tanhf(gv[2] + rg * (sum[2] + bh[2]));
      const bool active = t < len;
      const float h1 = active ? (1.0f - zg) * ng + zg * h : h;
      out[(static_cast<size_t>(row0 + rr) * T + t) * (p.dirs * H) + d * H + j] =
          active ? h1 : 0.0f;
      sl[rr * p.units4 + u] = h1;
    }
    if (s + 1 == T) return;  // h_T is not needed
    load_gi(s + 2, gv);
    __syncthreads();
    // this block's slice of h_{t+1} into buffer b ^ 1 of every block, each
    // 16 bytes counted on that block's bars[b ^ 1]
#pragma unroll
    for (int m = 0; m < kItems; ++m)
      if (off[m] >= 0)
        st_async(dst[m] + (b ^ 1) * buf_bytes, *reinterpret_cast<const float4*>(sl + off[m]),
                 bar[m] + 8u * (b ^ 1));
  };

  float gi_a[3] = {}, gi_b[3] = {};
  load_gi(0, gi_a);
  load_gi(1, gi_b);
  cluster.sync();  // every block's buffers and barriers are set before a peer writes
  for (int s = 0; s < T; s += 2) {
    step(s, gi_a);
    if (s + 1 < T) step(s + 1, gi_b);
  }
  cluster.sync();  // no block leaves while a peer may still address it
}

int smem_bytes(const Plan& p) {
  return static_cast<int>(sizeof(float)) * 2 * p.chunks * kChunk * (p.width + p.units4);
}

cudaLaunchConfig_t config(const Plan& p, cudaLaunchAttribute* attr, int clusters,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster * clusters);
  cfg.blockDim = dim3(kLanes * p.units4);
  cfg.dynamicSmemBytes = smem_bytes(p);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the plan's size the card holds at once (at the most shared
// memory a block takes, 4 chunks), remembered by cluster size and width.
template <int NK4>
cudaError_t active_clusters(Plan p, int* n) {
  static int cached[kMaxCluster + 1][kMaxUnits + 1] = {};
  int& seen = cached[p.cluster][p.units4];
  if (seen > 0) {
    *n = seen;
    return cudaSuccess;
  }
  p.chunks = kMaxChunks;
  auto kernel = gru_kernel<NK4, kMaxChunks>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                         p.cluster > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(p, attr, 1, nullptr);
  err = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (*n < 1) return cudaErrorInvalidConfiguration;  // no cluster of this size fits
  seen = *n;
  return cudaSuccess;
}

template <int NK4>
cudaError_t finish_plan(Plan* p) {
  cudaError_t err = active_clusters<NK4>(*p, &p->active);
  if (err != cudaSuccess) return err;
  const int b = p->batch;
  const int fit = max(1, p->active / p->dirs);  // groups that run at once
  int groups = max((b + kMaxChunks * kChunk - 1) / (kMaxChunks * kChunk), min(b, fit));
  p->rows = (b + groups - 1) / groups;
  p->groups = (b + p->rows - 1) / p->rows;
  p->chunks = (p->rows + kChunk - 1) / kChunk;
  return cudaSuccess;
}

cudaError_t make_plan(int batch, int steps, int hidden, int dirs, Plan* out) {
  if (batch < 1 || steps < 1 || hidden < 1 || dirs < 1 || dirs > 2) return cudaErrorInvalidValue;
  Plan p = {};
  p.batch = batch;
  p.steps = steps;
  p.hidden = hidden;
  p.dirs = dirs;
  p.cluster = (hidden + kMaxUnits - 1) / kMaxUnits;
  if (p.cluster > kMaxCluster) return cudaErrorInvalidValue;  // H > 384
  p.units = (hidden + p.cluster - 1) / p.cluster;
  p.units4 = (p.units + 3) / 4 * 4;
  // C units4 <= 16 x 24 = 384 columns: at most 6 float4 a lane. Two
  // widths are built, 64 and 384 columns (H <= 32 and the rest), which
  // keeps the library's build short; zero columns past H cost no more than
  // their products.
  p.nk4 = p.cluster * p.units4 <= 4 * kLanes ? 1 : 6;
  p.width = 4 * kLanes * p.nk4;
  const cudaError_t err = p.nk4 == 1 ? finish_plan<1>(&p) : finish_plan<6>(&p);
  if (err != cudaSuccess) return err;
  *out = p;
  return cudaSuccess;
}

template <int NK4, int NCH>
cudaError_t launch(const Plan& p, const float* gi, const float* w_hh, const float* b_hh,
                   const int* lens, float* out, cudaStream_t stream) {
  auto kernel = gru_kernel<NK4, NCH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                         p.cluster > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(p, attr, p.groups * p.dirs, stream);
  return cudaLaunchKernelEx(&cfg, kernel, gi, w_hh, b_hh, lens, out, p);
}

}  // namespace

// The launch's layout at this shape, into out[8]: cluster size, hidden
// units a block, clusters a direction, batch rows a cluster, float4
// columns a lane, clusters the card holds at once, threads a block, shared
// bytes a block. Returns the cudaError_t of the plan (nonzero: no launch
// takes this shape).
LA_API int la_gru_plan(int batch, int steps, int hidden, int dirs, int* out) {
  Plan p;
  cudaError_t err = make_plan(batch, steps, hidden, dirs, &p);
  if (err != cudaSuccess) return err;
  const int v[8] = {p.cluster, p.units, p.groups, p.rows, p.nk4, p.active, kLanes * p.units4,
                    smem_bytes(p)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}

// gi f32[batch, steps, dirs * 3H] (the input products and b_ih; direction d
// at columns [3H d, 3H (d + 1)), gates r, z, n), w_hh f32[dirs, 3H, H],
// b_hh f32[dirs, 3H], lens int32[batch] (each in [1, steps]) ->
// out f32[batch, steps, dirs * H]
LA_API int la_gru_recurrence(const void* gi, const void* w_hh, const void* b_hh, const void* lens,
                             void* out, int batch, int steps, int hidden, int dirs,
                             void* stream) {
  if (batch == 0 || steps == 0) return cudaSuccess;
  Plan p;
  cudaError_t err = make_plan(batch, steps, hidden, dirs, &p);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto a0 = static_cast<const float*>(gi);
  auto a1 = static_cast<const float*>(w_hh);
  auto a2 = static_cast<const float*>(b_hh);
  auto a3 = static_cast<const int*>(lens);
  auto a4 = static_cast<float*>(out);
#define LA_GRU_CASE(NK4)                                                 \
  case NK4:                                                              \
    switch (p.chunks) {                                                  \
      case 1: return launch<NK4, 1>(p, a0, a1, a2, a3, a4, s);           \
      case 2: return launch<NK4, 2>(p, a0, a1, a2, a3, a4, s);           \
      case 3: return launch<NK4, 3>(p, a0, a1, a2, a3, a4, s);           \
      default: return launch<NK4, 4>(p, a0, a1, a2, a3, a4, s);          \
    }
  switch (p.nk4) {
    LA_GRU_CASE(1)
    LA_GRU_CASE(6)
  }
#undef LA_GRU_CASE
  return cudaErrorInvalidValue;
}
