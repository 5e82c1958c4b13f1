// Reduced CTC: the alpha recursion of the fused training loss over the
// emissions of blank and of the target's own label positions only, forward
// (per-sample NLL) and backward (the gradient of the emissions).
//
// The JAX package computes this as lyricalignment_tpu/train/losses.py:
// _ctc_nll_single, a lax.scan over frames inside jax.vmap, and takes its
// gradient by autodiff of the scan: no Pallas kernel, so these two are port
// work. They keep its arithmetic exactly: S = 2N + 1 states (even = blank,
// odd 2p + 1 = label position p), the -1e30 sentinel for a state that cannot
// be reached, _lse3(a, b, c) = m + log(exp(a - m) + exp(b - m) + exp(c - m))
// with accurate expf / logf, the skip from s - 2 only where label p differs
// from label p - 1, label positions past the target unreachable, and the end
// states 2 tlen - 1 and 2 tlen (only 2 tlen when tlen == 0). A target that
// cannot fit its frames keeps the sentinel arithmetic: its NLL is about 1e30
// and its gradient is what the reverse of this recursion gives, as jax.grad
// gives it.
//
// Bound on H100: the serial chain. Each frame depends on the previous one;
// the ~1 MB that the recursion reads and writes is a microsecond of HBM
// beside T dependent steps. The design keeps each step's chain short and
// everything else off it:
// * A plan for each chain (make_plan): lane j of a sample's block owns the
//   K consecutive states [jK, jK + K), in ceil(S / 32K) warps. The states a
//   step reads beside its own come from the lane's registers or by
//   __shfl_up_sync (forward) / __shfl_down_sync (backward) from the next
//   lane; across warps a warp's two edge states go through shared memory
//   (two parities) and one barrier a step. One warp of K = 4 needs no
//   barrier, but a warp issues its K _lse3s one after another, so the
//   forward takes K = 1 (four warps at N = 48, 32 at N = 511) and the
//   backward K = 2 (two warps at N = 48): the fastest of 1, 2 and 4 on the
//   card (PERF.md, scripts/torch_kernel_variants.py ctc, whose variants
//   set K). A step's addresses are precomputed per lane and stepped by a
//   constant, and the next frame's emissions or weights are loaded a step
//   ahead, never from a slot that may be in flight: at a chunk's last frame
//   the forward reads its slot's spare frame, the backward its own row.
// * Emissions staged ahead of the chain: a chunk of up to kChunk frames'
//   label_lp rows (contiguous [T, N] a sample) and blank_lp values moves
//   into a shared-memory ring of kFwdRing chunks by cp.async, 16 bytes a copy
//   (4-byte copies at the span's unaligned ends), and is consumed while the
//   next is in flight. valid and the skip flags sit in registers from the
//   start, so a step reads only registers and shared memory.
// * The forward writes every frame's alphas, B x T x S floats, for the
//   backward (1.2 MB at B = 2, T = 1500, N = 48); the stores wait on nothing.
// * The backward's _lse3 weights depend on the stored alphas only, never on
//   the adjoint, so a grid-wide kernel (ctc_bwd_weights_kernel) computes them
//   first: for each sample, frame t >= 1 and state s, u0 = exp(a[s] - m_s) /
//   sum_s, u1 = the weight of a[s] in state s + 1's _lse3, u2 = its weight in
//   state s + 2's where that state may skip (else 0), with the max and sum of
//   the plain version over the alphas of frame t - 1. They go to scratch as
//   rows [3][Spad] (Spad = 32 K warps, zeros past S). The chain kernel then
//   runs the linear recurrence adj_{t-1}[s] = u0 adj_t[s] + u1 adj_t[s + 1]
//   + u2 adj_t[s + 2], three FMAs over two __shfl_down_sync a step, with the
//   weights staged a chunk ahead by one bulk copy (cp.async.bulk) a chunk
//   on an mbarrier.
//   (Not exp(a - (alpha_t - em_t)): equal in real arithmetic, but at the
//   sentinel jax.grad gives 1/3 each where that gives 1.)
// * The emissions' adjoints are the adjoints of alpha_t: d label_lp is
//   written straight from the odd states (0 at invalid positions); d
//   blank_lp[t] sums the even states, each lane's in order into shared
//   memory, then a chunk at a time the lanes in a fixed order (four sums by
//   lane mod 4, then (0 + 1) + (2 + 3)). No atomics: reruns give equal
//   bits.
#include <cstdint>

#include "hopper.cuh"

namespace {

using la::cp_async16;
using la::cp_async4;
using la::cp_async_commit;
using la::cp_async_wait;
using la::hopper::bulk_load;
using la::hopper::fence_barrier_init;
using la::hopper::mbar_arrive_expect_tx;
using la::hopper::mbar_init;
using la::hopper::mbar_wait;

constexpr float kNeg = -1.0e30f;     // _CTC_NEG
constexpr int kFwdStatesALane = 1;   // K of the forward: 1, 2 or 4
constexpr int kBwdStatesALane = 2;   // K of the backward: 1, 2 or 4
constexpr int kMaxStates = 1024;     // 32 warps of 32 lanes, one state a lane: N <= 511
constexpr int kFwdRing = 3;          // chunks a forward block keeps in shared memory
constexpr int kBwdRing = 2;          // chunks a backward block keeps in shared memory
constexpr int kChunk = 64;           // frames a chunk (fewer where the ring is short)
constexpr int kRingBytes = 128 * 1024;  // the most a ring may take
constexpr int kWeightThreads = 128;

// How a launch of one kernel lays out its work; la_ctc_plan reports both.
struct Plan {
  int k;      // states a lane
  int warps;  // warps a sample (a block)
  int lanes;  // lanes that own states: ceil(S / k)
  int s_pad;  // 32 k warps: the states the lanes own (a weight row's stride)
  int cf;     // frames a chunk
  int smem;   // shared bytes a block
};

// A forward ring slot: a chunk's label_lp rows as they lie in device
// memory, starting 0-3 floats in (their address mod 16 bytes), then its
// blank_lp values; every part a multiple of 4 floats, each with room for
// one frame more, which the look-ahead at the chunk's last frame reads
// (and drops) without touching the next slot.
__host__ __device__ inline int lab_floats(int cf, int n) { return ((cf + 1) * n + 4 + 3) & ~3; }
__host__ __device__ inline int slot_floats(int cf, int n) {
  return lab_floats(cf, n) + ((cf + 4) & ~3);
}
// the backward's d blank_lp partials: a row of a chunk's frame a thread
__host__ __device__ inline int red_floats(int cf, int threads) {
  return (cf * (threads + 1) + 3) & ~3;
}

// the target's length, summed over a warp's lanes (every lane gets it)
__device__ __forceinline__ int target_length(const unsigned char* __restrict__ valid, int n) {
  int c = 0;
  for (int p = threadIdx.x & 31; p < n; p += 32) c += valid[p] ? 1 : 0;
  return __reduce_add_sync(0xffffffffu, c);
}

__device__ __forceinline__ bool can_skip(const int* __restrict__ labels, int s_dim, int s) {
  return s < s_dim && (s & 1) && s >= 3 && labels[s / 2] != labels[s / 2 - 1];
}

template <int K>
__device__ __forceinline__ void load_k(const float* src, float (&dst)[K]) {
  if constexpr (K == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x, dst[1] = v.y;
  } else {
    dst[0] = *src;
  }
}

// a barrier over the sample's warps: the block's where it has more than one
__device__ __forceinline__ void sample_sync(bool multi) {
  if (multi)
    __syncthreads();
  else
    __syncwarp();
}

template <int K>
__global__ void __launch_bounds__(1024 / K)
ctc_fwd_kernel(const float* __restrict__ blank_lp, const float* __restrict__ label_lp,
               const int* __restrict__ labels_all, const unsigned char* __restrict__ valid_all,
               float* __restrict__ alphas, float* __restrict__ nll, int t_max, int n,
               const Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int s_dim = 2 * n + 1, s0 = tid * K, cf = p.cf;
  const int slot_f = slot_floats(cf, n);
  const bool multi = p.warps > 1;
  float* ring = smem;  // [kFwdRing] slots
  float2* edges = reinterpret_cast<float2*>(ring + kFwdRing * slot_f);  // [2][warps]
  float* ends = reinterpret_cast<float*>(edges + 2 * p.warps);
  const float* blank = blank_lp + (size_t)b * t_max;
  const float* label = label_lp + (size_t)b * t_max * n;
  const int* labels = labels_all + (size_t)b * n;
  const unsigned char* valid = valid_all + (size_t)b * n;
  const int tlen = target_length(valid, n);

  // Chunk ch holds frames [1 + ch cf, 1 + (ch + 1) cf); frame 0 only seeds
  // the alphas, from device memory. Floats between a slot's start and its
  // chunk's first label value:
  auto chunk_shift = [&](int ch) {
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(label + (size_t)(1 + ch * cf) * n) >> 2) & 3);
  };
  auto load_chunk = [&](int ch) {
    float* dst = ring + (ch % kFwdRing) * slot_f;
    const int f0 = 1 + ch * cf;
    const int nf = min(cf, t_max - f0);
    const float* src = label + (size_t)f0 * n;
    const int cnt = nf * n;
    const int shift = chunk_shift(ch);
    const int head = min(cnt, (4 - shift) & 3);
    const int end16 = head + ((cnt - head) & ~3);
    float* d = dst + shift;
    for (int i = tid; i < head; i += nthreads) cp_async4(d + i, src + i);
    for (int i = head + 4 * tid; i < end16; i += 4 * nthreads) cp_async16(d + i, src + i);
    for (int i = end16 + tid; i < cnt; i += nthreads) cp_async4(d + i, src + i);
    float* blank_dst = dst + lab_floats(cf, n);
    for (int f = tid; f < nf; f += nthreads) cp_async4(blank_dst + f, blank + f0 + f);
  };
  const int nchunks = t_max > 1 ? (t_max - 2) / cf + 1 : 0;
#pragma unroll
  for (int r = 0; r < kFwdRing; ++r) {
    if (r < nchunks) load_chunk(r);
    cp_async_commit();
  }

  // a lane's states: odd, dead (past S or an invalid label position: the
  // sentinel emission), may skip, stored (below S); an odd state's
  // emission is its label row's entry pos (clamped for dead ones), an even
  // one's the frame's blank value: its offset in a slot and stride a frame
  uint32_t odd = 0, dead = 0, skip = 0, stored = 0;
  int em_base[K], em_stride[K];
  float a[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i, pos = min(s >> 1, n - 1);
    if (s & 1) odd |= 1u << i;
    if (s >= s_dim || ((s & 1) && !valid[pos])) dead |= 1u << i;
    if (can_skip(labels, s_dim, s)) skip |= 1u << i;
    if (s < s_dim) stored |= 1u << i;
    em_base[i] = s & 1 ? pos : lab_floats(cf, n);
    em_stride[i] = s & 1 ? n : 1;
    const float em = (dead >> i) & 1 ? kNeg : ((odd >> i) & 1 ? label[pos] : blank[0]);
    a[i] = s < 2 ? em : kNeg;
  }
  float* out = alphas + (size_t)b * t_max * s_dim + s0;  // this lane's alphas of frame 0
#pragma unroll
  for (int i = 0; i < K; ++i)
    if ((stored >> i) & 1) out[i] = a[i];

  // the warp's two highest states, for the warp above; the edges a lane 0
  // (and at K = 1 a lane 1) reads from the warp below
  const bool top1 = multi && lane == 31, top2 = multi && lane == (K >= 2 ? 31 : 30);
  const bool has_below = warp > 0;
  float* edge_out = reinterpret_cast<float*>(edges + warp);
  const float* edge_in = reinterpret_cast<const float*>(edges + max(warp - 1, 0));
  auto publish = [&](int par) {
    if (top1) edge_out[2 * par * p.warps] = a[K - 1];
    if (top2) edge_out[2 * par * p.warps + 1] = a[K >= 2 ? K - 2 : 0];
  };
  publish(0);

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kFwdRing - 1>();
    sample_sync(multi);
    const int f0 = 1 + ch * cf;
    const int t_end = min(t_max, f0 + cf);
    // the lane's emission offsets for the chunk's first frame
    const float* slot = ring + (ch % kFwdRing) * slot_f;
    const int shift = chunk_shift(ch);
    int off[K];
    float em[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      off[i] = em_base[i] + ((odd >> i) & 1 ? shift : 0);
      em[i] = slot[off[i]];
    }
    for (int t = f0; t < t_end; ++t) {
      // states s0 - 1 and s0 - 2 of the previous frame
      float below1, below2;
      if constexpr (K >= 2) {
        below1 = __shfl_up_sync(0xffffffffu, a[K - 1], 1);
        below2 = __shfl_up_sync(0xffffffffu, a[K - 2], 1);
      } else {
        below1 = __shfl_up_sync(0xffffffffu, a[0], 1);
        below2 = __shfl_up_sync(0xffffffffu, a[0], 2);
      }
      const float* e = edge_in + 2 * ((t - 1) & 1) * p.warps;
      if (lane == 0) {
        below1 = has_below ? e[0] : kNeg;
        below2 = has_below ? e[1] : kNeg;
      }
      if (K == 1 && lane == 1) below2 = has_below ? e[0] : kNeg;
      // the next frame's emissions, loaded while this one's math runs (at
      // the chunk's last frame from the slot's spare frame)
      float em_next[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        off[i] += em_stride[i];
        em_next[i] = slot[off[i]];
      }
      // highest slot first, so each slot reads its neighbours' old values
#pragma unroll
      for (int i = K - 1; i >= 0; --i) {
        const float a1 = i >= 1 ? a[i - 1] : below1;
        const float a2 = (skip >> i) & 1 ? (i >= 2 ? a[i - 2] : (i == 1 ? below1 : below2)) : kNeg;
        const float m = fmaxf(fmaxf(a[i], a1), a2);
        a[i] = ((dead >> i) & 1 ? kNeg : em[i]) +
               (m + logf(expf(a[i] - m) + expf(a1 - m) + expf(a2 - m)));
      }
      out += s_dim;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if ((stored >> i) & 1) out[i] = a[i];
        em[i] = em_next[i];
      }
      publish(t & 1);
      if (multi) __syncthreads();
    }
    // every lane is done with the slot before it is refilled
    if (!multi) __syncwarp();
    if (ch + kFwdRing < nchunks) load_chunk(ch + kFwdRing);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (s0 + i == 2 * tlen) ends[1] = a[i];
    if (tlen > 0 && s0 + i == 2 * tlen - 1) ends[0] = a[i];
  }
  __syncthreads();
  if (tid == 0) {
    const float end_lab = tlen > 0 ? ends[0] : kNeg;
    const float end_blank = ends[1];
    const float m = fmaxf(end_lab, end_blank);
    nll[b] = -(m + logf(expf(end_lab - m) + expf(end_blank - m)));
  }
}

// max and sum of state x's _lse3 over one frame's alphas
__device__ __forceinline__ void lse3_parts(const float* __restrict__ a, int x, bool skip_x,
                                           float& m, float& sum) {
  const float a0 = a[x];
  const float a1 = x >= 1 ? a[x - 1] : kNeg;
  const float a2 = skip_x ? a[x - 2] : kNeg;
  m = fmaxf(fmaxf(a0, a1), a2);
  sum = expf(a0 - m) + expf(a1 - m) + expf(a2 - m);
}

// The weights of one frame's _lse3s by the state s of the frame before
// that they read, over that frame's alphas `a`, into a row [u0 | u1 | u2]
// of s_pad floats (zeros past S)
__device__ __forceinline__ void weight_row(const float* __restrict__ a,
                                           const int* __restrict__ labels, int s_dim, int s_pad,
                                           int first, int stride, float* __restrict__ w) {
  for (int s = first; s < s_pad; s += stride) {
    float u0 = 0.f, u1 = 0.f, u2 = 0.f;
    if (s < s_dim) {
      const float av = a[s];
      float m, sum;
      lse3_parts(a, s, can_skip(labels, s_dim, s), m, sum);
      u0 = expf(av - m) / sum;
      if (s + 1 < s_dim) {
        lse3_parts(a, s + 1, can_skip(labels, s_dim, s + 1), m, sum);
        u1 = expf(av - m) / sum;
      }
      if (can_skip(labels, s_dim, s + 2)) {
        lse3_parts(a, s + 2, true, m, sum);
        u2 = expf(av - m) / sum;
      }
    }
    w[s] = u0;
    w[s_pad + s] = u1;
    w[2 * s_pad + s] = u2;
  }
}

// One block a (sample, frame t >= 1): frame t's weight row over the alphas
// of frame t - 1.
__global__ void __launch_bounds__(kWeightThreads)
ctc_bwd_weights_kernel(const float* __restrict__ alphas, const int* __restrict__ labels_all,
                       float* __restrict__ weights, int t_max, int n, int s_pad) {
  const int row = blockIdx.x;  // b (t_max - 1) + t - 1
  const int b = row / (t_max - 1), t = row % (t_max - 1) + 1;
  const int s_dim = 2 * n + 1;
  weight_row(alphas + ((size_t)b * t_max + t - 1) * s_dim, labels_all + (size_t)b * n, s_dim,
             s_pad, threadIdx.x, blockDim.x, weights + (size_t)row * 3 * s_pad);
}

template <int K>
__global__ void __launch_bounds__(1024 / K)
ctc_bwd_kernel(const float* __restrict__ alphas, const float* __restrict__ weights,
               const int* __restrict__ labels_all, const unsigned char* __restrict__ valid_all,
               const float* __restrict__ g, float* __restrict__ d_blank,
               float* __restrict__ d_label, int t_max, int n, const Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = 32 * p.warps;
  const int s_dim = 2 * n + 1, s0 = tid * K, cf = p.cf;
  const int row_f = 3 * p.s_pad, slot_f = cf * row_f, red_stride = nthreads + 1;
  const bool multi = p.warps > 1;
  float* ring = smem;                     // [kBwdRing][cf][3][s_pad]
  float* red = ring + kBwdRing * slot_f;  // [cf][threads + 1]
  float2* edges = reinterpret_cast<float2*>(red + red_floats(cf, nthreads));  // [2][warps]
  uint64_t* full = reinterpret_cast<uint64_t*>(edges + 2 * p.warps);          // [kBwdRing]
  const unsigned char* valid = valid_all + (size_t)b * n;
  const float* w_b = weights + (size_t)b * (t_max - 1) * row_f;
  float* db = d_blank + (size_t)b * t_max;
  const int tlen = target_length(valid, n);

  // Chunk ch holds frames (t_hi - nf, t_hi], t_hi = t_max - 1 - ch cf, and
  // their weight rows t - 1, lowest frame first: one bulk copy, issued by
  // thread 0, completing on the slot's barrier.
  const int steps = t_max - 1;
  const int nchunks = steps > 0 ? (steps - 1) / cf + 1 : 0;
  auto load_chunk = [&](int ch) {
    const int t_hi = t_max - 1 - ch * cf, nf = min(cf, t_hi);
    const uint32_t bytes = 4u * nf * row_f;
    uint64_t* bar = full + ch % kBwdRing;
    mbar_arrive_expect_tx(bar, bytes);
    bulk_load(ring + (ch % kBwdRing) * slot_f, w_b + (size_t)(t_hi - nf) * row_f, bytes, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kBwdRing; ++r) mbar_init(full + r, 1);
    fence_barrier_init();
    for (int r = 0; r < kBwdRing && r < nchunks; ++r) load_chunk(r);
  }
  __syncthreads();

  // a lane's states: odd, live (their emission's adjoint reaches an input),
  // stored (an odd state below S: its label position gets the adjoint)
  uint32_t odd = 0, live = 0, stored = 0;
  int pos[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i;
    pos[i] = s >> 1;
    if (s & 1) odd |= 1u << i;
    if (s < s_dim && (!(s & 1) || valid[pos[i]])) live |= 1u << i;
    if ((s & 1) && s < s_dim) stored |= 1u << i;
  }

  // adjoint of the last frame's alphas: the NLL's two end states
  float adj[K];
  {
    const float* last = alphas + ((size_t)b * t_max + t_max - 1) * s_dim;
    const float end_lab = tlen > 0 ? last[2 * tlen - 1] : kNeg;
    const float end_blank = last[2 * tlen];
    const float m = fmaxf(end_lab, end_blank);
    const float e_lab = expf(end_lab - m), e_blank = expf(end_blank - m);
    const float gs = __ldg(g + b) / (e_lab + e_blank);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int s = s0 + i;
      adj[i] = 0.f;
      if (s == 2 * tlen) adj[i] = -gs * e_blank;
      if (tlen > 0 && s == 2 * tlen - 1) adj[i] = -gs * e_lab;
    }
  }

  // d label_lp of the current frame (from the last back to frame 0); a
  // frame's emission adjoints written there, the lane's even states summed
  // in order (at frame 0 only states 0 and 1 have one)
  float* dl = d_label + ((size_t)b * t_max + t_max - 1) * n;
  auto emit = [&](bool first) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const bool on = (live >> i) & 1 && (!first || s0 + i < 2);
      const float v = on ? adj[i] : 0.f;
      if ((stored >> i) & 1) dl[pos[i]] = v;
      if (!((odd >> i) & 1)) part += v;
    }
    return part;
  };
  // the warp's two lowest states, for the warp below; the edges a lane 31
  // (and at K = 1 a lane 30) reads from the warp above
  const bool low1 = multi && lane == 0, low2 = multi && lane == (K >= 2 ? 0 : 1);
  const bool has_above = warp + 1 < p.warps;
  float* edge_out = reinterpret_cast<float*>(edges + warp);
  const float* edge_in = reinterpret_cast<const float*>(edges + min(warp + 1, p.warps - 1));
  auto publish = [&](int par) {
    if (low1) edge_out[2 * par * p.warps] = adj[0];
    if (low2) edge_out[2 * par * p.warps + 1] = adj[K >= 2 ? 1 : 0];
  };
  publish((t_max - 1) & 1);

  for (int ch = 0; ch < nchunks; ++ch) {
    mbar_wait(full + ch % kBwdRing, (ch / kBwdRing) & 1);
    if (multi) __syncthreads();
    const int t_hi = t_max - 1 - ch * cf, nf = min(cf, t_hi), t_lo = t_hi - nf + 1;
    // frame t_hi's weight row and partial; both step back a row a frame
    const float* wr = ring + (ch % kBwdRing) * slot_f + (nf - 1) * row_f + s0;
    float* part_out = red + (nf - 1) * red_stride + tid;
    float u0[K], u1[K], u2[K];
    load_k<K>(wr, u0);
    load_k<K>(wr + p.s_pad, u1);
    load_k<K>(wr + 2 * p.s_pad, u2);
    for (int t = t_hi; t >= t_lo; --t) {
      // states s0 + K and s0 + K + 1 of frame t
      float above1, above2;
      if constexpr (K >= 2) {
        above1 = __shfl_down_sync(0xffffffffu, adj[0], 1);
        above2 = __shfl_down_sync(0xffffffffu, adj[1], 1);
      } else {
        above1 = __shfl_down_sync(0xffffffffu, adj[0], 1);
        above2 = __shfl_down_sync(0xffffffffu, adj[0], 2);
      }
      const float* e = edge_in + 2 * (t & 1) * p.warps;
      if (lane == 31) {
        above1 = has_above ? e[0] : 0.f;
        above2 = has_above ? e[1] : 0.f;
      }
      if (K == 1 && lane == 30) above2 = has_above ? e[0] : 0.f;
      // the next frame's weights, loaded while this one's run (at the
      // chunk's last frame this frame's again: the row before the slot is
      // another chunk's, which may be in flight)
      wr -= row_f;
      const float* next = t > t_lo ? wr : wr + row_f;
      float v0[K], v1[K], v2[K];
      load_k<K>(next, v0);
      load_k<K>(next + p.s_pad, v1);
      load_k<K>(next + 2 * p.s_pad, v2);
      *part_out = emit(false);
      part_out -= red_stride;
      dl -= n;
      // lowest slot first, so each slot reads its neighbours' old values
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float x1 = i + 1 < K ? adj[i + 1] : above1;
        const float x2 = i + 2 < K ? adj[i + 2] : (i + 2 == K ? above1 : above2);
        adj[i] = fmaf(u2[i], x2, fmaf(u1[i], x1, u0[i] * adj[i]));
      }
#pragma unroll
      for (int i = 0; i < K; ++i) u0[i] = v0[i], u1[i] = v1[i], u2[i] = v2[i];
      publish((t - 1) & 1);
      if (multi) __syncthreads();
    }
    // d blank_lp of the chunk's frames: a frame's lane partials into four
    // sums by lane mod 4, each in lane order, then (0 + 1) + (2 + 3)
    if (!multi) __syncwarp();
    for (int j = tid; j < nf; j += nthreads) {
      const float* r = red + j * red_stride;
      float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
      int l = 0;
      for (; l + 4 <= p.lanes; l += 4) {
        q0 += r[l];
        q1 += r[l + 1];
        q2 += r[l + 2];
        q3 += r[l + 3];
      }
      if (l < p.lanes) q0 += r[l];
      if (l + 1 < p.lanes) q1 += r[l + 1];
      if (l + 2 < p.lanes) q2 += r[l + 2];
      db[t_lo + j] = (q0 + q1) + (q2 + q3);
    }
    // the partials are read and the slot is done before either is rewritten
    sample_sync(multi);
    if (tid == 0 && ch + kBwdRing < nchunks) load_chunk(ch + kBwdRing);
  }
  const float part = emit(true);
  if (tid == 0) db[0] = part;
}

// The layout of one kernel at K states a lane; `weights` sizes the
// backward's ring (weight rows), else the forward's (emissions).
cudaError_t make_plan(int t_max, int n, int k, bool weights, Plan* p) {
  const int s_dim = 2 * n + 1;
  if (t_max <= 0 || n <= 0 || s_dim > kMaxStates) return cudaErrorInvalidValue;
  Plan q{};
  q.k = k;
  q.warps = (s_dim + 32 * k - 1) / (32 * k);  // at most 32: S <= kMaxStates
  q.lanes = (s_dim + k - 1) / k;
  q.s_pad = 32 * q.warps * k;
  const int slot = weights ? 3 * q.s_pad : 0;  // floats a frame (weights)
  int cf = min(kChunk, max(t_max - 1, 1));
  if (weights) {
    while (cf > 1 && 4 * kBwdRing * cf * slot > kRingBytes) --cf;
    q.smem = 4 * (kBwdRing * cf * slot + red_floats(cf, 32 * q.warps) + 4 * q.warps) +
             8 * kBwdRing;
  } else {
    while (cf > 1 && 4 * kFwdRing * slot_floats(cf, n) > kRingBytes) --cf;
    q.smem = 4 * (kFwdRing * slot_floats(cf, n) + 4 * q.warps + 4);
  }
  q.cf = cf;
  *p = q;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// the most label positions a target may have (S = 2N + 1 states, at most
// one a lane of a 32-warp block)
LA_API int la_ctc_max_labels() { return (kMaxStates - 1) / 2; }

// the plans at this shape into out[11]: the forward's states a lane, warps,
// lanes that own states, frames a chunk and shared bytes, then the
// backward's states a lane, warps, lanes, padded states (a weight row's
// stride), frames a chunk and shared bytes
LA_API int la_ctc_plan(int t_max, int n, int* out) {
  Plan f, w;
  cudaError_t err = make_plan(t_max, n, kFwdStatesALane, false, &f);
  if (err == cudaSuccess) err = make_plan(t_max, n, kBwdStatesALane, true, &w);
  if (err != cudaSuccess) return err;
  const int v[11] = {f.k, f.warps, f.lanes, f.cf, f.smem, w.k, w.warps, w.lanes, w.s_pad, w.cf,
                     w.smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return cudaSuccess;
}

// floats of la_ctc_reduced_bwd's scratch (its weight rows) at this shape
LA_API long long la_ctc_bwd_scratch_floats(int batch, int t_max, int n) {
  Plan p;
  if (batch <= 0 || make_plan(t_max, n, kBwdStatesALane, true, &p) != cudaSuccess) return 0;
  return (long long)batch * (t_max - 1) * 3 * p.s_pad;
}

// blank_lp f32[B, T], label_lp f32[B, T, N], labels i32[B, N], valid u8[B, N]
// -> alphas f32[B, T, 2N + 1], nll f32[B]. T >= 1, 1 <= N <= la_ctc_max_labels().
LA_API int la_ctc_reduced_fwd(const void* blank_lp, const void* label_lp, const void* labels,
                              const void* valid, void* alphas, void* nll, int batch, int t_max,
                              int n, void* stream) {
  if (batch <= 0) return cudaSuccess;
  Plan p;
  cudaError_t err = make_plan(t_max, n, kFwdStatesALane, false, &p);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(ctc_fwd_kernel<kFwdStatesALane>, p.smem)) != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  ctc_fwd_kernel<kFwdStatesALane><<<batch, 32 * p.warps, p.smem, s>>>(
      static_cast<const float*>(blank_lp), static_cast<const float*>(label_lp),
      static_cast<const int*>(labels), static_cast<const unsigned char*>(valid),
      static_cast<float*>(alphas), static_cast<float*>(nll), t_max, n, p);
  return cudaGetLastError();
}

// alphas of la_ctc_reduced_fwd, labels, valid, g f32[B] (the gradient of
// the NLL), scratch of la_ctc_bwd_scratch_floats(B, T, N) floats (the
// weights) -> d_blank f32[B, T], d_label f32[B, T, N]
LA_API int la_ctc_reduced_bwd(const void* alphas, const void* labels, const void* valid,
                              const void* g, void* scratch, void* d_blank, void* d_label,
                              int batch, int t_max, int n, void* stream) {
  if (batch <= 0) return cudaSuccess;
  Plan p;
  cudaError_t err = make_plan(t_max, n, kBwdStatesALane, true, &p);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(alphas);
  auto l = static_cast<const int*>(labels);
  auto w = static_cast<float*>(scratch);
  if (t_max > 1) {
    ctc_bwd_weights_kernel<<<batch * (t_max - 1), kWeightThreads, 0, s>>>(a, l, w, t_max, n,
                                                                          p.s_pad);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  auto kernel = ctc_bwd_kernel<kBwdStatesALane>;
  if ((err = allow_smem(kernel, p.smem)) != cudaSuccess) return err;
  kernel<<<batch, 32 * p.warps, p.smem, s>>>(
      a, w, l, static_cast<const unsigned char*>(valid), static_cast<const float*>(g),
      static_cast<float*>(d_blank), static_cast<float*>(d_label), t_max, n, p);
  return cudaGetLastError();
}
