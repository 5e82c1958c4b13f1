// Forced-alignment Viterbi over K = 2L+1 interleaved states (even = silence,
// odd 2i+1 = label i) with backtrace and onset/offset extraction.
//
// Replaces the TPU kernel lyricalignment_tpu/ops/viterbi_pallas.py:_kernel
// (viterbi_align_pallas), which runs the whole batch as one (B, K) lane tile
// and shifts neighbours in with pltpu.roll, and computes exactly what the
// production scan lyricalignment_tpu/ops/viterbi.py:_viterbi_dp computes:
//   * init row dp[0] = sil[0], dp[1] = lab[0, 0], NEG_BIG elsewhere;
//   * stay beats left iff p0 > p1 (strict); skip (k-2 -> k) iff the state is
//     odd, k >= 3, its label differs from the previous one, p2 >= p1 and
//     p2 >= p0; shifted-in neighbours are NEG_INF;
//   * only steps t < num_frames advance (later ones are identity steps, so
//     the loop stops there);
//   * end state 2L if dp[2L] > dp[2L-1] else 2L-1 (a negative index wraps,
//     a too-large one clamps, as JAX indexing does);
//   * onset = first frame / offset = last frame + 1 of each odd state on the
//     path, sentinels frames + 1 / 0 for states never visited.
// The DP does one float32 add per state and step and no multiply; this file
// is compiled with -fmad=false and without fast math, so from the same
// emissions its onsets and offsets equal the JAX ones exactly.
//
// Bound on H100: latency. Each sequence is a chain of num_frames dependent
// steps, then a walk back of the same length; the bytes (the emissions read
// once) are a few MB, a microsecond of HBM. What the design does about it:
// * The DP row in registers, one block a sequence: lane j owns the S
//   consecutive states [jS, jS + S), S the least of 2, 4, 8, 16, 32 that
//   needs at most 1024 lanes (S = 2 up to K = 2048, L = 1023), in
//   ceil(K / 32S) warps. A lane's left neighbours come from its own
//   registers or, for its first two states, from the previous lane's last
//   two by __shfl_up_sync; a warp's last lane publishes its two edge states
//   in shared memory (two parities) and one __syncthreads a step hands them
//   to the next warp. A step has no branch and no shared-memory round trip
//   inside a warp. Two states a lane keep the step short: more warps with
//   a barrier cost less than more states a lane without one (at K = 257
//   five warps of S = 2 run 1.39x faster than one warp of S = 10; PERF.md).
// * Emissions are staged ahead of the chain: a chunk of up to kChunk
//   frames' lab rows, contiguous in device memory, moves into a shared-
//   memory ring of kRing chunks by cp.async, 16 bytes a copy (4-byte copies
//   at the span's unaligned ends: any L, any offset), its sil values beside
//   them; a chunk is consumed while the next is in flight. A lane reads its
//   states' emissions there: odd k -> lab row entry k/2, even k -> sil.
// * Backpointers take 2 bits a state (0 stay, 1 from k-1, 2 from k-2): a
//   lane packs 16/S steps of its S states into one 32-bit word in shared
//   memory (36 KB a sequence at K = 97, 1500 frames). Where the frames do
//   not fit beside the ring, the shared window is flushed to the wrapper's
//   scratch when full and read back a window at a time for the walk.
// * The walk runs from shared memory in one thread. The state a step reaches
//   lies in the current state's lane or the one before, so both lanes' words
//   of the next row are loaded a step ahead and the chain is a select, a
//   shift and a subtract. Onsets and offsets are written as each state's run
//   of frames ends (the path's state never decreases in time, so a state's
//   frames are one run).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegBig = -1.0e7f;
constexpr float kNegInf = -1.0e30f;
constexpr int kRing = 2;      // chunks of emissions a sequence keeps in shared memory
constexpr int kChunk = 32;    // frames a chunk (fewer where shared memory is short)
constexpr int kMaxS = 32;     // states a lane: K <= 32 * 32 * kMaxS
constexpr int kSlack = 32;    // floats after the ring: lanes past K read there

// How a launch lays out its work; the same function sizes the scratch.
struct Plan {
  int s;          // states a lane
  int warps;      // warps a sequence (a block)
  int lanes;      // lanes that own states: ceil(K / s)
  int nw;         // backpointer words a lane a group of steps
  int g;          // steps a group
  int gw;         // words a group: lanes * nw
  int groups;     // groups of the longest sequence: ceil((frames - 1) / g)
  int cf;         // frames a chunk
  int wg;         // groups the shared window holds
  int flush;      // 1: wg < groups, so windows go through the scratch
  int smem;       // shared bytes a block
};

// A ring slot: a chunk's lab rows as they lie in device memory, starting
// 0-3 floats in (their address mod 16 bytes, so the middle moves in 16-byte
// copies), then its sil values; every part a multiple of 4 floats.
__host__ __device__ inline int lab_floats(int cf, int l_max) { return (cf * l_max + 4 + 3) & ~3; }
__host__ __device__ inline int slot_floats(int cf, int l_max) {
  return lab_floats(cf, l_max) + ((cf + 3) & ~3);
}
__host__ __device__ inline int ring_floats(int cf, int l_max) {
  return kRing * slot_floats(cf, l_max) + kSlack;
}
// two parities of each warp's two edge states, then the two end values
__host__ __device__ inline int fixed_floats(int warps) { return 4 * warps + 2; }

using la::cp_async16;
using la::cp_async4;
using la::cp_async_commit;
using la::cp_async_wait;

template <int S>
__global__ void __launch_bounds__(1024)
viterbi_kernel(const float* __restrict__ lab, const float* __restrict__ sil,
               const int* __restrict__ labels, const int* __restrict__ num_labels,
               const int* __restrict__ num_frames, uint32_t* __restrict__ scratch,
               int* __restrict__ onset, int* __restrict__ offset, int batch, int frames,
               int l_max, const Plan p) {
  // S >= 2 keeps the state a walk step can reach in the lane of the current
  // one or the lane before it
  static_assert(S >= 2 && S % 2 == 0, "a lane owns an even number of states");
  constexpr int G = S <= 16 ? 16 / S : 1;  // steps a word group (a power of 2)
  constexpr int NW = (2 * S + 31) / 32;    // words a lane a group
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;  // lane slot j: states [jS, jS + S)
  const int lane = tid & 31;
  const int warp = tid / 32;
  const int nthreads = blockDim.x;
  const int k0 = tid * S;
  const int n_states = 2 * l_max + 1;
  const int cf = p.cf;
  const int slot_f = slot_floats(cf, l_max);

  float* ring = smem;
  float2* edges = reinterpret_cast<float2*>(ring + ring_floats(cf, l_max));  // [2][warps]
  float* ends = reinterpret_cast<float*>(edges + 2 * p.warps);
  uint32_t* bt_s = reinterpret_cast<uint32_t*>(ends + 2);

  const float* lab_b = lab + (size_t)b * frames * l_max;
  const float* sil_b = sil + (size_t)b * frames;
  const int* lab_ids = labels + (size_t)b * l_max;
  int* on_b = onset + (size_t)b * l_max;
  int* off_b = offset + (size_t)b * l_max;
  uint32_t* scratch_b = scratch + (size_t)b * p.groups * p.gw;
  const int live = min(max(num_frames[b], 0), frames);

  for (int l = tid; l < l_max; l += nthreads) {
    on_b[l] = frames + 1;
    off_b[l] = 0;
  }

  // Chunk ch holds frames [1 + ch cf, 1 + (ch + 1) cf): the steps of
  // backpointer rows [ch cf, (ch + 1) cf), whole groups (cf % G == 0).
  // Frame 0 only seeds the row, from device memory.
  // floats between a slot's start and its chunk's first lab value
  auto chunk_shift = [&](int ch) {
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(lab_b + (size_t)(1 + ch * cf) * l_max) >> 2) & 3);
  };
  // chunk ch into ring slot ch % kRing: the lab rows as one span (4-byte
  // copies up to the first 16-byte boundary and after the last, 16-byte
  // copies between), the sil values apart
  auto load_chunk = [&](int ch) {
    float* dst = ring + (ch % kRing) * slot_f;
    const int f0 = 1 + ch * cf;
    const int nf = min(cf, live - f0);
    const float* src = lab_b + (size_t)f0 * l_max;
    const int n = nf * l_max;
    const int shift = chunk_shift(ch);
    const int head = min(n, (4 - shift) & 3);
    const int end16 = head + ((n - head) & ~3);
    float* d = dst + shift;
    for (int i = tid; i < head; i += nthreads) cp_async4(d + i, src + i);
    for (int i = head + 4 * tid; i < end16; i += 4 * nthreads) cp_async16(d + i, src + i);
    for (int i = end16 + tid; i < n; i += nthreads) cp_async4(d + i, src + i);
    float* sil_dst = dst + lab_floats(cf, l_max);
    for (int f = tid; f < nf; f += nthreads) cp_async4(sil_dst + f, sil_b + f0 + f);
  };
  const int nchunks = live > 1 ? (live - 2) / cf + 1 : 0;
#pragma unroll
  for (int r = 0; r < kRing; ++r) {
    if (r < nchunks) load_chunk(r);
    cp_async_commit();
  }

  float dp[S];
  uint32_t skip = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = k0 + s;
    dp[s] = k == 0 ? sil_b[0] : (k == 1 ? lab_b[0] : kNegBig);
    if ((k & 1) && k >= 3 && k < n_states && lab_ids[k / 2] != lab_ids[k / 2 - 1])
      skip |= 1u << s;
  }
  // odd slot s (k0 is even) reads lab row entry k0/2 + s/2; a lane past K
  // reads from the row's start
  const int lab_base = k0 < n_states ? k0 / 2 : 0;

  // the warp's two highest states, for the next warp
  auto publish = [&](int par) {
    if (lane == 31) edges[par * p.warps + warp] = make_float2(dp[S - 1], dp[S - 2]);
  };
  publish(1);

  uint32_t word[NW];
#pragma unroll
  for (int n = 0; n < NW; ++n) word[n] = 0;
  int gp = 0, wi = 0, win = 0;  // step in its group, group in the window, window
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const float* slot = ring + (ch % kRing) * slot_f;
    const float* lab_rows = slot + chunk_shift(ch);
    const float* sil_rows = slot + lab_floats(cf, l_max);
    const int f0 = 1 + ch * cf;
    const int t_end = min(live, f0 + cf);
    const float* labrow = lab_rows;
    const float* silp = sil_rows;
    // one basic block a step: the word is stored every step (the group's
    // slot is rewritten until the group is full), windows flush between
    // chunks
    for (int t = f0; t < t_end; ++t, labrow += l_max, ++silp) {
      const float silv = *silp;
      // states k0 - 1 and k0 - 2 of the previous step
      float a = __shfl_up_sync(0xffffffffu, dp[S - 1], 1);
      float c = __shfl_up_sync(0xffffffffu, dp[S - 2], 1);
      if (lane == 0) {
        a = c = kNegInf;
        if (warp > 0) {
          const float2 e = edges[(t & 1) * p.warps + warp - 1];
          a = e.x;
          c = e.y;
        }
      }
      uint32_t v[NW];
#pragma unroll
      for (int n = 0; n < NW; ++n) v[n] = 0;
      // highest slot first, so each slot reads its neighbours' old values
#pragma unroll
      for (int s = S - 1; s >= 0; --s) {
        const float p0 = dp[s];
        const float p1 = s >= 1 ? dp[s - 1] : a;
        const float p2 = s >= 2 ? dp[s - 2] : (s == 1 ? a : c);
        // fmaxf(p0, p1) is the value the strict p0 > p1 picks (at most the
        // sign of a zero differs, which no comparison sees), and p2 >= it
        // iff p2 >= p1 and p2 >= p0
        const float m = fmaxf(p0, p1);
        const bool from2 = ((skip >> s) & 1u) & (p2 >= m);
        const float val = from2 ? p2 : m;
        const uint32_t code = from2 ? 2u : (p0 > p1 ? 0u : 1u);
        dp[s] = __fadd_rn(val, (s & 1) ? labrow[lab_base + (s >> 1)] : silv);
        v[(2 * s) / 32] |= code << ((2 * s) % 32);
      }
      publish((t + 1) & 1);
#pragma unroll
      for (int n = 0; n < NW; ++n) word[n] |= v[n] << (gp * 2 * S);
      if (tid < p.lanes) {
#pragma unroll
        for (int n = 0; n < NW; ++n) bt_s[wi * p.gw + tid * NW + n] = word[n];
      }
      gp = (gp + 1) & (G - 1);
      wi += gp == 0;
#pragma unroll
      for (int n = 0; n < NW; ++n) word[n] = gp == 0 ? 0u : word[n];
      // the edges of step t for step t + 1; after a chunk's last step,
      // every lane is done with its slot and its words are in
      __syncthreads();
    }
    if (wi == p.wg && t_end < live) {
      // the window is full and steps remain: out to the scratch
      for (int i = tid; i < p.wg * p.gw; i += nthreads)
        scratch_b[(size_t)win * p.wg * p.gw + i] = bt_s[i];
      __syncthreads();
      ++win;
      wi = 0;
    }
    if (ch + kRing < nchunks) load_chunk(ch + kRing);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const int nl = num_labels[b];
  int i_sil = 2 * nl, i_lab = 2 * nl - 1;
  if (i_sil < 0) i_sil += n_states;
  if (i_lab < 0) i_lab += n_states;
  i_sil = min(max(i_sil, 0), n_states - 1);
  i_lab = min(max(i_lab, 0), n_states - 1);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (k0 + s == i_sil) ends[0] = dp[s];
    if (k0 + s == i_lab) ends[1] = dp[s];
  }
  __syncthreads();
  if (live == 0) return;  // uniform across the sequence's threads

  // The walk: cur is the state at frame u + 1 and row u's code takes it to
  // frame u. The state at frame u lies in cur's lane or the one before, so
  // both lanes' words of row u are loaded one step ahead, off the chain.
  int cur = ends[0] > ends[1] ? i_sil : i_lab;
  int lane_c = cur / S, slot_c = cur - lane_c * S;
  int run_end = live - 1;  // last frame of cur's run
  const int n_steps = live - 1;
  const int last_win = n_steps > 0 ? (n_steps - 1) / G / p.wg : -1;
  // row words at `base` of lane ln and of ln - 1 (-1 reads lane 0: unused)
  auto load = [&](int base, int ln, uint32_t (&here)[NW], uint32_t (&below)[NW]) {
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      here[n] = bt_s[base + ln * NW + n];
      below[n] = bt_s[base + max(ln - 1, 0) * NW + n];
    }
  };
  for (int wdw = last_win; wdw >= 0; --wdw) {
    if (wdw != last_win) {
      __syncthreads();
      for (int i = tid; i < p.wg * p.gw; i += nthreads)
        bt_s[i] = scratch_b[(size_t)wdw * p.wg * p.gw + i];
      __syncthreads();
    }
    if (tid != 0) continue;
    const int u_lo = wdw * p.wg * G;
    const int u_hi = min(n_steps, (wdw + 1) * p.wg * G) - 1;
    int gpos = u_hi % G;                                // row u's step in its group
    int base = (u_hi / G - wdw * p.wg) * p.gw;          // its group's words
    uint32_t here[NW], below[NW];
    load(base, lane_c, here, below);
    int fetched_lane = lane_c;
    for (int u = u_hi; u >= u_lo; --u) {
      // row u - 1's words (row u's again at the window's first row)
      const int next_base = gpos == 0 && u > u_lo ? base - p.gw : base;
      uint32_t next_here[NW], next_below[NW];
      load(next_base, lane_c, next_here, next_below);
      const int next_lane = lane_c;
      const int bit = 2 * (gpos * S + slot_c);
      uint32_t w = lane_c == fetched_lane ? here[0] : below[0];
      if constexpr (NW == 2) {
        if (bit >= 32) w = lane_c == fetched_lane ? here[1] : below[1];
      }
      const int code = static_cast<int>((w >> (bit & 31)) & 3u);
      if (code != 0) {  // cur's run is frames [u + 1, run_end]
        if (cur & 1) {
          on_b[cur >> 1] = u + 1;
          off_b[cur >> 1] = run_end + 1;
        }
        run_end = u;
        cur -= code;
        slot_c -= code;
        if (slot_c < 0) {
          slot_c += S;
          --lane_c;
        }
      }
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        here[n] = next_here[n];
        below[n] = next_below[n];
      }
      fetched_lane = next_lane;
      if (gpos == 0) {
        gpos = G - 1;
        base = next_base;
      } else {
        --gpos;
      }
    }
  }
  if (tid == 0 && (cur & 1)) {
    on_b[cur >> 1] = 0;
    off_b[cur >> 1] = run_end + 1;
  }
}

cudaError_t make_plan(int frames, int l_max, Plan* p) {
  const int k = 2 * l_max + 1;
  Plan q{};
  q.s = 2;
  while (q.s < kMaxS && k > 32 * 32 * q.s) q.s *= 2;
  if (k > 32 * 32 * q.s) return cudaErrorInvalidValue;
  q.warps = (k + 32 * q.s - 1) / (32 * q.s);
  q.lanes = (k + q.s - 1) / q.s;
  q.nw = (2 * q.s + 31) / 32;
  q.g = q.s <= 16 ? 16 / q.s : 1;
  q.gw = q.lanes * q.nw;
  q.groups = (max(frames - 1, 0) + q.g - 1) / q.g;
  int device, smem_max;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  const int per = smem_max & ~15;
  // frames a chunk: whole groups, the ring within half the shared memory
  int cf = min(kChunk, max(frames - 1, 1));
  while (cf > 1 && 4 * ring_floats(cf, l_max) > per / 2) --cf;
  cf = max(q.g, cf - cf % q.g);
  int fixed = 4 * (ring_floats(cf, l_max) + fixed_floats(q.warps));
  int wg = (per - fixed) / (4 * q.gw);
  if (wg < 1) return cudaErrorInvalidValue;
  if (wg < q.groups) {
    // windows flush between chunks: a window holds whole chunks
    if (wg < cf / q.g) {
      cf = wg * q.g;
      fixed = 4 * (ring_floats(cf, l_max) + fixed_floats(q.warps));
    }
    wg -= wg % (cf / q.g);
  }
  q.cf = cf;
  q.wg = min(max(q.groups, 1), wg);
  q.smem = (fixed + 4 * q.wg * q.gw + 15) & ~15;
  q.flush = q.wg < q.groups;
  *p = q;
  return cudaSuccess;
}

template <int S>
cudaError_t launch(const Plan& p, const float* lab, const float* sil, const int* labels,
                   const int* num_labels, const int* num_frames, uint32_t* scratch, int* onset,
                   int* offset, int batch, int frames, int l_max, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(viterbi_kernel<S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  viterbi_kernel<S><<<batch, 32 * p.warps, p.smem, stream>>>(
      lab, sil, labels, num_labels, num_frames, scratch, onset, offset, batch, frames, l_max, p);
  return cudaGetLastError();
}

}  // namespace

// 32-bit words of backpointer scratch la_viterbi needs at this shape: 0 when
// every sequence's backpointers fit in shared memory
LA_API long long la_viterbi_scratch_words(int batch, int frames, int l_max) {
  Plan p;
  if (batch <= 0 || make_plan(frames, l_max, &p) != cudaSuccess || !p.flush) return 0;
  return (long long)batch * p.groups * p.gw;
}

// lab f32[batch, frames, l_max] (per label position), sil f32[batch, frames],
// labels / num_labels / num_frames int32, backpointer scratch of
// la_viterbi_scratch_words(batch, frames, l_max) 32-bit words (any pointer
// when that is 0) -> onset / offset int32[batch, l_max]
LA_API int la_viterbi(const void* lab, const void* sil, const void* labels,
                      const void* num_labels, const void* num_frames, void* bt, void* onset,
                      void* offset, int batch, int frames, int l_max, void* stream) {
  if (batch <= 0) return cudaSuccess;
  Plan p;
  cudaError_t err = make_plan(frames, l_max, &p);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto a0 = static_cast<const float*>(lab);
  auto a1 = static_cast<const float*>(sil);
  auto a2 = static_cast<const int*>(labels);
  auto a3 = static_cast<const int*>(num_labels);
  auto a4 = static_cast<const int*>(num_frames);
  auto a5 = static_cast<uint32_t*>(bt);
  auto a6 = static_cast<int*>(onset);
  auto a7 = static_cast<int*>(offset);
#define LA_VITERBI_CASE(S) \
  case S:                  \
    return launch<S>(p, a0, a1, a2, a3, a4, a5, a6, a7, batch, frames, l_max, s);
  switch (p.s) {
    LA_VITERBI_CASE(2)
    LA_VITERBI_CASE(4)
    LA_VITERBI_CASE(8)
    LA_VITERBI_CASE(16)
    LA_VITERBI_CASE(32)
  }
#undef LA_VITERBI_CASE
  return cudaErrorInvalidValue;
}
