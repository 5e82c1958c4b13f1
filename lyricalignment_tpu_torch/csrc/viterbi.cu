// Forced-alignment Viterbi over K = 2L+1 interleaved states (even = silence,
// odd 2i+1 = label i) with backtrace and onset/offset extraction.
//
// Replaces the TPU kernel lyricalignment_tpu/ops/viterbi_pallas.py:_kernel
// (viterbi_align_pallas) and computes exactly what the production scan
// lyricalignment_tpu/ops/viterbi.py:_viterbi_dp computes:
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
// Emissions are read straight from the fused path's per-position tables:
// odd k -> lab[b, t, k/2], even k -> sil[b, t]; no [T, K] table is built.
//
// Bound on H100: latency. A chain of `frames` dependent steps (one
// __syncthreads each) and a serial backtrace of the same length, per
// sequence; the bytes (the emissions read once) are a few MB. One block per
// sequence, threads striding over the states (any K works), dp
// double-buffered in shared memory, uint8 backpointers (offset 0/1/2) in a
// [B, frames, K] scratch the wrapper allocates.
#include "common.cuh"

namespace {

constexpr float kNegBig = -1.0e7f;
constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ lab, const float* __restrict__ sil,
               const int* __restrict__ labels, const int* __restrict__ num_labels,
               const int* __restrict__ num_frames, unsigned char* __restrict__ bt,
               int* __restrict__ onset, int* __restrict__ offset, int frames, int l_max) {
  extern __shared__ float smem[];
  const int n_states = 2 * l_max + 1;
  float* prev = smem;
  float* next = smem + n_states;
  unsigned char* can_skip = reinterpret_cast<unsigned char*>(smem + 2 * n_states);

  const int b = blockIdx.x;
  const float* lab_b = lab + (size_t)b * frames * l_max;
  const float* sil_b = sil + (size_t)b * frames;
  const int* lab_ids = labels + (size_t)b * l_max;
  unsigned char* bt_b = bt + (size_t)b * frames * n_states;
  int* on_b = onset + (size_t)b * l_max;
  int* off_b = offset + (size_t)b * l_max;
  const int live = min(max(num_frames[b], 0), frames);

  for (int k = threadIdx.x; k < n_states; k += kThreads) {
    can_skip[k] = (k & 1) && k >= 3 && lab_ids[k / 2] != lab_ids[k / 2 - 1];
    prev[k] = k == 0 ? sil_b[0] : (k == 1 ? lab_b[0] : kNegBig);
  }
  for (int l = threadIdx.x; l < l_max; l += kThreads) {
    on_b[l] = frames + 1;
    off_b[l] = 0;
  }
  __syncthreads();

  for (int t = 1; t < live; ++t) {
    for (int k = threadIdx.x; k < n_states; k += kThreads) {
      const float p0 = prev[k];
      const float p1 = k >= 1 ? prev[k - 1] : kNegInf;
      const float p2 = k >= 2 ? prev[k - 2] : kNegInf;
      const bool stay = p0 > p1;
      float val = stay ? p0 : p1;
      unsigned char from = stay ? 0 : 1;
      if (can_skip[k] && p2 >= p1 && p2 >= p0) {
        val = p2;
        from = 2;
      }
      const float em = (k & 1) ? lab_b[(size_t)t * l_max + k / 2] : sil_b[t];
      next[k] = __fadd_rn(val, em);
      bt_b[(size_t)t * n_states + k] = from;
    }
    __syncthreads();
    float* tmp = prev;
    prev = next;
    next = tmp;
  }

  if (threadIdx.x == 0) {
    const int nl = num_labels[b];
    int i_sil = 2 * nl, i_lab = 2 * nl - 1;
    if (i_sil < 0) i_sil += n_states;
    if (i_lab < 0) i_lab += n_states;
    i_sil = min(max(i_sil, 0), n_states - 1);
    i_lab = min(max(i_lab, 0), n_states - 1);
    int cur = prev[i_sil] > prev[i_lab] ? i_sil : i_lab;
    for (int t = live - 1; t >= 0; --t) {
      if (cur & 1) {
        const int l = cur >> 1;
        if (off_b[l] == 0) off_b[l] = t + 1;
        on_b[l] = t;
      }
      if (t > 0) cur -= bt_b[(size_t)t * n_states + cur];
    }
  }
}

}  // namespace

// lab f32[batch, frames, l_max] (per label position), sil f32[batch, frames],
// labels / num_labels / num_frames int32, bt uint8[batch, frames, 2 l_max + 1]
// scratch -> onset / offset int32[batch, l_max]
LA_API int la_viterbi(const void* lab, const void* sil, const void* labels,
                      const void* num_labels, const void* num_frames, void* bt, void* onset,
                      void* offset, int batch, int frames, int l_max, void* stream) {
  if (batch <= 0) return cudaSuccess;
  const int n_states = 2 * l_max + 1;
  const int smem = 2 * n_states * sizeof(float) + n_states;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  viterbi_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lab), static_cast<const float*>(sil),
      static_cast<const int*>(labels), static_cast<const int*>(num_labels),
      static_cast<const int*>(num_frames), static_cast<unsigned char*>(bt),
      static_cast<int*>(onset), static_cast<int*>(offset), frames, l_max);
  return cudaGetLastError();
}
