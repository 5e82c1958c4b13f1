// Reduced CTC: the alpha recursion of the fused training loss over the
// emissions of blank and of the target's own label positions only, forward
// (per-sample NLL) and backward (the gradient of the emissions).
//
// The JAX package computes this as lyricalignment_tpu/train/losses.py:
// _ctc_nll_single, a lax.scan over frames inside jax.vmap, and takes its
// gradient by autodiff of the scan: no Pallas kernel, so these two are port
// work. They keep its arithmetic exactly: S = 2N + 1 states (even = blank,
// odd 2p + 1 = label position p), the -1e30 sentinel for a state that cannot
// be reached, _lse3(a, b, c) = m + log(exp(a - m) + exp(b - m) + exp(c - m)),
// the skip from s - 2 only where label p differs from label p - 1, label
// positions past the target unreachable, and the end states 2 tlen - 1 and
// 2 tlen (only 2 tlen when tlen == 0). A target that cannot fit its frames
// keeps the sentinel arithmetic: its NLL is about 1e30 and its gradient is
// what the reverse of this recursion gives, as jax.grad gives it.
//
// Bound on H100: the serial chain. Each frame depends on the previous one
// through a log-sum-exp of three neighbours; the ~1 MB that the recursion
// reads and writes is nothing beside T dependent steps. The design:
// * one block a sample, the states over its 128 threads (up to 8 a thread),
//   the alphas of the previous frame in shared memory (double buffered), one
//   barrier a frame; the next frame's emissions are loaded before the
//   barrier so that their latency hides behind it;
// * the forward writes every frame's alphas, B x T x S floats, for the
//   backward (1.2 MB at B = 2, T = 1500, N = 48);
// * the backward runs the recursion in reverse: the adjoint of alpha_t goes
//   back to alpha_{t-1} through each _lse3's weights exp(a - m) / sum,
//   recomputed from the stored alphas, in two half-steps (each state's
//   adjoint over its sum, then each state gathers from the up to three states
//   it feeds); the adjoint of the emission at (t, s) is the adjoint of
//   alpha_t[s]. It writes those to scratch, and after the loop the block sums
//   them into d blank_lp (even states, in order) and d label_lp (the valid
//   positions' odd states). No atomics: equal bits from run to run.
#include "common.cuh"

namespace {

constexpr float kNeg = -1.0e30f;   // _CTC_NEG
constexpr int kThreads = 128;
constexpr int kPer = 8;            // states a thread at most: S <= 1024

// emission of state s at frame t (the sentinel at invalid label positions)
__device__ __forceinline__ float emission(const float* __restrict__ blank,
                                          const float* __restrict__ label,
                                          const unsigned char* __restrict__ valid, int t, int s,
                                          int n) {
  if (s % 2 == 0) return __ldg(blank + t);
  const int p = s / 2;
  return valid[p] ? __ldg(label + (size_t)t * n + p) : kNeg;
}

__device__ __forceinline__ bool can_skip(const int* __restrict__ labels, int s) {
  return s % 2 == 1 && s >= 3 && labels[s / 2] != labels[s / 2 - 1];
}

__device__ __forceinline__ int target_length(const unsigned char* __restrict__ valid, int n) {
  int tlen = 0;
  for (int p = 0; p < n; ++p) tlen += valid[p] ? 1 : 0;
  return tlen;
}

__global__ void __launch_bounds__(kThreads)
ctc_fwd_kernel(const float* __restrict__ blank_lp, const float* __restrict__ label_lp,
               const int* __restrict__ labels_all, const unsigned char* __restrict__ valid_all,
               float* __restrict__ alphas, float* __restrict__ nll, int t_max, int n) {
  extern __shared__ float fwd_smem[];
  const int b = blockIdx.x, s_dim = 2 * n + 1;
  float* prev = fwd_smem;          // [2][S]
  const float* blank = blank_lp + (size_t)b * t_max;
  const float* label = label_lp + (size_t)b * t_max * n;
  const int* labels = labels_all + (size_t)b * n;
  const unsigned char* valid = valid_all + (size_t)b * n;
  float* alpha_out = alphas + (size_t)b * t_max * s_dim;

  bool skip[kPer];
  float em[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = threadIdx.x + k * kThreads;
    skip[k] = s < s_dim && can_skip(labels, s);
    em[k] = s < s_dim ? emission(blank, label, valid, 0, s, n) : 0.f;
    if (s < s_dim) {
      const float a = s < 2 ? em[k] : kNeg;
      prev[s] = a;
      alpha_out[s] = a;
    }
    if (s < s_dim && t_max > 1) em[k] = emission(blank, label, valid, 1, s, n);
  }
  __syncthreads();

  for (int t = 1; t < t_max; ++t) {
    const float* cur = prev + ((t - 1) & 1) * s_dim;
    float* nxt = prev + (t & 1) * s_dim;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = threadIdx.x + k * kThreads;
      if (s < s_dim) {
        const float a0 = cur[s];
        const float a1 = s >= 1 ? cur[s - 1] : kNeg;
        const float a2 = skip[k] ? cur[s - 2] : kNeg;
        const float m = fmaxf(fmaxf(a0, a1), a2);
        const float v = em[k] + (m + logf(expf(a0 - m) + expf(a1 - m) + expf(a2 - m)));
        nxt[s] = v;
        alpha_out[(size_t)t * s_dim + s] = v;
        if (t + 1 < t_max) em[k] = emission(blank, label, valid, t + 1, s, n);
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const float* last = prev + ((t_max - 1) & 1) * s_dim;
    const int tlen = target_length(valid, n);
    const float end_lab = tlen > 0 ? last[2 * tlen - 1] : kNeg;
    const float end_blank = last[2 * tlen];
    const float m = fmaxf(end_lab, end_blank);
    nll[b] = -(m + logf(expf(end_lab - m) + expf(end_blank - m)));
  }
}

__global__ void __launch_bounds__(kThreads)
ctc_bwd_kernel(const float* __restrict__ alphas, const int* __restrict__ labels_all,
               const unsigned char* __restrict__ valid_all, const float* __restrict__ g,
               float* __restrict__ d_em_all, float* __restrict__ d_blank,
               float* __restrict__ d_label, int t_max, int n) {
  extern __shared__ float bwd_smem[];
  const int b = blockIdx.x, s_dim = 2 * n + 1;
  float* arow = bwd_smem;              // [2][S]: alphas of frames t - 1 (double buffered)
  float* coef = arow + 2 * s_dim;      // [S]: adjoint / sum of each state's _lse3
  float* mx = coef + s_dim;            // [S]: each state's max
  const int* labels = labels_all + (size_t)b * n;
  const unsigned char* valid = valid_all + (size_t)b * n;
  const float* alpha = alphas + (size_t)b * t_max * s_dim;
  float* d_em = d_em_all + (size_t)b * t_max * s_dim;
  const int tlen = target_length(valid, n);

  // adjoint of the last frame's alphas: the NLL's two end states
  float adj[kPer];
  bool skip_self[kPer];
  {
    const float* last = alpha + (size_t)(t_max - 1) * s_dim;
    const float end_lab = tlen > 0 ? last[2 * tlen - 1] : kNeg;
    const float end_blank = last[2 * tlen];
    const float m = fmaxf(end_lab, end_blank);
    const float e_lab = expf(end_lab - m), e_blank = expf(end_blank - m);
    const float gs = __ldg(g + b) / (e_lab + e_blank);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = threadIdx.x + k * kThreads;
      adj[k] = 0.f;
      if (s == 2 * tlen) adj[k] = -gs * e_blank;
      if (tlen > 0 && s == 2 * tlen - 1) adj[k] = -gs * e_lab;
      skip_self[k] = s < s_dim && can_skip(labels, s);
      if (s < s_dim && t_max > 1) arow[((t_max - 2) & 1) * s_dim + s] = alpha[(size_t)(t_max - 2) * s_dim + s];
    }
  }
  __syncthreads();

  for (int t = t_max - 1; t >= 1; --t) {
    const float* a = arow + ((t - 1) & 1) * s_dim;  // alphas of frame t - 1
    // the emission's adjoint, and each state's coefficient and max
    float pre[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = threadIdx.x + k * kThreads;
      if (s < s_dim) {
        d_em[(size_t)t * s_dim + s] = adj[k];
        const float a0 = a[s];
        const float a1 = s >= 1 ? a[s - 1] : kNeg;
        const float a2 = skip_self[k] ? a[s - 2] : kNeg;
        const float m = fmaxf(fmaxf(a0, a1), a2);
        const float sum = expf(a0 - m) + expf(a1 - m) + expf(a2 - m);
        coef[s] = adj[k] / sum;
        mx[s] = m;
        // frame t - 2's alphas, staged for the next step
        pre[k] = t >= 2 ? alpha[(size_t)(t - 2) * s_dim + s] : 0.f;
      }
    }
    __syncthreads();
    // adjoint of alpha_{t-1}[s]: from states s, s + 1 and (where it skips) s + 2
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = threadIdx.x + k * kThreads;
      if (s < s_dim) {
        const float av = a[s];
        float d = coef[s] * expf(av - mx[s]);
        if (s + 1 < s_dim) d += coef[s + 1] * expf(av - mx[s + 1]);
        if (s + 2 < s_dim && can_skip(labels, s + 2)) d += coef[s + 2] * expf(av - mx[s + 2]);
        adj[k] = d;
        if (t >= 2) arow[(t & 1) * s_dim + s] = pre[k];
      }
    }
    __syncthreads();
  }
  // frame 0: only states 0 and 1 start from an emission
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = threadIdx.x + k * kThreads;
    if (s < s_dim) d_em[s] = s < 2 ? adj[k] : 0.f;
  }
  __syncthreads();

  // the emissions' adjoints by state into blank_lp's and label_lp's
  for (int t = threadIdx.x; t < t_max; t += kThreads) {
    const float* row = d_em + (size_t)t * s_dim;
    float sum = 0.f;
    for (int s = 0; s < s_dim; s += 2) sum += row[s];
    d_blank[(size_t)b * t_max + t] = sum;
  }
  for (int i = threadIdx.x; i < t_max * n; i += kThreads) {
    const int t = i / n, p = i % n;
    d_label[(size_t)b * t_max * n + i] = valid[p] ? d_em[(size_t)t * s_dim + 2 * p + 1] : 0.f;
  }
}

}  // namespace

// the most label positions a target may have (S = 2N + 1 states over the
// block's threads)
LA_API int la_ctc_max_labels() { return (kThreads * kPer - 1) / 2; }

// blank_lp f32[B, T], label_lp f32[B, T, N], labels i32[B, N], valid u8[B, N]
// -> alphas f32[B, T, 2N + 1], nll f32[B]. T >= 1, 1 <= N <= la_ctc_max_labels().
LA_API int la_ctc_reduced_fwd(const void* blank_lp, const void* label_lp, const void* labels,
                              const void* valid, void* alphas, void* nll, int batch, int t_max,
                              int n, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (t_max <= 0 || n <= 0 || n > la_ctc_max_labels()) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (2 * n + 1);
  ctc_fwd_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank_lp), static_cast<const float*>(label_lp),
      static_cast<const int*>(labels), static_cast<const unsigned char*>(valid),
      static_cast<float*>(alphas), static_cast<float*>(nll), t_max, n);
  return cudaGetLastError();
}

// alphas of la_ctc_reduced_fwd, labels, valid, g f32[B] (the gradient of
// the NLL) -> d_blank f32[B, T], d_label f32[B, T, N]; scratch f32[B, T, 2N + 1]
LA_API int la_ctc_reduced_bwd(const void* alphas, const void* labels, const void* valid,
                              const void* g, void* scratch, void* d_blank, void* d_label,
                              int batch, int t_max, int n, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (t_max <= 0 || n <= 0 || n > la_ctc_max_labels()) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 4 * (2 * n + 1);
  ctc_bwd_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alphas), static_cast<const int*>(labels),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(g),
      static_cast<float*>(scratch), static_cast<float*>(d_blank), static_cast<float*>(d_label),
      t_max, n);
  return cudaGetLastError();
}
