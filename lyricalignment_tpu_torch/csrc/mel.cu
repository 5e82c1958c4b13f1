// Log10 mel spectrogram: framing, Hann-windowed real DFT, power, mel
// projection and log10 in one kernel.
//
// Replaces the TPU kernel lyricalignment_tpu/ops/mel_pallas.py:_kernel
// (launched by fused_log_mel). Like it, only the [n_mels, frames] log tile
// is written to device memory: the 400-sample frames, the spectra and the
// power spectrum stay on chip. The reflect pad runs in PyTorch before the
// launch, and the peak-8 clamp and (x+4)/4 after it, as on the TPU
// (mel_pallas.py:122-126). The TPU kernel multiplies by dense cos/sin
// bases on the MXU; here the DFT is a fast transform written out below, in
// float32 on the CUDA cores (no TF32: the 8-decade clamp after the log makes
// matmul error visible, lyricalignment_tpu/ops/mel.py:137-139).
//
// Bound on H100: bytes. At B = 16 and 3000 frames 31 MB of padded audio in
// and 15 MB of log-mel out take ~0.014 ms at 3.35 TB/s; the arithmetic is
// ~0.5 GFLOP. The design keeps everything between on chip:
// * One block per (batch row, tile of 32 frames) stages the tile's
//   31 x 160 + 400 samples in shared memory once, with the twiddle tables
//   (made in float64 and rounded once by ops/mel.py; the window is read
//   through L1). 75 KB of shared memory and 68 registers a thread let three
//   blocks share an SM: the phases below are short and separated by block
//   barriers, so the resident threads, not the arithmetic, set the time.
// * A frame's 400 windowed real samples are one 200-point complex
//   transform of z[n] = x[2n] + i x[2n+1], so every frame stands alone (an
//   all-zero frame gives exact zeros whatever its neighbours hold).
//   200 = 8 x 25: pass 1 gives each (frame, n2) to a thread, which reads its
//   8 samples 25 apart, runs a radix-8 butterfly in registers, multiplies by
//   W_200^(n2 k1) and writes z[frame][k1][n2]; pass 2 gives each
//   (k1, frame) to a thread, which runs a 25-point transform (5 x 5, in
//   registers) on its row in place, leaving Z[k1 + 8 k2] at [k1][k2]. A
//   frame's z is 201 complex values apart from the next one's (402 words:
//   18 f mod 32 are distinct even banks for 16 frames), so threads on
//   neighbouring n2 (pass 1) or neighbouring frames (pass 2, projection)
//   meet no bank conflicts.
// * The real spectrum follows from the conjugate symmetry:
//   E = (Z[k] + conj Z[200-k]) / 2, O = (Z[k] - conj Z[200-k]) / 2i,
//   X[k] = E + W_400^k O for k = 0..200 (Z[200] = Z[0]).
// * The mel projection forms |X[k]|^2 as it goes, each band only over its
//   nonzero bins (band_range; the skipped terms are exact zeros): no power
//   spectrum is stored. A warp covers 32 consecutive frames of one band, so
//   stores are 128-byte coalesced.
#include "common.cuh"

namespace {

constexpr int kNFft = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFft / 2 + 1;              // 201
constexpr int kHalf = kNFft / 2;                  // complex points a frame
constexpr int kN1 = 8, kN2 = 25;                  // kHalf = kN1 x kN2
constexpr int kTile = 32;                         // frames per block
constexpr int kSpan = (kTile - 1) * kHop + kNFft; // samples per tile: 5360
constexpr int kThreads = 256;

constexpr int kZStride = kHalf + 1;               // complex values from frame to frame

struct Smem {
  float x[kSpan];              // the tile's samples
  float2 tw[kN1][kN2];         // W_200^(n2 k1)
  float2 post[kBins];          // W_400^k
  // a frame's row: pass 1 leaves [k1][n2] at 25 k1 + n2, pass 2 leaves
  // Z[k1 + 8 k2] at 25 k1 + k2
  float2 z[kTile][kZStride];
};
static_assert(3 * (sizeof(Smem) + 1024) <= 228 * 1024 || kTile != 32, "three blocks an SM");

// cos and sin of 2 pi / 5 and 4 pi / 5, sqrt(1/2), and W_25^m for the
// products n2 k1 <= 16 of the 5 x 5 split (float64 values rounded once)
constexpr float kC1 = 0.309016994f, kC2 = -0.809016994f;
constexpr float kS1 = 0.951056516f, kS2 = 0.587785252f;
constexpr float kR = 0.707106781f;
__constant__ float2 kW25[17] = {
    {1.f, 0.f}, {0.968583167f, -0.24868989f}, {0.876306653f, -0.481753677f},
    {0.72896862f, -0.684547126f}, {0.535826802f, -0.844327927f}, {0.309017003f, -0.95105654f},
    {0.0627905205f, -0.998026729f}, {-0.187381312f, -0.982287228f},
    {-0.425779283f, -0.904827058f}, {-0.637423992f, -0.770513237f},
    {-0.809017003f, -0.587785244f}, {-0.92977649f, -0.368124545f},
    {-0.992114723f, -0.125333235f}, {-0.992114723f, 0.125333235f},
    {-0.92977649f, 0.368124545f}, {-0.809017003f, 0.587785244f},
    {-0.637423992f, 0.770513237f}};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// t - i u and t + i u
__device__ __forceinline__ float2 sub_i(float2 t, float2 u) { return make_float2(t.x + u.y, t.y - u.x); }
__device__ __forceinline__ float2 add_i(float2 t, float2 u) { return make_float2(t.x - u.y, t.y + u.x); }

// forward 4- and 5-point transforms in place, outputs in natural order
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 s0 = cadd(a, c), d0 = csub(a, c), s1 = cadd(b, d), d1 = csub(b, d);
  a = cadd(s0, s1);
  c = csub(s0, s1);
  b = sub_i(d0, d1);
  d = add_i(d0, d1);
}

__device__ __forceinline__ void dft5(float2& x0, float2& x1, float2& x2, float2& x3, float2& x4) {
  const float2 a1 = cadd(x1, x4), a2 = cadd(x2, x3), b1 = csub(x1, x4), b2 = csub(x2, x3);
  const float2 t1 = make_float2(x0.x + kC1 * a1.x + kC2 * a2.x, x0.y + kC1 * a1.y + kC2 * a2.y);
  const float2 t2 = make_float2(x0.x + kC2 * a1.x + kC1 * a2.x, x0.y + kC2 * a1.y + kC1 * a2.y);
  const float2 u1 = make_float2(kS1 * b1.x + kS2 * b2.x, kS1 * b1.y + kS2 * b2.y);
  const float2 u2 = make_float2(kS2 * b1.x - kS1 * b2.x, kS2 * b1.y - kS1 * b2.y);
  x0 = cadd(x0, cadd(a1, a2));
  x1 = sub_i(t1, u1);
  x4 = add_i(t1, u1);
  x2 = sub_i(t2, u2);
  x3 = add_i(t2, u2);
}

// 8 = 2 x 4: output k1 + 2 k2 is left at v[4 k1 + k2]
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float2 a = v[n], b = v[n + 4];
    v[n] = cadd(a, b);
    v[n + 4] = csub(a, b);
  }
  v[5] = make_float2(kR * (v[5].x + v[5].y), kR * (v[5].y - v[5].x));   // W_8
  v[6] = make_float2(v[6].y, -v[6].x);                                  // W_8^2 = -i
  v[7] = make_float2(kR * (v[7].y - v[7].x), -kR * (v[7].x + v[7].y));  // W_8^3
  dft4(v[0], v[1], v[2], v[3]);
  dft4(v[4], v[5], v[6], v[7]);
}

// 25 = 5 x 5: output k1 + 5 k2 is left at v[5 k1 + k2]
__device__ __forceinline__ void dft25(float2 (&v)[25]) {
#pragma unroll
  for (int n = 0; n < 5; ++n) dft5(v[n], v[5 + n], v[10 + n], v[15 + n], v[20 + n]);
#pragma unroll
  for (int k = 1; k < 5; ++k)
#pragma unroll
    for (int n = 1; n < 5; ++n) v[5 * k + n] = cmul(v[5 * k + n], kW25[k * n]);
#pragma unroll
  for (int k = 0; k < 5; ++k) dft5(v[5 * k], v[5 * k + 1], v[5 * k + 2], v[5 * k + 3], v[5 * k + 4]);
}

// |X[k]|^2 of a frame's real spectrum from its packed transform
__device__ __forceinline__ float bin_power(const float2* z, const float2* post, int k) {
  const int ka = k == kHalf ? 0 : k, kb = k == 0 ? 0 : kHalf - k;
  const float2 zk = z[kN2 * (ka % kN1) + ka / kN1], zc = z[kN2 * (kb % kN1) + kb / kN1];
  const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
  const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
  const float2 xk = cadd(e, cmul(post[k], o));
  return xk.x * xk.x + xk.y * xk.y;
}

__global__ void __launch_bounds__(kThreads, 3)
log10_mel_kernel(const float* __restrict__ padded, const float2* __restrict__ window,
                 const float2* __restrict__ twiddle, const float* __restrict__ mel_t,
                 const int* __restrict__ band_range, float* __restrict__ out,
                 int padded_len, int n_frames, int n_mels) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int frames = min(kTile, n_frames - t0);
  const int avail = (frames - 1) * kHop + kNFft;
  const float* row = padded + (size_t)b * padded_len + (size_t)t0 * kHop;
  for (int i = threadIdx.x; i < kSpan; i += kThreads) sm.x[i] = i < avail ? row[i] : 0.f;
  // the tables: W_200^(n2 k1) as [k1][n2], then W_400^k
  for (int i = threadIdx.x; i < kHalf; i += kThreads) (&sm.tw[0][0])[i] = __ldg(twiddle + i);
  for (int i = threadIdx.x; i < kBins; i += kThreads) sm.post[i] = __ldg(twiddle + kHalf + i);
  __syncthreads();

  // pass 1: (frame, n2) -> radix 8 over the samples 25 apart, then twiddle
  for (int task = threadIdx.x; task < frames * kN2; task += kThreads) {
    const int f = task / kN2, n2 = task % kN2;
    const float2* x2 = reinterpret_cast<const float2*>(sm.x + f * kHop);  // frame starts are even
    float2 v[kN1];
#pragma unroll
    for (int n1 = 0; n1 < kN1; ++n1) {
      const float2 s = x2[kN2 * n1 + n2], w = __ldg(window + kN2 * n1 + n2);
      v[n1] = make_float2(s.x * w.x, s.y * w.y);
    }
    dft8(v);
#pragma unroll
    for (int k1 = 0; k1 < kN1; ++k1)
      sm.z[f][kN2 * k1 + n2] = cmul(v[4 * (k1 % 2) + k1 / 2], sm.tw[k1][n2]);
  }
  __syncthreads();

  // pass 2: (k1, frame) -> 25 points over n2, in place
  for (int task = threadIdx.x; task < frames * kN1; task += kThreads) {
    const int f = task % frames, k1 = task / frames;
    float2* row = sm.z[f] + kN2 * k1;
    float2 v[kN2];
#pragma unroll
    for (int n2 = 0; n2 < kN2; ++n2) v[n2] = row[n2];
    dft25(v);
#pragma unroll
    for (int j = 0; j < kN2; ++j) row[j / 5 + 5 * (j % 5)] = v[j];
  }
  __syncthreads();

  // a warp covers 32 consecutive frames of one band: coalesced stores,
  // conflict-free z reads, broadcast table and mel reads; band m's weights
  // are zero outside bins [band_range[2m], band_range[2m+1])
  for (int idx = threadIdx.x; idx < n_mels * kTile; idx += kThreads) {
    const int f = idx % kTile, m = idx / kTile;
    if (f >= frames) continue;
    const int lo = __ldg(band_range + 2 * m), hi = __ldg(band_range + 2 * m + 1);
    float acc = 0.f;
    for (int j = lo; j < hi; ++j)
      acc = fmaf(bin_power(sm.z[f], sm.post, j), __ldg(mel_t + j * n_mels + m), acc);
    out[((size_t)b * n_mels + m) * n_frames + t0 + f] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// padded f32[batch, padded_len] (reflect-padded audio), window f32[400]
// (periodic Hann), twiddle f32 complex pairs: W_200^(n2 k1) as [8][25], then
// W_400^k for k = 0..200; mel_t f32[201, n_mels], band_range i32[n_mels, 2]
// (each band's first nonzero bin and last + 1) -> out f32[batch, n_mels,
// n_frames]. window and twiddle 8-byte aligned.
LA_API int la_log10_mel(const void* padded, const void* window, const void* twiddle,
                        const void* mel_t, const void* band_range, void* out,
                        int batch, int padded_len,
                        int n_frames, int n_mels, void* stream) {
  if (n_frames <= 0 || batch <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      log10_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  log10_mel_kernel<<<grid, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(padded), static_cast<const float2*>(window),
      static_cast<const float2*>(twiddle), static_cast<const float*>(mel_t),
      static_cast<const int*>(band_range), static_cast<float*>(out), padded_len,
      n_frames, n_mels);
  return cudaGetLastError();
}
