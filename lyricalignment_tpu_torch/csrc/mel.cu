// Log10 mel spectrogram: framing, Hann-windowed real DFT, power, mel
// projection and log10 in one kernel.
//
// Replaces the TPU kernel lyricalignment_tpu/ops/mel_pallas.py:_kernel
// (launched by fused_log_mel). Like it, only the [n_mels, frames] log tile
// is written to device memory: the 400-sample frames, the 201-bin re/im
// spectra and the power spectrum stay on chip. The reflect pad runs in
// PyTorch before the launch, and the peak-8 clamp and (x+4)/4 after it, as
// on the TPU (mel_pallas.py:122-126).
//
// Bound on H100: bytes. The function needs little arithmetic: a real
// 400-point FFT is about 5/2 N log2 N = 8.6 kFLOP a frame and the Slaney
// projection about 2 x 400 (each bin feeds at most two bands), so at B=16
// and 3000 frames it is ~0.5 GFLOP, while 31 MB of padded audio in and
// 15 MB of log-mel out take ~0.014 ms at 3.35 TB/s. This kernel does not
// reach that bound: it computes the DFT densely (2 x 2 x 48000 x 400 x 201
// = 15.4 GFLOP of float32 FMAs on the CUDA cores; no TF32, because the
// 8-decade clamp after the log makes matmul error visible,
// lyricalignment_tpu/ops/mel.py:137-139), which is simple and exact to
// float32 rounding. The design keeps that arithmetic fed from on-chip
// memory: one block per (batch row, tile of 32 frames) stages the tile's
// 32 x 160 + 240 samples in shared memory once; thread k owns DFT bin k for
// all 32 frames, so each cos/sin basis value it loads (the 643 KB bases
// stay resident in L2) feeds 64 FMAs, and it reads the samples four at a
// time as 16-byte shared-memory broadcasts, one load per eight FMAs. The
// mel projection runs each band only over its nonzero bins (band_range);
// the skipped terms are exact zeros, so this changes no bit of the output.
#include "common.cuh"

namespace {

constexpr int kNFft = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFft / 2 + 1;              // 201
constexpr int kTile = 32;                         // frames per block
constexpr int kSpan = (kTile - 1) * kHop + kNFft; // samples per tile: 5360
constexpr int kThreads = 224;                     // 7 warps >= 201 bins

__global__ void __launch_bounds__(kThreads)
log10_mel_kernel(const float* __restrict__ padded, const float* __restrict__ cos_b,
                 const float* __restrict__ sin_b, const float* __restrict__ mel_t,
                 const int* __restrict__ band_range, float* __restrict__ out,
                 int padded_len, int n_frames, int n_mels) {
  __shared__ __align__(16) float x[kSpan];
  __shared__ float power[kTile][kBins];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int frames = min(kTile, n_frames - t0);
  const int avail = (frames - 1) * kHop + kNFft;
  const float* row = padded + (size_t)b * padded_len + (size_t)t0 * kHop;
  for (int i = threadIdx.x; i < kSpan; i += kThreads) x[i] = i < avail ? row[i] : 0.f;
  __syncthreads();

  const int k = threadIdx.x;
  if (k < kBins) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) re[f] = im[f] = 0.f;
    // frame f starts at f * 160, a multiple of 4: x[f * kHop + n .. n + 3]
    // is one aligned float4, and every lane of the warp reads the same one
    for (int n = 0; n < kNFft; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = __ldg(cos_b + (n + u) * kBins + k);
        s[u] = __ldg(sin_b + (n + u) * kBins + k);
      }
#pragma unroll
      for (int f = 0; f < kTile; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(x + f * kHop + n);
        re[f] = fmaf(v.x, c[0], re[f]);
        im[f] = fmaf(v.x, s[0], im[f]);
        re[f] = fmaf(v.y, c[1], re[f]);
        im[f] = fmaf(v.y, s[1], im[f]);
        re[f] = fmaf(v.z, c[2], re[f]);
        im[f] = fmaf(v.z, s[2], im[f]);
        re[f] = fmaf(v.w, c[3], re[f]);
        im[f] = fmaf(v.w, s[3], im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTile; ++f) power[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // a warp covers 32 consecutive frames of one band: coalesced stores,
  // conflict-free power reads (row stride 201 is odd), broadcast mel reads;
  // band m's weights are zero outside bins [band_range[2m], band_range[2m+1])
  for (int idx = threadIdx.x; idx < n_mels * kTile; idx += kThreads) {
    const int f = idx % kTile, m = idx / kTile;
    if (f >= frames) continue;
    const int lo = __ldg(band_range + 2 * m), hi = __ldg(band_range + 2 * m + 1);
    float acc = 0.f;
    for (int j = lo; j < hi; ++j) acc = fmaf(power[f][j], __ldg(mel_t + j * n_mels + m), acc);
    out[((size_t)b * n_mels + m) * n_frames + t0 + f] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// padded f32[batch, padded_len] (reflect-padded audio), cos_b / sin_b
// f32[400, 201], mel_t f32[201, n_mels], band_range i32[n_mels, 2] (each
// band's first nonzero bin and last + 1) -> out f32[batch, n_mels, n_frames]
LA_API int la_log10_mel(const void* padded, const void* cos_b, const void* sin_b,
                        const void* mel_t, const void* band_range, void* out,
                        int batch, int padded_len,
                        int n_frames, int n_mels, void* stream) {
  if (n_frames <= 0 || batch <= 0) return cudaSuccess;
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  log10_mel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(padded), static_cast<const float*>(cos_b),
      static_cast<const float*>(sin_b), static_cast<const float*>(mel_t),
      static_cast<const int*>(band_range), static_cast<float*>(out), padded_len,
      n_frames, n_mels);
  return cudaGetLastError();
}
