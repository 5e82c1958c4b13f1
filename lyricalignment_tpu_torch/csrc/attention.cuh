// Shared by the encoder attention kernels (attention.cu: forward,
// attention_bwd.cu: dK/dV and dQ). q, k, v, out and their gradients keep
// the callers' [B, T, H, 64] layout, read with row stride H x 64; the row
// statistics (log-sum-exp, delta) are float32 [B, H, T]. Every kernel masks
// rows past `seq` itself, so T needs no padding. The float32 kernels work on
// the 64-row tiles below; the bf16 kernels have their own Hopper tilings
// (hopper.cuh) and read their tiles through the tensor maps encoded here.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace la {
namespace attn {

constexpr int kD = 64;        // head width (every Whisper size)
constexpr int kTile = 64;     // float32 kernels: queries or keys per tile
constexpr int kLd = kD + 1;   // float row stride: conflict-free column reads
constexpr int kThreads = 256; // float32 kernels: 16 x 16 threads, 4 x 4 tile each

// float32: 64 rows of a [.., T, H, 64] tensor into a [64][kLd] shared tile
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, size_t base,
                                              size_t row_stride, int t0, int seq) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, c = i % kD, t = t0 + r;
    dst[r * kLd + c] = t < seq ? src[base + t * row_stride + c] : 0.f;
  }
}

// ---- host: tensor maps of the bf16 kernels ---------------------------------

// [B, T, H, 64] bf16 as the 4-D tensor {64, H, T, B} (innermost first), in
// boxes of one head's 64 values for box_rows rows of T, written to shared
// memory with the 128-byte swizzle; rows past T read as zero
inline cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
                               int box_rows) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = kD * sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};  // bytes, dims 1..3
  const cuuint32_t box[4] = {(cuuint32_t)kD, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// f32[T] key bias (16-byte aligned) in boxes of box_keys; entries past T
// read as zero (the kernels mask those keys)
inline cudaError_t encode_bias(CUtensorMap* map, const void* ptr, int seq, int box_keys) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)seq};
  const cuuint64_t strides[1] = {sizeof(float)};  // not read for rank 1
  const cuuint32_t box[1] = {(cuuint32_t)box_keys};
  const cuuint32_t elem[1] = {1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// p rounded to bf16 straight into the register A fragments of a product over
// the accumulator's N columns: a thread's accumulator values (rows r and
// r + 8, columns 8 j + c, + 1) of columns 16 kk .. 16 kk + 15 are its share
// of the k16 slice kk
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&p)[N / 2],
                                               uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(p[4 * j], p[4 * j + 1]);          // row r
    pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p[4 * j + 2], p[4 * j + 3]);  // row r + 8
  }
}

}  // namespace attn
}  // namespace la
