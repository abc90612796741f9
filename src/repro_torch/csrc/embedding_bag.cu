// Weighted EmbeddingBag (gather + per-bag reduce) for Hopper.
//
// Replaces the Pallas kernel _bag_kernel of repro/kernels/embedding_bag.py
// (wrapper embedding_bag): out[b] = sum_l w[b, l] * table[idx[b, l]], and in
// "mean" mode divided by max(sum_l w[b, l], 1e-9); no weights means ones.
// Sums in f32, output in the table's type.  An id outside [0, V) is clamped
// to the nearest row (the JAX package's dense reference clamps one past the
// end and wraps a negative one; the TPU kernel drops both); callers keep ids
// in range.
//
// The TPU kernel tiles the vocabulary through VMEM and resolves every bag
// against every tile, because a TPU has no fast data-dependent gather from
// HBM.  On Hopper the natural form is a direct gather: one warp per bag, its
// lanes across the embedding width (BST's D = 32: one f32 a lane, one
// 128-byte line a row), a loop over the bag's L ids with the id and weight
// broadcast to the warp.  Rows that several bags share (Zipf ids) are served
// from the 50 MB L2.
//
// Bound on an H100: bytes.  Each distinct row gathered once (D * 4 bytes in
// f32), plus the ids, weights and output, over 3.35 TB/s; two flops a
// gathered element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void embedding_bag_kernel(const T* __restrict__ table,   // [V, D]
                                     const int* __restrict__ idx,    // [B, L]
                                     const float* __restrict__ w,    // [B, L] or null
                                     T* __restrict__ out,            // [B, D]
                                     int B, int L, int V, int D, int mean) {
  const int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (bag >= B) return;  // warp-uniform
  const int* ib = idx + bag * L;
  const float* wb = w ? w + bag * L : nullptr;
  float wsum = 0.f;
  if (mean)
    for (int l = 0; l < L; ++l) wsum += wb ? __ldg(wb + l) : 1.f;
  const float denom = fmaxf(wsum, 1e-9f);
  for (int d0 = 0; d0 < D; d0 += kWarp) {
    const int d = d0 + lane;
    float acc = 0.f;
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      const int id = min(max(__ldg(ib + l), 0), V - 1);
      const float wl = wb ? __ldg(wb + l) : 1.f;
      if (d < D) acc = fmaf(wl, to_f(table[(int64_t)id * D + d]), acc);
    }
    if (d < D) out[bag * D + d] = from_f<T>(mean ? acc / denom : acc);
  }
}

template <typename T>
int launch(const void* table, const int* idx, const float* w, void* out, int B, int L, int V,
           int D, int mean, cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  embedding_bag_kernel<T><<<grid, kWarpsPerBlock * kWarp, 0, stream>>>(
      static_cast<const T*>(table), idx, w, static_cast<T*>(out), B, L, V, D, mean);
  return (int)cudaGetLastError();
}

}  // namespace

// table [V, D] and out [B, D] of one type (dtype 0 = float32, 1 = bfloat16),
// idx [B, L] int32, w [B, L] float32 or null (ones); all contiguous.
extern "C" int embedding_bag_fwd(const void* table, const int* idx, const float* w, void* out,
                                 int B, int L, int V, int D, int mean, int dtype,
                                 void* stream) {
  if (V < 1 || D < 1 || L < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(table, idx, w, out, B, L, V, D, mean, st);
  if (dtype == 1) return launch<__nv_bfloat16>(table, idx, w, out, B, L, V, D, mean, st);
  return (int)cudaErrorInvalidValue;
}
