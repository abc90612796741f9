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
// HBM.  On Hopper the natural form is a direct gather, one warp per bag:
//
//   * the bag's ids and weights are read once, coalesced, lane l holding
//     id l and weight l of each chunk of 32; "mean"'s weight sum is a warp
//     reduction of what the lanes hold;
//   * a row is gathered by G lanes with 16-byte loads (G = D * sizeof(T) /
//     16 rounded up to a power of two; BST's 32 f32 take 8 lanes, so one
//     warp instruction fetches 4 rows), each id broadcast by __shfl_sync;
//     the loads of up to 8 rows a lane (a chunk's 32 ids when G <= 8) come
//     before the first FMA, so a bag's rows are in flight together (as
//     many as 32 registers hold), and 64 warps (bags) a SM are resident;
//   * the 32 / G row groups' partial sums are reduced by __shfl_xor_sync,
//     and the first group stores the output row with 16-byte stores.
//
// Where D * sizeof(T) is not a multiple of 16 or the table's base is not
// 16-byte aligned, the same kernel runs with one element a lane per load.
//
// Bound on an H100: bytes.  Each distinct row gathered once (D * sizeof(T)
// bytes), plus the ids, weights and output, over 3.35 TB/s; two flops a
// gathered element.  Rows that several bags share (Zipf ids) are read again
// from the 50 MB L2, whose rate then sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxInFlight = 8;  // rows a lane has in flight
constexpr int kMinBlocks = 8;  // resident blocks a SM: 2,048 threads, the most it takes

// bf16 <-> f32 on raw bits: widening is exact, narrowing rounds to nearest even
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// One load of a row: 16 bytes (Vec = uint4) or one element (Vec = T).
template <typename T, bool kVec>
struct Chunk;

template <>
struct Chunk<float, true> {
  using Vec = uint4;
  static constexpr int E = 4;
  __device__ static Vec load(const Vec* p) { return __ldg(p); }
  __device__ static void fma(float (&acc)[E], Vec v, float w) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
  }
  __device__ static void store(Vec* p, const float (&a)[E]) {
    *p = make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                    __float_as_uint(a[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16, true> {
  using Vec = uint4;
  static constexpr int E = 8;
  __device__ static Vec load(const Vec* p) { return __ldg(p); }
  __device__ static void fma(float (&acc)[E], Vec v, float w) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(w, bf16_lo(u[i]), acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, bf16_hi(u[i]), acc[2 * i + 1]);
    }
  }
  __device__ static void store(Vec* p, const float (&a)[E]) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = bf16_bits(a[2 * i]) | (bf16_bits(a[2 * i + 1]) << 16);
    *p = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <>
struct Chunk<float, false> {
  using Vec = float;
  static constexpr int E = 1;
  __device__ static Vec load(const Vec* p) { return __ldg(p); }
  __device__ static void fma(float (&acc)[E], Vec v, float w) { acc[0] = fmaf(w, v, acc[0]); }
  __device__ static void store(Vec* p, const float (&a)[E]) { *p = a[0]; }
};

template <>
struct Chunk<__nv_bfloat16, false> {
  using Vec = unsigned short;
  static constexpr int E = 1;
  __device__ static Vec load(const Vec* p) { return __ldg(p); }
  __device__ static void fma(float (&acc)[E], Vec v, float w) {
    acc[0] = fmaf(w, bf16_lo(v), acc[0]);
  }
  __device__ static void store(Vec* p, const float (&a)[E]) { *p = (Vec)bf16_bits(a[0]); }
};

// G lanes a row, 32 / G rows a warp instruction; C chunks a row.  Bounded
// to 32 registers so that 64 warps fit an SM: more bags in flight beat more
// rows a lane in flight (at 56 registers and 32 warps a SM the BST case
// took 0.168 ms, at 32 and 64 warps 0.119 ms on an H100, 700 W).
template <typename T, bool kVec, int G>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp, kMinBlocks)
    embedding_bag_kernel(const T* __restrict__ table,  // [V, D]
                         const int* __restrict__ idx,   // [B, L]
                         const float* __restrict__ w,   // [B, L] or null
                         T* __restrict__ out,           // [B, D]
                         int B, int L, int V, int C, int mean) {
  using K = Chunk<T, kVec>;
  using Vec = typename K::Vec;
  constexpr int P = kWarp / G;                             // row groups a warp
  constexpr int U = G < kMaxInFlight ? G : kMaxInFlight;   // rows a lane per batch
  const int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (bag >= B) return;  // warp-uniform
  const int g = lane / G;
  const int sub = lane % G;
  const int* ib = idx + bag * L;
  const float* wb = w ? w + bag * L : nullptr;
  const Vec* rows = reinterpret_cast<const Vec*>(table);
  Vec* orow = reinterpret_cast<Vec*>(out) + bag * C;
  float denom = 1.f;
  for (int c0 = 0; c0 < C; c0 += G) {  // one pass unless a row is wider than 32 loads
    const int c = c0 + sub;
    const bool col = c < C;
    float acc[K::E];
#pragma unroll
    for (int e = 0; e < K::E; ++e) acc[e] = 0.f;
    float wsum = 0.f;
    for (int base = 0; base < L; base += kWarp) {
      const int n = min(kWarp, L - base);
      int my_id = 0;
      float my_w = 0.f;
      if (lane < n) {
        my_id = min(max(__ldg(ib + base + lane), 0), V - 1);
        my_w = wb ? __ldg(wb + base + lane) : 1.f;
      }
      wsum += my_w;
      for (int t0 = 0; t0 < n; t0 += P * U) {
        Vec v[U];
        float wt[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {  // every load of the batch before any FMA
          const int t = t0 + g + P * u;
          const int row = __shfl_sync(kFull, my_id, t & (kWarp - 1));
          const float wl = __shfl_sync(kFull, my_w, t & (kWarp - 1));
          wt[u] = t < n ? wl : 0.f;
          v[u] = (t < n && col) ? K::load(rows + (int64_t)row * C + c) : Vec{};
        }
#pragma unroll
        for (int u = 0; u < U; ++u) K::fma(acc, v[u], wt[u]);
      }
    }
#pragma unroll
    for (int off = G; off < kWarp; off <<= 1) {
#pragma unroll
      for (int e = 0; e < K::E; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
    }
    if (mean) {
      if (c0 == 0) {
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) wsum += __shfl_xor_sync(kFull, wsum, off);
        denom = fmaxf(wsum, 1e-9f);
      }
#pragma unroll
      for (int e = 0; e < K::E; ++e) acc[e] = acc[e] / denom;
    }
    if (g == 0 && col) K::store(orow + c, acc);
  }
}

// lanes a row: the chunks of a row rounded up to a power of two, at most 32
int lanes_for(int C) {
  int G = 1;
  while (G < C && G < kWarp) G <<= 1;
  return G;
}

template <typename T, bool kVec, int G>
void launch_g(unsigned grid, cudaStream_t st, const void* table, const int* idx,
              const float* w, void* out, int B, int L, int V, int C, int mean) {
  embedding_bag_kernel<T, kVec, G><<<grid, kWarpsPerBlock * kWarp, 0, st>>>(
      static_cast<const T*>(table), idx, w, static_cast<T*>(out), B, L, V, C, mean);
}

template <typename T, bool kVec>
int launch(const void* table, const int* idx, const float* w, void* out, int B, int L, int V,
           int C, int mean, cudaStream_t st) {
  const unsigned grid = (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  switch (lanes_for(C)) {
    case 1: launch_g<T, kVec, 1>(grid, st, table, idx, w, out, B, L, V, C, mean); break;
    case 2: launch_g<T, kVec, 2>(grid, st, table, idx, w, out, B, L, V, C, mean); break;
    case 4: launch_g<T, kVec, 4>(grid, st, table, idx, w, out, B, L, V, C, mean); break;
    case 8: launch_g<T, kVec, 8>(grid, st, table, idx, w, out, B, L, V, C, mean); break;
    case 16: launch_g<T, kVec, 16>(grid, st, table, idx, w, out, B, L, V, C, mean); break;
    default: launch_g<T, kVec, 32>(grid, st, table, idx, w, out, B, L, V, C, mean); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The instance that runs for a [V, D] table of type dtype (0 = float32,
// 1 = bfloat16) at table and out: (bytes a load << 8) | lanes a row.
// 16-byte loads where a row is a whole number of 16-byte pieces and both
// bases are 16-byte aligned, one element a load otherwise.
extern "C" int embedding_bag_instance(const void* table, const void* out, int D, int dtype) {
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = (D * esize) % 16 == 0 && (uintptr_t)table % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int bytes = vec ? 16 : esize;
  return (bytes << 8) | lanes_for(D * esize / bytes);
}

// table [V, D] and out [B, D] of one type (dtype 0 = float32, 1 = bfloat16),
// idx [B, L] int32, w [B, L] float32 or null (ones); all contiguous.
extern "C" int embedding_bag_fwd(const void* table, const int* idx, const float* w, void* out,
                                 int B, int L, int V, int D, int mean, int dtype,
                                 void* stream) {
  if (V < 1 || D < 1 || L < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int bytes = embedding_bag_instance(table, out, D, dtype) >> 8;
  const int C = D * (dtype == 0 ? 4 : 2) / bytes;
  if (dtype == 0)
    return bytes == 16 ? launch<float, true>(table, idx, w, out, B, L, V, C, mean, st)
                       : launch<float, false>(table, idx, w, out, B, L, V, C, mean, st);
  return bytes == 16 ? launch<__nv_bfloat16, true>(table, idx, w, out, B, L, V, C, mean, st)
                     : launch<__nv_bfloat16, false>(table, idx, w, out, B, L, V, C, mean, st);
}
