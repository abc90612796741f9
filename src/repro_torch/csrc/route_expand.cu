// Fused stepwise layered routing expansion (paper §VI) + Eq. 1 latency fold.
//
// Replaces the Pallas kernel _expand_kernel of repro/kernels/route_expand.py.
// The TPU version walks a block of requests in lockstep and packs per-DC
// coverage into 10-bit fields of int32 lane words.  Requests are
// independent and extra greedy passes are idempotent, so here each request
// runs its own greedy walk on one warp, with no lockstep:
//
//   * serve locally where the origin's bit is set;
//   * per layer, count for every cluster DC the still-missing items holding
//     its bit: each pass ballots the masked bitmask of 32 items at a time,
//     one ballot per DC, and lane d keeps DC d's count (D <= 31);
//   * the argmax goes to the lowest DC id on ties; its hits are assigned; a
//     pass with no progress records miss_after[l + 1] and moves up a layer;
//     the walk is bounded by L * (D + 1) passes;
//   * then the fold: bytes per DC, straggler = max over serving DCs of
//     rtt + bytes * (1 / bw), and WAN bytes (served away from the origin).
//
// Bound on an H100: memory.  The inputs that scale are bits and sizes,
// R * K * (4 + 4) bytes read, and served, R * K * 4 bytes written; a pass
// re-reads the request's own slots from L1/L2.  Lanes own consecutive item
// slots, so every load and store of a row coalesces.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void route_expand_kernel(const int* __restrict__ bits,     // [R, K]
                                    const float* __restrict__ sizes,  // [R, K]
                                    const int* __restrict__ lens,     // [R]
                                    const int* __restrict__ origin,   // [R]
                                    const int* __restrict__ comp,     // [L + 1, D]
                                    const float* __restrict__ rtt,    // [D, D]
                                    const float* __restrict__ ibw,    // [D, D]
                                    int* __restrict__ served,         // [R, K]
                                    float* __restrict__ bytes_rd,     // [R, D]
                                    int* __restrict__ layers_used,    // [R]
                                    int* __restrict__ miss_after,     // [R, L + 1]
                                    float* __restrict__ straggler,    // [R]
                                    float* __restrict__ wan,          // [R]
                                    int R, int K, int D, int L) {
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= R) return;  // warp-uniform
  const int o = origin[r];
  const int len = min(max(lens[r], 0), K);
  const unsigned* brow = reinterpret_cast<const unsigned*>(bits) + r * K;
  const float* zrow = sizes + r * K;
  int* srow = served + r * K;
  int* mrow = miss_after + r * (L + 1);

  // layer 0: local items; every slot a lane writes is read back only by it
  int nmiss = 0;
  for (int k = lane; k < K; k += kWarp) {
    int s = -1;
    if (k < len) {
      if ((brow[k] >> o) & 1u) s = o; else ++nmiss;
    }
    srow[k] = s;
  }
  nmiss = warp_sum(nmiss);
  for (int i = lane; i <= L; i += kWarp) mrow[i] = i == 0 ? nmiss : 0;

  int used = 0;
  int layer = 0;
  const int max_it = L * (D + 1);
  for (int it = 0; layer < L && nmiss > 0 && it < max_it; ++it) {
    // cluster of the origin at layer + 1, origin excluded; lane d = DC d
    const int* cl = comp + (int64_t)(layer + 1) * D;
    const unsigned allowed =
        __ballot_sync(kFull, lane < D && lane != o && cl[lane < D ? lane : 0] == cl[o]);
    if (allowed) used = layer + 1;
    int cover = 0;
    for (int base = 0; base < len; base += kWarp) {
      const int k = base + lane;
      const unsigned m = (k < len && srow[k] < 0) ? (brow[k] & allowed) : 0u;
      if (__any_sync(kFull, m != 0u)) {
        for (int d = 0; d < D; ++d) {
          const int c = __popc(__ballot_sync(kFull, (m >> d) & 1u));
          if (lane == d) cover += c;
        }
      }
    }
    // argmax over DCs, lowest id on ties
    int gain = lane < D ? cover : -1;
    int best = lane;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const int g2 = __shfl_xor_sync(kFull, gain, off);
      const int b2 = __shfl_xor_sync(kFull, best, off);
      if (g2 > gain || (g2 == gain && b2 < best)) {
        gain = g2;
        best = b2;
      }
    }
    if (gain > 0) {
      for (int k = lane; k < len; k += kWarp) {
        if (srow[k] < 0 && ((brow[k] >> best) & 1u)) srow[k] = best;
      }
      nmiss -= gain;
    } else {
      if (lane == 0) mrow[layer + 1] = nmiss;
      ++layer;
    }
  }

  // Eq. 1 fold; lane d ends with DC d's bytes and whether it served at all
  float my_bytes = 0.f;
  bool my_served = false;
  for (int d = 0; d < D; ++d) {
    float s = 0.f;
    bool any = false;
    for (int k = lane; k < len; k += kWarp) {
      if (srow[k] == d) {
        s += zrow[k];
        any = true;
      }
    }
    s = warp_sum(s);
    any = __any_sync(kFull, any);
    if (lane == d) {
      my_bytes = s;
      my_served = any;
    }
  }
  float lat = 0.f;
  float away = 0.f;
  if (lane < D) {
    bytes_rd[r * D + lane] = my_bytes;
    if (lane != o) {
      away = my_bytes;
      if (my_served) lat = rtt[lane * D + o] + my_bytes * ibw[lane * D + o];
    }
  }
  lat = warp_max(lat);
  away = warp_sum(away);
  if (lane == 0) {
    layers_used[r] = used;
    straggler[r] = lat;
    wan[r] = away;
  }
}

}  // namespace

extern "C" int route_expand_launch(const int* bits, const float* sizes, const int* lens,
                                   const int* origin, const int* comp, const float* rtt,
                                   const float* ibw, int* served, float* bytes_rd,
                                   int* layers_used, int* miss_after, float* straggler,
                                   float* wan, int R, int K, int D, int L, int block_r,
                                   void* stream) {
  if (R == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((R + block_r - 1) / block_r);
  route_expand_kernel<<<grid, block_r * kWarp, 0, (cudaStream_t)stream>>>(
      bits, sizes, lens, origin, comp, rtt, ibw, served, bytes_rd, layers_used, miss_after,
      straggler, wan, R, K, D, L);
  return (int)cudaGetLastError();
}
