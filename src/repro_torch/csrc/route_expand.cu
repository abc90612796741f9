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
//     its bit, lane d ending with DC d's count (D <= 31);
//   * the argmax goes to the lowest DC id on ties; its hits are assigned; a
//     pass with no progress records miss_after[l + 1] and moves up a layer;
//     the walk is bounded by L * (D + 1) passes;
//   * then the fold: bytes per DC, straggler = max over serving DCs of
//     rtt + bytes * (1 / bw), and WAN bytes (served away from the origin).
//
// Bound on an H100: a request's walk is a chain of up to L * (D + 1)
// dependent passes, so a call takes the latency of one warp's walk, not its
// bytes (R * K * 12 bytes of bits, sizes and picks at 3.35 TB/s is below
// the launch floor).  The design keeps the walk off memory: every load of a
// request (its slots, its length and origin, the comp table, the origin's
// rtt and 1/bw columns) is issued before the first use, the walk and the
// fold run on registers and warp collectives only (redux.sync counts and
// argmax, eight DCs' reductions in flight at once), and the picks are
// stored once, coalesced.
//
//   * route_expand_regs_kernel<S>: lane l holds slots l + 32 j, j < S, in
//     registers (S = 1, 2, 4, 8: K <= 256).
//   * route_expand_smem_kernel: K > 256; each warp stages its slots (bits,
//     sizes, int8 picks) in its own region of shared memory, never in
//     global memory, and lane l touches only slots l + 32 j.
//
// Masks and miss counts per layer live one a lane: lane i holds layer
// i + 32 c's in word c (c < 4, L <= 127).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLayerWords = 4;  // per-layer values one a lane: L + 1 <= 128
constexpr int kLoadLayers = 8;  // comp rows loaded up front, before any use
constexpr int kMaxRegSlots = 8;  // slots a lane in registers: K <= 256
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the value of layer i held one a lane in w (lane i & 31, word i >> 5)
__device__ __forceinline__ unsigned lane_word(const unsigned (&w)[kLayerWords], int i) {
  unsigned v = w[0];
#pragma unroll
  for (int c = 1; c < kLayerWords; ++c)
    if ((i >> 5) == c) v = w[c];
  return __shfl_sync(kFull, v, i & 31);
}

__device__ __forceinline__ void set_lane_word(unsigned (&w)[kLayerWords], int i, unsigned v,
                                              int lane) {
#pragma unroll
  for (int c = 0; c < kLayerWords; ++c)
    if (i == lane + kWarp * c) w[c] = v;
}

// The per-request prologue both instances share: origin, clamped length,
// cluster masks of layers 1..L (lane i holds layer i + 1's in word i >> 5),
// and the origin's rtt / 1/bw entries of lane d's DC, all loaded before use.
struct Request {
  int o, len;
  unsigned allowed[kLayerWords];
  float rtt_o, ibw_o;
};

__device__ __forceinline__ Request load_request(int64_t r, int lane, const int* lens,
                                                const int* origin, const int* comp,
                                                const float* rtt, const float* ibw, int K,
                                                int D, int L) {
  Request q;
  const int len_raw = __ldg(lens + r);
  q.o = __ldg(origin + r);
  int cv[kLoadLayers];
#pragma unroll
  for (int i = 0; i < kLoadLayers; ++i)
    cv[i] = (i < L && lane < D) ? __ldg(comp + (int64_t)(i + 1) * D + lane) : 0;
  q.rtt_o = lane < D ? __ldg(rtt + lane * D + q.o) : 0.f;  // used by the fold only
  q.ibw_o = lane < D ? __ldg(ibw + lane * D + q.o) : 0.f;
  q.len = min(max(len_raw, 0), K);
#pragma unroll
  for (int c = 0; c < kLayerWords; ++c) q.allowed[c] = 0u;
#pragma unroll
  for (int i = 0; i < kLoadLayers; ++i) {
    if (i < L) {  // warp-uniform
      const int co = __shfl_sync(kFull, cv[i], q.o);
      set_lane_word(q.allowed, i,
                    __ballot_sync(kFull, lane < D && lane != q.o && cv[i] == co), lane);
    }
  }
  for (int i = kLoadLayers; i < L; ++i) {  // deep hierarchies only
    const int v = lane < D ? __ldg(comp + (int64_t)(i + 1) * D + lane) : 0;
    const int co = __shfl_sync(kFull, v, q.o);
    set_lane_word(q.allowed, i, __ballot_sync(kFull, lane < D && lane != q.o && v == co),
                  lane);
  }
  return q;
}

// DCs d0 .. d0 + 7 at once: their reductions are independent, so the eight
// are in flight together; lane d0 + i keeps entry i
constexpr int kGroup = 8;

__device__ __forceinline__ void keep_counts(int (&c)[kGroup], int d0, int lane, int& mine) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) c[i] = __reduce_add_sync(kFull, c[i]);
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (lane == d0 + i) mine = c[i];
}

__device__ __forceinline__ void keep_sums(float (&t)[kGroup], int d0, int lane, float& mine) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) t[i] += __shfl_xor_sync(kFull, t[i], o);
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (lane == d0 + i) mine = t[i];
}

// argmax over lanes < D of cover, lowest lane on ties: (gain, best)
__device__ __forceinline__ int2 argmax_dc(int cover, int lane, int D) {
  const int key = __reduce_max_sync(kFull, lane < D ? (cover << 5) | (31 - lane) : -1);
  return make_int2(key >> 5, 31 - (key & 31));
}

// the fold's epilogue: lane d holds DC d's bytes and whether it served
__device__ __forceinline__ void store_request(int64_t r, int lane, const Request& q,
                                              float my_bytes, bool my_served, int used,
                                              const unsigned (&miss)[kLayerWords],
                                              float* bytes_rd, int* layers_used,
                                              int* miss_after, float* straggler, float* wan,
                                              int D, int L) {
  float lat = 0.f;
  float away = 0.f;
  if (lane < D) {
    bytes_rd[r * D + lane] = my_bytes;
    if (lane != q.o) {
      away = my_bytes;
      if (my_served) lat = q.rtt_o + my_bytes * q.ibw_o;
    }
  }
  lat = warp_max(lat);
  away = warp_sum(away);
  int* mrow = miss_after + r * (L + 1);
#pragma unroll
  for (int c = 0; c < kLayerWords; ++c) {
    const int i = lane + kWarp * c;
    if (i <= L) mrow[i] = (int)miss[c];
  }
  if (lane == 0) {
    layers_used[r] = used;
    straggler[r] = lat;
    wan[r] = away;
  }
}

template <int S>
__global__ void route_expand_regs_kernel(const int* __restrict__ bits,     // [R, K]
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
  const unsigned* brow = reinterpret_cast<const unsigned*>(bits) + r * K;
  const float* zrow = sizes + r * K;
  unsigned b[S];
  float z[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = lane + kWarp * j;
    b[j] = k < K ? __ldg(brow + k) : 0u;
    z[j] = k < K ? __ldg(zrow + k) : 0.f;
  }
  const Request q = load_request(r, lane, lens, origin, comp, rtt, ibw, K, D, L);

  // layer 0: local items; a slot past the length holds no bits and no pick
  int s[S];
  int local_miss = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (lane + kWarp * j >= q.len) b[j] = 0u;
    const bool local = (b[j] >> q.o) & 1u;
    s[j] = local ? q.o : -1;
    local_miss += (lane + kWarp * j < q.len) && !local;
  }
  int nmiss = __reduce_add_sync(kFull, local_miss);
  unsigned miss[kLayerWords] = {0u, 0u, 0u, 0u};
  set_lane_word(miss, 0, nmiss, lane);

  int used = 0;
  int layer = 0;
  const int max_it = L * (D + 1);
  for (int it = 0; layer < L && nmiss > 0 && it < max_it; ++it) {
    const unsigned allowed = lane_word(q.allowed, layer);
    if (allowed) used = layer + 1;
    unsigned m[S];
#pragma unroll
    for (int j = 0; j < S; ++j) m[j] = s[j] < 0 ? b[j] & allowed : 0u;
    int cover = 0;
    for (int d0 = 0; d0 < D; d0 += kGroup) {
      if (!((allowed >> d0) & 0xffu)) continue;  // warp-uniform
      int c[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        c[i] = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) c[i] += (m[j] >> (d0 + i)) & 1u;
      }
      keep_counts(c, d0, lane, cover);
    }
    const int2 gb = argmax_dc(cover, lane, D);
    if (gb.x > 0) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if ((m[j] >> gb.y) & 1u) s[j] = gb.y;
      nmiss -= gb.x;
    } else {
      ++layer;
      set_lane_word(miss, layer, nmiss, lane);
    }
  }

  // Eq. 1 fold over the registers; DCs that served nothing are skipped
  unsigned served_local = 0u;
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (s[j] >= 0) served_local |= 1u << s[j];
  const unsigned served_dcs = __reduce_or_sync(kFull, served_local);
  float my_bytes = 0.f;
  for (int d0 = 0; d0 < D; d0 += kGroup) {
    if (!((served_dcs >> d0) & 0xffu)) continue;  // warp-uniform
    float t[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      t[i] = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (s[j] == d0 + i) t[i] += z[j];
    }
    keep_sums(t, d0, lane, my_bytes);
  }
  int* srow = served + r * K;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = lane + kWarp * j;
    if (k < K) srow[k] = s[j];
  }
  store_request(r, lane, q, my_bytes, (served_dcs >> lane) & 1u, used, miss, bytes_rd,
                layers_used, miss_after, straggler, wan, D, L);
}

// bytes of one warp's region: bits and sizes as 4-byte words, picks as int8
__host__ __device__ __forceinline__ size_t smem_region(int K) {
  const size_t words = ((size_t)K + 3) & ~(size_t)3;
  return words * 8 + words;
}

__global__ void route_expand_smem_kernel(const int* __restrict__ bits,
                                         const float* __restrict__ sizes,
                                         const int* __restrict__ lens,
                                         const int* __restrict__ origin,
                                         const int* __restrict__ comp,
                                         const float* __restrict__ rtt,
                                         const float* __restrict__ ibw,
                                         int* __restrict__ served, float* __restrict__ bytes_rd,
                                         int* __restrict__ layers_used,
                                         int* __restrict__ miss_after,
                                         float* __restrict__ straggler,
                                         float* __restrict__ wan, int R, int K, int D, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  const int lane = threadIdx.x % kWarp;
  if (r >= R) return;  // warp-uniform
  const size_t words = ((size_t)K + 3) & ~(size_t)3;
  unsigned* sb = reinterpret_cast<unsigned*>(smem + warp * smem_region(K));
  float* sz = reinterpret_cast<float*>(sb + words);
  signed char* ss = reinterpret_cast<signed char*>(sz + words);
  const unsigned* brow = reinterpret_cast<const unsigned*>(bits) + r * K;
  const float* zrow = sizes + r * K;
  const Request q = load_request(r, lane, lens, origin, comp, rtt, ibw, K, D, L);

  // stage the slots; lane l reads back only the slots l + 32 j it wrote
  int local_miss = 0;
#pragma unroll 4
  for (int k = lane; k < q.len; k += kWarp) {
    const unsigned bk = __ldg(brow + k);
    sb[k] = bk;
    sz[k] = __ldg(zrow + k);
    const bool local = (bk >> q.o) & 1u;
    ss[k] = local ? (signed char)q.o : (signed char)-1;
    local_miss += !local;
  }
  int nmiss = __reduce_add_sync(kFull, local_miss);
  unsigned miss[kLayerWords] = {0u, 0u, 0u, 0u};
  set_lane_word(miss, 0, nmiss, lane);

  int used = 0;
  int layer = 0;
  const int max_it = L * (D + 1);
  for (int it = 0; layer < L && nmiss > 0 && it < max_it; ++it) {
    const unsigned allowed = lane_word(q.allowed, layer);
    if (allowed) used = layer + 1;
    int cover = 0;
    for (int d0 = 0; d0 < D; d0 += kGroup) {
      if (!((allowed >> d0) & 0xffu)) continue;  // warp-uniform
      int c[kGroup] = {};
      for (int k = lane; k < q.len; k += kWarp) {
        const unsigned m = ss[k] < 0 ? sb[k] & allowed : 0u;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) c[i] += (m >> (d0 + i)) & 1u;
      }
      keep_counts(c, d0, lane, cover);
    }
    const int2 gb = argmax_dc(cover, lane, D);
    if (gb.x > 0) {
      for (int k = lane; k < q.len; k += kWarp)
        if (ss[k] < 0 && ((sb[k] & allowed) >> gb.y) & 1u) ss[k] = (signed char)gb.y;
      nmiss -= gb.x;
    } else {
      ++layer;
      set_lane_word(miss, layer, nmiss, lane);
    }
  }

  unsigned served_local = 0u;
  for (int k = lane; k < q.len; k += kWarp)
    if (ss[k] >= 0) served_local |= 1u << ss[k];
  const unsigned served_dcs = __reduce_or_sync(kFull, served_local);
  float my_bytes = 0.f;
  for (int d0 = 0; d0 < D; d0 += kGroup) {
    if (!((served_dcs >> d0) & 0xffu)) continue;  // warp-uniform
    float t[kGroup] = {};
    for (int k = lane; k < q.len; k += kWarp) {
      const int sk = ss[k];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (sk == d0 + i) t[i] += sz[k];
    }
    keep_sums(t, d0, lane, my_bytes);
  }
  int* srow = served + r * K;
  for (int k = lane; k < K; k += kWarp) srow[k] = k < q.len ? (int)ss[k] : -1;
  store_request(r, lane, q, my_bytes, (served_dcs >> lane) & 1u, used, miss, bytes_rd,
                layers_used, miss_after, straggler, wan, D, L);
}

template <int S>
void launch_regs(unsigned grid, int threads, cudaStream_t st, const int* bits,
                 const float* sizes, const int* lens, const int* origin, const int* comp,
                 const float* rtt, const float* ibw, int* served, float* bytes_rd,
                 int* layers_used, int* miss_after, float* straggler, float* wan, int R, int K,
                 int D, int L) {
  route_expand_regs_kernel<S><<<grid, threads, 0, st>>>(bits, sizes, lens, origin, comp, rtt,
                                                        ibw, served, bytes_rd, layers_used,
                                                        miss_after, straggler, wan, R, K, D, L);
}

}  // namespace

// Slots a lane holds in registers for K item slots (1, 2, 4 or 8), or 0
// when the warp stages them in shared memory; -1 when no instance takes K.
extern "C" int route_expand_slots(int K) {
  for (int s = 1; s <= kMaxRegSlots; s <<= 1)
    if (K <= kWarp * s) return s;
  return smem_region(K) <= (size_t)kSmemMax ? 0 : -1;
}

extern "C" int route_expand_launch(const int* bits, const float* sizes, const int* lens,
                                   const int* origin, const int* comp, const float* rtt,
                                   const float* ibw, int* served, float* bytes_rd,
                                   int* layers_used, int* miss_after, float* straggler,
                                   float* wan, int R, int K, int D, int L, int block_r,
                                   void* stream) {
  if (R == 0) return (int)cudaSuccess;
  const int slots = route_expand_slots(K);
  if (D < 1 || D > kWarp - 1 || L < 0 || L + 1 > kWarp * kLayerWords || block_r < 1 ||
      slots < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (slots == 0) {
    static bool attr_set[kMaxDevices] = {};  // raise the shared memory cap once a device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!attr_set[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          route_expand_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e != cudaSuccess) return (int)e;
      attr_set[dev] = true;
    }
    const size_t fit = (size_t)kSmemMax / smem_region(K);
    const int warps = fit < (size_t)block_r ? (int)fit : block_r;
    const unsigned grid = (unsigned)((R + warps - 1) / warps);
    route_expand_smem_kernel<<<grid, warps * kWarp, warps * smem_region(K), st>>>(
        bits, sizes, lens, origin, comp, rtt, ibw, served, bytes_rd, layers_used, miss_after,
        straggler, wan, R, K, D, L);
    return (int)cudaGetLastError();
  }
  const unsigned grid = (unsigned)((R + block_r - 1) / block_r);
  const int threads = block_r * kWarp;
#define RE_ARGS                                                                          \
  grid, threads, st, bits, sizes, lens, origin, comp, rtt, ibw, served, bytes_rd,        \
      layers_used, miss_after, straggler, wan, R, K, D, L
  switch (slots) {
    case 1: launch_regs<1>(RE_ARGS); break;
    case 2: launch_regs<2>(RE_ARGS); break;
    case 4: launch_regs<4>(RE_ARGS); break;
    default: launch_regs<8>(RE_ARGS); break;
  }
#undef RE_ARGS
  return (int)cudaGetLastError();
}
