// Fused stepwise layered routing expansion (paper §VI) + each read's exact
// bytes per DC, the fold of Eq. 1's S_d.
//
// Replaces the Pallas kernel _expand_kernel of repro/kernels/route_expand.py.
// The TPU version walks a block of requests in lockstep and packs per-DC
// coverage into 10-bit fields of int32 lane words.  Requests are
// independent and extra greedy passes are idempotent, so here each request
// runs its own greedy walk, with no lockstep:
//
//   * serve locally where the origin's bit is set;
//   * per layer, count for every cluster DC the still-missing items holding
//     its bit, lane d ending with DC d's count (D <= 31);
//   * the argmax goes to the lowest DC id on ties; its hits are assigned; a
//     pass with no progress records miss_after[l + 1] and moves up a layer;
//     the walk is bounded by L * (D + 1) passes;
//   * then the fold: each read's bytes per DC as int64 units (an item's
//     f32 bytes times 2^shift, a whole number at the tables' shift), the
//     DCs that served it as a bitmask, and its unresolved items.  An int64
//     sum is exact in any order, so the host takes bytes = units * 2^-shift
//     as the f64 fold it would have made itself, bit for bit, and computes
//     the latencies and WAN bytes from it.
//
// Bound on an H100: a request's walk is a chain of up to L * (D + 1)
// dependent passes, so a call takes the latency of one walk, not its bytes
// (13 bytes a slot of ids, table entries and picks at 3.35 TB/s is below
// the launch floor).  The design keeps the walk off per-slot state: every load
// of a request's prologue (its offsets and origin, the comp table) is
// issued before the first use, counts and argmax are warp collectives
// (redux.sync, eight DCs' reductions in flight at once), and the picks are
// stored once, coalesced.  The kernel is instantiated for 1 to 4 groups of
// eight DCs, so a thread keeps counts and int64 sums for the store's DCs
// alone (a 5-DC store: 8 of each, not 32), and a pass keeps several
// slots' gathers in flight a thread (kInFlight).
//
// route_expand_ragged_kernel takes the flat item stream with request
// offsets, no [R, K] tile and no bound on a request's length; a request
// past a warp's share gets a block of its own, and no slot is staged.  The
// stream carries item ids alone: a slot's bitmask and bytes are the table
// entries of its id, in tables keyed by item id that the store keeps on the
// card (a caller with rows in hand passes them as the tables over ids 0 ..
// N - 1).
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

// The per-request prologue: origin, length (0 if negative) and the
// cluster masks of layers 1..L (lane i holds layer i + 1's in word i >> 5),
// all loaded before use.
struct Request {
  int o, len;
  unsigned allowed[kLayerWords];
};

__device__ __forceinline__ Request load_request(int64_t r, int lane, int len_raw,
                                                const int* origin, const int* comp, int D,
                                                int L) {
  Request q;
  q.o = __ldg(origin + r);
  int cv[kLoadLayers];
#pragma unroll
  for (int i = 0; i < kLoadLayers; ++i)
    cv[i] = (i < L && lane < D) ? __ldg(comp + (int64_t)(i + 1) * D + lane) : 0;
  q.len = max(len_raw, 0);
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

__device__ __forceinline__ void keep_sums(long long (&t)[kGroup], int d0, int lane,
                                          long long& mine) {
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

// A request's outputs: lane d holds DC d's units; served_dcs and the
// unresolved count are the warp's
struct Outputs {
  signed char* served;   // [N] the serving DC a slot (-1 unresolved)
  long long* units;      // [R, D] bytes per DC in units of 2^-shift
  int* layers_used;      // [R]
  int* miss_after;       // [R, L + 1]
  int* served_dcs;       // [R] bit d: DC d served an item
  int* n_miss;           // [R] unresolved items
};

__device__ __forceinline__ void store_request(int64_t r, int lane, long long my_units,
                                              unsigned served_dcs, int n_miss, int used,
                                              const unsigned (&miss)[kLayerWords],
                                              const Outputs& out, int D, int L) {
  if (lane < D) out.units[r * D + lane] = my_units;
  int* mrow = out.miss_after + r * (L + 1);
#pragma unroll
  for (int c = 0; c < kLayerWords; ++c) {
    const int i = lane + kWarp * c;
    if (i <= L) mrow[i] = (int)miss[c];
  }
  if (lane == 0) {
    out.layers_used[r] = used;
    out.served_dcs[r] = (int)served_dcs;
    out.n_miss[r] = n_miss;
  }
}

// ------------------------------------------------------------------ ragged
// The flat item stream as it is: request r's slots are [offsets[r],
// offsets[r + 1]).  A block of kRaggedThreads either walks one request with
// all its warps (a request longer than a warp's share, listed first in
// `order`) or hands each warp a request of its own.  Neither stages a slot:
// an item is still missing exactly when its bitmask shares no bit with the
// DCs taken so far (the origin, then each greedy pick; a picked DC covers
// every missing item holding it, so it is never picked again), so a pass
// reads the bits and keeps no per-slot state, and a request of any length
// is read where it lies.  The picks come from one last pass: an item goes
// to the first DC taken, in order, that holds it.
constexpr int kRaggedThreads = 512;
constexpr int kRaggedWarps = kRaggedThreads / kWarp;
// Slots a thread reads at once in a greedy pass, their id and bitmask loads
// issued before any is used: a warp's read holds at most 8 slots a lane, so
// two; a block's read up to thousands a thread, so eight, or a pass over a
// long read waits on few gathers at a time
template <bool kCta>
constexpr int kInFlight = kCta ? 8 : 2;

// A request's slots: slot k holds item id ids[k], whose bitmask and bytes
// are bits[ids[k]] and sizes[ids[k]] (the tables keyed by item id).
struct Slots {
  const int* ids;  // the request's first slot
  const unsigned* bits;
  const float* sizes;

  __device__ __forceinline__ int item(int k) const { return __ldg(ids + k); }
  __device__ __forceinline__ unsigned bit(int i) const { return __ldg(bits + i); }
  // the bytes in units of 2^-shift: exact where the tables' shift makes
  // them whole (a power-of-two scale of a normal float is exact)
  __device__ __forceinline__ long long units(int i, int shift) const {
    return __float2ll_rz(ldexpf(__ldg(sizes + i), shift));
  }
};

// Per-DC counts of the missing slots (no bit of `chosen`) holding a bit of
// `allowed`; lane d returns DC d's count over the group that walks the
// request (a warp, or the whole block when kCta).  With `nmiss`, also the
// number of missing slots.  `red` is the block's scratch for this pass.
// kG groups of eight DCs hold the store's D.
template <bool kCta, int kG>
__device__ __forceinline__ int ragged_cover(const Slots& src, int len, int rank,
                                            unsigned chosen, unsigned allowed, int lane,
                                            int warp, int* red, int* nmiss) {
  constexpr int stride = kCta ? kRaggedThreads : kWarp;
  int c[kGroup * kG];
#pragma unroll
  for (int i = 0; i < kGroup * kG; ++i) c[i] = 0;
  constexpr int in_flight = kInFlight<kCta>;
  int open = 0;
  for (int k0 = rank; k0 < len; k0 += in_flight * stride) {
    int id[in_flight];
#pragma unroll
    for (int j = 0; j < in_flight; ++j)
      id[j] = k0 + j * stride < len ? src.item(k0 + j * stride) : -1;
    unsigned bs[in_flight];  // past the read: all bits, so never missing
#pragma unroll
    for (int j = 0; j < in_flight; ++j) bs[j] = id[j] >= 0 ? src.bit(id[j]) : ~0u;
#pragma unroll
    for (int j = 0; j < in_flight; ++j) {
      const bool missing = (bs[j] & chosen) == 0u;
      open += missing;
      const unsigned m = missing ? bs[j] & allowed : 0u;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if ((allowed >> (kGroup * g)) & 0xffu) {  // warp-uniform
#pragma unroll
          for (int i = 0; i < kGroup; ++i) c[kGroup * g + i] += (m >> (kGroup * g + i)) & 1u;
        }
      }
    }
  }
  int cover = 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if ((allowed >> (kGroup * g)) & 0xffu) {
      int cg[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) cg[i] = c[kGroup * g + i];
      keep_counts(cg, kGroup * g, lane, cover);
    }
  }
  if (nmiss) open = __reduce_add_sync(kFull, open);
  if (kCta) {
    // lane 31 is no DC (D <= 31): it carries the warp's missing count
    red[warp * kWarp + lane] = (lane == kWarp - 1 && nmiss) ? open : cover;
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kRaggedWarps; ++w) sum += red[w * kWarp + lane];
    if (nmiss) *nmiss = __shfl_sync(kFull, sum, kWarp - 1);
    cover = lane < kWarp - 1 ? sum : 0;
  } else if (nmiss) {
    *nmiss = open;
  }
  return cover;
}

// One request's walk and fold by a warp, or by the whole block when kCta
template <bool kCta, int kG>
__device__ __forceinline__ void ragged_walk(
    int r, int lane, int warp, const int* __restrict__ ids, const unsigned* __restrict__ bits,
    const float* __restrict__ sizes, const int* __restrict__ offsets,
    const int* __restrict__ origin, const int* __restrict__ comp, int shift, const Outputs& out,
    int D, int L, int (*red)[kRaggedThreads], long long* sums, signed char* picks) {
  constexpr int stride = kCta ? kRaggedThreads : kWarp;
  const int rank = kCta ? (int)threadIdx.x : lane;
  const int beg = __ldg(offsets + r);
  const Request q = load_request(r, lane, __ldg(offsets + r + 1) - beg, origin, comp, D, L);
  const Slots src{ids + beg, bits, sizes};
  unsigned chosen = 1u << q.o;
  int buf = 0;
  int nmiss = 0;
  int cover = ragged_cover<kCta, kG>(src, q.len, rank, chosen, lane_word(q.allowed, 0), lane,
                                     warp, red[buf], &nmiss);
  const int local_miss = nmiss;
  unsigned miss[kLayerWords] = {0u, 0u, 0u, 0u};
  set_lane_word(miss, 0, nmiss, lane);

  int used = 0;
  int layer = 0;
  int n_picks = 0;
  const int max_it = L * (D + 1);
  for (int it = 0; layer < L && nmiss > 0 && it < max_it; ++it) {
    if (lane_word(q.allowed, layer)) used = layer + 1;
    const int2 gb = argmax_dc(cover, lane, D);
    if (gb.x > 0) {
      chosen |= 1u << gb.y;
      if (lane == 0) picks[n_picks] = (signed char)gb.y;
      ++n_picks;
      nmiss -= gb.x;
    } else {
      ++layer;
      set_lane_word(miss, layer, nmiss, lane);
    }
    if (layer < L && nmiss > 0 && it + 1 < max_it) {  // the next pass's counts
      buf ^= 1;
      cover = ragged_cover<kCta, kG>(src, q.len, rank, chosen, lane_word(q.allowed, layer),
                                     lane, warp, red[buf], nullptr);
    }
  }
  __syncwarp();

  // picks and the byte fold in one pass; DCs that served nothing are
  // skipped.  Every DC picked covered a missing item when picked, which no
  // DC taken before it holds, so it serves that item: the DCs that serve
  // are the picks and the origin where it holds an item.
  const unsigned served_dcs =
      (chosen & ~(1u << q.o)) | (q.len > local_miss ? 1u << q.o : 0u);
  long long t[kGroup * kG];
#pragma unroll
  for (int i = 0; i < kGroup * kG; ++i) t[i] = 0;
#pragma unroll 4
  for (int k = rank; k < q.len; k += stride) {
    const int i = src.item(k);
    const unsigned b = src.bit(i);
    const long long z = src.units(i, shift);
    int p = -1;
    if ((b >> q.o) & 1u) {
      p = q.o;
    } else {
      for (int j = 0; j < n_picks; ++j) {
        const int d = picks[j];
        if ((b >> d) & 1u) {
          p = d;
          break;
        }
      }
    }
    out.served[beg + k] = (signed char)p;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if ((served_dcs >> (kGroup * g)) & 0xffu) {  // warp-uniform
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (p == kGroup * g + i) t[kGroup * g + i] += z;
      }
    }
  }
  long long my_units = 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if ((served_dcs >> (kGroup * g)) & 0xffu) {
      long long tg[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) tg[i] = t[kGroup * g + i];
      keep_sums(tg, kGroup * g, lane, my_units);
    }
  }
  if (kCta) {
    sums[warp * kWarp + lane] = my_units;
    __syncthreads();
    if (warp != 0) return;
    my_units = 0;
#pragma unroll
    for (int w = 0; w < kRaggedWarps; ++w) my_units += sums[w * kWarp + lane];
  }
  store_request(r, lane, my_units, served_dcs, nmiss, used, miss, out, D, L);
}

template <int kG>
__global__ void __launch_bounds__(kRaggedThreads) route_expand_ragged_kernel(
    const int* __restrict__ ids,          // [N] item ids, the flat item stream
    const unsigned* __restrict__ bits,    // [I] replica bitmask an item id
    const float* __restrict__ sizes,      // [I] item bytes an item id
    const int* __restrict__ offsets,  // [R + 1] request r's slots: [offsets[r], offsets[r + 1])
    const int* __restrict__ origin,   // [R]
    const int* __restrict__ order,    // [R] the n_long requests a block walks first
    int n_long, const int* __restrict__ comp, int shift, Outputs out, int R, int D, int L) {
  __shared__ int red[2][kRaggedThreads];
  __shared__ long long sums[kRaggedThreads];
  __shared__ signed char picks[kRaggedWarps][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if ((int)blockIdx.x < n_long) {  // block-uniform
    ragged_walk<true, kG>(__ldg(order + blockIdx.x), lane, warp, ids, bits, sizes, offsets,
                          origin, comp, shift, out, D, L, red, sums, picks[warp]);
    return;
  }
  const int64_t w = (int64_t)(blockIdx.x - n_long) * kRaggedWarps + warp + n_long;
  if (w >= R) return;  // warp-uniform
  ragged_walk<false, kG>(__ldg(order + w), lane, warp, ids, bits, sizes, offsets, origin, comp,
                         shift, out, D, L, red, sums, picks[warp]);
}

}  // namespace

// Route a ragged batch: n_long blocks walk order[0 .. n_long) one request
// each, then each warp of the rest walks one of order[n_long .. R).  Slot k
// holds item id ids[k], whose bitmask and bytes are table_bits[ids[k]] and
// table_sizes[ids[k]]; a read's bytes per DC are summed as
// table_sizes * 2^shift in int64 (exact where the tables' shift makes every
// entry whole).
extern "C" int route_expand_ragged_ids_launch(const int* ids, const int* table_bits,
                                              const float* table_sizes, const int* offsets,
                                              const int* origin, const int* order, int n_long,
                                              const int* comp, int shift, signed char* served,
                                              long long* units, int* layers_used,
                                              int* miss_after, int* served_dcs, int* n_miss,
                                              int R, int D, int L, void* stream) {
  if (R == 0) return (int)cudaSuccess;
  if (D < 1 || D > kWarp - 1 || L < 0 || L + 1 > kWarp * kLayerWords || n_long < 0 ||
      n_long > R)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(n_long + (R - n_long + kRaggedWarps - 1) / kRaggedWarps);
  const Outputs out{served, units, layers_used, miss_after, served_dcs, n_miss};
  const unsigned* bits = reinterpret_cast<const unsigned*>(table_bits);
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((D + kGroup - 1) / kGroup) {
    case 1:
      route_expand_ragged_kernel<1><<<grid, kRaggedThreads, 0, s>>>(
          ids, bits, table_sizes, offsets, origin, order, n_long, comp, shift, out, R, D, L);
      break;
    case 2:
      route_expand_ragged_kernel<2><<<grid, kRaggedThreads, 0, s>>>(
          ids, bits, table_sizes, offsets, origin, order, n_long, comp, shift, out, R, D, L);
      break;
    case 3:
      route_expand_ragged_kernel<3><<<grid, kRaggedThreads, 0, s>>>(
          ids, bits, table_sizes, offsets, origin, order, n_long, comp, shift, out, R, D, L);
      break;
    default:
      route_expand_ragged_kernel<4><<<grid, kRaggedThreads, 0, s>>>(
          ids, bits, table_sizes, offsets, origin, order, n_long, comp, shift, out, R, D, L);
  }
  return (int)cudaGetLastError();
}
