// Directed-Heat-Diffusion step over symmetric ELL adjacency (paper Eqs. 7-8):
// for B heat fields that share one column structure (dhd_count_batch /
// dhd_flow_batch), and for one heat field (dhd_count_single /
// dhd_flow_single, at the end of this file).
//
// Replaces the Pallas kernels _count_kernel_batch / _flow_kernel_batch of
// repro/kernels/dhd_spmv.py.  The TPU version keeps each field's whole heat
// vector resident in VMEM as an (n, 1) block and walks row blocks in grid
// order.  Here the neighbour heat gathers go through L1 and L2 (26,000 rows
// x 5 fields of f32 heat is 0.5 MB, far below the 50 MB L2).
//
// What bounds a pass on an H100.  By bytes, HBM: a pass reads cols and vals
// (n*kmax*8 bytes with shared vals, plus B*n*kmax*4 with per-field vals)
// once, at 3.35 TB/s; at maintain's 5 x 26,000 x 71 the count pass moves
// 15.8 MB (4.7 us), the flow pass 16.8 MB (5.0 us).  In fact, the gathers:
// every live slot reads h[b, c] of each field, and the flow pass nout[b, c]
// where heat flows in, a 32-byte sector for 4 useful bytes at a column that
// shares its line with no other lane's.  L1 serves about one such line a
// clock, so an SM gathers about one value a clock however the lanes are
// arranged: 5.0 M gathers a count pass and 7.6 M a flow pass at maintain's
// shape, 19 us and 29 us on 132 SMs at 1.98 GHz.  With one field, each
// pass also reads back from L2 most of the field's sectors on every SM (a
// third of the lane graph's edges join random communities), about as many
// bytes again as cols and vals.
//
// Both passes therefore share one design, aimed at the gathers.  Block x
// owns a contiguous range of rows (one block of up to 32 warps per SM, n /
// 132 rows each, and no block without rows), so an SM's gathers fall mostly
// in its rows' neighbourhood (the lane graph's vertex ids are grouped by
// community: median |c - u| 623 of 26,000) and hit its L1; with the L1
// carved down to make room for shared memory it is as slow as a grid-order
// design.  blockIdx.y takes groups of FB fields, FB the largest divisor of B
// up to 5.  A warp takes one row at a time for all FB fields: the row's cols
// (and shared vals, or FB rows of per-field vals) are loaded once, every
// slot's load issued before any gather, then every field's gathers at once,
// so a row is three dependent levels (slots -> h[c] -> nout[c]) instead of
// a chain per slot and field.  The row's own h, nout and q load at the top
// of the row, off the chain.  The first designs gave a warp one (field,
// row) pair: 130,000 warps at maintain's shape, each reloading its row's
// cols and vals for every field and walking 71 slots as chains of dependent
// loads, at 8x (count) and 13x (flow) the bound.  The [B, n] layout still
// puts the fields of one column in FB different lines; interleaving them
// ([n, B] heat) would cut the gathers' lines FB-fold, and is the next step
// for both passes (it changes the layouts the callers pass).
//
// Two launches per step: the flow pass reads |N_j^out| of neighbour rows,
// which needs every row's count first (a grid-wide sync).  The ragged edge
// is masked; ELL padding slots carry weight 0 and stay inactive, so no pad
// rows are needed.
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

// Pass 1: |N_u^out| = active neighbours with strictly lower heat.  Block
// (x, y) owns rows [x * per_block, (x + 1) * per_block) for the FB fields
// from y * FB on; each warp takes one row at a time for all FB fields,
// kCountSlots slots a lane per sweep (one sweep when ONE_SWEEP, kmax <= 96).
// A slot gathers h[b, c] only where its weight is positive, so pad slots and
// edges a field switched off cost no gather.  No inflow terms: 52 registers
// at FB = 5 with shared vals, under the 64 a 1,024-thread block allows (no
// spills in any instance).  Lane f writes field f's count; the sums are
// integers, so the order of the reduction (redux.sync) does not matter.
constexpr int kMaxFields = 5;
constexpr int kCountSlots = 3;
constexpr int kCountThreads = 1024;

template <int FB, bool PER_FIELD, bool ONE_SWEEP>
__global__ void __launch_bounds__(kCountThreads)
    dhd_count_kernel(const float* __restrict__ heat,   // [B, n]
                     const int* __restrict__ cols,     // [n, kmax]
                     const float* __restrict__ vals,   // [n, kmax] or [B, n, kmax]
                     float* __restrict__ nout,         // [B, n]
                     int n, int kmax, int per_block) {
  constexpr int FW = PER_FIELD ? FB : 1;  // weight rows a slot carries
  const int end = min(n, (int)(blockIdx.x + 1) * per_block);
  const int warps = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t field0 = (int64_t)blockIdx.y * FB * n;
  heat += field0;
  nout += field0;
  if (PER_FIELD) vals += field0 * kmax;
#define FIELD(f) ((int64_t)(f) * n)

  for (int u = blockIdx.x * per_block + threadIdx.x / kWarp; u < end; u += warps) {
    float hu[FB];
    int cnt[FB];
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      hu[f] = __ldg(heat + FIELD(f) + u);
      cnt[f] = 0;
    }
    const int64_t row = (int64_t)u * kmax;
    for (int j0 = 0; j0 < (ONE_SWEEP ? 1 : kmax); j0 += kWarp * kCountSlots) {
      int c[kCountSlots];
      float w[FW][kCountSlots];
#pragma unroll
      for (int s = 0; s < kCountSlots; ++s) {
        const int j = j0 + s * kWarp + lane;
        const bool live = j < kmax;
        c[s] = live ? __ldg(cols + row + j) : 0;
#pragma unroll
        for (int f = 0; f < FW; ++f)
          w[f][s] = live ? __ldg(vals + FIELD(f) * kmax + row + j) : 0.f;
      }
      // an inactive slot reads its own row's heat: never strictly lower
      float hn[FB][kCountSlots];
#pragma unroll
      for (int f = 0; f < FB; ++f)
#pragma unroll
        for (int s = 0; s < kCountSlots; ++s)
          hn[f][s] = w[PER_FIELD ? f : 0][s] > 0.f ? __ldg(heat + FIELD(f) + c[s]) : hu[f];
#pragma unroll
      for (int f = 0; f < FB; ++f)
#pragma unroll
        for (int s = 0; s < kCountSlots; ++s) cnt[f] += hu[f] > hn[f][s] ? 1 : 0;
    }
    int mine = 0;
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const int total = (int)__reduce_add_sync(kFull, (unsigned)cnt[f]);
      if (lane == f) mine = total;
    }
    if (lane < FB) nout[FIELD(lane) + u] = (float)mine;
  }
#undef FIELD
}

// Pass 2: inflow - outflow with alpha / max(n_out, 1) on both ends, then the
// epilogue (1 - gamma) * (h + delta) + beta * q.  Block (x, y) owns a
// contiguous range of rows, one x per SM, for the FB fields from y * FB on
// (clamped to B); each of its warps takes one row at a time for all FB
// fields, kFlowSlots slots a lane per sweep of the slot loop (one sweep when
// ONE_SWEEP, kmax <= 96: the loop's bookkeeping cost 4% at maintain's shape
// on an H100).  PER_FIELD: vals is [B, n, kmax] (one weight row per field)
// rather than shared.
constexpr int kFlowSlots = 3;  // kmax <= 96 in one sweep (the serving lane's is 71)
constexpr int kFlowThreads = 1024;

template <int FB, bool PER_FIELD, bool ONE_SWEEP>
__global__ void __launch_bounds__(kFlowThreads)
    dhd_flow_kernel(const float* __restrict__ heat,   // [B, n]
                    const float* __restrict__ nout,   // [B, n]
                    const int* __restrict__ cols,     // [n, kmax]
                    const float* __restrict__ vals,   // [n, kmax] or [B, n, kmax]
                    const float* __restrict__ q,      // [B, n]
                    float* __restrict__ out,          // [B, n]
                    int B, int n, int kmax, float alpha, float one_minus_gamma,
                    float beta) {
  constexpr int FW = PER_FIELD ? FB : 1;  // weight rows a slot carries
  const int per_block = (n + gridDim.x - 1) / gridDim.x;
  const int end = min(n, (int)(blockIdx.x + 1) * per_block);
  const int warps = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // this block's fields: b0 .. b0 + FB - 1 (FB divides B), addressed by
  // compile-time offsets from field b0, which keeps registers low
  const int b0 = blockIdx.y * FB;
  const int64_t field0 = (int64_t)b0 * n;
  heat += field0;
  nout += field0;
  q += field0;
  out += field0;
  if (PER_FIELD) vals += field0 * kmax;
#define FIELD(f) ((int64_t)(f) * n)

  for (int u = blockIdx.x * per_block + threadIdx.x / kWarp; u < end; u += warps) {
    // the row's own |N^out| and q (lane f writes field f) load first, so no
    // load waits at the end of the row's chain
    float hu[FB], nu[FB], acc[FB];
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      nu[f] = nout[FIELD(f) + u];
      acc[f] = 0.f;
    }
    const float qu = lane < FB ? q[FIELD(lane) + u] : 0.f;
    for (int j0 = 0; j0 < (ONE_SWEEP ? 1 : kmax); j0 += kWarp * kFlowSlots) {
      // the row's slots first (pad slots: weight 0, column u), then every
      // field's gathers, then |N^out| only where heat flows in
      int c[kFlowSlots];
      float w[FW][kFlowSlots];
#pragma unroll
      for (int s = 0; s < kFlowSlots; ++s) {
        const int j = j0 + s * kWarp + lane;
        const bool live = j < kmax;
        c[s] = live ? __ldg(cols + (int64_t)u * kmax + j) : u;
#pragma unroll
        for (int f = 0; f < FW; ++f)
          w[f][s] = live ? __ldg(vals + FIELD(f) * kmax + (int64_t)u * kmax + j) : 0.f;
      }
      float hn[FB][kFlowSlots], nn[FB][kFlowSlots];
#pragma unroll
      for (int f = 0; f < FB; ++f) {
        hu[f] = heat[FIELD(f) + u];
#pragma unroll
        for (int s = 0; s < kFlowSlots; ++s) hn[f][s] = __ldg(heat + FIELD(f) + c[s]);
      }
#pragma unroll
      for (int f = 0; f < FB; ++f)
#pragma unroll
        for (int s = 0; s < kFlowSlots; ++s)
          nn[f][s] = w[PER_FIELD ? f : 0][s] > 0.f && hn[f][s] > hu[f]
                         ? __ldg(nout + FIELD(f) + c[s])
                         : 1.f;
#pragma unroll
      for (int f = 0; f < FB; ++f) {
        const float a_u = alpha / fmaxf(nu[f], 1.f);
#pragma unroll
        for (int s = 0; s < kFlowSlots; ++s) {
          const float v = w[PER_FIELD ? f : 0][s];
          if (v > 0.f) {
            if (hu[f] > hn[f][s]) {
              acc[f] -= a_u * v * (hu[f] - hn[f][s]);
            } else if (hn[f][s] > hu[f]) {
              acc[f] += alpha / fmaxf(nn[f][s], 1.f) * v * (hn[f][s] - hu[f]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const float delta = warp_sum(acc[f]);
      if (lane == f)
        out[FIELD(f) + u] = one_minus_gamma * (hu[f] + delta) + beta * qu;
    }
  }
#undef FIELD
}

// ---------------------------------------------------------------- one field
// Replaces the Pallas kernels _count_kernel / _flow_kernel of
// repro/kernels/dhd_spmv.py, the step that warm DHD (streaming/delta_dhd.py)
// sweeps to its steady state over one heat field.  Its ELL has
// kmax = round8(max degree + 8) slots a row: 80 on the 26,000-vertex serving
// lane, about half of them pad slots.  Bound on an H100: by bytes, HBM, as
// for the batched pair (cols + vals, n * kmax * 8 bytes, read once a pass);
// in fact, as there, the gathers, and with one field the sectors of heat
// and nout that every SM reads back from L2.
//
// The count pass gives half a warp (kRowLanes lanes) to a row: each lane
// walks kmax / 16 slots and the row sum is a 4-step xor shuffle inside the
// half.  A warp's two halves may hold a live and a dead row at the ragged
// edge, so dead rows skip their loads but still take part in the shuffles.
//
// The flow pass gives a team of L lanes to a row, each lane kSingleSlots
// slots a sweep, and keeps the batched passes' locality: block x owns a
// contiguous range of rows, one block per SM.  A lane loads all its slots'
// cols and vals first (three 16-byte loads each when kmax % 4 == 0 and both
// arrays start 16-byte aligned, as StreamingHeat's round8 widths do; twelve
// scalar loads otherwise), then all its heat[c] gathers, then nout[c] only
// where heat flows in: three dependent levels a row, where the first design
// (half a warp a row, kmax / 16 slots a lane in a loop behind branches) had
// up to five chains of four.  Its time follows the number of such chains a
// team walks in series, so L is the smallest team whose sweep of L * 12
// slots holds the row: 8 lanes up to kmax 96 (the lane's 80: 20 chunks of 4
// over 8 lanes, 128 rows in flight a block, a block's ~206 rows in two
// passes), 16 up to 192, 32 beyond (kmax > 384 loops).  More lanes a row
// leave fewer rows in flight, so more passes; more slots a lane would not
// fit the 64 registers of a 1,024-thread block (each slot holds 4: c, w,
// heat, nout).  The row's own heat, nout and q load at the top of the row.
constexpr int kRowLanes = 16;
constexpr int kSingleThreads = 256;
constexpr int kSingleSlots = 12;  // three 16-byte chunks
constexpr int kSingleFlowThreads = 1024;

// sum over the L lanes of a team (L a power of two, teams aligned in the warp)
template <int L, typename T>
__device__ __forceinline__ T team_sum(T v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void dhd_count_single_kernel(const float* __restrict__ heat,  // [n]
                                        const int* __restrict__ cols,    // [n, kmax]
                                        const float* __restrict__ vals,  // [n, kmax]
                                        float* __restrict__ nout,        // [n]
                                        int n, int kmax) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kRowLanes;
  const int lane = threadIdx.x % kRowLanes;
  const bool live = row < n;
  int cnt = 0;
  if (live) {
    const int* crow = cols + row * kmax;
    const float* vrow = vals + row * kmax;
    const float hu = heat[row];
    for (int j = lane; j < kmax; j += kRowLanes) {
      const float v = __ldg(vrow + j);
      if (v > 0.f) cnt += hu > __ldg(heat + __ldg(crow + j)) ? 1 : 0;
    }
  }
  cnt = team_sum<kRowLanes>(cnt);
  if (live && lane == 0) nout[row] = (float)cnt;
}

template <int L, bool VEC>
__global__ void __launch_bounds__(kSingleFlowThreads)
    dhd_flow_single_kernel(const float* __restrict__ heat,  // [n]
                           const float* __restrict__ nout,  // [n]
                           const int* __restrict__ cols,    // [n, kmax]
                           const float* __restrict__ vals,  // [n, kmax]
                           const float* __restrict__ q,     // [n]
                           float* __restrict__ out,         // [n]
                           int n, int kmax, int per_block, float alpha,
                           float one_minus_gamma, float beta) {
  constexpr int kTeams = kWarp / L;  // rows a warp takes at once
  const int end = min(n, (int)(blockIdx.x + 1) * per_block);
  const int lane = threadIdx.x % kWarp;
  const int l = lane % L;
  const int rows_per_pass = blockDim.x / L;
  // the loop bound is the warp's first row, so every lane of a warp runs
  // the same iterations and the team shuffles have all 32 lanes
  for (int base = blockIdx.x * per_block + threadIdx.x / kWarp * kTeams; base < end;
       base += rows_per_pass) {
    const int u = base + lane / L;
    const bool live = u < end;
    float hu = 0.f, a_u = 0.f, qu = 0.f;
    if (live) {
      hu = __ldg(heat + u);
      a_u = alpha / fmaxf(__ldg(nout + u), 1.f);
      if (l == 0) qu = __ldg(q + u);
    }
    const int64_t row = (int64_t)u * kmax;
    float inflow = 0.f, outflow = 0.f;
    for (int j0 = 0; j0 < kmax; j0 += L * kSingleSlots) {
      int c[kSingleSlots];
      float w[kSingleSlots];
      if (VEC) {
#pragma unroll
        for (int s = 0; s < kSingleSlots / 4; ++s) {
          const int j = j0 + 4 * (s * L + l);
          int4 cv = make_int4(0, 0, 0, 0);
          float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live && j < kmax) {  // kmax % 4 == 0: a chunk is whole or absent
            cv = __ldg(reinterpret_cast<const int4*>(cols + row + j));
            wv = __ldg(reinterpret_cast<const float4*>(vals + row + j));
          }
          c[4 * s] = cv.x, c[4 * s + 1] = cv.y, c[4 * s + 2] = cv.z, c[4 * s + 3] = cv.w;
          w[4 * s] = wv.x, w[4 * s + 1] = wv.y, w[4 * s + 2] = wv.z, w[4 * s + 3] = wv.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < kSingleSlots; ++s) {
          const int j = j0 + s * L + l;
          const bool ok = live && j < kmax;
          c[s] = ok ? __ldg(cols + row + j) : 0;
          w[s] = ok ? __ldg(vals + row + j) : 0.f;
        }
      }
      // an inactive slot reads the row's own heat: no flow either way
      float hn[kSingleSlots], nn[kSingleSlots];
#pragma unroll
      for (int s = 0; s < kSingleSlots; ++s) hn[s] = w[s] > 0.f ? __ldg(heat + c[s]) : hu;
#pragma unroll
      for (int s = 0; s < kSingleSlots; ++s)
        nn[s] = w[s] > 0.f && hn[s] > hu ? __ldg(nout + c[s]) : 1.f;
#pragma unroll
      for (int s = 0; s < kSingleSlots; ++s) {
        if (hu > hn[s]) {
          outflow += a_u * w[s] * (hu - hn[s]);
        } else if (hn[s] > hu) {
          inflow += alpha / fmaxf(nn[s], 1.f) * w[s] * (hn[s] - hu);
        }
      }
    }
    const float delta = team_sum<L>(inflow) - team_sum<L>(outflow);
    if (live && l == 0) out[u] = one_minus_gamma * (hu + delta) + beta * qu;
  }
}

inline dim3 single_grid(int n) {
  const int64_t threads = (int64_t)n * kRowLanes;
  return dim3((unsigned)((threads + kSingleThreads - 1) / kSingleThreads));
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// Blocks over n rows, one per SM at most, with none left without rows:
// per_block rows each, threads enough for per_block rows at team lanes a row
// (a whole warp at least), up to max_threads.
struct RowGrid {
  int blocks, per_block, threads;
};

inline RowGrid row_grid(int n, int sms, int team, int max_threads) {
  RowGrid g;
  g.blocks = n < sms ? n : sms;
  g.per_block = (n + g.blocks - 1) / g.blocks;
  g.blocks = (n + g.per_block - 1) / g.per_block;
  const int64_t want = ((int64_t)g.per_block * team + kWarp - 1) / kWarp * kWarp;
  g.threads = want < max_threads ? (int)want : max_threads;
  return g;
}

// FB, the largest divisor of B up to kMaxFields: a block's field group
inline int field_group(int B) {
  int fields = kMaxFields;
  while (B % fields) --fields;
  return fields;
}

}  // namespace

extern "C" int dhd_count_batch(const float* heat, const int* cols, const float* vals,
                               float* nout, int B, int n, int kmax, int vals_per_field,
                               void* stream) {
  if ((int64_t)B * n == 0) return (int)cudaSuccess;
  const int fields = field_group(B);
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const RowGrid g = row_grid(n, sms, kWarp, kCountThreads);
  const dim3 grid((unsigned)g.blocks, (unsigned)(B / fields));
  const cudaStream_t st = (cudaStream_t)stream;
  const bool one_sweep = kmax <= kWarp * kCountSlots;
#define COUNT_LAUNCH(fb, per_field, one)                        \
  dhd_count_kernel<fb, per_field, one><<<grid, g.threads, 0, st>>>( \
      heat, cols, vals, nout, n, kmax, g.per_block)
#define COUNT_CASE(fb)                     \
  case fb:                                 \
    if (vals_per_field && one_sweep)       \
      COUNT_LAUNCH(fb, true, true);        \
    else if (vals_per_field)               \
      COUNT_LAUNCH(fb, true, false);       \
    else if (one_sweep)                    \
      COUNT_LAUNCH(fb, false, true);       \
    else                                   \
      COUNT_LAUNCH(fb, false, false);      \
    break;
  switch (fields) {
    COUNT_CASE(1)
    COUNT_CASE(2)
    COUNT_CASE(3)
    COUNT_CASE(4)
    COUNT_CASE(5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef COUNT_CASE
#undef COUNT_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int dhd_flow_batch(const float* heat, const float* nout, const int* cols,
                              const float* vals, const float* q, float* out, int B, int n,
                              int kmax, int vals_per_field, float alpha,
                              float one_minus_gamma, float beta, void* stream) {
  const int64_t rows = (int64_t)B * n;
  if (rows == 0) return (int)cudaSuccess;
  // groups of FB fields; one block of each group per SM
  const int fields = field_group(B);
  const int groups = B / fields;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)sms, (unsigned)groups);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool one_sweep = kmax <= kWarp * kFlowSlots;
#define FLOW_LAUNCH(fb, per_field, one)                                              \
  dhd_flow_kernel<fb, per_field, one><<<grid, kFlowThreads, 0, st>>>(               \
      heat, nout, cols, vals, q, out, B, n, kmax, alpha, one_minus_gamma, beta)
#define FLOW_CASE(fb)                      \
  case fb:                                 \
    if (vals_per_field && one_sweep)       \
      FLOW_LAUNCH(fb, true, true);         \
    else if (vals_per_field)               \
      FLOW_LAUNCH(fb, true, false);        \
    else if (one_sweep)                    \
      FLOW_LAUNCH(fb, false, true);        \
    else                                   \
      FLOW_LAUNCH(fb, false, false);       \
    break;
  switch (fields) {
    FLOW_CASE(1)
    FLOW_CASE(2)
    FLOW_CASE(3)
    FLOW_CASE(4)
    FLOW_CASE(5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLOW_CASE
#undef FLOW_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int dhd_count_single(const float* heat, const int* cols, const float* vals,
                                float* nout, int n, int kmax, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  dhd_count_single_kernel<<<single_grid(n), kSingleThreads, 0, (cudaStream_t)stream>>>(
      heat, cols, vals, nout, n, kmax);
  return (int)cudaGetLastError();
}

extern "C" int dhd_flow_single(const float* heat, const float* nout, const int* cols,
                               const float* vals, const float* q, float* out, int n,
                               int kmax, float alpha, float one_minus_gamma, float beta,
                               void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int lanes = kmax <= 8 * kSingleSlots ? 8 : kmax <= 16 * kSingleSlots ? 16 : 32;
  const RowGrid g = row_grid(n, sms, lanes, kSingleFlowThreads);
  const bool vec = kmax % 4 == 0 && ((uintptr_t)cols | (uintptr_t)vals) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define SINGLE_LAUNCH(l, v)                                                          \
  dhd_flow_single_kernel<l, v><<<g.blocks, g.threads, 0, st>>>(                     \
      heat, nout, cols, vals, q, out, n, kmax, g.per_block, alpha, one_minus_gamma, \
      beta)
  if (lanes == 8 && vec)
    SINGLE_LAUNCH(8, true);
  else if (lanes == 8)
    SINGLE_LAUNCH(8, false);
  else if (lanes == 16 && vec)
    SINGLE_LAUNCH(16, true);
  else if (lanes == 16)
    SINGLE_LAUNCH(16, false);
  else if (vec)
    SINGLE_LAUNCH(32, true);
  else
    SINGLE_LAUNCH(32, false);
#undef SINGLE_LAUNCH
  return (int)cudaGetLastError();
}
