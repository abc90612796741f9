// Directed-Heat-Diffusion step over symmetric ELL adjacency (paper Eqs. 7-8):
// for B heat fields that share one column structure (dhd_count_batch /
// dhd_flow_batch), and for one heat field (dhd_count_single /
// dhd_flow_single, at the end of this file).
//
// Replaces the Pallas kernels _count_kernel_batch / _flow_kernel_batch of
// repro/kernels/dhd_spmv.py.  The TPU version keeps each field's whole heat
// vector resident in VMEM as an (n, 1) block and walks row blocks in grid
// order.  Here the neighbour heat gathers go through L2 (26,000 rows x 5
// fields of f32 heat is 0.5 MB, far below the 50 MB L2).
//
// Bound on an H100: memory.  A step reads cols and vals (n*kmax*8 bytes with
// shared vals, plus B*n*kmax*4 with per-field vals) once per pass and does a
// handful of flops per slot, so both launches are bounded by HBM bandwidth
// (3.35 TB/s): at maintain's 5 x 26,000 x 71 the flow pass moves 16.8 MB, a
// bound of 5.0 us.
//
// The count pass gives one warp to each (field, row) pair; its lanes stride
// the row's kmax neighbour slots.  The flow pass did the same at first and
// ran at 13x its bound on an H100 (0.0658 ms at 5 x 26,000 x 71): 130,000
// warps, each walking 71 slots in three passes (the third with 7 of 32
// lanes live) as chains of dependent loads (cols/vals -> h[c] -> nout[c]),
// and loading the row's cols and vals again for each of the 5 fields.
// Giving a warp one row for all fields (cols/vals once, every field's
// gathers in flight together) shortened the chains but not the time: the
// gathers are what costs.  Each reads a 32-byte sector for 4 useful bytes,
// 5 fields x (h, and nout where heat flows in) per live slot, about 7.5 M
// a pass, at the rate of L1 and L2 rather than of HBM.  So the flow pass
// also keeps them local: block x owns a contiguous range of rows (one block
// of 32 warps per SM, n / 132 rows each), so an SM's gathers fall mostly
// in its rows' neighbourhood (the lane graph's vertex ids are grouped by
// community: median |c - u| 623 of 26,000) and hit its L1; with the L1
// carved down to make room for shared memory it is as slow as the first
// design.  The row's own nout and q load at the top of the row, off the
// chain.  At maintain's shape it runs at about 7x the bound (PERF.md); the
// [B, n] layout puts the fields of one column in 5 different sectors, and
// interleaving them is the next step (it changes the layouts the callers
// pass).
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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Pass 1: |N_u^out| = active neighbours with strictly lower heat.
__global__ void dhd_count_kernel(const float* __restrict__ heat,   // [B, n]
                                 const int* __restrict__ cols,     // [n, kmax]
                                 const float* __restrict__ vals,   // [n, kmax] or [B, n, kmax]
                                 float* __restrict__ nout,         // [B, n]
                                 int B, int n, int kmax, int64_t vals_bstride) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= (int64_t)B * n) return;  // warp-uniform
  const int64_t b = row / n;
  const int64_t u = row - b * n;
  const float* h = heat + b * n;
  const int* crow = cols + u * kmax;
  const float* vrow = vals + b * vals_bstride + u * kmax;
  const float hu = h[u];
  int cnt = 0;
  for (int j = lane; j < kmax; j += kWarp) {
    const float v = __ldg(vrow + j);
    if (v > 0.f) cnt += hu > __ldg(h + __ldg(crow + j)) ? 1 : 0;
  }
  cnt = warp_sum(cnt);
  if (lane == 0) nout[row] = (float)cnt;
}

// Pass 2: inflow - outflow with alpha / max(n_out, 1) on both ends, then the
// epilogue (1 - gamma) * (h + delta) + beta * q.  Block (x, y) owns a
// contiguous range of rows, one x per SM, for the FB fields from y * FB on
// (clamped to B); each of its warps takes one row at a time for all FB
// fields, kFlowSlots slots a lane per sweep of the slot loop (one sweep when
// ONE_SWEEP, kmax <= 96: the loop's bookkeeping cost 4% at maintain's shape
// on an H100).  PER_FIELD: vals is [B, n, kmax] (one weight row per field)
// rather than shared.
constexpr int kFlowMaxFields = 5;
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

constexpr int kWarpsPerBlock = 8;

inline dim3 grid_for(int64_t rows) {
  return dim3((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

// ---------------------------------------------------------------- one field
// Replaces the Pallas kernels _count_kernel / _flow_kernel of
// repro/kernels/dhd_spmv.py, the step that warm DHD (streaming/delta_dhd.py)
// sweeps to its steady state over one heat field.  Its ELL has
// kmax = round8(max degree + 8) slots a row: 80 on the 26,000-vertex serving
// lane, where a whole warp per row would leave lanes 16-31 idle on the third
// pass.  So a row gets half a warp (kRowLanes lanes, two rows a warp): each
// lane walks kmax / 16 slots and the row sum is a 4-step xor shuffle inside
// the half.  Bound on an H100: memory, as for the batched pair (cols + vals,
// n * kmax * 8 bytes, read once per pass).
//
// A warp's two halves may hold a live and a dead row at the ragged edge, so
// dead rows skip their loads but still take part in the shuffles (no early
// return before a full-mask shuffle).
constexpr int kRowLanes = 16;
constexpr int kSingleThreads = 256;

template <typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int o = kRowLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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
  cnt = row_sum(cnt);
  if (live && lane == 0) nout[row] = (float)cnt;
}

__global__ void dhd_flow_single_kernel(const float* __restrict__ heat,  // [n]
                                       const float* __restrict__ nout,  // [n]
                                       const int* __restrict__ cols,    // [n, kmax]
                                       const float* __restrict__ vals,  // [n, kmax]
                                       const float* __restrict__ q,     // [n]
                                       float* __restrict__ out,         // [n]
                                       int n, int kmax, float alpha,
                                       float one_minus_gamma, float beta) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kRowLanes;
  const int lane = threadIdx.x % kRowLanes;
  const bool live = row < n;
  float inflow = 0.f, outflow = 0.f, hu = 0.f;
  if (live) {
    const int* crow = cols + row * kmax;
    const float* vrow = vals + row * kmax;
    hu = heat[row];
    const float a_u = alpha / fmaxf(nout[row], 1.f);
    for (int j = lane; j < kmax; j += kRowLanes) {
      const float v = __ldg(vrow + j);
      if (v > 0.f) {
        const int c = __ldg(crow + j);
        const float hn = __ldg(heat + c);
        if (hu > hn) {
          outflow += a_u * v * (hu - hn);
        } else if (hn > hu) {
          inflow += alpha / fmaxf(__ldg(nout + c), 1.f) * v * (hn - hu);
        }
      }
    }
  }
  const float delta = row_sum(inflow) - row_sum(outflow);
  if (live && lane == 0) out[row] = one_minus_gamma * (hu + delta) + beta * q[row];
}

inline dim3 single_grid(int n) {
  const int64_t threads = (int64_t)n * kRowLanes;
  return dim3((unsigned)((threads + kSingleThreads - 1) / kSingleThreads));
}

}  // namespace

extern "C" int dhd_count_batch(const float* heat, const int* cols, const float* vals,
                               float* nout, int B, int n, int kmax, int vals_per_field,
                               void* stream) {
  const int64_t rows = (int64_t)B * n;
  if (rows == 0) return (int)cudaSuccess;
  const int64_t vstride = vals_per_field ? (int64_t)n * kmax : 0;
  dhd_count_kernel<<<grid_for(rows), kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
      heat, cols, vals, nout, B, n, kmax, vstride);
  return (int)cudaGetLastError();
}

extern "C" int dhd_flow_batch(const float* heat, const float* nout, const int* cols,
                              const float* vals, const float* q, float* out, int B, int n,
                              int kmax, int vals_per_field, float alpha,
                              float one_minus_gamma, float beta, void* stream) {
  const int64_t rows = (int64_t)B * n;
  if (rows == 0) return (int)cudaSuccess;
  // groups of FB fields, FB the largest divisor of B up to kFlowMaxFields;
  // one block of each group per SM
  int fields = kFlowMaxFields;
  while (B % fields) --fields;
  const int groups = B / fields;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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
  dhd_flow_single_kernel<<<single_grid(n), kSingleThreads, 0, (cudaStream_t)stream>>>(
      heat, nout, cols, vals, q, out, n, kmax, alpha, one_minus_gamma, beta);
  return (int)cudaGetLastError();
}
