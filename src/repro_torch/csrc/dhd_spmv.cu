// Directed-Heat-Diffusion step over symmetric ELL adjacency (paper Eqs. 7-8):
// for B heat fields that share one column structure (dhd_count_batch /
// dhd_flow_batch), and for one heat field (dhd_count_single /
// dhd_flow_single, at the end of this file).
//
// Replaces the Pallas kernels _count_kernel_batch / _flow_kernel_batch of
// repro/kernels/dhd_spmv.py.  The TPU version keeps each field's whole heat
// vector resident in VMEM as an (n, 1) block and walks row blocks in grid
// order.  Here every (field, row) pair gets one warp; its lanes stride the
// row's kmax neighbour slots, and the neighbour heat gather goes through L2
// (26,000 rows x 5 fields of f32 heat is 0.5 MB, far below the 50 MB L2).
//
// Bound on an H100: memory.  A step reads cols and vals (n*kmax*8 bytes with
// shared vals, plus B*n*kmax*4 with per-field vals) once per pass and does a
// handful of flops per slot, so both launches are limited by HBM bandwidth
// (3.35 TB/s).  Lanes read consecutive slots of one row, so the cols/vals
// loads coalesce; with shared vals the B fields of a row reuse the same
// lines from L2.
//
// Two launches per step: the flow pass reads |N_j^out| of neighbour rows,
// which needs every row's count first (a grid-wide sync).  The ragged edge
// (rows past B*n) is masked; ELL padding slots carry weight 0 and stay
// inactive, so no pad rows are needed.
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
// epilogue (1 - gamma) * (h + delta) + beta * q.
__global__ void dhd_flow_kernel(const float* __restrict__ heat,   // [B, n]
                                const float* __restrict__ nout,   // [B, n]
                                const int* __restrict__ cols,     // [n, kmax]
                                const float* __restrict__ vals,   // [n, kmax] or [B, n, kmax]
                                const float* __restrict__ q,      // [B, n]
                                float* __restrict__ out,          // [B, n]
                                int B, int n, int kmax, int64_t vals_bstride,
                                float alpha, float one_minus_gamma, float beta) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= (int64_t)B * n) return;  // warp-uniform
  const int64_t b = row / n;
  const int64_t u = row - b * n;
  const float* h = heat + b * n;
  const float* no = nout + b * n;
  const int* crow = cols + u * kmax;
  const float* vrow = vals + b * vals_bstride + u * kmax;
  const float hu = h[u];
  const float a_u = alpha / fmaxf(no[u], 1.f);
  float inflow = 0.f, outflow = 0.f;
  for (int j = lane; j < kmax; j += kWarp) {
    const float v = __ldg(vrow + j);
    if (v > 0.f) {
      const int c = __ldg(crow + j);
      const float hn = __ldg(h + c);
      if (hu > hn) {
        outflow += a_u * v * (hu - hn);
      } else if (hn > hu) {
        inflow += alpha / fmaxf(__ldg(no + c), 1.f) * v * (hn - hu);
      }
    }
  }
  const float delta = warp_sum(inflow) - warp_sum(outflow);
  if (lane == 0) out[row] = one_minus_gamma * (hu + delta) + beta * q[row];
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
  const int64_t vstride = vals_per_field ? (int64_t)n * kmax : 0;
  dhd_flow_kernel<<<grid_for(rows), kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
      heat, nout, cols, vals, q, out, B, n, kmax, vstride, alpha, one_minus_gamma, beta);
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
