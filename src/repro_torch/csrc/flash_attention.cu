// Blocked online-softmax attention, forward only (FlashAttention), for Hopper.
//
// Replaces the Pallas kernel _attn_kernel of repro/kernels/flash_attention.py
// (wrapper flash_attention).  Same function: causal and sliding-window masks,
// GQA through kv head h / group, query positions suffix-aligned when
// Sq < Skv, a -1e30 fill for masked scores, scale Dqk^-0.5, running max,
// denominator and numerator in f32, output in q's dtype.  Two differences
// from the TPU kernel, both following the dense reference attention_ref:
//   * v may be narrower than q/k (MLA: q.k width 192, v width 128); the output
//     is [B, Hq, Sq, Dv].  The TPU kernel takes one width from q for v's block
//     and for its output.
//   * a masked score adds nothing (p = 0).  For a row with at least one
//     unmasked key this equals the TPU kernel; a fully masked row (possible
//     only when a causal Sq > Skv) returns 0 as attention_ref does, where the
//     TPU kernel averages v.
//
// Layout: one block of 8 warps per (b, q head, 64-row q tile); the q tile
// sits in shared memory, and K (transposed) and V tiles of 64 kv rows are
// staged through shared memory one after another.  Each warp owns 8 q rows:
// for the scores its lanes take kv columns (lane, lane + 32), for P.V they
// take output columns (lane + 32 i), so every row's f32 accumulator lives in
// registers (8 rows x ceil(Dv / 32) a lane), never in shared memory.  KV
// tiles that the causal or window mask hides from every row of the q tile
// are skipped; ragged Sq and Skv are masked, not padded.  Tiles are kept in
// the input type (bf16 halves the shared memory: 65 KB at MLA's 192/128,
// three blocks an SM); products run on the CUDA cores in f32.
//
// Bound on an H100: at an MLA prefill of S tokens and 16 heads the work is
// 2 * 16 * S(S+1)/2 * (192 + 128) flops over q, k, v and o read or written
// once (S * 16 * 640 bytes in bf16): at S = 700 that is 2.5 GFLOP (2.5 us at
// 989 TFLOP/s bf16 dense) against 14.3 MB (4.3 us at 3.35 TB/s), so the
// bound is bytes.  This first kernel runs its products on the CUDA cores,
// not the tensor cores (wgmma), and is far above that bound; see PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // q rows per warp
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may opt into
constexpr float kNegInf = -1e30f;

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

// Row stride of the transposed K tile: odd in 32-bit words, so the writes
// (threads along Dqk) and the reads (lanes along kv) are free of bank
// conflicts.
template <typename T>
struct KTStride {
  static constexpr int value = kBlockKV + 4 / (int)sizeof(T);  // f32: 65, bf16: 66
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
size_t smem_bytes(int dqk, int dv) {
  return ((size_t)kBlockQ * dqk + (size_t)dqk * KTStride<T>::value + (size_t)kBlockKV * dv) *
         sizeof(T);
}

// DVC = ceil(Dv / 32): output columns a lane owns.
template <typename T, int DVC>
__global__ void __launch_bounds__(kWarps * kWarp)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out, int group, int Sq,
                          int Skv, int dqk, int dv, int64_t qsb, int64_t qsh, int64_t qss,
                          int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                          int64_t vss, float scale, int causal, int has_window,
                          int window) {
  constexpr int KTS = KTStride<T>::value;
  extern __shared__ unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kBlockQ][dqk]
  T* KTs = Qs + kBlockQ * dqk;              // [dqk][KTS]
  T* Vs = KTs + dqk * KTS;                  // [kBlockKV][dv]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int r0 = (tid / kWarp) * kRows;
  const int offset = Skv - Sq;  // suffix alignment of query positions
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;
  const T zero = from_f<T>(0.f);

  for (int i = tid; i < kBlockQ * dqk; i += blockDim.x) {
    const int r = i / dqk;
    const int c = i - r * dqk;
    Qs[i] = q0 + r < Sq ? qb[(int64_t)(q0 + r) * qss + c] : zero;
  }

  float m[kRows], l[kRows], acc[kRows][DVC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DVC; ++i) acc[r][i] = 0.f;
  }

  // kv positions any row of this tile may see: [kv_begin, kv_end)
  const int pos_first = q0 + offset;
  const int pos_last = min(q0 + kBlockQ, Sq) - 1 + offset;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, pos_last + 1);
  int kv_begin = 0;
  if (has_window) kv_begin = max(0, pos_first - window + 1);
  kv_begin = kv_begin / kBlockKV * kBlockKV;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < kBlockKV * dqk; i += blockDim.x) {
      const int j = i / dqk;
      const int c = i - j * dqk;
      KTs[c * KTS + j] = kv0 + j < Skv ? kb[(int64_t)(kv0 + j) * kss + c] : zero;
    }
    for (int i = tid; i < kBlockKV * dv; i += blockDim.x) {
      const int j = i / dv;
      const int c = i - j * dv;
      Vs[i] = kv0 + j < Skv ? vb[(int64_t)(kv0 + j) * vss + c] : zero;
    }
    __syncthreads();

    // scores of the warp's rows against kv columns lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < dqk; ++c) {
      const float k0 = to_f(KTs[c * KTS + lane]);
      const float k1 = to_f(KTs[c * KTS + lane + kWarp]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = to_f(Qs[(r0 + r) * dqk + c]);
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

    // masks and the online-softmax update; s becomes p
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r + offset;
      bool ok[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kpos = kv0 + lane + jj * kWarp;
        ok[jj] = kpos < Skv;
        if (causal) ok[jj] = ok[jj] && kpos <= qpos;
        if (has_window) ok[jj] = ok[jj] && kpos > qpos - window;
        s[r][jj] = ok[jj] ? s[r][jj] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DVC; ++i) acc[r][i] *= corr;
      s[r][0] = p0;
      s[r][1] = p1;
    }

    // acc += P V: p of kv row j broadcast from lane j % 32
    const int n_j = min(kBlockKV, Skv - kv0);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int t_end = min(kWarp, n_j - jj * kWarp);  // block-uniform
      for (int t = 0; t < t_end; ++t) {
        const int j = jj * kWarp + t;
        float vv[DVC];
#pragma unroll
        for (int i = 0; i < DVC; ++i) {
          const int d = lane + i * kWarp;
          vv[i] = d < dv ? to_f(Vs[j * dv + d]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = __shfl_sync(kFull, s[r][jj], t);
#pragma unroll
          for (int i = 0; i < DVC; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Sq) break;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + (((int64_t)b * Hq + h) * Sq + row) * dv;
#pragma unroll
    for (int i = 0; i < DVC; ++i) {
      const int d = lane + i * kWarp;
      if (d < dv) orow[d] = from_f<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int DVC>
int launch_dvc(const T* q, const T* k, const T* v, T* out, int B, int Hq, int group, int Sq,
               int Skv, int dqk, int dv, const int64_t* qs, const int64_t* ks,
               const int64_t* vs, float scale, int causal, int has_window, int window,
               cudaStream_t stream) {
  static bool opted_in = false;  // one attribute call per instantiation
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_kernel<T, DVC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)((Sq + kBlockQ - 1) / kBlockQ), (unsigned)Hq, (unsigned)B);
  flash_attn_fwd_kernel<T, DVC><<<grid, kWarps * kWarp, smem_bytes<T>(dqk, dv), stream>>>(
      q, k, v, out, group, Sq, Skv, dqk, dv, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int Sq, int Skv, int dqk, int dv, const int64_t* qs, const int64_t* ks,
           const int64_t* vs, float scale, int causal, int has_window, int window,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const int group = Hq / Hkv;
#define FA_CASE(n)                                                                        \
  case n:                                                                                 \
    return launch_dvc<T, n>(qt, kt, vt, ot, B, Hq, group, Sq, Skv, dqk, dv, qs, ks, vs,  \
                            scale, causal, has_window, window, stream);
  switch ((dv + kWarp - 1) / kWarp) {
    FA_CASE(1)
    FA_CASE(2)
    FA_CASE(3)
    FA_CASE(4)
    FA_CASE(5)
    FA_CASE(6)
    FA_CASE(7)
    FA_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// q [B, Hq, Sq, dqk], k [B, Hkv, Skv, dqk], v [B, Hkv, Skv, dv] with unit
// stride on the last axis and the given element strides on (b, h, s); out
// [B, Hq, Sq, dv] contiguous.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int Sq, int Skv, int dqk, int dv,
                                   int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                   int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                                   int64_t vss, float scale, int causal, int has_window,
                                   int window, int dtype, void* stream) {
  if (dqk < 1 || dqk > kMaxD || dv < 1 || dv > kMaxD || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  const int64_t qs[3] = {qsb, qsh, qss};
  const int64_t ks[3] = {ksb, ksh, kss};
  const int64_t vs[3] = {vsb, vsh, vss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Hq, Hkv, Sq, Skv, dqk, dv, qs, ks, vs, scale,
                         causal, has_window, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, dqk, dv, qs, ks, vs,
                                 scale, causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}
