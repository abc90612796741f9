// Blocked online-softmax attention, forward only (FlashAttention), for Hopper.
//
// Replaces the Pallas kernel _attn_kernel of repro/kernels/flash_attention.py
// (wrapper flash_attention).  Same function: causal and sliding-window masks,
// GQA through kv head h / group, query positions suffix-aligned when
// Sq < Skv, scale Dqk^-0.5, running max, denominator and numerator in f32,
// output in q's dtype.  Two differences from the TPU kernel, both following
// the dense reference attention_ref:
//   * v may be narrower than q/k (MLA: q.k width 192, v width 128); the output
//     is [B, Hq, Sq, Dv].  The TPU kernel takes one width from q for v's block
//     and for its output.
//   * a masked score adds nothing: its p is 0 by the mask, never by
//     exp(-1e30 - m).  For a row with at least one unmasked key this equals
//     the TPU kernel; a fully masked row (possible only when a causal
//     Sq > Skv) returns 0 as attention_ref does, where the TPU kernel
//     averages v.
// Ragged Sq and Skv are masked, never padded in device memory; q, k and v
// are read through (b, h, s) strides with a unit last axis; widths 1-256.
//
// Bound on an H100: at an MLA prefill of S tokens and 16 heads the work is
// 2 * 16 * S(S+1)/2 * (192 + 128) flops over q, k, v and o read or written
// once (S * 16 * 640 bytes in bf16): at S = 605 that is 1.88 GFLOP (1.9 us
// at 989 TFLOP/s bf16 dense) against 12.4 MB (3.7 us at 3.35 TB/s), so the
// bound is bytes.  Each dtype has one kernel:
//
// bf16: flash_attn_wgmma_kernel, on the tensor cores.  A first kernel ran
// both products on the CUDA cores in f32 (scalar shared-memory reads, one
// shuffle per (row, kv) pair in P.V, synchronous staging of a transposed K):
// about 3.4 TFLOP/s, 150x the bound at 605 tokens.  This design:
//   * one warpgroup (128 threads) per (b, q head, 64-row q tile); q tiles
//     run in reverse order, so the causal tiles with the most kv tiles start
//     first;
//   * S = Q K^T by wgmma m64n64k16 (bf16 in, f32 accumulators), both
//     operands from shared memory, K in its natural [kv, d] layout (K-major
//     B), Dqk / 16 k-steps;
//   * the online softmax on the accumulator fragment in registers: a thread
//     holds parts of two rows, and row max and sum are 4-lane xor shuffles;
//   * O += P V by wgmma m64n64k16 per 64 columns of Dv, P converted in
//     registers to two bf16 terms (hi + lo, about 16 bits of each p) and fed
//     as the register A operand (the S accumulator's layout is the A
//     fragment's), V read from shared memory as an MN-major B (transpose
//     bit);
//   * K/V tiles of 64 rows arrive by 16-byte cp.async into a 2-stage ring,
//     tile i + 1 in flight while tile i is multiplied.  Every operand sits in
//     64-column chunks of 128-byte rows in the 128-byte swizzle that the
//     wgmma descriptors name; widths are zero-filled in shared memory up to
//     a multiple of 64 (q.k) or the instance's Dv (64, 128 or 256), and rows
//     past Sq or Skv are zero-filled by the copy's source size.  cp.async
//     needs 16-byte aligned rows: the bases and the (b, h, s) strides of q,
//     k and v must be multiples of 8 elements (the wrapper raises otherwise).
// Shared memory at MLA's 192 / 128: Q 24 KB + 2 x (K 24 KB + V 16 KB), two
// blocks an SM.
//
// f32: flash_attn_f32_kernel keeps the first design on the CUDA cores (one
// block of 8 warps per q tile, K transposed and V staged through shared
// memory, f32 products); it serves the f32 checks, not the bf16 model path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may opt into
constexpr float kNegInf = -1e30f;

// kv positions any row of a q tile [q0, q0 + rows) may see, with kv_begin
// rounded down to a tile: [kv_begin, kv_end)
__device__ __forceinline__ void kv_range(int q0, int rows, int Sq, int Skv, int causal,
                                         int has_window, int window, int tile, int* begin,
                                         int* end) {
  const int offset = Skv - Sq;
  const int pos_first = q0 + offset;
  const int pos_last = min(q0 + rows, Sq) - 1 + offset;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, pos_last + 1);
  int kv_begin = 0;
  if (has_window) kv_begin = max(0, pos_first - window + 1);
  *begin = kv_begin / tile * tile;
  *end = kv_end;
}

// ------------------------------------------------------------ bf16: wgmma
constexpr int kTile = 64;                // q rows of a block, kv rows of a tile
constexpr int kWgThreads = 128;          // one warpgroup
constexpr int kChunkBytes = kTile * 128;  // 64 rows x 64 bf16 columns
constexpr int kMaxDvChunks = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a wgmma operand in the 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart (stride byte offset); the leading byte
// offset is unused, as every instruction here reads 64 columns of one chunk
// (an MN-major B) or 16 columns inside a 128-byte row (a K-major operand).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma and its wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_D32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define WG_D32_OPS                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, A and B K-major in shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_OPS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A from registers (the m64k16 fragment), B MN-major in shared
// memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_OPS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, 64) of a bf16 matrix (row r at src + r * stride) into `chunks`
// swizzled chunks at dst: element (r, c) lands in chunk c / 64, row r,
// 16-byte group ((c % 64) / 8) ^ (r % 8).  Rows >= nrows and columns >=
// width are zero-filled through the copy's source size, so nothing outside
// the tensor is read.
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                int64_t stride, int nrows, int width,
                                                int chunks) {
  const int per_row = chunks * 8;
  for (int i = threadIdx.x; i < kTile * per_row; i += kWgThreads) {
    const int r = i / per_row;
    const int g = i - r * per_row;
    const int col = g * 8;
    const int bytes = r < nrows ? min(max(width - col, 0), 8) * 2 : 0;
    const __nv_bfloat16* p = bytes ? src + r * stride + col : src;
    const uint32_t d = dst + (g >> 3) * kChunkBytes + r * 128 + (((g & 7) ^ (r & 7)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(p),
                 "r"(bytes)
                 : "memory");
  }
}

size_t wgmma_smem_bytes(int qk_chunks, int dv_chunks) {
  return 1024 + (size_t)kChunkBytes * (qk_chunks + 2 * (qk_chunks + dv_chunks));
}

// NV = the instance's Dv / 64; the q.k width runs in ceil(dqk / 64) chunks.
template <int NV>
__global__ void __launch_bounds__(kWgThreads)
    flash_attn_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int group, int Sq, int Skv,
                            int dqk, int dv, int64_t qsb, int64_t qsh, int64_t qss,
                            int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                            int64_t vsh, int64_t vss, float scale_log2, int causal,
                            int has_window, int window) {
  extern __shared__ unsigned char smem_raw[];
  const int QC = (dqk + 63) / 64;
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle needs 1 KB
  const uint32_t stage_bytes = (uint32_t)(QC + NV) * kChunkBytes;
  const uint32_t Ks0 = Qs + QC * kChunkBytes;  // stage s: K at Ks0 + s * stage_bytes,
                                               // V right after it

  const int h = blockIdx.x;
  const int Hq = gridDim.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // longest causal walk first
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int r0 = (tid / kWarp) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int offset = Skv - Sq;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + (h / group) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (h / group) * vsh;

  int kv_begin, kv_end;
  kv_range(q0, kTile, Sq, Skv, causal, has_window, window, kTile, &kv_begin, &kv_end);
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kTile - 1) / kTile : 0;

  auto load_kv = [&](int t) {
    const int kv0 = kv_begin + t * kTile;
    const uint32_t ks = Ks0 + (t & 1) * stage_bytes;
    const int rows = min(kTile, Skv - kv0);
    load_tile_async(ks, kb + kv0 * kss, kss, rows, dqk, QC);
    load_tile_async(ks + QC * kChunkBytes, vb + kv0 * vss, vss, rows, dv, NV);
  };

  load_tile_async(Qs, qb + q0 * qss, qss, min(kTile, Sq - q0), dqk, QC);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  float o[NV][32];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = kv_begin + t * kTile;
    const uint32_t ks = Ks0 + (t & 1) * stage_bytes;
    const uint32_t vs = ks + QC * kChunkBytes;
    if (t + 1 < n_tiles) {
      __syncthreads();  // tile t - 1 is consumed by every warp: its stage is free
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // everything but tile t + 1 has landed
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T over the q.k chunks, 4 k-steps of 16 columns each
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
    for (int c = 0; c < QC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = c * kChunkBytes + kk * 32;
        wgmma_ss(s, wgmma_desc(Qs + off), wgmma_desc(ks + off), (c | kk) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // masks: s[i] is row r0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
    // 2 * (lane % 4) + (i & 1) of the tile; bit i of keep says it is seen
    uint32_t keep = kFull;
    const bool edge = kv0 + kTile > Skv || (causal && kv0 + kTile - 1 > q0 + offset) ||
                      (has_window && kv0 <= q0 + kTile - 1 + offset - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = kv0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1) + offset;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        if (!ok) keep &= ~(1u << i);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= scale_log2;
      if (keep & (1u << i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      corr[rr] = exp2f(m[rr] - m_new);
      m[rr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      s[i] = (keep & (1u << i)) ? exp2f(s[i] - m[rr]) : 0.f;
      rsum[rr] += s[i];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rsum[rr] += __shfl_xor_sync(kFull, rsum[rr], 1);
      rsum[rr] += __shfl_xor_sync(kFull, rsum[rr], 2);
      l[rr] = l[rr] * corr[rr] + rsum[rr];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i >> 1) & 1];

    // O += P V: k-step kk takes kv rows [16 kk, 16 kk + 16), whose p values
    // are s[8 kk .. 8 kk + 7] in the A fragment's order.  P goes in as two
    // bf16 terms, hi + lo, so the product keeps about 16 bits of each p (V
    // is bf16 already): P rounded to bf16 alone moved the logits of the
    // full-depth MLA prefill further from the f32 reference than SDPA does.
    // Every register a wgmma reads is written before the fence.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = s[8 * kk + 2 * j], p1 = s[8 * kk + 2 * j + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
        lo[kk][j] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
      }
      pin(hi[kk]);
      pin(lo[kk]);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) pin(o[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const uint64_t dv_desc = wgmma_desc(vs + n * kChunkBytes + kk * 16 * 128);
        wgmma_rs_mn(o[n], hi[kk], dv_desc);
        wgmma_rs_mn(o[n], lo[kk], dv_desc);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NV; ++n) pin(o[n]);
  }
  if (n_tiles == 0) cp_async_wait<0>();  // the q tile's copies, never read

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);  // a fully masked row: 0 * inv = 0
    __nv_bfloat16* orow = out + (((int64_t)b * Hq + h) * Sq + row) * dv;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n * 64 + j * 8 + (lane & 3) * 2;
        const float x0 = o[n][j * 4 + 2 * rr] * inv;
        const float x1 = o[n][j * 4 + 2 * rr + 1] * inv;
        if (!(dv & 1)) {
          if (col < dv)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < dv) orow[col] = __float2bfloat16(x0);
          if (col + 1 < dv) orow[col + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// Dv instances of the bf16 kernel: the smallest of 64, 128, 256 that holds dv.
int dv_chunks(int dv) { return dv <= 64 ? 1 : dv <= 128 ? 2 : kMaxDvChunks; }

template <int NV>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 __nv_bfloat16* out, int B, int Hq, int group, int Sq, int Skv, int dqk,
                 int dv, const int64_t* qs, const int64_t* ks, const int64_t* vs,
                 float scale, int causal, int has_window, int window, cudaStream_t stream) {
  static bool opted_in = false;  // one attribute call per instance
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(flash_attn_wgmma_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)Hq, (unsigned)B, (unsigned)((Sq + kTile - 1) / kTile));
  const size_t smem = wgmma_smem_bytes((dqk + 63) / 64, NV);
  flash_attn_wgmma_kernel<NV><<<grid, kWgThreads, smem, stream>>>(
      q, k, v, out, group, Sq, Skv, dqk, dv, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale * 1.4426950408889634f, causal, has_window, window);
  return (int)cudaGetLastError();
}

// cp.async reads 16-byte pieces: the base and every stride that moves
// (its axis longer than 1) must be a multiple of 8 bf16 elements
bool aligned16(const void* p, const int64_t* st, const int* sizes) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && st[i] % 8) return false;
  return true;
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                int Hkv, int Sq, int Skv, int dqk, int dv, const int64_t* qs,
                const int64_t* ks, const int64_t* vs, float scale, int causal,
                int has_window, int window, cudaStream_t stream) {
  const int qsz[3] = {B, Hq, Sq};
  const int kvsz[3] = {B, Hkv, Skv};
  if (!aligned16(q, qs, qsz) || !aligned16(k, ks, kvsz) || !aligned16(v, vs, kvsz))
    return (int)cudaErrorMisalignedAddress;
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  const int group = Hq / Hkv;
#define FA_WG_CASE(width)                                                                  \
  case width / 64:                                                                         \
    return launch_wgmma<width / 64>(qt, kt, vt, ot, B, Hq, group, Sq, Skv, dqk, dv, qs, ks, \
                                    vs, scale, causal, has_window, window, stream);
  switch (dv_chunks(dv)) {
    FA_WG_CASE(64)
    FA_WG_CASE(128)
    FA_WG_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_WG_CASE
}

// -------------------------------------------------------------- f32: CUDA cores
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // q rows per warp
// Row stride of the transposed K tile: odd, so the writes (threads along
// Dqk) and the reads (lanes along kv) are free of bank conflicts.
constexpr int kKTStride = kBlockKV + 1;

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

size_t f32_smem_bytes(int dqk, int dv) {
  return ((size_t)kBlockQ * dqk + (size_t)dqk * kKTStride + (size_t)kBlockKV * dv) *
         sizeof(float);
}

// Each warp owns 8 q rows: for the scores its lanes take kv columns (lane,
// lane + 32), for P.V they take output columns (lane + 32 i), so every row's
// accumulator lives in registers.  DVC = ceil(Dv / 32).
template <int DVC>
__global__ void __launch_bounds__(kWarps * kWarp)
    flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out, int group,
                          int Sq, int Skv, int dqk, int dv, int64_t qsb, int64_t qsh,
                          int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                          int64_t vsh, int64_t vss, float scale, int causal, int has_window,
                          int window) {
  extern __shared__ unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBlockQ][dqk]
  float* KTs = Qs + kBlockQ * dqk;                  // [dqk][kKTStride]
  float* Vs = KTs + dqk * kKTStride;                // [kBlockKV][dv]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int r0 = (tid / kWarp) * kRows;
  const int offset = Skv - Sq;  // suffix alignment of query positions
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < kBlockQ * dqk; i += blockDim.x) {
    const int r = i / dqk;
    const int c = i - r * dqk;
    Qs[i] = q0 + r < Sq ? qb[(int64_t)(q0 + r) * qss + c] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DVC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DVC; ++i) acc[r][i] = 0.f;
  }

  int kv_begin, kv_end;
  kv_range(q0, kBlockQ, Sq, Skv, causal, has_window, window, kBlockKV, &kv_begin, &kv_end);

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < kBlockKV * dqk; i += blockDim.x) {
      const int j = i / dqk;
      const int c = i - j * dqk;
      KTs[c * kKTStride + j] = kv0 + j < Skv ? kb[(int64_t)(kv0 + j) * kss + c] : 0.f;
    }
    for (int i = tid; i < kBlockKV * dv; i += blockDim.x) {
      const int j = i / dv;
      const int c = i - j * dv;
      Vs[i] = kv0 + j < Skv ? vb[(int64_t)(kv0 + j) * vss + c] : 0.f;
    }
    __syncthreads();

    // scores of the warp's rows against kv columns lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < dqk; ++c) {
      const float k0 = KTs[c * kKTStride + lane];
      const float k1 = KTs[c * kKTStride + lane + kWarp];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = Qs[(r0 + r) * dqk + c];
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
          vv[i] = d < dv ? Vs[j * dv + d] : 0.f;
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
    float* orow = out + (((int64_t)b * Hq + h) * Sq + row) * dv;
#pragma unroll
    for (int i = 0; i < DVC; ++i) {
      const int d = lane + i * kWarp;
      if (d < dv) orow[d] = acc[r][i] / denom;
    }
  }
}

template <int DVC>
int launch_f32_dvc(const float* q, const float* k, const float* v, float* out, int B, int Hq,
                   int group, int Sq, int Skv, int dqk, int dv, const int64_t* qs,
                   const int64_t* ks, const int64_t* vs, float scale, int causal,
                   int has_window, int window, cudaStream_t stream) {
  static bool opted_in = false;  // one attribute call per instance
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(flash_attn_f32_kernel<DVC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)((Sq + kBlockQ - 1) / kBlockQ), (unsigned)Hq, (unsigned)B);
  flash_attn_f32_kernel<DVC><<<grid, kWarps * kWarp, f32_smem_bytes(dqk, dv), stream>>>(
      q, k, v, out, group, Sq, Skv, dqk, dv, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Hq,
               int Hkv, int Sq, int Skv, int dqk, int dv, const int64_t* qs,
               const int64_t* ks, const int64_t* vs, float scale, int causal, int has_window,
               int window, cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(out);
  const int group = Hq / Hkv;
#define FA_CASE(n)                                                                       \
  case n:                                                                                \
    return launch_f32_dvc<n>(qt, kt, vt, ot, B, Hq, group, Sq, Skv, dqk, dv, qs, ks, vs, \
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
// [B, Hq, Sq, dv] contiguous.  dtype: 0 = float32 (CUDA-core kernel), 1 =
// bfloat16 (tensor-core kernel; 16-byte aligned rows, else
// cudaErrorMisalignedAddress).
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
    return launch_f32(q, k, v, out, B, Hq, Hkv, Sq, Skv, dqk, dv, qs, ks, vs, scale, causal,
                      has_window, window, st);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, Hq, Hkv, Sq, Skv, dqk, dv, qs, ks, vs, scale, causal,
                       has_window, window, st);
  return (int)cudaErrorInvalidValue;
}
