// Device building blocks shared by the hand-written decode-step kernels
// (slab_decode.cu and multirow_decode.cu: the genre Transformer-XL step;
// s2s_slab.cu / s2s_fused.cu: the multitask decoder step): bf16 rounding,
// block reductions, the weight-panel readers, the split-K GEMV / all-rows
// GEMM and their finishing passes, residual + LayerNorm, the decode
// self-attention and the fresh-slot write as templates on the cache format,
// and the genre step's layer chain (decode_step). Each .cu includes this
// header into its own anonymous namespace, so the libraries share source,
// not symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr int kCols = 64;                           // GEMV output columns per block
constexpr int kColThreads = kCols / 4;              // 16 threads x 4 columns
constexpr int kKSlices = kThreads / kColThreads;    // 16 interleaved K slices
constexpr int kKChunk = 64;                         // K rows per GEMV block
constexpr int kRows = 8;                            // batch rows per GEMV block
constexpr int kARChunk = 128;                       // K rows per all-rows GEMM block
constexpr int kARRowGroups = kThreads / kColThreads;  // 16
constexpr int kARRows = 64;                         // batch rows per all-rows GEMM block
constexpr int kARRowsPerThread = kARRows / kARRowGroups;  // 4
constexpr int kARWordsPerThread = kARChunk / kARRowGroups;  // 8 char4 of the slice
// dynamic shared memory of gemm_partial: the dequantized slice and x chunk
constexpr size_t kARSmem = (size_t)kARChunk * kCols * 4 + (size_t)kARRows * (kARChunk + 1) * 4;

enum Act { kNone = 0, kGeluTanh = 1, kRelu = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread gets the result. Warp partials are
// combined in warp order, so the result does not depend on scheduling.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // a previous call's readers are done with `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t = fmaxf(t, red[i]);
  return t;
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kGeluTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  if (act == kRelu) return fmaxf(x, 0.f);
  return x;
}

// Four consecutive weights W[k][n .. n + 3] of a panel, loaded as one word
// (Raw) and turned into the kernel's bf16 operand values. int8 panels are
// dequantized by their column scales and rounded to bf16, as the TPU kernel
// upcasts them into VMEM; bf16 panels are used as they are (no scales).
template <typename WT>
struct Panel;

template <>
struct Panel<int8_t> {
  using Raw = char4;
  static __device__ __forceinline__ Raw zero() { return make_char4(0, 0, 0, 0); }
  static __device__ __forceinline__ float4 value(Raw q, const float* sc) {
    return make_float4(bf16_round((float)q.x * sc[0]), bf16_round((float)q.y * sc[1]),
                       bf16_round((float)q.z * sc[2]), bf16_round((float)q.w * sc[3]));
  }
};

template <>
struct Panel<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ float4 value(Raw p, const float*) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

template <typename WT>
__device__ __forceinline__ typename Panel<WT>::Raw load_raw(const WT* W, size_t off) {
  return *reinterpret_cast<const typename Panel<WT>::Raw*>(W + off);
}

// partial[kb][b][n] = sum over k in chunk kb of bf16(x[b][k]) * w(k, n), where
// w is bf16(W[k][n] * s[n]) for an int8 panel and W[k][n] for a bf16 one (s is
// then null). grid (ceil(N / kCols), ceil(K / kKChunk), ceil(B / kRows)); W is (K, N).
template <typename WT>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const float* __restrict__ x, int B, int K, int N,
             const WT* __restrict__ W, const float* __restrict__ s,
             float* __restrict__ partial) {
  __shared__ float red[kKSlices][kRows][kCols];
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int n0 = blockIdx.x * kCols + tx * 4;
  const int kb = blockIdx.y;
  const int b0 = blockIdx.z * kRows;
  const int nb = min(kRows, B - b0);
  const int k_end = min(K, (kb + 1) * kKChunk);
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  if (n0 < N) {
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if (s != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = s[n0 + j];
    }
#pragma unroll 4
    for (int k = kb * kKChunk + ty; k < k_end; k += kKSlices) {
      const float4 w4 = Panel<WT>::value(load_raw(W, (size_t)k * N + n0), sc);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nb) {
          const float xv = bf16_round(x[(size_t)(b0 + r) * K + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][r][tx * 4 + j] = acc[r][j];
  __syncthreads();
  for (int o = threadIdx.x; o < kRows * kCols; o += kThreads) {
    const int r = o / kCols, c = o % kCols;
    const int n = blockIdx.x * kCols + c;
    if (r < nb && n < N) {
      float t = 0.f;
      for (int i = 0; i < kKSlices; ++i) t += red[i][r][c];
      partial[((size_t)kb * B + b0 + r) * N + n] = t;
    }
  }
}

// All-rows variant of gemv_partial: the same partial sums, but one block
// reads its weight slice (kARChunk K rows x kCols columns) once and applies
// every batch row of its kARRows-row group to it. Every load of the slice and
// of the rows' x chunk is issued before the one barrier, so a block waits on
// memory once; each thread then accumulates 4 columns for kARRowsPerThread
// rows over k in ascending order, one accumulator per output.
// grid (ceil(N / kCols), ceil(K / kARChunk), ceil(B / kARRows)), kARSmem
// bytes of dynamic shared memory.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
gemm_partial(const float* __restrict__ x, int B, int K, int N,
             const WT* __restrict__ W, const float* __restrict__ s,
             float* __restrict__ partial) {
  extern __shared__ float4 ar_smem[];
  float4 (*ws)[kColThreads] = reinterpret_cast<float4 (*)[kColThreads]>(ar_smem);
  float (*xs)[kARChunk + 1] =
      reinterpret_cast<float (*)[kARChunk + 1]>(ar_smem + kARChunk * kColThreads);
  const int cg = threadIdx.x % kColThreads;
  const int rg = threadIdx.x / kColThreads;
  const int n = blockIdx.x * kCols + 4 * cg;
  const int kb = blockIdx.y;
  const int k0 = kb * kARChunk;
  const int kn = min(kARChunk, K - k0);
  const int b0 = blockIdx.z * kARRows;
  const int nb = min(kARRows, B - b0);
  // this thread's part of the slice: rows rg + kARRowGroups * j, columns n .. n + 3;
  // rows past K and columns past N are zeros, which add nothing below
  typename Panel<WT>::Raw w4[kARWordsPerThread];
#pragma unroll
  for (int j = 0; j < kARWordsPerThread; ++j) {
    const int kk = rg + kARRowGroups * j;
    w4[j] = (kk < kn && n < N) ? load_raw(W, (size_t)(k0 + kk) * N + n) : Panel<WT>::zero();
  }
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n < N && s != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = s[n + j];
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < nb * kARChunk; i += kThreads) {
    const int r = i / kARChunk, kk = i % kARChunk;
    xs[r][kk] = kk < kn ? bf16_round(x[(size_t)(b0 + r) * K + k0 + kk]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kARWordsPerThread; ++j)
    ws[rg + kARRowGroups * j][cg] = Panel<WT>::value(w4[j], sc);
  __syncthreads();
  float acc[kARRowsPerThread][4];
#pragma unroll
  for (int a = 0; a < kARRowsPerThread; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < kARChunk; ++kk) {
    const float4 w = ws[kk][cg];
#pragma unroll
    for (int a = 0; a < kARRowsPerThread; ++a) {
      const int r = rg + kARRowGroups * a;
      if (r < nb) {
        const float xv = xs[r][kk];
        acc[a][0] = fmaf(xv, w.x, acc[a][0]);
        acc[a][1] = fmaf(xv, w.y, acc[a][1]);
        acc[a][2] = fmaf(xv, w.z, acc[a][2]);
        acc[a][3] = fmaf(xv, w.w, acc[a][3]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kARRowsPerThread; ++a) {
    const int r = rg + kARRowGroups * a;
    if (r < nb) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) partial[((size_t)kb * B + b0 + r) * N + n + j] = acc[a][j];
    }
  }
}

// y[b][n] = act(sum_kb partial[kb][b][n] + bias[n]); bias may be null.
__global__ void __launch_bounds__(kThreads)
gemv_finish(const float* __restrict__ partial, int KB, int B, int N,
            const __nv_bfloat16* __restrict__ bias, int act, float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  float t = 0.f;
  for (int kb = 0; kb < KB; ++kb) t += partial[(size_t)kb * B * N + i];
  if (bias != nullptr) t += __bfloat162float(bias[i % N]);
  y[i] = activate(t, act);
}

// out[b] = LN(resid[b] + (sum_kb partial[kb][b] + bias)) * g + beta, one block
// per row. `out` may alias `resid`: the row is read into shared memory first.
__global__ void __launch_bounds__(kThreads)
add_layer_norm(const float* resid, const float* __restrict__ partial, int KB, int B,
               int N, const __nv_bfloat16* __restrict__ bias,
               const float* __restrict__ g, const float* __restrict__ beta, float* out) {
  extern __shared__ float xs[];  // N floats
  __shared__ float red[32];
  const int b = blockIdx.x;
  float sum = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float t = 0.f;
    for (int kb = 0; kb < KB; ++kb) t += partial[((size_t)kb * B + b) * N + n];
    if (bias != nullptr) t += __bfloat162float(bias[n]);
    const float v = resid[(size_t)b * N + n] + t;
    xs[n] = v;
    sum += v;
  }
  const float mu = block_sum(sum, red) / (float)N;
  float sq = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float d = xs[n] - mu;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / (float)N;
  const float rs = rsqrtf(var + 1e-5f);
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    out[(size_t)b * N + n] = (xs[n] - mu) * rs * g[n] + beta[n];
}

// Cache formats of the decode steps. Each says where layer l's K and V live
// and how a slot is read and written; slab_attention and kv_slot_write are
// templates on it, so the slab and multirow steps share one attention.
//   SlotI8: slot-major int8 K and V (B, M, HD) with per-slot f32 scales (B, M);
//           the relative table wkr is slot-major (M + 1, HD) bf16.
//   SlotI4: the same with two slots a byte along M: packed row m holds slot
//           m in its high nibble and slot m + M/2 in its low one, value + 8.
// (multirow_decode.cu adds the head-major panel formats.)
__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// (q + v) . wkr[row m] for head h of a slot-major (M + 1, HD) table: a whole
// row per thread in 16-byte loads.
template <int DH>
__device__ __forceinline__ float wkr_row_dot(const __nv_bfloat16* wkr, int m, int h, int HD,
                                             const float* qv) {
  const uint4* w = reinterpret_cast<const uint4*>(wkr + (size_t)m * HD + h * DH);
  uint4 w8[DH / 8];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) w8[c] = w[c];
  float t = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w8[c]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p2[j]);
      t = fmaf(f.x, qv[c * 8 + 2 * j], t);
      t = fmaf(f.y, qv[c * 8 + 2 * j + 1], t);
    }
  }
  return t;
}

// symmetric quantization of one value to +-qmax by its row's scale
__device__ __forceinline__ float quantize(float x, float s, float qmax) {
  return fminf(fmaxf(rintf(x / s), -qmax), qmax);
}

struct SlotI8 {
  using KT = int8_t;
  using VT = int8_t;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ float inv_qmax() { return (float)(1.0 / 127.0); }
  static size_t layer_elems(int B, int M, int HD) { return (size_t)B * M * HD; }
  template <int DH>
  static __device__ __forceinline__ float wkr_dot(const __nv_bfloat16* wkr, int m, int h,
                                                  int M, int HD, const float* qv) {
    return wkr_row_dot<DH>(wkr, m, h, HD, qv);
  }
  template <int DH>
  static __device__ __forceinline__ float key_dot(const KT* kt, int b, int m, int h, int M,
                                                  int HD, const float* qu) {
    const int4* kr = reinterpret_cast<const int4*>(kt + ((size_t)b * M + m) * HD + h * DH);
    int4 k16[DH / 16];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) k16[c] = kr[c];
    float t = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const int8_t* kb = reinterpret_cast<const int8_t*>(&k16[c]);
#pragma unroll
      for (int j = 0; j < 16; ++j) t = fmaf((float)kb[j], qu[c * 16 + j], t);
    }
    return t;
  }
  // V[slot m] at columns col .. col + 3
  static __device__ __forceinline__ float4 value4(const VT* vc, int b, int m, int col, int M,
                                                  int HD) {
    const char4 v4 = *reinterpret_cast<const char4*>(vc + ((size_t)b * M + m) * HD + col);
    return make_float4((float)v4.x, (float)v4.y, (float)v4.z, (float)v4.w);
  }
  static __device__ __forceinline__ void put_k(KT* kt, int b, int j, int M, int HD, int ptr,
                                               float x, float s) {
    kt[((size_t)b * M + ptr) * HD + j] = (int8_t)quantize(x, s, 127.f);
  }
  static __device__ __forceinline__ void put_v(VT* vc, int b, int j, int M, int HD, int ptr,
                                               float x, float s) {
    vc[((size_t)b * M + ptr) * HD + j] = (int8_t)quantize(x, s, 127.f);
  }
};

struct SlotI4 {
  using KT = int8_t;
  using VT = int8_t;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ float inv_qmax() { return (float)(1.0 / 7.0); }
  static size_t layer_elems(int B, int M, int HD) { return (size_t)B * (M / 2) * HD; }
  // the byte of slot m, column col, and the shift of its nibble
  static __device__ __forceinline__ size_t byte_of(int b, int m, int col, int M, int HD,
                                                   int* shift) {
    const int M2 = M / 2;
    *shift = m < M2 ? 4 : 0;
    return ((size_t)b * M2 + (m < M2 ? m : m - M2)) * HD + col;
  }
  static __device__ __forceinline__ float nibble(int8_t byte, int shift) {
    return (float)((int)(((unsigned)(uint8_t)byte >> shift) & 15u) - 8);
  }
  template <int DH>
  static __device__ __forceinline__ float wkr_dot(const __nv_bfloat16* wkr, int m, int h,
                                                  int M, int HD, const float* qv) {
    return wkr_row_dot<DH>(wkr, m, h, HD, qv);
  }
  template <int DH>
  static __device__ __forceinline__ float key_dot(const KT* kt, int b, int m, int h, int M,
                                                  int HD, const float* qu) {
    int shift;
    const int4* kr = reinterpret_cast<const int4*>(kt + byte_of(b, m, h * DH, M, HD, &shift));
    int4 k16[DH / 16];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) k16[c] = kr[c];
    float t = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const int8_t* kb = reinterpret_cast<const int8_t*>(&k16[c]);
#pragma unroll
      for (int j = 0; j < 16; ++j) t = fmaf(nibble(kb[j], shift), qu[c * 16 + j], t);
    }
    return t;
  }
  static __device__ __forceinline__ float4 value4(const VT* vc, int b, int m, int col, int M,
                                                  int HD) {
    int shift;
    const char4 v4 = *reinterpret_cast<const char4*>(vc + byte_of(b, m, col, M, HD, &shift));
    return make_float4(nibble(v4.x, shift), nibble(v4.y, shift), nibble(v4.z, shift),
                       nibble(v4.w, shift));
  }
  // read-modify-write of the slot's own nibble; the byte's other nibble is
  // a live slot that this write leaves as it is
  static __device__ __forceinline__ void put(int8_t* cache, int b, int j, int M, int HD,
                                             int ptr, float x, float s) {
    int shift;
    uint8_t* p = reinterpret_cast<uint8_t*>(cache) + byte_of(b, ptr, j, M, HD, &shift);
    const unsigned n4 = (unsigned)(int)(quantize(x, s, 7.f) + 8.f);
    const unsigned old = *p;
    *p = (uint8_t)(shift ? ((old & 15u) | (n4 << 4)) : ((old & 240u) | n4));
  }
  static __device__ __forceinline__ void put_k(KT* kt, int b, int j, int M, int HD, int ptr,
                                               float x, float s) {
    put(kt, b, j, M, HD, ptr, x, s);
  }
  static __device__ __forceinline__ void put_v(VT* vc, int b, int j, int M, int HD, int ptr,
                                               float x, float s) {
    put(vc, b, j, M, HD, ptr, x, s);
  }
};

// Decode attention, one block per (row b, head h), for one layer, over a
// cache of format F. qkv (B, 3HD) f32; wkr row / column m <-> distance M-m;
// ks/vs (B, M) f32 (unused by unscaled formats); blocked (B, M) int32; attn
// (B, HD) f32. Each thread owns whole slot rows for the score dot products
// (several rows in flight per block, no cross-lane reduction); for P.V each
// thread owns 4 output columns of one slot group.
template <int DH, typename F>
__global__ void __launch_bounds__(kThreads)
slab_attention(const float* __restrict__ qkv, int H, int M,
               const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ vb,
               const __nv_bfloat16* __restrict__ wkr, const typename F::KT* __restrict__ kt,
               const float* __restrict__ ks, const typename F::VT* __restrict__ vc,
               const float* __restrict__ vs, const int32_t* __restrict__ blocked,
               int ptr, float scale, float* __restrict__ attn) {
  constexpr int kColGroups = DH / 4;                 // 4 output columns each
  constexpr int kSlotGroups = kThreads / kColGroups;
  extern __shared__ float sm[];
  float* qu = sm;            // DH: bf16(bf16(q) + u)
  float* qv = qu + DH;       // DH: bf16(bf16(q) + v)
  float* sd = qv + DH;       // M + 1 distance-space relative scores
  float* sc = sd + M + 1;    // M + 1 scores, then probabilities (slot M = self)
  float* pv = sc + M + 1;    // kSlotGroups x DH partial P.V sums
  __shared__ float red[32];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int HD = H * DH;
  const float* q = qkv + (size_t)b * 3 * HD + h * DH;
  const float* k1 = q + HD;
  const float* v1 = q + 2 * HD;
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    const float qb = bf16_round(q[d]);
    qu[d] = bf16_round(qb + __bfloat162float(u[h * DH + d]));
    qv[d] = bf16_round(qb + __bfloat162float(vb[h * DH + d]));
  }
  __syncthreads();
  for (int m = threadIdx.x; m <= M; m += blockDim.x)
    sd[m] = F::template wkr_dot<DH>(wkr, m, h, M, HD, qv);
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float t = F::template key_dot<DH>(kt, b, m, h, M, HD, qu);
    if (F::kScaled) t *= ks[(size_t)b * M + m];
    const int src = (m - ptr < 0) ? m - ptr + M : m - ptr;  // roll by ptr
    const float s = (t + sd[src]) * scale;
    sc[m] = blocked[(size_t)b * M + m] ? -1e9f : s;
  }
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int d = 0; d < DH; ++d) t = fmaf(qu[d], k1[d], t);
    sc[M] = (t + sd[M]) * scale;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int m = threadIdx.x; m <= M; m += blockDim.x) mx = fmaxf(mx, sc[m]);
  mx = block_max(mx, red);
  // The sums below visit the slots in ring order, oldest first (position i
  // is slot (ptr + i) mod M, the self term last), so their order does not
  // depend on where a row's ring starts: a row that joins a resident batch
  // at another pointer sums exactly as it does alone.
  float den = 0.f;
  for (int i = threadIdx.x; i <= M; i += blockDim.x) {
    const int m = i < M - ptr ? i + ptr : (i < M ? i + ptr - M : M);
    const float e = expf(sc[m] - mx);
    sc[m] = e;
    den += e;
  }
  den = block_sum(den, red);  // its barriers also publish sc
  const int c = threadIdx.x % kColGroups, grp = threadIdx.x / kColGroups;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int i = grp; i < M; i += kSlotGroups) {
    const int m = i < M - ptr ? i + ptr : i + ptr - M;
    const float ew = bf16_round(F::kScaled ? sc[m] * vs[(size_t)b * M + m] : sc[m]);
    const float4 v4 = F::value4(vc, b, m, h * DH + 4 * c, M, HD);
    a0 = fmaf(ew, v4.x, a0);
    a1 = fmaf(ew, v4.y, a1);
    a2 = fmaf(ew, v4.z, a2);
    a3 = fmaf(ew, v4.w, a3);
  }
  float* mine = pv + grp * DH + 4 * c;
  mine[0] = a0;
  mine[1] = a1;
  mine[2] = a2;
  mine[3] = a3;
  __syncthreads();
  if (threadIdx.x < DH) {
    float t = 0.f;
    for (int g = 0; g < kSlotGroups; ++g) t += pv[g * DH + threadIdx.x];
    attn[(size_t)b * HD + h * DH + threadIdx.x] = (t + sc[M] * v1[threadIdx.x]) / den;
  }
}

// Write the fresh k1/v1 rows of qkv into slot `ptr` of a layer's caches of
// format F, one block per batch row: quantized by the row's absmax (scale
// max(amax, 1e-6) / qmax, round half to even) for scaled formats, rounded
// to bf16 otherwise.
template <typename F>
__global__ void __launch_bounds__(kThreads)
kv_slot_write(const float* __restrict__ qkv, int HD, int M, int ptr,
              typename F::KT* __restrict__ kt, float* __restrict__ ks,
              typename F::VT* __restrict__ vc, float* __restrict__ vs) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const float* k1 = qkv + (size_t)b * 3 * HD + HD;
  const float* v1 = k1 + HD;
  float k_scale = 1.f, v_scale = 1.f;
  if (F::kScaled) {
    float ka = 0.f, va = 0.f;
    for (int j = threadIdx.x; j < HD; j += blockDim.x) {
      ka = fmaxf(ka, fabsf(k1[j]));
      va = fmaxf(va, fabsf(v1[j]));
    }
    ka = block_max(ka, red);
    va = block_max(va, red);
    k_scale = fmaxf(ka, 1e-6f) * F::inv_qmax();
    v_scale = fmaxf(va, 1e-6f) * F::inv_qmax();
  }
  for (int j = threadIdx.x; j < HD; j += blockDim.x) {
    F::put_k(kt, b, j, M, HD, ptr, k1[j], k_scale);
    F::put_v(vc, b, j, M, HD, ptr, v1[j], v_scale);
  }
  if (F::kScaled && threadIdx.x == 0) {
    ks[(size_t)b * M + ptr] = k_scale;
    vs[(size_t)b * M + ptr] = v_scale;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// K rows per split-K slice of the weight products of each step variant.
inline int k_chunk(bool allrows) { return allrows ? kARChunk : kKChunk; }

inline size_t max_partial(int B, int D, int Dff, int HD, int ch) {
  size_t p = (size_t)ceil_div(D, ch) * 3 * HD;
  p = p > (size_t)ceil_div(HD, ch) * D ? p : (size_t)ceil_div(HD, ch) * D;
  p = p > (size_t)ceil_div(D, ch) * Dff ? p : (size_t)ceil_div(D, ch) * Dff;
  p = p > (size_t)ceil_div(Dff, ch) * D ? p : (size_t)ceil_div(Dff, ch) * D;
  return p * B;
}

// Split-K partial sums of bf16(x) . w for all B rows into
// partial[ceil_div(K, k_chunk(allrows))][B][N] (w as in gemv_partial).
template <typename WT>
cudaError_t gemv(bool allrows, const float* x, int B, int K, int N, const WT* W,
                 const float* s, float* partial, cudaStream_t st) {
  if (allrows) {
    dim3 grid(ceil_div(N, kCols), ceil_div(K, kARChunk), ceil_div(B, kARRows));
    gemm_partial<WT><<<grid, kThreads, kARSmem, st>>>(x, B, K, N, W, s, partial);
  } else {
    dim3 grid(ceil_div(N, kCols), ceil_div(K, kKChunk), ceil_div(B, kRows));
    gemv_partial<WT><<<grid, kThreads, 0, st>>>(x, B, K, N, W, s, partial);
  }
  return cudaGetLastError();
}

template <int DH, typename F, typename... Args>
cudaError_t attention_dh(int blocks, size_t smem, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slab_attention<DH, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  slab_attention<DH, F><<<blocks, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

// slab_attention<Dh, F> on B * H blocks; smem from attention_smem
template <typename F, typename... Args>
cudaError_t attention(int Dh, int blocks, size_t smem, cudaStream_t st, Args... args) {
  switch (Dh) {
    case 16: return attention_dh<16, F>(blocks, smem, st, args...);
    case 32: return attention_dh<32, F>(blocks, smem, st, args...);
    case 64: return attention_dh<64, F>(blocks, smem, st, args...);
    case 128: return attention_dh<128, F>(blocks, smem, st, args...);
    default: return cudaErrorInvalidValue;
  }
}

inline size_t attention_smem(int Dh, int M) {
  return (size_t)(2 * Dh + 2 * (M + 1) + 4 * kThreads) * sizeof(float);
}

// Float32 scratch of decode_step: qkv (B x 3HD), attn (B x HD), h1 (B x D),
// ffx (B x Dff) and the split-K partial sums of either weight product.
inline size_t step_scratch_floats(int B, int D, int Dff, int HD) {
  return (size_t)B * (3 * HD + HD + D + Dff) + max_partial(B, D, Dff, HD, k_chunk(false));
}

// Kernel launches decode_step makes per layer besides attend's.
constexpr int kChainKernelsPerLayer = 8;

// One token step for all B rows through all L layers of the Transformer-XL
// stack, as a chain of kernels on one stream; h stays in device memory
// between them. Per layer: qkv = bf16(h) . W_qkv; attend(l, qkv, attn)
// launches the layer's attention over its cache and then the fresh-slot
// write (so the write follows every read of the old slot);
// h1 = LN(h + bf16(attn) . W_out); h = LN(h1 + W_ff2 . act(W_ff1 . h1 + b1) + b2).
// WT is the weight panels' type (int8 with w_scales, or bf16 with null);
// `allrows` takes the all-rows GEMM for the four products. scratch holds
// step_scratch_floats(B, D, Dff, HD) floats. Returns the first CUDA error.
template <typename WT, typename Attend>
int decode_step(bool allrows, const WT* qkv_w, const WT* out_w, const WT* ff1_w,
                const WT* ff2_w, const float* w_scales, const __nv_bfloat16* ff1_b,
                const __nv_bfloat16* ff2_b, const float* ln1_g, const float* ln1_b,
                const float* ln2_g, const float* ln2_b, const float* h_in, float* h_out,
                float* scratch, int L, int B, int D, int Dff, int HD, int smax, int act,
                cudaStream_t st, Attend attend) {
  float* qkv = scratch;
  float* attn = qkv + (size_t)B * 3 * HD;
  float* h1 = attn + (size_t)B * HD;
  float* ffx = h1 + (size_t)B * D;
  float* part = ffx + (size_t)B * Dff;
  const size_t ln_smem = (size_t)D * sizeof(float);
  const int ch = k_chunk(allrows);
  cudaError_t err;
  if (ln_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(add_layer_norm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ln_smem);
    if (err != cudaSuccess) return err;
  }
  if (allrows) {
    err = cudaFuncSetAttribute(gemm_partial<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kARSmem);
    if (err != cudaSuccess) return err;
  }
  err = cudaMemcpyAsync(h_out, h_in, (size_t)B * D * sizeof(float),
                        cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < L; ++l) {
    // column scales of the layer's qkv / out / ff1 / ff2 panels (int8 only)
    auto sc = [&](int row) -> const float* {
      return w_scales != nullptr ? w_scales + ((size_t)l * 8 + row) * smax : nullptr;
    };
    // qkv projection
    if ((err = gemv(allrows, h_out, B, D, 3 * HD, qkv_w + (size_t)l * D * 3 * HD, sc(0), part, st)))
      return err;
    gemv_finish<<<ceil_div(B * 3 * HD, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, ch), B, 3 * HD, nullptr, kNone, qkv);
    if ((err = cudaGetLastError())) return err;
    // attention over the old cache + self, then the fresh slot write
    if ((err = attend(l, qkv, attn))) return err;
    // out projection + residual + post-LN
    if ((err = gemv(allrows, attn, B, HD, D, out_w + (size_t)l * HD * D, sc(1), part, st)))
      return err;
    add_layer_norm<<<B, kThreads, ln_smem, st>>>(h_out, part, ceil_div(HD, ch), B, D,
                                                 nullptr, ln1_g + (size_t)l * D,
                                                 ln1_b + (size_t)l * D, h1);
    if ((err = cudaGetLastError())) return err;
    // feed-forward + residual + post-LN
    if ((err = gemv(allrows, h1, B, D, Dff, ff1_w + (size_t)l * D * Dff, sc(2), part, st)))
      return err;
    gemv_finish<<<ceil_div(B * Dff, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, ch), B, Dff, ff1_b + (size_t)l * Dff, act, ffx);
    if ((err = cudaGetLastError())) return err;
    if ((err = gemv(allrows, ffx, B, Dff, D, ff2_w + (size_t)l * Dff * D, sc(3), part, st)))
      return err;
    add_layer_norm<<<B, kThreads, ln_smem, st>>>(h1, part, ceil_div(Dff, ch), B, D,
                                                 ff2_b + (size_t)l * D,
                                                 ln2_g + (size_t)l * D,
                                                 ln2_b + (size_t)l * D, h_out);
    if ((err = cudaGetLastError())) return err;
  }
  return cudaSuccess;
}

// Every decode step's C signature (slab_decode.cu, multirow_decode.cu):
// device pointers into contiguous tensors with the layouts of the Python
// wrappers in ops/fused_decode.py, then the sizes, the ring pointer, the
// rows per cell, the score scale, the activation code and the stream.
#define DECODE_STEP_ARGS(WT, KT)                                                          \
  const WT *qkv_w, const WT *out_w, const WT *ff1_w, const WT *ff2_w,                    \
      const float *w_scales, const __nv_bfloat16 *ff1_b, const __nv_bfloat16 *ff2_b,     \
      const float *ln1_g, const float *ln1_b, const float *ln2_g, const float *ln2_b,    \
      const __nv_bfloat16 *wkr, const __nv_bfloat16 *u, const __nv_bfloat16 *v, KT *kt,  \
      float *ks, KT *vc, float *vs, const float *h_in, const int32_t *blocked,           \
      float *h_out, float *scratch, int L, int B, int D, int Dff, int H, int Dh, int M,  \
      int smax, int ptr, int rows_per_cell, float scale, int act, void *stream

}  // namespace
