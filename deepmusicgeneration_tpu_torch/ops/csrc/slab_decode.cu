// One decode token step through the whole Transformer-XL layer stack with
// int8 weights and an int8 slot-major KV ring ("slab_w8").
//
// Replaces the TPU kernel deepmusicgeneration_tpu/ops/fused_decode.py::
// fused_slab_core (pallas_call built by _make_slab_kernel) in the mode
// score_mode="bf16", weights_int8=True, and computes the same function:
//
//   per layer l, per batch row b
//     qkv   = bf16(h) . bf16(W_qkv_int8 * col_scale)           (f32 accumulate)
//     score = ((q+u) . K_int8[slot] * k_scale[slot] + roll((q+v) . wkr, ptr)[slot])
//             * scale, slots masked by `blocked`; self term from the fresh
//             unquantized k1 at distance 0; softmax over M + 1 keys
//     attn  = (sum_slot bf16(p * v_scale) . V_int8 + p_self * v1) / denom
//     the fresh k1/v1 rows are quantized (scale = max(|x|, 1e-6) / 127,
//     round half to even, clip +-127) and written into slot `ptr` only,
//     after the layer's attention has read the old slot
//     h1 = LN(h + bf16(attn) . W_out);  h = LN(h1 + W_ff2 . gelu_tanh(W_ff1 . h1 + b1) + b2)
//
// The Pallas kernel walks a sequential (layer, row-group) grid and carries h
// in VMEM across layers. Hopper blocks cannot carry state across a grid, so
// each layer is a short chain of kernels on one stream; the hidden state
// stays in device memory between them (it is a few KB).
//
// Bound. At batch 1 on the 41M flagship (8 layers, d 512, d_inner 3072,
// 12 x 64 heads, mem_len 512) one step must read ~51 MB: 37.7 MB of int8
// weights, 6.3 MB of bf16 wkr and 6.3 MB of int8 K/V; at 3.35 TB/s that is
// ~15 us. The arithmetic (~2 FLOP per weight byte) is far below the card's
// ridge, so the step is bound by bytes. Design for that bound: weights stay
// int8 in memory and are dequantized in registers; the GEMV splits the
// reduction dimension over blocks (partials summed in a fixed order, so the
// result is deterministic) to have enough loads in flight; attention reads
// each wkr and K/V slot row once, a whole row per thread in 16-byte loads.
// This version is simple, not tuned: it launches 10 kernels per layer.
//
// The same file holds the all-rows step ("slab_ar_w8"), which replaces
// fused_decode.py::fused_slab_allrows_core (pallas_call built by
// _make_slab_allrows_kernel) with weights_int8=True. It computes the same
// function; what defines that TPU kernel is that each layer's weights are read
// once for all B rows. Here the four weight products go through
// gemm_partial, a skinny GEMM: one block owns a
// (128 K rows x 64 columns) weight slice, holds it dequantized in shared
// memory, and applies up to 64 batch rows to it, so the weights leave device
// memory once per step for B <= 64 (the row-tiled GEMV above reads them
// B / 8 times). The GEMM's larger blocks (a 64 KB slice in shared memory)
// cost more per launch than the GEMV's, so at small B the GEMV step is the
// faster one; chip_smoke.py times both steps across B and PERF.md records
// where each wins. Attention, the fresh-slot write and the
// residual + LayerNorm kernels are shared with slab_w8. At B = 64, M = 512 on
// the flagship one step must read ~449 MB (37.7 MB int8 weights, 6.3 MB wkr,
// 402.7 MB int8 K/V, ~2.1 MB scales): ~134 us at 3.35 TB/s, bound by bytes.
//
// The bf16-weight modes ("slab" and "slab_ar", the same two TPU kernels with
// weights_int8=False) run the same chain with the weight products reading
// bf16 panels as they are, with no column scale: the TPU kernel's else branch
// feeds the bf16 panels to the MXU directly. The weight products are templates
// on the panel type (Panel<int8_t> dequantizes and rounds to bf16,
// Panel<__nv_bfloat16> reads the value), so attention, the slot write and
// LayerNorm stay shared. At B = 16 on the flagship a bf16 step must read
// 75.5 MB of weights (twice the int8 panels' 37.7 MB) besides wkr and K/V.
//
// Order contract of all four steps: attention reads the OLD slot `ptr` of every
// row (on a full ring that slot holds the oldest token, at distance exactly
// M, which is visible), and the fresh-slot write is a separate kernel
// launched after it on the same stream. The TPU all-rows kernel overlaps its
// slot-write DMA with later row groups' reads of that slot; that race is not
// carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                       // every kernel's block size
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

// Slab attention, one block per (row b, head h), for one layer.
// qkv (B, 3HD) f32; wkr (M+1, HD) bf16, row m <-> distance M-m; kt/vc
// (B, M, HD) int8; ks/vs (B, M) f32; blocked (B, M) int32; attn (B, HD) f32.
// Each thread owns whole slot rows for the score dot products (16-byte
// loads, no cross-lane reduction, several rows in flight per block); for
// P.V each thread owns 4 output columns of one slot group.
template <int DH>
__global__ void __launch_bounds__(kThreads)
slab_attention(const float* __restrict__ qkv, int H, int M,
               const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ vb,
               const __nv_bfloat16* __restrict__ wkr, const int8_t* __restrict__ kt,
               const float* __restrict__ ks, const int8_t* __restrict__ vc,
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
  for (int m = threadIdx.x; m <= M; m += blockDim.x) {
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
    sd[m] = t;
  }
  __syncthreads();
  const int8_t* krow = kt + (size_t)b * M * HD + h * DH;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int4* kr = reinterpret_cast<const int4*>(krow + (size_t)m * HD);
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
    const int src = (m - ptr < 0) ? m - ptr + M : m - ptr;  // roll by ptr
    const float s = (t * ks[(size_t)b * M + m] + sd[src]) * scale;
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
  const int8_t* vcol = vc + (size_t)b * M * HD + h * DH + 4 * c;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int i = grp; i < M; i += kSlotGroups) {
    const int m = i < M - ptr ? i + ptr : i + ptr - M;
    const float ew = bf16_round(sc[m] * vs[(size_t)b * M + m]);
    const char4 v4 = *reinterpret_cast<const char4*>(vcol + (size_t)m * HD);
    a0 = fmaf(ew, (float)v4.x, a0);
    a1 = fmaf(ew, (float)v4.y, a1);
    a2 = fmaf(ew, (float)v4.z, a2);
    a3 = fmaf(ew, (float)v4.w, a3);
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

// Quantize the fresh k1/v1 rows of qkv and write them into slot `ptr` of the
// layer's slot-major caches; one block per batch row.
__global__ void __launch_bounds__(kThreads)
kv_slot_write(const float* __restrict__ qkv, int HD, int M, int ptr,
              int8_t* __restrict__ kt, float* __restrict__ ks,
              int8_t* __restrict__ vc, float* __restrict__ vs) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const float* k1 = qkv + (size_t)b * 3 * HD + HD;
  const float* v1 = k1 + HD;
  float ka = 0.f, va = 0.f;
  for (int j = threadIdx.x; j < HD; j += blockDim.x) {
    ka = fmaxf(ka, fabsf(k1[j]));
    va = fmaxf(va, fabsf(v1[j]));
  }
  ka = block_max(ka, red);
  va = block_max(va, red);
  const float inv127 = (float)(1.0 / 127.0);
  const float k_scale = fmaxf(ka, 1e-6f) * inv127;
  const float v_scale = fmaxf(va, 1e-6f) * inv127;
  const size_t slot = (size_t)b * M + ptr;
  for (int j = threadIdx.x; j < HD; j += blockDim.x) {
    kt[slot * HD + j] = (int8_t)fminf(fmaxf(rintf(k1[j] / k_scale), -127.f), 127.f);
    vc[slot * HD + j] = (int8_t)fminf(fmaxf(rintf(v1[j] / v_scale), -127.f), 127.f);
  }
  if (threadIdx.x == 0) {
    ks[slot] = k_scale;
    vs[slot] = v_scale;
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

template <int DH, typename... Args>
cudaError_t attention_dh(int blocks, size_t smem, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slab_attention<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  slab_attention<DH><<<blocks, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename... Args>
cudaError_t attention(int Dh, int blocks, size_t smem, cudaStream_t st, Args... args) {
  switch (Dh) {
    case 16: return attention_dh<16>(blocks, smem, st, args...);
    case 32: return attention_dh<32>(blocks, smem, st, args...);
    case 64: return attention_dh<64>(blocks, smem, st, args...);
    case 128: return attention_dh<128>(blocks, smem, st, args...);
    default: return cudaErrorInvalidValue;
  }
}

// One token step for all B rows through all L layers (see slab_w8_step).
// WT is the weight panels' type; w_scales is null for bf16 panels.
template <typename WT>
int step(bool allrows, const WT* qkv_w, const WT* out_w, const WT* ff1_w,
         const WT* ff2_w, const float* w_scales, const __nv_bfloat16* ff1_b,
         const __nv_bfloat16* ff2_b, const float* ln1_g, const float* ln1_b,
         const float* ln2_g, const float* ln2_b, const __nv_bfloat16* wkr,
         const __nv_bfloat16* u, const __nv_bfloat16* v, int8_t* kt, float* ks,
         int8_t* vc, float* vs, const float* h_in, const int32_t* blocked, float* h_out,
         float* scratch, int L, int B, int D, int Dff, int H, int Dh, int M, int smax,
         int ptr, float scale, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * Dh;
  float* qkv = scratch;
  float* attn = qkv + (size_t)B * 3 * HD;
  float* h1 = attn + (size_t)B * HD;
  float* ffx = h1 + (size_t)B * D;
  float* part = ffx + (size_t)B * Dff;
  const size_t attn_smem = (size_t)(2 * Dh + 2 * (M + 1) + 4 * kThreads) * sizeof(float);
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
    const size_t kv_off = (size_t)l * B * M;
    // qkv projection
    if ((err = gemv(allrows, h_out, B, D, 3 * HD, qkv_w + (size_t)l * D * 3 * HD, sc(0), part, st)))
      return err;
    gemv_finish<<<ceil_div(B * 3 * HD, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, ch), B, 3 * HD, nullptr, kNone, qkv);
    if ((err = cudaGetLastError())) return err;
    // attention over the old cache + self, then the fresh slot write
    if ((err = attention(Dh, B * H, attn_smem, st, qkv, H, M, u, v,
                         wkr + (size_t)l * (M + 1) * HD, kt + kv_off * HD, ks + kv_off,
                         vc + kv_off * HD, vs + kv_off, blocked, ptr, scale, attn)))
      return err;
    kv_slot_write<<<B, kThreads, 0, st>>>(qkv, HD, M, ptr, kt + kv_off * HD, ks + kv_off,
                                          vc + kv_off * HD, vs + kv_off);
    if ((err = cudaGetLastError())) return err;
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

}  // namespace

extern "C" {

// Float32 scratch elements any of the four steps needs for these sizes (the
// all-rows steps' larger K slices need fewer partial sums).
size_t slab_w8_scratch_floats(int B, int D, int Dff, int HD) {
  return (size_t)B * (3 * HD + HD + D + Dff) + max_partial(B, D, Dff, HD, k_chunk(false));
}

// Kernel launches any step makes per call (for the launch accounting).
int slab_w8_kernels_per_step(int L) { return 10 * L; }

const char* slab_w8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One token step for all B rows through all L layers. Pointers are device
// pointers into contiguous tensors with the layouts of fused_slab_core:
// qkv_w (L,D,3HD) out_w (L,HD,D) ff1_w (L,D,Dff) ff2_w (L,Dff,D), int8 for
// the _w8 steps and bf16 for slab_step / slab_ar_step; w_scales (L,8,smax)
// f32 (rows 0..3: qkv, out, ff1, ff2 column scales), null for bf16 panels;
// ff1_b (L,Dff) ff2_b (L,D) bf16; ln1_g/ln1_b/ln2_g/ln2_b (L,D) f32;
// wkr (L,M+1,HD) bf16; u, v (HD) bf16; kt, vc (L,B,M,HD) int8 and ks, vs
// (L,B,M) f32, updated in slot ptr only; h_in (B,D) f32; blocked (B,M) int32;
// h_out (B,D) f32; scratch of slab_w8_scratch_floats(...) floats.
// Returns the first CUDA error (0 = cudaSuccess). Does not synchronize.
#define SLAB_STEP_ARGS(WT)                                                              \
  const WT *qkv_w, const WT *out_w, const WT *ff1_w, const WT *ff2_w,                  \
      const float *w_scales, const __nv_bfloat16 *ff1_b, const __nv_bfloat16 *ff2_b,   \
      const float *ln1_g, const float *ln1_b, const float *ln2_g, const float *ln2_b,  \
      const __nv_bfloat16 *wkr, const __nv_bfloat16 *u, const __nv_bfloat16 *v,       \
      int8_t *kt, float *ks, int8_t *vc, float *vs, const float *h_in,                 \
      const int32_t *blocked, float *h_out, float *scratch, int L, int B, int D,       \
      int Dff, int H, int Dh, int M, int smax, int ptr, float scale, int act,          \
      void *stream
#define SLAB_STEP_PASS                                                                  \
  qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, \
      u, v, kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M,     \
      smax, ptr, scale, act, stream

int slab_w8_step(SLAB_STEP_ARGS(int8_t)) { return step<int8_t>(false, SLAB_STEP_PASS); }

// The all-rows step: the same arguments, scratch and result, weight products
// through gemm_partial.
int slab_ar_w8_step(SLAB_STEP_ARGS(int8_t)) { return step<int8_t>(true, SLAB_STEP_PASS); }

// The bf16-weight steps ("slab", "slab_ar"): bf16 panels, w_scales ignored.
int slab_step(SLAB_STEP_ARGS(__nv_bfloat16)) {
  return step<__nv_bfloat16>(false, qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b,
                             ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v, kt, ks, vc, vs, h_in,
                             blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, 0, ptr,
                             scale, act, stream);
}

int slab_ar_step(SLAB_STEP_ARGS(__nv_bfloat16)) {
  return step<__nv_bfloat16>(true, qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b,
                             ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v, kt, ks, vc, vs, h_in,
                             blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, 0, ptr,
                             scale, act, stream);
}

}  // extern "C"
