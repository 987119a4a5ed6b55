// Device building blocks shared by the hand-written training-attention
// kernels (flash_train.cu: attention over [XL memory, window] under the
// causal-window curriculum; flash_mt.cu: the multitask model's bidirectional
// and cross attention): bf16 packing, the warp-level bf16 tensor-core
// products (ldmatrix + mma.sync m16n8k16), the dropout counter hash, tile
// loads and stores, the online softmax statistics, and the fixed-order
// reduction of per-block partial sums. Each .cu includes this header into
// its own anonymous namespace, so the two libraries share source, not
// symbols.
//
// Tiles are 64 query rows by 64 keys, one block of 8 warps each; warp w owns
// rows 16 (w % 4) .. and columns 32 (w / 4) .. of a 64 x 64 tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;       // 8 warps
constexpr int kTile = 64;           // query rows and key columns per tile
constexpr int kBand = 2 * kTile;    // wkr rows a tile pair reads (127 used)
constexpr int kSS = kTile + 1;      // f32 stride of a score tile row
constexpr int kSP = kTile + 8;      // bf16 stride of a probability tile row
constexpr int kSB = kBand + 8;      // bf16 stride of a band-gradient tile row
constexpr uint32_t kCB = 0x632be59bu;
constexpr uint32_t kCH = 0x9E3779B9u;

// bf16 stride of a (rows x DH) operand tile: DH plus 8, a 16-byte multiple
// whose rows start 4 banks apart, so ldmatrix's 8 rows hit distinct banks.
template <int DH>
__host__ __device__ constexpr int stride() { return DH + 8; }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// --- warp-level bf16 tensor-core products ----------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8 NB, NB even) += A (16 x KD) . B (KD x 8 NB), operands in shared
// memory. A_T: A is stored k-major (A[m][k] at pa[k * sa + m]), else m-major
// (pa[m * sa + k]). B_NK: B is stored n-major (B[k][n] at pb[n * sb + k], as
// the key rows of q . k^T), else k-major (pb[k * sb + n], as V in p . V).
// Fragment layout of c: c[nb][e] is row lane / 4 + 8 (e / 2), column
// nb * 8 + 2 (lane % 4) + e % 2.
template <int KD, int NB, bool A_T, bool B_NK>
__device__ __forceinline__ void warp_mma(float (&c)[NB][4], const bf16* pa, int sa,
                                         const bf16* pb, int sb) {
  static_assert(KD % 16 == 0 && NB % 2 == 0, "warp_mma shape");
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, m1 = (lane >> 3) & 1, m2 = (lane >> 4) & 1;
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t a[4];
    if (A_T)
      ldsm_x4_t(a, pa + (k0 + r8 + 8 * m2) * sa + 8 * m1);
    else
      ldsm_x4(a, pa + (lane & 15) * sa + k0 + 8 * m2);
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t b[4];
      if (B_NK)
        ldsm_x4(b, pb + (nb * 8 + r8 + 8 * m2) * sb + k0 + 8 * m1);
      else
        ldsm_x4_t(b, pb + (k0 + r8 + 8 * m1) * sb + nb * 8 + 8 * m2);
      mma16816(c[nb], a, b[0], b[1]);
      mma16816(c[nb + 1], a, b[2], b[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&c)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
}

// Warp w's block of a 64 x 64 tile: rows 16 (w % 4) .., columns 32 (w / 4) ..
__device__ __forceinline__ int warp_row0() { return 16 * ((threadIdx.x >> 5) & 3); }
__device__ __forceinline__ int warp_col0() { return 32 * (threadIdx.x >> 7); }

// --- dropout -----------------------------------------------------------------

// The TPU kernels' counter hash (_hash_keep): the dropout factor of (batch
// row b, head h, query i, key j) of a (rows x ncols) grid, 0 or keep_scale,
// from a 3-round multiply-xor mix of seed + b CB + (h + 1) CH + i ncols + j
// in uint32, kept where the mix read as int32 exceeds thresh.
__device__ __forceinline__ float hash_keep(uint32_t seed, int thresh, float keep_scale, int b,
                                           int h, int i, int ncols, int j) {
  uint32_t x = seed + (uint32_t)b * kCB + (uint32_t)(h + 1) * kCH + (uint32_t)i * (uint32_t)ncols +
               (uint32_t)j;
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return (int32_t)x > thresh ? keep_scale : 0.f;
}

// --- tiles ---------------------------------------------------------------------

// Rows first .. first + n_rows - 1 (mod `mod`) of a bf16 matrix whose row t
// starts at src + t * ld, one head's DH columns, into shared memory (16-byte
// copies).
template <int DH>
__device__ void load_rows(bf16* dst, const bf16* src, size_t ld, int first, int n_rows,
                          int mod) {
  constexpr int VPR = DH / 8;
  for (int x = threadIdx.x; x < n_rows * VPR; x += kThreads) {
    const int r = x / VPR, c = x % VPR;
    int t = first + r;
    if (t >= mod) t -= mod;
    *reinterpret_cast<uint4*>(dst + r * stride<DH>() + 8 * c) =
        *reinterpret_cast<const uint4*>(src + (size_t)t * ld + 8 * c);
  }
}

// The qu / qv tile of query rows i0 .. i0 + n - 1 of one head:
// bf16(f32(q) + f32(bias)); q points at the batch row's (L, HD) queries
// offset to the head, u and vb at the head's biases. Rows at or past L are
// zero.
template <int DH>
__device__ void load_q_biased(bf16* s_qu, bf16* s_qv, const bf16* q, const bf16* u,
                              const bf16* vb, int HD, int L, int i0, int n) {
  constexpr int VPR = DH / 8;
  for (int x = threadIdx.x; x < n * VPR; x += kThreads) {
    const int r = x / VPR, c = x % VPR;
    uint4 ou4 = make_uint4(0u, 0u, 0u, 0u), ov4 = ou4;
    if (i0 + r < L) {
      const uint4 qq = *reinterpret_cast<const uint4*>(q + (size_t)(i0 + r) * HD + 8 * c);
      const uint4 uu = *reinterpret_cast<const uint4*>(u + 8 * c);
      const uint4 vv = *reinterpret_cast<const uint4*>(vb + 8 * c);
      const uint32_t q4[4] = {qq.x, qq.y, qq.z, qq.w};
      const uint32_t u4[4] = {uu.x, uu.y, uu.z, uu.w};
      const uint32_t v4[4] = {vv.x, vv.y, vv.z, vv.w};
      uint32_t ou[4], ov[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 qf = unpack(q4[w]), uf = unpack(u4[w]), vf = unpack(v4[w]);
        ou[w] = pack(qf.x + uf.x, qf.y + uf.y);
        ov[w] = pack(qf.x + vf.x, qf.y + vf.y);
      }
      ou4 = make_uint4(ou[0], ou[1], ou[2], ou[3]);
      ov4 = make_uint4(ov[0], ov[1], ov[2], ov[3]);
    }
    *reinterpret_cast<uint4*>(s_qu + r * stride<DH>() + 8 * c) = ou4;
    *reinterpret_cast<uint4*>(s_qv + r * stride<DH>() + 8 * c) = ov4;
  }
}

// The first wkr row of the band a (64-query, 64-key) tile pair (i0, j0)
// reads: (j0 + L - 64 - i0) mod K; band row r is wkr row (first + r) mod K,
// and BD[i, j] of the pair's skew (j + L - 1 - i) mod K is band row
// j - i + 63.
__device__ __forceinline__ int band_first(int L, int K, int i0, int j0) {
  return (j0 + L - kTile - i0) % K;
}

// Stores a warp's (16 x 8 NB) f32 fragments as bf16 rows of a global matrix
// whose (row, col) element is at dst[row * ld + col].
template <int NB>
__device__ __forceinline__ void store_bf16(bf16* dst, size_t ld, const float (&c)[NB][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    *reinterpret_cast<uint32_t*>(dst + (size_t)g * ld + nb * 8 + t2) = pack(c[nb][0], c[nb][1]);
    *reinterpret_cast<uint32_t*>(dst + (size_t)(g + 8) * ld + nb * 8 + t2) =
        pack(c[nb][2], c[nb][3]);
  }
}

// --- softmax -----------------------------------------------------------------

// The normalised probability of a masked, scaled score. The _rn intrinsics
// keep nvcc from contracting the steps into FMAs differently in different
// kernels, so every pass forms the same probability from the same score bits.
__device__ __forceinline__ float prob(float s, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), l);
}

// One key tile's step of the online row max and sum: s_s holds the tile's
// 64 x 64 masked, scaled scores (stride kSS); s_m, s_l each row's running
// max and sum. Four threads a row; the caller syncs before and after.
__device__ __forceinline__ void update_row_stats(const float* s_s, float* s_m, float* s_l) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const float* row = s_s + r * kSS + 16 * part;
  const float m_old = s_m[r];
  float mx = -INFINITY;
#pragma unroll
  for (int x = 0; x < 16; ++x) mx = fmaxf(mx, row[x]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.f;
#pragma unroll
  for (int x = 0; x < 16; ++x) sum += expf(row[x] - m_new);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0) {
    s_l[r] = s_l[r] * expf(m_old - m_new) + sum;   // expf(-inf) = 0 on the first tile
    s_m[r] = m_new;
  }
}

// --- the batch-wide gradients ----------------------------------------------------

struct Partials {
  float *w;    // (n_slots, K, HD): dWkr of each (batch row, query tile)
  float *u;    // (n_slots, HD): du
  float *v;    // (n_slots, HD): dv
};

// The column sums over a 64-row tile of two warp-fragment accumulators (this
// warp's 16 rows x DH / 2 columns at oc, NO = DH / 16 blocks), summed over
// the four row warps in a fixed order and written to pu / pv (the slot's DH
// entries of the head). s_red: 8 DH floats of free shared memory; the caller
// syncs before s_red is reused.
template <int DH, int NO>
__device__ void tile_column_sums(const float (&au)[NO][4], const float (&av)[NO][4], int oc,
                                 float* s_red, float* pu, float* pv) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  float* s_su = s_red;
  float* s_sv = s_red + 4 * DH;
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x = au[nb][c] + au[nb][c + 2], y = av[nb][c] + av[nb][c + 2];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {             // over the 8 row groups
        x += __shfl_xor_sync(0xffffffffu, x, o);
        y += __shfl_xor_sync(0xffffffffu, y, o);
      }
      if (g8 == 0) {
        s_su[(warp & 3) * DH + oc + nb * 8 + t2 + c] = x;
        s_sv[(warp & 3) * DH + oc + nb * 8 + t2 + c] = y;
      }
    }
  __syncthreads();
  if (tid < DH) {
    float tu = 0.f, tv = 0.f;
    for (int r = 0; r < 4; ++r) {
      tu += s_su[r * DH + tid];
      tv += s_sv[r * DH + tid];
    }
    pu[tid] = tu;
    pv[tid] = tv;
  }
}

// dwkr (K, HD), du, dv (HD) f32: the partial slots summed in slot order, so
// a backward is reproducible bit for bit (f32 atomics would add in an order
// that changes from run to run).
__global__ void __launch_bounds__(kThreads)
partials_reduce_kernel(Partials part, int n_slots, int K, int HD, float* __restrict__ dwkr,
                       float* __restrict__ du, float* __restrict__ dv) {
  const size_t n_w = (size_t)K * HD;
  const size_t x = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (x < n_w) {
    float s = 0.f;
    for (int p = 0; p < n_slots; ++p) s += part.w[(size_t)p * n_w + x];
    dwkr[x] = s;
  } else if (x < n_w + 2 * (size_t)HD) {
    const int c = (int)(x - n_w) % HD;
    const float* src = x - n_w < (size_t)HD ? part.u : part.v;
    float s = 0.f;
    for (int p = 0; p < n_slots; ++p) s += src[(size_t)p * HD + c];
    (x - n_w < (size_t)HD ? du : dv)[c] = s;
  }
}

cudaError_t launch_reduce(Partials part, int n_slots, int K, int HD, float* dwkr, float* du,
                          float* dv, cudaStream_t st) {
  const size_t n = (size_t)K * HD + 2 * (size_t)HD;
  partials_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part, n_slots, K, HD, dwkr, du, dv);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
