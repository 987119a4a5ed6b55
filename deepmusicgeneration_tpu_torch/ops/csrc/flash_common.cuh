// Device building blocks shared by the hand-written attention kernels
// (flash_train.cu: attention over [XL memory, window] under the
// causal-window curriculum; flash_mt.cu: the multitask model's bidirectional
// and cross attention; flash_encoder.cu: the multitask encoder's inference
// attention): bf16 packing, the warp-level bf16 tensor-core products
// (ldmatrix + mma.sync m16n8k16, flash_encoder.cu's), the dropout counter
// hash, the biased query tile load, and the fixed-order reduction of
// per-block partial sums. Each .cu includes this header into its own
// anonymous namespace, so the libraries share source, not symbols.
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

// --- the batch-wide gradients ----------------------------------------------------

struct Partials {
  float *w;    // (n_slots, K, HD): dWkr of each slot (group of batch rows, query tile)
  float *u;    // (n_slots, HD): du
  float *v;    // (n_slots, HD): dv
};

// The bidirectional multitask backward's dQ seam: each query tile's first
// row of dQ in f32, and the spill's dQ of the row after the tile.
struct Seam {
  float* head;     // (B * L / 64, HD); null: no seam
  float* carry;    // (B * L / 64, HD)
};

// dwkr (K, HD), du, dv (HD) f32: the partial slots summed in slot order, so
// a backward is reproducible bit for bit (f32 atomics would add in an order
// that changes from run to run); with a seam, dq[b, t * 64] = bf16(head[b,
// t] + carry[b, t - 1]) for every query tile t (no carry into t = 0).
__global__ void __launch_bounds__(kThreads)
partials_reduce_kernel(Partials part, int n_slots, int K, int HD, float* __restrict__ dwkr,
                       float* __restrict__ du, float* __restrict__ dv, Seam seam, int n_tiles,
                       int nq, bf16* __restrict__ dq) {
  const size_t n_w = (size_t)K * HD;
  size_t x = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (x < n_w) {
    float s = 0.f;
    for (int p = 0; p < n_slots; ++p) s += part.w[(size_t)p * n_w + x];
    dwkr[x] = s;
    return;
  }
  x -= n_w;
  if (x < 2 * (size_t)HD) {
    const int c = (int)(x % HD);
    const float* src = x < (size_t)HD ? part.u : part.v;
    float s = 0.f;
    for (int p = 0; p < n_slots; ++p) s += src[(size_t)p * HD + c];
    (x < (size_t)HD ? du : dv)[c] = s;
    return;
  }
  x -= 2 * (size_t)HD;
  if (seam.head && x < (size_t)n_tiles * HD) {
    const size_t tile = x / HD;
    float v = seam.head[x];
    if (tile % nq) v += seam.carry[x - HD];
    dq[tile * kTile * HD + x % HD] = __float2bfloat16_rn(v);
  }
}

// The reduction; with a seam (head not null) of n_tiles query tiles, nq a
// batch row, also dq's first rows.
cudaError_t launch_reduce(Partials part, int n_slots, int K, int HD, float* dwkr, float* du,
                          float* dv, cudaStream_t st, Seam seam = Seam{nullptr, nullptr},
                          int n_tiles = 0, int nq = 1, bf16* dq = nullptr) {
  const size_t n = (size_t)K * HD + 2 * (size_t)HD + (seam.head ? (size_t)n_tiles * HD : 0);
  partials_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part, n_slots, K, HD, dwkr, du, dv, seam, n_tiles, nq, dq);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
