// Causal Transformer-XL prefill attention over a left-padded prompt window,
// without materializing the (B, H, W, W) scores.
//
// Replaces the TPU kernels of deepmusicgeneration_tpu/ops/flash_prefill.py::
// flash_prefill_attention: the whole-window pallas_call (_make_kernel,
// W <= 2048) and the row-blocked one (_blocked_prefill_call /
// _make_blocked_kernel, 2048 < W <= 8192). One kernel serves every W and
// computes the same function:
//
//   qu = bf16(q + u), qv = bf16(q + v)                       (per head, f32 add)
//   score[i, j] = (qu_i . k_j + qv_i . wkr[j + W - 1 - i]) * scale   (f32)
//   score[i, j] = -1e9 where j > i or key j is left padding
//   out_i = softmax_j(score[i, :]) . V                        (bf16 out)
//
// The relative-position skew (fastai's _line_shift) needs no roll: the BD
// term indexes the wkr row j + W - 1 - i directly, which replaces both the
// whole-window kernel's strided roll and the blocked kernel's pre-rotated
// per-block tables. One block owns (query tile of 64 rows, head, batch row)
// and streams 64-key tiles of K, V and the 127 wkr rows the tile pair needs
// through shared memory, with an online softmax in f32; key tiles in the
// future of the whole query tile are skipped. When W is not a multiple of 64
// the last tile is a tail: its query rows past W are zeros and are not
// written, its keys past W are masked like padding, and wkr rows outside
// [0, W) (read only by those rows) are zeros.
//
// Numerics against the TPU kernel: the mask fill stays the finite -1e9, so a
// padded query row (all its keys masked) averages V over the keys of the
// tiles it visits instead of all W keys; that value is finite and is read
// only by padded keys, which every real query masks. The TPU kernel rounds
// the normalized probabilities to bf16 before P.V; here the unnormalized
// exponentials stay f32 and the row is divided by its sum at the end.
//
// Bound. At B = 16, W = 512 on the flagship (12 x 64 heads) the call reads
// q, k, v and wkr once and writes the output: ~50 MB, ~15 us at 3.35 TB/s;
// its ~9.7 GFLOP of causal products take ~10 us at the bf16 tensor-core
// peak, so bytes bound it. This first version multiplies on the CUDA cores
// in f32 (products of bf16 values are exact), so arithmetic, not bytes,
// limits it; tensor cores (mma / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key columns per tile
constexpr int kScoreStride = kTile + 1;

// Two bf16 values packed in one 32-bit word, low half first.
__device__ __forceinline__ float2 unpack(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// Shared-memory words per tile row: DH / 2 bf16 pairs plus one, an odd count,
// so threads reading consecutive rows at the same column hit distinct banks.
template <int DH>
__host__ __device__ constexpr int row_words() { return DH / 2 + 1; }

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)6 * kTile * row_words<DH>() * 4     // qu, qv, k, v, 2 x wkr rows
         + (size_t)kTile * kScoreStride * 4           // scores / probabilities
         + (size_t)3 * kTile * 4                      // running max, sum, rescale
         + (size_t)kTile * 4;                         // key pad flags
}

// Copy rows first .. first + n_rows - 1 of a (W x DH) bf16 matrix whose row t
// starts at src + t * ld (elements) into shared memory, row_words<DH>() words
// per row; rows outside [0, W) are zero-filled.
template <int DH>
__device__ void load_rows(uint32_t* dst, const __nv_bfloat16* src, size_t ld, int first,
                          int n_rows, int W) {
  constexpr int WPR = DH / 2;
  for (int i = threadIdx.x; i < n_rows * WPR; i += kThreads) {
    const int r = i / WPR, w = i % WPR;
    const int t = first + r;
    dst[r * row_words<DH>() + w] =
        (t >= 0 && t < W) ? reinterpret_cast<const uint32_t*>(src + (size_t)t * ld)[w] : 0u;
  }
}

// grid (ceil(W / kTile), H, B). q, k, v, out (B, W, H*DH) bf16; wkr (W, H*DH) bf16,
// row t <-> distance W - 1 - t; u, vb (H*DH) bf16; pad (B, W) 0/1 bytes.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ wkr,
                     const __nv_bfloat16* __restrict__ ub,
                     const __nv_bfloat16* __restrict__ vb, const uint8_t* __restrict__ pad,
                     int W, int H, float scale, __nv_bfloat16* __restrict__ out) {
  constexpr int RW = row_words<DH>();
  constexpr int kColGroups = DH / 4;                  // P.V: 4 output columns each
  constexpr int kRowGroups = kThreads / kColGroups;
  constexpr int kRowsPT = kTile / kRowGroups;         // P.V rows per thread
  static_assert(kRowsPT >= 1 && kTile % kRowGroups == 0, "unsupported head width");
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_qu = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_qv = s_qu + kTile * RW;
  uint32_t* s_k = s_qv + kTile * RW;
  uint32_t* s_v = s_k + kTile * RW;
  uint32_t* s_r = s_v + kTile * RW;                   // 2 * kTile wkr rows
  float* s_s = reinterpret_cast<float*>(s_r + 2 * kTile * RW);
  float* s_m = s_s + kTile * kScoreStride;
  float* s_l = s_m + kTile;
  float* s_a = s_l + kTile;
  int* s_pad = reinterpret_cast<int*>(s_a + kTile);

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;          // most key tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * DH;
  const int i0 = qt * kTile;
  const size_t row0 = (size_t)b * W;                  // first row of batch row b

  // qu / qv tile: bf16(f32(q) + f32(bias)), per pair of columns
  {
    const uint32_t* qsrc = reinterpret_cast<const uint32_t*>(q + (row0 + i0) * HD + h * DH);
    const uint32_t* u2 = reinterpret_cast<const uint32_t*>(ub + h * DH);
    const uint32_t* v2 = reinterpret_cast<const uint32_t*>(vb + h * DH);
    constexpr int WPR = DH / 2;
    for (int i = tid; i < kTile * WPR; i += kThreads) {
      const int r = i / WPR, w = i % WPR;
      const float2 qq =
          i0 + r < W ? unpack(qsrc[(size_t)r * (HD / 2) + w]) : make_float2(0.f, 0.f);
      const float2 uu = unpack(u2[w]), vv = unpack(v2[w]);
      s_qu[r * RW + w] = pack(qq.x + uu.x, qq.y + uu.y);
      s_qv[r * RW + w] = pack(qq.x + vv.x, qq.y + vv.y);
    }
  }
  if (tid < kTile) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  // scores: thread (ty, tx) owns rows 4 ty + a and columns tx + 16 c
  const int ty = tid / 16, tx = tid % 16;
  // P.V: thread (rg, cg) owns rows rg + kRowGroups * a and columns 4 cg .. 4 cg + 3
  const int cg = tid % kColGroups, rg = tid / kColGroups;
  float o[kRowsPT][4];
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[a][e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kTile;
    // wkr rows the tile pair reads: t = j + W - 1 - i for j <= i lies in
    // [base, base + 2 kTile - 2]; rows past W - 1 belong to masked pairs and
    // rows below 0 to query rows past W (a tail tile)
    const int base = W - kTile - i0 + j0;
    __syncthreads();  // the previous tile's readers are done
    load_rows<DH>(s_k, k + row0 * HD + h * DH, HD, j0, kTile, W);
    load_rows<DH>(s_v, v + row0 * HD + h * DH, HD, j0, kTile, W);
    load_rows<DH>(s_r, wkr + h * DH, HD, base, 2 * kTile, W);
    if (tid < kTile) s_pad[tid] = j0 + tid < W ? pad[row0 + j0 + tid] : 1;
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 2
    for (int w = 0; w < DH / 2; ++w) {
      float2 qu[4], qv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qu[a] = unpack(s_qu[(4 * ty + a) * RW + w]);
        qv[a] = unpack(s_qv[(4 * ty + a) * RW + w]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 kk = unpack(s_k[(tx + 16 * c) * RW + w]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][c] = fmaf(qu[a].x, kk.x, acc[a][c]);
          acc[a][c] = fmaf(qu[a].y, kk.y, acc[a][c]);
          // window row of (i, j): 63 - (i - i0) + (j - j0)
          const float2 rr = unpack(s_r[(kTile - 1 - 4 * ty - a + tx + 16 * c) * RW + w]);
          acc[a][c] = fmaf(qv[a].x, rr.x, acc[a][c]);
          acc[a][c] = fmaf(qv[a].y, rr.y, acc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ii = 4 * ty + a, jj = tx + 16 * c;
        const bool masked = j0 + jj > i0 + ii || s_pad[jj] != 0;
        s_s[ii * kScoreStride + jj] = masked ? -1e9f : acc[a][c] * scale;
      }
    __syncthreads();

    // online softmax, 4 threads per query row, 16 columns each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = s_s + r * kScoreStride + 16 * part;
      const float m_old = s_m[r];
      float mx = -INFINITY;
#pragma unroll
      for (int x = 0; x < 16; ++x) mx = fmaxf(mx, row[x]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float e = expf(row[x] - m_new);
        row[x] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        s_a[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + p . V
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a) {
      const float alpha = s_a[rg + kRowGroups * a];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[a][e] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float2 v01 = unpack(s_v[j * RW + 2 * cg]);
      const float2 v23 = unpack(s_v[j * RW + 2 * cg + 1]);
#pragma unroll
      for (int a = 0; a < kRowsPT; ++a) {
        const float p = s_s[(rg + kRowGroups * a) * kScoreStride + j];
        o[a][0] = fmaf(p, v01.x, o[a][0]);
        o[a][1] = fmaf(p, v01.y, o[a][1]);
        o[a][2] = fmaf(p, v23.x, o[a][2]);
        o[a][3] = fmaf(p, v23.y, o[a][3]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRowsPT; ++a) {
    const int r = rg + kRowGroups * a;
    if (i0 + r >= W) continue;  // a tail tile's rows past W
    const float inv = 1.f / s_l[r];
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (row0 + i0 + r) * HD + h * DH + 4 * cg);
    dst[0] = pack(o[a][0] * inv, o[a][1] * inv);
    dst[1] = pack(o[a][2] * inv, o[a][3] * inv);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* wkr,
                   const void* u, const void* vb, const uint8_t* pad, void* out, int B,
                   int W, int H, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, H, B);
  flash_prefill_kernel<DH><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(wkr),
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(vb), pad, W,
      H, scale, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out = causal TXL attention of (q, k, v, wkr, u, vb) under the key pad mask.
// Pointers are device pointers into contiguous tensors: q, k, v, out
// (B, W, H*Dh) bf16; wkr (W, H*Dh) bf16; u, vb (H*Dh) bf16; pad (B, W) bytes
// (nonzero = left padding). Needs W >= 1 and Dh in {16, 32, 64, 128}.
// Returns the CUDA error of the launch (0 = cudaSuccess); does not synchronize.
int flash_prefill_fwd(const void* q, const void* k, const void* v, const void* wkr,
                      const void* u, const void* vb, const uint8_t* pad, void* out, int B,
                      int W, int H, int Dh, float scale, void* stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 16: return launch<16>(q, k, v, wkr, u, vb, pad, out, B, W, H, scale, st);
    case 32: return launch<32>(q, k, v, wkr, u, vb, pad, out, B, W, H, scale, st);
    case 64: return launch<64>(q, k, v, wkr, u, vb, pad, out, B, W, H, scale, st);
    case 128: return launch<128>(q, k, v, wkr, u, vb, pad, out, B, W, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
