// Bidirectional relative self-attention of the multitask encoder's
// inference forward (encode), without writing the (B, H, W, W) scores to
// device memory.
//
// Replaces the TPU kernel deepmusicgeneration_tpu/ops/flash_prefill.py::
// flash_encoder_attention with causal=False (the pallas_call built by
// _make_encoder_kernel). Per batch row b and head h, with qu = bf16(q + u),
// qv = bf16(q + v) (f32 add) and w(i, j) = wkr[(j + W - 1 - i) mod W]:
//
//   BD[i, j] = qv_i . w(i, j)           for j <= i
//            = 0                         for j == i + 1
//            = qv_{i+1} . w(i + 1, j)    for j >= i + 2   (the rel_shift spill)
//   s[i, j]  = (qu_i . k_j + BD[i, j]) * scale, -1e9 where key j is padding
//   out_i    = softmax_j(s[i, :]) . V                       (bf16 out)
//
// Every query row is computed and written, padded ones too: the encoder
// output at a padded position feeds the decoder's cross-attention keys, and
// a row whose keys are all padding averages V over all W keys (the fill is
// the finite -1e9), as the reference does.
//
// The score tiles are those of flash_mt.cu's bidirectional forward (row 12a
// of the port's kernel table, the training version of the same function):
// a (64-query, 64-key) tile pair reads a band of 128 wkr rows on which
// w(i, j) is band row j - i + 64 and the spill's w(i + 1, j) row j - i + 63;
// each query tile keeps 65 qv rows (the next tile's first, zero past W).
// Here W need not be a multiple of 64 or at least 128: band rows are taken
// mod W (the pairs of the last tile read rows past W only for keys or
// queries past W), a tail tile's keys past W get no weight at all (-inf,
// not the padding fill) and its query rows past W are not written.
//
// Numerics against the TPU kernel: the TPU kernel rounds the normalised
// probabilities to bf16 before P.V. Here one pass keeps an online softmax in
// f32 and multiplies V by the unnormalised exponentials split into two bf16
// parts (hi = bf16(e), lo = bf16(e - hi): 16 significant bits) on the tensor
// cores, so the result is the f32 function up to summation order, as the
// causal flash_prefill.cu computes it; the row is divided by its sum at the
// end.
//
// Bound. At B 16, W 512, 8 x 64 heads (the 85M flagship's batched encode)
// the call reads q, k, v, wkr and writes the output, ~34.6 MB (~10 us at
// 3.35 TB/s); its AC, BD and P.V products over the B H W^2 pairs take
// 12.9 GFLOP, ~13 us at the bf16 tensor-core peak: operations bound it.
// This version uses mma.sync (below wgmma's rate), computes the band
// products over all 128 band rows of a pair (half are used) and P.V twice
// (hi and lo parts); wgmma / TMA pipelines are later work.

#include "flash_common.cuh"

namespace {

struct EncParams {
  const bf16 *q, *k, *v, *wkr, *u, *vb;   // (B,W,HD) x3, (W,HD), (HD) x2
  const uint8_t* pad;                      // (B,W), nonzero = padded key
  int B, W, H;
  float scale;
};

constexpr int kQRows = kTile + 16;   // qu / qv rows a query tile keeps (65 used)

// A key's weight class: visible, padding (-1e9, still in the softmax), or
// past W in a tail tile (-inf, no weight).
constexpr int kVisible = 0, kPadded = 1, kOutside = 2;

// Key rows j0 .. j0 + 63 of one head into shared memory; rows past W zero.
template <int DH>
__device__ void load_keys(bf16* dst, const bf16* src, int HD, int j0, int W) {
  constexpr int VPR = DH / 8;
  for (int x = threadIdx.x; x < kTile * VPR; x += kThreads) {
    const int r = x / VPR, c = x % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j0 + r < W) val = *reinterpret_cast<const uint4*>(src + (size_t)(j0 + r) * HD + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * stride<DH>() + 8 * c) = val;
  }
}

// The band of a tile pair: wkr rows (first + r) mod W, r < 128, of one head.
template <int DH>
__device__ void load_band(bf16* dst, const bf16* wkr, int HD, int first, int W) {
  constexpr int VPR = DH / 8;
  for (int x = threadIdx.x; x < kBand * VPR; x += kThreads) {
    const int r = x / VPR, c = x % VPR;
    const int t = (first + r) % W;
    *reinterpret_cast<uint4*>(dst + r * stride<DH>() + 8 * c) =
        *reinterpret_cast<const uint4*>(wkr + (size_t)t * HD + 8 * c);
  }
}

// The pair (i0, j0)'s band starts at wkr row (j0 + W - 65 - i0) mod W: the
// causal score (i, j) sits on band row j - i + 64 (local indices), the
// spill's on j - i + 63.
__device__ __forceinline__ int band_start(int W, int i0, int j0) {
  const int t = (j0 - i0 - kTile - 1) % W;
  return t < 0 ? t + W : t;
}

// The unmasked scores of a tile pair, s = qu . k^T + BD (f32), as this
// warp's fragments (4 column blocks of 8); flash_mt.cu's bidirectional score
// function. Each warp computes its 16 query rows against 64 band rows (the
// spill's products take qv rows one further down) and places each band score
// on its (i, j) through s_bd; below the diagonal every entry of a pair is
// causal, above it every one is spill, and on it the warps on the lower band
// half take j <= i and those on the upper half j > i. The entry (i, i + 1),
// which no warp stores, is zero. The caller syncs before s_bd is written
// again.
template <int DH>
__device__ __forceinline__ void scores(const bf16* s_qu, const bf16* s_qv, const bf16* s_k,
                                       const bf16* s_r, float* s_bd, int i0, int j0,
                                       float (&s)[4][4]) {
  constexpr int SQ = stride<DH>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rb = warp_row0(), cb = warp_col0();
  zero(s);
  warp_mma<DH, 4, false, true>(s, s_qu + rb * SQ, SQ, s_k + cb * SQ, SQ);
  {
    int xb = 2 * cb, sp = j0 > i0 ? 1 : 0;       // band half 0 or 64; spill rows
    if (j0 == i0) {
      xb = cb == 0 ? 1 : kTile;
      sp = cb == 0 ? 0 : 1;
    }
    float bd[8][4];
    zero(bd);
    warp_mma<DH, 8, false, true>(bd, s_qv + (rb + sp) * SQ, SQ, s_r + xb * SQ, SQ);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb + g + 8 * (e >> 1);
        const int j = xb + nb * 8 + t2 + (e & 1) + i + sp - kTile;
        if (j >= 0 && j < kTile) s_bd[i * kSS + j] = bd[nb][e];
      }
  }
  __syncthreads();
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
      s[nb][e] += j0 + j == i0 + i + 1 ? 0.f : s_bd[i * kSS + j];
    }
}

template <int DH>
__host__ __device__ constexpr size_t enc_smem() {
  return (size_t)2 * kQRows * stride<DH>() * 2      // qu, qv
         + (size_t)2 * kTile * stride<DH>() * 2     // k, v
         + (size_t)kBand * stride<DH>() * 2         // wkr band
         + (size_t)2 * kTile * kSP * 2              // exponentials, hi and lo parts
         + (size_t)kTile * kSS * 4                  // band scores, then scores
         + (size_t)3 * kTile * 4                    // row max, sum, rescale
         + (size_t)kTile * 4;                       // key classes
}

// grid (ceil(W / 64), H, B). out (B, W, HD) bf16.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_encoder_kernel(EncParams a, bf16* __restrict__ out) {
  constexpr int SQ = stride<DH>();
  constexpr int NO = DH / 16;                        // P.V column blocks a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_qu = reinterpret_cast<bf16*>(smem);
  bf16* s_qv = s_qu + kQRows * SQ;
  bf16* s_k = s_qv + kQRows * SQ;
  bf16* s_v = s_k + kTile * SQ;
  bf16* s_r = s_v + kTile * SQ;
  bf16* s_ph = s_r + kBand * SQ;
  bf16* s_pl = s_ph + kTile * kSP;
  float* s_s = reinterpret_cast<float*>(s_pl + kTile * kSP);
  float* s_m = s_s + kTile * kSS;
  float* s_l = s_m + kTile;
  float* s_a = s_l + kTile;
  int* s_kc = reinterpret_cast<int*>(s_a + kTile);

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int h = blockIdx.y, b = blockIdx.z;
  const int W = a.W, HD = a.H * DH;
  const int i0 = blockIdx.x * kTile;
  const int nk = (W + kTile - 1) / kTile;
  const int rb = warp_row0(), cb = warp_col0();
  const size_t row0 = (size_t)b * W;
  const bf16* kb = a.k + row0 * HD + h * DH;
  const bf16* vbase = a.v + row0 * HD + h * DH;
  const bf16* wb = a.wkr + h * DH;

  // 65 query rows: the tile's and the next tile's first (the spill), zero past W
  load_q_biased<DH>(s_qu, s_qv, a.q + row0 * HD + h * DH, a.u + h * DH, a.vb + h * DH, HD, W,
                    i0, kTile + 1);
  if (tid < kTile) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float o[NO][4];
  zero(o);
  const int oc = (DH / 2) * (tid >> 7);              // this warp's output columns

  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * kTile;
    __syncthreads();                                 // the previous tile's readers are done
    load_keys<DH>(s_k, kb, HD, j0, W);
    load_keys<DH>(s_v, vbase, HD, j0, W);
    load_band<DH>(s_r, wb, HD, band_start(W, i0, j0), W);
    if (tid < kTile) {
      const int j = j0 + tid;
      s_kc[tid] = j >= W ? kOutside : (a.pad[row0 + j] ? kPadded : kVisible);
    }
    __syncthreads();
    float s[4][4];
    scores<DH>(s_qu, s_qv, s_k, s_r, s_s, i0, j0, s);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
        const int kc = s_kc[j];
        // each thread overwrites only the band scores it read
        s_s[i * kSS + j] = kc == kVisible ? __fmul_rn(s[nb][e], a.scale)
                                          : (kc == kPadded ? -1e9f : -INFINITY);
      }
    __syncthreads();
    // online softmax, 4 threads a row, 16 columns each: the row max, the
    // rescale of what was summed so far, and e = exp(s - max) as hi + lo
    {
      const int r = tid >> 2, part = tid & 3;
      const float* row = s_s + r * kSS + 16 * part;
      const float m_old = s_m[r];
      float mx = -INFINITY;
#pragma unroll
      for (int x = 0; x < 16; ++x) mx = fmaxf(mx, row[x]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);           // finite: key 0 lies in tile 0
      float sum = 0.f;
      bf16* ph = s_ph + r * kSP + 16 * part;
      bf16* pl = s_pl + r * kSP + 16 * part;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float e = expf(row[x] - m_new);
        sum += e;
        const bf16 hi = __float2bfloat16_rn(e);
        ph[x] = hi;
        pl[x] = __float2bfloat16_rn(e - __bfloat162float(hi));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);      // 0 on the first tile
        s_a[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();
    // o = o * alpha + (e_hi + e_lo) . V
    const float a_lo = s_a[rb + g], a_hi = s_a[rb + g + 8];
#pragma unroll
    for (int nb = 0; nb < NO; ++nb) {
      o[nb][0] *= a_lo;
      o[nb][1] *= a_lo;
      o[nb][2] *= a_hi;
      o[nb][3] *= a_hi;
    }
    warp_mma<kTile, NO, false, false>(o, s_ph + rb * kSP, kSP, s_v + oc, SQ);
    warp_mma<kTile, NO, false, false>(o, s_pl + rb * kSP, kSP, s_v + oc, SQ);
  }

  // out = o / l on the rows that exist
  const int r_lo = rb + g, r_hi = r_lo + 8;
  const float inv_lo = 1.f / s_l[r_lo], inv_hi = 1.f / s_l[r_hi];
  bf16* dst = out + (row0 + i0) * HD + h * DH + oc;
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) {
    if (i0 + r_lo < W)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_lo * HD + nb * 8 + t2) =
          pack(o[nb][0] * inv_lo, o[nb][1] * inv_lo);
    if (i0 + r_hi < W)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_hi * HD + nb * 8 + t2) =
          pack(o[nb][2] * inv_hi, o[nb][3] * inv_hi);
  }
}

template <int DH>
cudaError_t launch(const EncParams& a, void* out, cudaStream_t st) {
  constexpr size_t smem = enc_smem<DH>();
  const cudaError_t err = set_smem(flash_encoder_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  flash_encoder_kernel<DH><<<dim3((a.W + kTile - 1) / kTile, a.H, a.B), kThreads, smem, st>>>(
      a, static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_encoder_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out = the bidirectional TXL attention of (q, k, v, wkr, u, vb) under the
// key pad mask, with the rel_shift spill. Device pointers into contiguous
// tensors: q, k, v, out (B, W, H*Dh) bf16; wkr (W, H*Dh) bf16; u, vb (H*Dh)
// bf16; pad (B, W) bytes (nonzero = padded key). Needs W >= 1 and Dh in
// {32, 64}. Returns the CUDA error of the launch (0 = cudaSuccess); does not
// synchronize.
int flash_encoder_fwd(const void* q, const void* k, const void* v, const void* wkr,
                      const void* u, const void* vb, const uint8_t* pad, void* out, int B,
                      int W, int H, int Dh, float scale, void* stream) {
  if (B <= 0 || W <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  EncParams a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.wkr = static_cast<const bf16*>(wkr);
  a.u = static_cast<const bf16*>(u);
  a.vb = static_cast<const bf16*>(vb);
  a.pad = pad;
  a.B = B;
  a.W = W;
  a.H = H;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return launch<32>(a, out, st);
    case 64: return launch<64>(a, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
