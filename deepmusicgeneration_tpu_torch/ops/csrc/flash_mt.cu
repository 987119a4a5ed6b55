// Differentiable relative attention of the multitask model's training step,
// forward and backward, without writing the (B, H, L, K) scores to device
// memory: the encoder's bidirectional self-attention and the decoder's cross
// attention to the encoder output.
//
// Replaces the TPU kernels of deepmusicgeneration_tpu/ops/flash_train.py::
// flash_bidir_attention and flash_cross_attention (_make_flash_mt: the
// forward pallas_call built by _make_bidir_fwd_kernel / _make_cross_fwd_kernel
// and the backward one built by _make_bidir_bwd_kernel /
// _make_cross_bwd_kernel) and computes the same functions, per batch row b
// and head h, with qu = bf16(q + u), qv = bf16(q + v) (f32 add), the band row
// w(i, j) = wkr[(j + L - 1 - i) mod K] and f32 sums:
//
//   bidir (L == K = W, key padding kp):
//     BD[i, j] = qv_i . w(i, j)           for j <= i
//              = 0                         for j == i + 1
//              = qv_{i+1} . w(i + 1, j)    for j >= i + 2   (the rel_shift spill)
//     s = (qu . k^T + BD) * scale, -1e9 where kp[b, j]
//   cross (K >= L, no mask at all):
//     BD[i, j] = qv_i . w(i, j) where j <= i + K - L, else 0
//     s = (qu . k^T + BD) * scale
//   p = softmax_j(s),  pd = p * keep(b, h, i, j),  out_i = bf16(pd) . V
//
// keep is the TPU kernels' counter hash over the (L, K) grid (flash_common.cuh).
//
// The skew is computed as in flash_train.cu: a (64-query, 64-key) tile pair
// (i0, j0) reads a band of 128 wkr rows from band_first(L, K, i0, j0), on
// which w(i, j) is row j - i + 63; one tensor-core product of 16 query rows
// by 64 band rows per warp, each score placed on its (i, j) through shared
// memory. The spill reads the NEXT query row: w(i + 1, j) is row j - i + 62,
// and its product takes qv rows i + 1 .., so each query tile keeps 65 qv
// rows (the next tile's first; zero after the last). Its rows run from -1
// (i = 63, j = 0) to 125, the causal ones from 0 to 126, so the
// bidirectional kernels read the band from one row earlier. A tile pair
// below the diagonal (j0 < i0) is all causal, one above it (j0 > i0) all
// spill, and on the diagonal the warps on the lower band half take the
// causal entries and those on the upper half the spill: every warp does one
// product either way, as in flash_train.cu.
//
// Forward (flash_mt_fwd_kernel), one block per (64-query tile, head, batch
// row): two passes over the key tiles (row max and sum online, then the
// normalised, dropped-out, bf16-rounded probabilities times V), saving each
// row's max and sum.
//
// Backward: dS = P * (keep * dP - delta) * scale, dP = dO . V^T, delta =
// sum_d dO * O taken in f32 by the caller from the bf16 output, P recomputed
// from the saved statistics by the same score code, bit for bit.
//   - flash_mt_dkdv_kernel, one block per (64-key tile, head, batch row):
//     dV += bf16(Pd)^T dO, dK += bf16(dS)^T qu, in registers.
//   - flash_mt_dq_kernel, one block per (64-query tile, head, batch row):
//     dQ += bf16(dS) K + dBD band, dWkr += dBD^T qv. dBD is bf16(dS) placed
//     on the band by the qv row it multiplies: row p holds the causal entries
//     of query row p and the spill entries of query row p - 1 (the two sets
//     are disjoint, as in the TPU kernel's _unskew_bidir). With the spill, a
//     query tile's dS reaches qv row i0 + 64, the next tile's first: the
//     block computes that row's dQv too (a 16-row product of which one row
//     is live) and hands it over in f32 (`seam.carry`), and writes its own
//     first row in f32 (`seam.head`); flash_mt_seam_kernel adds the two and
//     rounds. dWkr, du and dv: per-(batch row, query tile) partial slots,
//     summed in a fixed order (partials_reduce_kernel), so a backward is
//     reproducible bit for bit.
//
// Bound. At the flagship's multitask train shape (B 16, W = L = K = 512, 8 x
// 64 heads, bf16) the forward reads q, k, v, wkr (~25 MB) and its three
// products over the B H L K pairs take 12.9 GFLOP, ~13 us at the bf16
// tensor-core peak: operations bound it; the backward's eight take 34.4
// GFLOP, ~35 us. This version recomputes the scores in every pass and the
// band products over all 128 band rows, half of which a pair uses (7 and 15
// dense 64 x 64 x Dh products a tile pair against the function's 3 and 8),
// at mma.sync's rate, below wgmma's; wgmma/TMA pipelines are later work.

#include "flash_common.cuh"

namespace {

struct MtParams {
  const bf16 *q, *k, *v, *wkr, *u, *vb;   // (B,L,HD) (B,K,HD) x2 (K,HD) (HD) x2
  const int* kp;                           // (B,K) key padding, bidir only
  int B, L, K, H;
  float scale;
  uint32_t seed;       // attention seed as uint32
  int thresh;          // keep where the mix, as int32, exceeds it
  float keep_scale;    // 1 / (1 - p) in f32
  bool dropout;
};

__device__ __forceinline__ float keep_factor(const MtParams& a, int b, int h, int i, int j) {
  return a.dropout ? hash_keep(a.seed, a.thresh, a.keep_scale, b, h, i, a.K, j) : 1.f;
}

// qv rows a query tile keeps: its 64, the next tile's first (the spill), and
// zero rows up to a multiple of 16 for the dWkr product over 65 rows.
template <bool BIDIR>
__host__ __device__ constexpr int q_rows() { return BIDIR ? kTile + 16 : kTile; }

// The qu / qv tile of query rows i0 .. (the next tile's first too, for the
// bidirectional spill; zero past L).
template <int DH, bool BIDIR>
__device__ void load_q_tile(bf16* s_qu, bf16* s_qv, const MtParams& a, int b, int h, int i0) {
  const int HD = a.H * DH;
  load_q_biased<DH>(s_qu, s_qv, a.q + (size_t)b * a.L * HD + h * DH, a.u + h * DH,
                    a.vb + h * DH, HD, a.L, i0, BIDIR ? kTile + 1 : kTile);
}

// The key tile's pad flags (bidir): s_kp[c] = kp[b, j0 + c].
template <bool BIDIR>
__device__ void load_pad(int* s_kp, const MtParams& a, int b, int j0) {
  if (BIDIR && threadIdx.x < kTile) s_kp[threadIdx.x] = a.kp[(size_t)b * a.K + j0 + threadIdx.x] != 0;
}

// The rows the bidirectional kernels' band starts before band_first: one.
template <bool BIDIR>
__host__ __device__ constexpr int band_lead() { return BIDIR ? 1 : 0; }

// The first wkr row of the band a tile pair reads into shared memory: the
// score (i, j) of qv row p (i, or i + 1 for the spill) sits on its row
// j - p + 63 + band_lead.
template <bool BIDIR>
__device__ __forceinline__ int band_start(const MtParams& a, int i0, int j0) {
  return (band_first(a.L, a.K, i0, j0) - band_lead<BIDIR>() + a.K) % a.K;
}

// This warp's band product of the tile pair (i0, j0): band rows xb ..
// xb + 63 against qv rows i + sp (sp = 1: the spill). Warps on band half
// bb = 0 or 64.
struct BandPart {
  int xb, sp;
};

template <bool BIDIR>
__device__ __forceinline__ BandPart band_part(int i0, int j0, int bb) {
  if (!BIDIR) return {bb, 0};
  if (j0 != i0) return {bb, j0 > i0 ? 1 : 0};
  return bb == 0 ? BandPart{1, 0} : BandPart{kTile, 1};   // the diagonal: j <= i, j > i
}

// Is BD[i, j] of the tile pair zero (bidir: the column after the diagonal;
// cross: above the band j <= i + K - L)? Global indices.
template <bool BIDIR>
__device__ __forceinline__ bool bd_zero(const MtParams& a, int gi, int gj) {
  return BIDIR ? gj == gi + 1 : gj > gi + (a.K - a.L);
}

// The scores of a tile pair before masking, s = qu . k^T + BD (f32), as this
// warp's fragments (4 column blocks of 8). BD goes through s_bd (64 x kSS
// f32): each warp computes its 16 rows x 64 band rows of qv . band^T (qv rows
// shifted by one for the spill, band_part) and stores each band score at the
// (i, j) it belongs to: j = band row + i + sp - 63 - band_lead. Every kernel
// forms its scores with this function, so the backward recomputes the
// forward's bits. The only entries nobody stores (bidir: (i, i + 1) on the
// diagonal tile pair) are among those bd_zero selects away. The caller syncs
// before s_bd is written again.
template <int DH, bool BIDIR>
__device__ __forceinline__ void scores(const MtParams& a, const bf16* s_qu, const bf16* s_qv,
                                       const bf16* s_k, const bf16* s_r, float* s_bd, int i0,
                                       int j0, float (&s)[4][4]) {
  constexpr int SQ = stride<DH>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rb = warp_row0(), cb = warp_col0();
  zero(s);
  warp_mma<DH, 4, false, true>(s, s_qu + rb * SQ, SQ, s_k + cb * SQ, SQ);
  {
    float bd[8][4];
    zero(bd);
    const BandPart bp = band_part<BIDIR>(i0, j0, 2 * cb);   // band half 64 (w / 4) ..
    warp_mma<DH, 8, false, true>(bd, s_qv + (rb + bp.sp) * SQ, SQ, s_r + bp.xb * SQ, SQ);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb + g + 8 * (e >> 1);
        const int j = bp.xb + nb * 8 + t2 + (e & 1) + i + bp.sp - (kTile - 1) - band_lead<BIDIR>();
        if (j >= 0 && j < kTile) s_bd[i * kSS + j] = bd[nb][e];
      }
  }
  __syncthreads();
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
      const float bd = s_bd[i * kSS + j];
      s[nb][e] += bd_zero<BIDIR>(a, i0 + i, j0 + j) ? 0.f : bd;
    }
}

// The masked, scaled score: -1e9 on a padded key (bidir), no mask (cross).
// __fmul_rn keeps nvcc from contracting it differently in different kernels.
__device__ __forceinline__ float masked(float acc, float scale, int pad) {
  return pad ? -1e9f : __fmul_rn(acc, scale);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DH, bool BIDIR>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)2 * q_rows<BIDIR>() * stride<DH>() * 2 + (size_t)2 * kTile * stride<DH>() * 2 +
         (size_t)kBand * stride<DH>() * 2 + (size_t)kTile * kSP * 2 + (size_t)kTile * kSS * 4 +
         (size_t)2 * kTile * 4 + (size_t)kTile * 4;
}

// grid (L / 64, H, B). out (B, L, HD) bf16; m, l (B, H, L) f32: each query
// row's softmax max and sum.
template <int DH, bool BIDIR>
__global__ void __launch_bounds__(kThreads)
flash_mt_fwd_kernel(MtParams a, bf16* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out) {
  constexpr int SQ = stride<DH>();
  constexpr int NO = DH / 16;                        // P.V column blocks a warp
  constexpr int QR = q_rows<BIDIR>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_qu = reinterpret_cast<bf16*>(smem);
  bf16* s_qv = s_qu + QR * SQ;
  bf16* s_k = s_qv + QR * SQ;
  bf16* s_v = s_k + kTile * SQ;
  bf16* s_r = s_v + kTile * SQ;
  bf16* s_p = s_r + kBand * SQ;
  float* s_s = reinterpret_cast<float*>(s_p + kTile * kSP);   // band scores, then scores
  float* s_m = s_s + kTile * kSS;
  float* s_l = s_m + kTile;
  int* s_kp = reinterpret_cast<int*>(s_l + kTile);

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int HD = a.H * DH;
  const int i0 = qt * kTile;
  const int nk = a.K / kTile;
  const int rb = warp_row0(), cb = warp_col0();
  const bf16* kb = a.k + (size_t)b * a.K * HD + h * DH;
  const bf16* vbase = a.v + (size_t)b * a.K * HD + h * DH;

  load_q_tile<DH, BIDIR>(s_qu, s_qv, a, b, h, i0);
  if (tid < kTile) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
    s_kp[tid] = 0;
  }

  // pass 1: each row's max and sum, online
  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * kTile;
    __syncthreads();
    load_rows<DH>(s_k, kb, HD, j0, kTile, a.K);
    load_rows<DH>(s_r, a.wkr + h * DH, HD, band_start<BIDIR>(a, i0, j0), kBand, a.K);
    load_pad<BIDIR>(s_kp, a, b, j0);
    __syncthreads();
    float s[4][4];
    scores<DH, BIDIR>(a, s_qu, s_qv, s_k, s_r, s_s, i0, j0, s);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
        // each thread overwrites only the band scores it read
        s_s[i * kSS + j] = masked(s[nb][e], a.scale, s_kp[j]);
      }
    __syncthreads();
    update_row_stats(s_s, s_m, s_l);
  }

  // pass 2: normalised, dropped-out, bf16-rounded probabilities times V
  float o[NO][4];
  zero(o);
  const int oc = (DH / 2) * (tid >> 7);              // this warp's output columns
  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * kTile;
    __syncthreads();
    load_rows<DH>(s_k, kb, HD, j0, kTile, a.K);
    load_rows<DH>(s_v, vbase, HD, j0, kTile, a.K);
    load_rows<DH>(s_r, a.wkr + h * DH, HD, band_start<BIDIR>(a, i0, j0), kBand, a.K);
    load_pad<BIDIR>(s_kp, a, b, j0);
    __syncthreads();
    float s[4][4];
    scores<DH, BIDIR>(a, s_qu, s_qv, s_k, s_r, s_s, i0, j0, s);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = rb + g + 4 * e, j = cb + nb * 8 + t2;
        float p2[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const float sm = masked(s[nb][e + d], a.scale, s_kp[j + d]);
          p2[d] = __fmul_rn(prob(sm, s_m[i], s_l[i]), keep_factor(a, b, h, i0 + i, j0 + j + d));
        }
        *reinterpret_cast<uint32_t*>(s_p + i * kSP + j) = pack(p2[0], p2[1]);
      }
    __syncthreads();
    warp_mma<kTile, NO, false, false>(o, s_p + rb * kSP, kSP, s_v + oc, SQ);
  }

  store_bf16(out + ((size_t)b * a.L + i0 + rb) * HD + h * DH + oc, HD, o);
  if (tid < kTile) {
    const size_t row = ((size_t)b * a.H + h) * a.L + i0 + tid;
    m_out[row] = s_m[tid];
    l_out[row] = s_l[tid];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct Grads {
  const bf16* dout;            // (B, L, HD)
  const float* delta;          // (B, L, H): sum_d dO * O
  const float *m, *l;          // (B, H, L): the forward's row max and sum
};

// The query tile's rows: the biased q, dO and the row statistics.
template <int DH, bool BIDIR>
__device__ void load_query_side(bf16* s_qu, bf16* s_qv, bf16* s_do, float* s_m, float* s_l,
                                float* s_dl, const MtParams& a, const Grads& g, int b, int h,
                                int i0) {
  const int HD = a.H * DH;
  load_q_tile<DH, BIDIR>(s_qu, s_qv, a, b, h, i0);
  load_rows<DH>(s_do, g.dout + (size_t)b * a.L * HD + h * DH, HD, i0, kTile, a.L);
  if (threadIdx.x < kTile) {
    const int i = i0 + threadIdx.x;
    const size_t row = ((size_t)b * a.H + h) * a.L + i;
    s_m[threadIdx.x] = g.m[row];
    s_l[threadIdx.x] = g.l[row];
    s_dl[threadIdx.x] = g.delta[((size_t)b * a.L + i) * a.H + h];
  }
}

// p, then dS = p * (keep * dP - delta) * scale, as the TPU kernel forms them,
// for this warp's fragment elements (i, j): calls f(i, j, dS, p * keep).
template <typename F>
__device__ __forceinline__ void for_ds(const MtParams& a, int b, int h, int i0, int j0,
                                       const float (&s)[4][4], const float (&dp)[4][4],
                                       const float* s_m, const float* s_l, const float* s_dl,
                                       const int* s_kp, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rb = warp_row0(), cb = warp_col0();
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
      const float p = prob(masked(s[nb][e], a.scale, s_kp[j]), s_m[i], s_l[i]);
      const float kf = keep_factor(a, b, h, i0 + i, j0 + j);
      const float t = __fsub_rn(__fmul_rn(kf, dp[nb][e]), s_dl[i]);
      f(i, j, __fmul_rn(__fmul_rn(p, t), a.scale), __fmul_rn(p, kf));
    }
}

template <int DH, bool BIDIR>
__host__ __device__ constexpr size_t dkdv_smem() {
  return (size_t)2 * q_rows<BIDIR>() * stride<DH>() * 2 + (size_t)3 * kTile * stride<DH>() * 2 +
         (size_t)kBand * stride<DH>() * 2 + (size_t)2 * kTile * kSP * 2 +
         (size_t)kTile * kSS * 4 + (size_t)3 * kTile * 4 + (size_t)kTile * 4;
}

// grid (K / 64, H, B): dK, dV of one key tile, (B, K, HD) bf16.
template <int DH, bool BIDIR>
__global__ void __launch_bounds__(kThreads)
flash_mt_dkdv_kernel(MtParams a, Grads g, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int SQ = stride<DH>();
  constexpr int NO = DH / 16;
  constexpr int QR = q_rows<BIDIR>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + kTile * SQ;
  bf16* s_qu = s_v + kTile * SQ;
  bf16* s_qv = s_qu + QR * SQ;
  bf16* s_do = s_qv + QR * SQ;
  bf16* s_r = s_do + kTile * SQ;
  bf16* s_ds = s_r + kBand * SQ;
  bf16* s_pd = s_ds + kTile * kSP;
  float* s_bd = reinterpret_cast<float*>(s_pd + kTile * kSP);
  float* s_m = s_bd + kTile * kSS;
  float* s_l = s_m + kTile;
  float* s_dl = s_l + kTile;
  int* s_kp = reinterpret_cast<int*>(s_dl + kTile);

  const int tid = threadIdx.x;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int HD = a.H * DH;
  const int j0 = kt * kTile;
  const int nq = a.L / kTile;
  const int rb = warp_row0(), cb = warp_col0();
  load_rows<DH>(s_k, a.k + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
  load_rows<DH>(s_v, a.v + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
  if (tid < kTile) s_kp[tid] = 0;
  load_pad<BIDIR>(s_kp, a, b, j0);

  const int oc = (DH / 2) * (tid >> 7);              // this warp's dK / dV columns
  float ak[NO][4], av[NO][4];
  zero(ak);
  zero(av);
  for (int qt = 0; qt < nq; ++qt) {
    const int i0 = qt * kTile;
    __syncthreads();
    load_query_side<DH, BIDIR>(s_qu, s_qv, s_do, s_m, s_l, s_dl, a, g, b, h, i0);
    load_rows<DH>(s_r, a.wkr + h * DH, HD, band_start<BIDIR>(a, i0, j0), kBand, a.K);
    __syncthreads();
    {
      float s[4][4], dp[4][4];
      scores<DH, BIDIR>(a, s_qu, s_qv, s_k, s_r, s_bd, i0, j0, s);
      zero(dp);
      warp_mma<DH, 4, false, true>(dp, s_do + rb * SQ, SQ, s_v + cb * SQ, SQ);
      for_ds(a, b, h, i0, j0, s, dp, s_m, s_l, s_dl, s_kp,
             [&](int i, int j, float ds, float pd) {
               s_ds[i * kSP + j] = __float2bfloat16_rn(ds);
               s_pd[i * kSP + j] = __float2bfloat16_rn(pd);
             });
    }
    __syncthreads();
    // dV += Pd^T dO, dK += dS^T qu: this warp's key rows rb .., columns oc ..
    warp_mma<kTile, NO, true, false>(av, s_pd + rb, kSP, s_do + oc, SQ);
    warp_mma<kTile, NO, true, false>(ak, s_ds + rb, kSP, s_qu + oc, SQ);
  }
  const size_t off = ((size_t)b * a.K + j0 + rb) * HD + h * DH + oc;
  store_bf16(dk + off, HD, ak);
  store_bf16(dv + off, HD, av);
}

struct Seam {
  float* head;     // (B * L / 64, HD): dQ of each query tile's first row, f32 (bidir)
  float* carry;    // (B * L / 64, HD): the spill's dQv of the row after the tile
};

template <int DH, bool BIDIR>
__host__ __device__ constexpr size_t dq_smem() {
  return (size_t)2 * q_rows<BIDIR>() * stride<DH>() * 2 + (size_t)3 * kTile * stride<DH>() * 2 +
         (size_t)kBand * stride<DH>() * 2 + (size_t)kTile * kSP * 2 +
         (size_t)q_rows<BIDIR>() * kSB * 2 + (size_t)kTile * kSS * 4 + (size_t)3 * kTile * 4 +
         (size_t)kTile * 4;
}

// grid (L / 64, H, B): dQ of one query tile, (B, L, HD) bf16, and its
// partial sums of dWkr, du and dv (bidir: the tile's first row and the carry
// to the next tile in f32, for flash_mt_seam_kernel).
template <int DH, bool BIDIR>
__global__ void __launch_bounds__(kThreads)
flash_mt_dq_kernel(MtParams a, Grads g, bf16* __restrict__ dq, Partials part, Seam seam) {
  constexpr int SQ = stride<DH>();
  constexpr int NO = DH / 16;                        // dQ column blocks a warp
  constexpr int NW = DH / 8;                         // dWkr column blocks a warp
  constexpr int QR = q_rows<BIDIR>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_qu = reinterpret_cast<bf16*>(smem);
  bf16* s_qv = s_qu + QR * SQ;
  bf16* s_do = s_qv + QR * SQ;
  bf16* s_k = s_do + kTile * SQ;
  bf16* s_v = s_k + kTile * SQ;
  bf16* s_r = s_v + kTile * SQ;
  bf16* s_ds = s_r + kBand * SQ;
  bf16* s_dbd = s_ds + kTile * kSP;   // dBD on the band: [qv row p][j - p + 63 + band_lead]
  float* s_bd = reinterpret_cast<float*>(s_dbd + QR * kSB);
  float* s_m = s_bd + kTile * kSS;
  float* s_l = s_m + kTile;
  float* s_dl = s_l + kTile;
  int* s_kp = reinterpret_cast<int*>(s_dl + kTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int HD = a.H * DH;
  const int i0 = qt * kTile;
  const int nk = a.K / kTile;
  const int rb = warp_row0();
  const size_t slot = (size_t)b * (a.L / kTile) + qt;
  float* pw = part.w + slot * a.K * HD + h * DH;
  load_query_side<DH, BIDIR>(s_qu, s_qv, s_do, s_m, s_l, s_dl, a, g, b, h, i0);
  // band entries off a row's 64 keys stay zero in every tile, as do the qv
  // and dBD rows past the 65 the spill uses
  for (int x = tid; x < QR * kSB / 2; x += kThreads) reinterpret_cast<uint32_t*>(s_dbd)[x] = 0u;
  if (BIDIR)
    for (int x = tid; x < (QR - kTile - 1) * SQ; x += kThreads)
      s_qv[(kTile + 1) * SQ + x] = __float2bfloat16_rn(0.f);
  if (tid < kTile) s_kp[tid] = 0;

  const int oc = (DH / 2) * (tid >> 7);
  float aqu[NO][4], aqv[NO][4], acar[NO][4], aw[NW][4];
  zero(aqu);
  zero(aqv);
  zero(acar);
  zero(aw);
  // this warp's 16 wkr rows: band rows 16 ((warp - 4 kt) mod 8) ..; the
  // upper half's rows are the next tile's lower half, kept by the same warp
  auto band_block = [&](int kt) { return (warp - 4 * (kt & 1) + 8) & 7; };
  auto store_rows = [&](int first, int blk, bool add) {
#pragma unroll
    for (int nb = 0; nb < NW; ++nb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int t = first + 16 * blk + g8 + 8 * half;
        if (t >= a.K) t -= a.K;
        float2* dst = reinterpret_cast<float2*>(pw + (size_t)t * HD + nb * 8 + t2);
        float2 v = make_float2(aw[nb][2 * half], aw[nb][2 * half + 1]);
        if (add) {
          const float2 old = *dst;
          v = make_float2(old.x + v.x, old.y + v.y);
        }
        *dst = v;
      }
  };

  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * kTile;
    const int first = band_start<BIDIR>(a, i0, j0);
    __syncthreads();
    load_rows<DH>(s_k, a.k + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
    load_rows<DH>(s_v, a.v + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
    load_rows<DH>(s_r, a.wkr + h * DH, HD, first, kBand, a.K);
    load_pad<BIDIR>(s_kp, a, b, j0);
    if (BIDIR)   // rows 0 and 64 hold entries of the neighbouring tiles' rows: none here
      for (int x = tid; x < kBand; x += kThreads) {
        s_dbd[x] = __float2bfloat16_rn(0.f);
        s_dbd[kTile * kSB + x] = __float2bfloat16_rn(0.f);
      }
    __syncthreads();
    {
      float s[4][4], dp[4][4];
      scores<DH, BIDIR>(a, s_qu, s_qv, s_k, s_r, s_bd, i0, j0, s);
      zero(dp);
      warp_mma<DH, 4, false, true>(dp, s_do + rb * SQ, SQ, s_v + warp_col0() * SQ, SQ);
      for_ds(a, b, h, i0, j0, s, dp, s_m, s_l, s_dl, s_kp,
             [&](int i, int j, float ds, float) {
               const bf16 v = __float2bfloat16_rn(ds);
               const int gi = i0 + i, gj = j0 + j;
               s_ds[i * kSP + j] = v;
               if (!BIDIR)
                 s_dbd[i * kSB + j - i + kTile - 1] =
                     bd_zero<false>(a, gi, gj) ? __float2bfloat16_rn(0.f) : v;
               else if (gj <= gi)                       // causal: qv row i
                 s_dbd[i * kSB + j - i + kTile] = v;
               else if (gj >= gi + 2)                   // spill: qv row i + 1
                 s_dbd[(i + 1) * kSB + j - i + kTile - 1] = v;
             });
    }
    __syncthreads();
    // dQ += dS K + dBD band: query rows rb .., columns oc ..
    warp_mma<kTile, NO, false, false>(aqu, s_ds + rb * kSP, kSP, s_k + oc, SQ);
    warp_mma<kBand, NO, false, false>(aqv, s_dbd + rb * kSB, kSB, s_r + oc, SQ);
    if (BIDIR && rb == 0)   // qv rows 64 .. 79: the next tile's first row, the rest zero
      warp_mma<kBand, NO, false, false>(acar, s_dbd + kTile * kSB, kSB, s_r + oc, SQ);
    // dWkr += dBD^T qv on this warp's band rows, over the QR qv rows
    const int blk = band_block(kt);
    warp_mma<QR, NW, true, false>(aw, s_dbd + 16 * blk, kSB, s_qv, SQ);
    if (blk < 4) {                 // complete: the lower half of this tile's band
      store_rows(first, blk, false);
      zero(aw);
    }
  }
  // the last tile's upper half wraps onto the first tile's lower half, which
  // another warp may have written: sync, then add
  __syncthreads();
  if (band_block(nk - 1) >= 4) store_rows(band_start<BIDIR>(a, i0, (nk - 1) * kTile),
                                          band_block(nk - 1), true);

  // dQ (bidir: the first row and the carry in f32 to the seam), and the
  // tile's column sums of dQu and dQv (du, dv partials; dv counts the carry)
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) {
    const int col = h * DH + oc + nb * 8 + t2;
    bf16* dst = dq + ((size_t)b * a.L + i0 + rb) * HD + col;
    if (BIDIR && rb == 0 && g8 == 0) {
      *reinterpret_cast<float2*>(seam.head + slot * HD + col) =
          make_float2(aqu[nb][0] + aqv[nb][0], aqu[nb][1] + aqv[nb][1]);
      *reinterpret_cast<float2*>(seam.carry + slot * HD + col) =
          make_float2(acar[nb][0], acar[nb][1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst + (size_t)g8 * HD) =
          pack(aqu[nb][0] + aqv[nb][0], aqu[nb][1] + aqv[nb][1]);
    }
    *reinterpret_cast<uint32_t*>(dst + (size_t)(g8 + 8) * HD) =
        pack(aqu[nb][2] + aqv[nb][2], aqu[nb][3] + aqv[nb][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) aqv[nb][e] += acar[nb][e];
  }
  // s_bd is free after the sync above
  tile_column_sums<DH, NO>(aqu, aqv, oc, s_bd, part.u + slot * HD + h * DH,
                           part.v + slot * HD + h * DH);
}

// Bidir: dq[b, t * 64] = bf16(head[b, t] + carry[b, t - 1]) for every
// query tile t (no carry into t = 0).
__global__ void __launch_bounds__(kThreads)
flash_mt_seam_kernel(Seam seam, int B, int L, int HD, bf16* __restrict__ dq) {
  const int nq = L / kTile;
  const size_t x = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (x >= (size_t)B * nq * HD) return;
  const size_t slot = x / HD;
  const int c = (int)(x % HD), t = (int)(slot % nq);
  float v = seam.head[x];
  if (t > 0) v += seam.carry[x - HD];
  dq[slot * kTile * HD + c] = __float2bfloat16_rn(v);
}

template <int DH, bool BIDIR>
cudaError_t launch_fwd(const MtParams& a, void* out, float* m, float* l, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<DH, BIDIR>();
  cudaError_t err = set_smem(flash_mt_fwd_kernel<DH, BIDIR>, smem);
  if (err != cudaSuccess) return err;
  flash_mt_fwd_kernel<DH, BIDIR><<<dim3(a.L / kTile, a.H, a.B), kThreads, smem, st>>>(
      a, static_cast<bf16*>(out), m, l);
  return cudaGetLastError();
}

template <int DH, bool BIDIR>
cudaError_t launch_bwd(const MtParams& a, const Grads& g, void* dq, void* dk, void* dv,
                       Partials part, Seam seam, float* dwkr, float* du, float* dvb,
                       cudaStream_t st) {
  cudaError_t err = set_smem(flash_mt_dkdv_kernel<DH, BIDIR>, dkdv_smem<DH, BIDIR>());
  if (err != cudaSuccess) return err;
  err = set_smem(flash_mt_dq_kernel<DH, BIDIR>, dq_smem<DH, BIDIR>());
  if (err != cudaSuccess) return err;
  flash_mt_dkdv_kernel<DH, BIDIR>
      <<<dim3(a.K / kTile, a.H, a.B), kThreads, dkdv_smem<DH, BIDIR>(), st>>>(
          a, g, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_mt_dq_kernel<DH, BIDIR>
      <<<dim3(a.L / kTile, a.H, a.B), kThreads, dq_smem<DH, BIDIR>(), st>>>(
          a, g, static_cast<bf16*>(dq), part, seam);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int HD = a.H * DH;
  if (BIDIR) {
    const size_t n = (size_t)a.B * (a.L / kTile) * HD;
    flash_mt_seam_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        seam, a.B, a.L, HD, static_cast<bf16*>(dq));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_reduce(part, a.B * (a.L / kTile), a.K, HD, dwkr, du, dvb, st);
}

MtParams make_params(const void* q, const void* k, const void* v, const void* wkr,
                     const void* u, const void* vb, const int* kp, int B, int L, int K, int H,
                     float scale, int dropout, uint32_t seed, int thresh, float keep_scale) {
  MtParams a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.wkr = static_cast<const bf16*>(wkr);
  a.u = static_cast<const bf16*>(u);
  a.vb = static_cast<const bf16*>(vb);
  a.kp = kp;
  a.B = B;
  a.L = L;
  a.K = K;
  a.H = H;
  a.scale = scale;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.dropout = dropout != 0;
  return a;
}

// bidir: a square grid; cross: K >= L. K >= kBand: a tile pair's band of wkr
// rows wraps around K at most once.
bool shapes_ok(int bidir, int B, int L, int K, int H, const int* kp) {
  return B > 0 && H > 0 && L > 0 && L % kTile == 0 && K % kTile == 0 && K >= kBand &&
         (bidir ? (K == L && kp != nullptr) : K >= L);
}

}  // namespace

extern "C" {

const char* flash_mt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward. bidir != 0: the bidirectional kernel (L == K, kp (B, K) int32 key
// padding); else the cross kernel (K >= L, kp unused). Device pointers into
// contiguous tensors: q, out (B, L, H*Dh) bf16; k, v (B, K, H*Dh) bf16; wkr
// (K, H*Dh) bf16; u, vb (H*Dh) bf16; m, l (B, H, L) f32 out. Needs L, K
// multiples of 64, K >= 128, Dh in {32, 64}. dropout != 0 switches dropout
// on: keep where the hash of seed + b CB + (h + 1) CH + i K + j, as int32,
// exceeds thresh, and scale the kept probabilities by keep_scale. Returns the
// CUDA error of the launch (0 = cudaSuccess); does not synchronize.
int flash_mt_fwd(int bidir, const void* q, const void* k, const void* v, const void* wkr,
                 const void* u, const void* vb, const int* kp, void* out, float* m, float* l,
                 int B, int L, int K, int H, int Dh, float scale, int dropout, uint32_t seed,
                 int thresh, float keep_scale, void* stream) {
  if (!shapes_ok(bidir, B, L, K, H, kp)) return (int)cudaErrorInvalidValue;
  const MtParams a = make_params(q, k, v, wkr, u, vb, kp, B, L, K, H, scale, dropout, seed,
                                 thresh, keep_scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh * 2 + (bidir != 0)) {
    case 64: return launch_fwd<32, false>(a, out, m, l, st);
    case 65: return launch_fwd<32, true>(a, out, m, l, st);
    case 128: return launch_fwd<64, false>(a, out, m, l, st);
    case 129: return launch_fwd<64, true>(a, out, m, l, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Backward. The forward's operands, then dout (B, L, H*Dh) bf16, delta
// (B, L, H) f32, the forward's m, l; out: dq (B, L, H*Dh), dk, dv (B, K,
// H*Dh) bf16, dwkr (K, H*Dh), du, dvb (H*Dh) f32; scratch: part_w
// (B * L / 64, K, H*Dh), part_u, part_v, seam_head, seam_carry
// (B * L / 64, H*Dh) f32.
int flash_mt_bwd(int bidir, const void* q, const void* k, const void* v, const void* wkr,
                 const void* u, const void* vb, const int* kp, const void* dout,
                 const float* delta, const float* m, const float* l, void* dq, void* dk,
                 void* dv, float* dwkr, float* du, float* dvb, float* part_w, float* part_u,
                 float* part_v, float* seam_head, float* seam_carry, int B, int L, int K, int H,
                 int Dh, float scale, int dropout, uint32_t seed, int thresh, float keep_scale,
                 void* stream) {
  if (!shapes_ok(bidir, B, L, K, H, kp)) return (int)cudaErrorInvalidValue;
  const MtParams a = make_params(q, k, v, wkr, u, vb, kp, B, L, K, H, scale, dropout, seed,
                                 thresh, keep_scale);
  Grads g;
  g.dout = static_cast<const bf16*>(dout);
  g.delta = delta;
  g.m = m;
  g.l = l;
  Partials part;
  part.w = part_w;
  part.u = part_u;
  part.v = part_v;
  Seam seam;
  seam.head = seam_head;
  seam.carry = seam_carry;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh * 2 + (bidir != 0)) {
    case 64: return launch_bwd<32, false>(a, g, dq, dk, dv, part, seam, dwkr, du, dvb, st);
    case 65: return launch_bwd<32, true>(a, g, dq, dk, dv, part, seam, dwkr, du, dvb, st);
    case 128: return launch_bwd<64, false>(a, g, dq, dk, dv, part, seam, dwkr, du, dvb, st);
    case 129: return launch_bwd<64, true>(a, g, dq, dk, dv, part, seam, dwkr, du, dvb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
