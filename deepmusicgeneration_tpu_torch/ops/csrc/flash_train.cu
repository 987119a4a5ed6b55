// Differentiable Transformer-XL attention for training: the window's L
// queries against K = M + L keys ([XL memory, window]), forward and backward,
// without writing the (B, H, L, K) scores to device memory.
//
// Replaces the TPU kernels of deepmusicgeneration_tpu/ops/flash_train.py::
// flash_train_attention (_make_flash_train: the forward pallas_call built by
// _make_fwd_kernel and the backward one built by _make_bwd_kernel) and
// computes the same function, per batch row b and head h:
//
//   qu = bf16(q + u), qv = bf16(q + v)                      (f32 add, per head)
//   s[i, j] = (qu_i . k_j + qv_i . wkr[(j + L - 1 - i) mod K]) * scale    (f32)
//   s[i, j] = -1e9 where cw[j] >= rt[i] or cb[j] or kp[b, j]
//   p = softmax_j(s),  pd = p * keep(b, h, i, j),  out_i = bf16(pd) . V
//
// keep is the TPU kernel's counter hash (_hash_keep): 0 or 1 / (1 - p_drop)
// from a 3-round multiply-xor mix of seed + b * CB + (h + 1) * CH + i * K + j
// in uint32, kept where the mix read as int32 exceeds a threshold. The fill
// stays the finite -1e9, so a row whose keys are all blocked averages V
// uniformly, as on the TPU.
//
// The skew needs no roll. A (64-query, 64-key) tile pair (i0, j0) reads the
// band of 128 wkr rows (j0 + L - 64 - i0 + r) mod K, r < 128: BD[i, j] is band
// row j - i + 63. One tensor-core product qv . band^T gives the tile pair's
// (64 x 128) band scores, and each lands on its (i, j) through shared memory;
// the wrap-around is the index's mod, so the wrapped entries the curriculum
// masks are computed and masked as on the TPU.
//
// Every product is a warp-level bf16 mma.sync (m16n8k16, f32 accumulation)
// fed by ldmatrix from shared memory: the operands are bf16 where the TPU
// kernel's are and their products exact, so only the summation order differs.
//
// Forward (flash_train_fwd_kernel), one block per (64-query tile, head, batch
// row), two passes over 64-key tiles: the first finds each row's max and sum
// (online), the second forms the normalised probabilities, drops out, rounds
// them to bf16 as the TPU kernel does before P.V, and accumulates P.V. It
// saves each row's max and sum for the backward.
//
// Backward: dS = P * (keep * dP - delta) * scale with dP = dO . V^T and delta
// = sum_d dO * O (taken in f32 by the caller), P recomputed from the saved
// row statistics by the same score code, so bit for bit as the forward.
//   - flash_train_dkdv_kernel, one block per (64-key tile, head, batch row),
//     loops over the query tiles: dV += bf16(Pd)^T dO, dK += bf16(dS)^T qu in
//     registers; no atomics;
//   - flash_train_dq_kernel, one block per (64-query tile, head, batch row),
//     loops over the key tiles: dQ += bf16(dS) K + unskew(bf16(dS)) band, and
//     dWkr += unskew(dS)^T qv. Each warp owns 16 wkr rows of the band as it
//     slides 64 rows a key tile (the upper half of one tile's band is the
//     lower half of the next's, so a warp keeps its rows in registers until
//     they are complete) and writes them to a per-(batch row, query tile)
//     partial slot; du and dv likewise;
//   - partials_reduce_kernel (flash_common.cuh) sums the slots in a fixed order, so a
//     training step is reproducible (the TPU kernel adds them over a
//     sequential grid; f32 atomics would vary from run to run).
//
// Bound. At the flagship's train shape (B 16, L 512, K 1024, 12 x 64 heads,
// bf16, causal with full memory) the forward reads q, k, v, wkr (~78 MB) and
// its three products over the pairs the mask leaves visible take 29 GFLOP,
// ~29 us at the bf16 tensor-core peak: operations bound it; the backward's
// eight take 77 GFLOP, ~78 us. This version computes every pair (masked ones
// too), recomputes the scores in each pass (two forward, two backward) and
// the band products over all 128 band rows, half of which a pair uses: 7 and
// 15 dense 64 x 64 x Dh products a tile pair against the function's 3 and 8,
// at mma.sync's rate, below wgmma's. wgmma/TMA pipelines and skipping fully
// masked tiles are later work.

#include "flash_common.cuh"

namespace {

// --- operands ---------------------------------------------------------------

struct Params {
  const bf16 *q, *k, *v, *wkr, *u, *vb;   // (B,L,HD) (B,K,HD) x2 (K,HD) (HD) x2
  const int *rt, *cw, *cb, *kp;            // (L) (K) (K) (B,K)
  int B, L, K, H;
  float scale;
  uint32_t seed;       // attention seed as uint32
  int thresh;          // keep where the mix, as int32, exceeds it
  float keep_scale;    // 1 / (1 - p) in f32
  bool dropout;
};

// The dropout factor of (b, h, i, j): 0 or keep_scale (1 without dropout).
__device__ __forceinline__ float keep_factor(const Params& a, int b, int h, int i, int j) {
  return a.dropout ? hash_keep(a.seed, a.thresh, a.keep_scale, b, h, i, a.K, j) : 1.f;
}

// The qu / qv tile of query rows i0 .. i0 + 63.
template <int DH>
__device__ void load_q_tile(bf16* s_qu, bf16* s_qv, const Params& a, int b, int h, int i0) {
  const int HD = a.H * DH;
  load_q_biased<DH>(s_qu, s_qv, a.q + (size_t)b * a.L * HD + h * DH, a.u + h * DH,
                    a.vb + h * DH, HD, a.L, i0, kTile);
}

// The key tile's column flags: s_cw[c] = cw[j], s_cb[c] = cb[j] | kp[b, j].
__device__ void load_cols(int* s_cw, int* s_cb, const Params& a, int b, int j0) {
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    s_cw[threadIdx.x] = a.cw[j];
    s_cb[threadIdx.x] = (a.cb[j] | a.kp[(size_t)b * a.K + j]) != 0;
  }
}

// The first band row of the tile pair (i0, j0).
__device__ __forceinline__ int band_first(const Params& a, int i0, int j0) {
  return band_first(a.L, a.K, i0, j0);
}

// The scores of a tile pair before masking, s = qu . k^T + BD (f32), as this
// warp's fragments (4 column blocks of 8). BD goes through s_bd (64 x kSS
// f32): each warp computes its 16 rows x 64 band columns of qv . band^T and
// stores each band score at the (i, j) it belongs to. Every kernel forms its
// scores with this function, so the backward recomputes the forward's bits.
// Each thread reads back only the (i, j) of its own fragments; the caller
// syncs before s_bd is written again.
template <int DH>
__device__ __forceinline__ void scores(const bf16* s_qu, const bf16* s_qv, const bf16* s_k,
                                       const bf16* s_r, float* s_bd, float (&s)[4][4]) {
  constexpr int SQ = stride<DH>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rb = warp_row0(), cb = warp_col0();
  zero(s);
  warp_mma<DH, 4, false, true>(s, s_qu + rb * SQ, SQ, s_k + cb * SQ, SQ);
  {
    float bd[8][4];
    zero(bd);
    const int bb = 2 * cb;                             // band columns 64 (w / 4) ..
    warp_mma<DH, 8, false, true>(bd, s_qv + rb * SQ, SQ, s_r + bb * SQ, SQ);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb + g + 8 * (e >> 1);
        const int j = bb + nb * 8 + t2 + (e & 1) + i - (kTile - 1);
        if (j >= 0 && j < kTile) s_bd[i * kSS + j] = bd[nb][e];
      }
  }
  __syncthreads();
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
      s[nb][e] += s_bd[i * kSS + j];
    }
}

// The masked, scaled score. The _rn intrinsics keep nvcc from contracting
// these steps into FMAs differently in different kernels, so every pass
// forms the same probability from the same score bits.
__device__ __forceinline__ float masked(float acc, float scale, int cw, int rt, int cb) {
  return (cw >= rt || cb) ? -1e9f : __fmul_rn(acc, scale);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DH>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)4 * kTile * stride<DH>() * 2 + (size_t)kBand * stride<DH>() * 2 +
         (size_t)kTile * kSP * 2 + (size_t)kTile * kSS * 4 + (size_t)2 * kTile * 4 +
         (size_t)3 * kTile * 4;
}

// grid (L / 64, H, B). out (B, L, HD) bf16; m, l (B, H, L) f32: each query
// row's softmax max and sum.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_train_fwd_kernel(Params a, bf16* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out) {
  constexpr int SQ = stride<DH>();
  constexpr int NO = DH / 16;                        // P.V column blocks a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_qu = reinterpret_cast<bf16*>(smem);
  bf16* s_qv = s_qu + kTile * SQ;
  bf16* s_k = s_qv + kTile * SQ;
  bf16* s_v = s_k + kTile * SQ;
  bf16* s_r = s_v + kTile * SQ;
  bf16* s_p = s_r + kBand * SQ;
  float* s_s = reinterpret_cast<float*>(s_p + kTile * kSP);   // band scores, then scores
  float* s_m = s_s + kTile * kSS;
  float* s_l = s_m + kTile;
  int* s_rt = reinterpret_cast<int*>(s_l + kTile);
  int* s_cw = s_rt + kTile;
  int* s_cb = s_cw + kTile;

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int HD = a.H * DH;
  const int i0 = qt * kTile;
  const int nk = a.K / kTile;
  const int rb = warp_row0(), cb = warp_col0();
  const bf16* kb = a.k + (size_t)b * a.K * HD + h * DH;
  const bf16* vbase = a.v + (size_t)b * a.K * HD + h * DH;

  load_q_tile<DH>(s_qu, s_qv, a, b, h, i0);
  if (tid < kTile) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
    s_rt[tid] = a.rt[i0 + tid];
  }

  // pass 1: each row's max and sum, online
  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * kTile;
    __syncthreads();
    load_rows<DH>(s_k, kb, HD, j0, kTile, a.K);
    load_rows<DH>(s_r, a.wkr + h * DH, HD, band_first(a, i0, j0), kBand, a.K);
    load_cols(s_cw, s_cb, a, b, j0);
    __syncthreads();
    float s[4][4];
    scores<DH>(s_qu, s_qv, s_k, s_r, s_s, s);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
        // each thread overwrites only the band scores it read
        s_s[i * kSS + j] = masked(s[nb][e], a.scale, s_cw[j], s_rt[i], s_cb[j]);
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
    load_rows<DH>(s_r, a.wkr + h * DH, HD, band_first(a, i0, j0), kBand, a.K);
    load_cols(s_cw, s_cb, a, b, j0);
    __syncthreads();
    float s[4][4];
    scores<DH>(s_qu, s_qv, s_k, s_r, s_s, s);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = rb + g + 4 * e, j = cb + nb * 8 + t2;
        float p2[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const float sm = masked(s[nb][e + d], a.scale, s_cw[j + d], s_rt[i], s_cb[j + d]);
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
template <int DH>
__device__ void load_query_side(bf16* s_qu, bf16* s_qv, bf16* s_do, float* s_m, float* s_l,
                                float* s_dl, int* s_rt, const Params& a, const Grads& g,
                                int b, int h, int i0) {
  const int HD = a.H * DH;
  load_q_tile<DH>(s_qu, s_qv, a, b, h, i0);
  load_rows<DH>(s_do, g.dout + (size_t)b * a.L * HD + h * DH, HD, i0, kTile, a.L);
  if (threadIdx.x < kTile) {
    const int i = i0 + threadIdx.x;
    const size_t row = ((size_t)b * a.H + h) * a.L + i;
    s_m[threadIdx.x] = g.m[row];
    s_l[threadIdx.x] = g.l[row];
    s_dl[threadIdx.x] = g.delta[((size_t)b * a.L + i) * a.H + h];
    s_rt[threadIdx.x] = a.rt[i];
  }
}

// p, then dS = p * (keep * dP - delta) * scale, as the TPU kernel forms them,
// for this warp's fragment elements (i, j): calls f(i, j, dS, p * keep).
template <typename F>
__device__ __forceinline__ void for_ds(const Params& a, int b, int h, int i0, int j0,
                                       const float (&s)[4][4], const float (&dp)[4][4],
                                       const float* s_m, const float* s_l, const float* s_dl,
                                       const int* s_rt, const int* s_cw, const int* s_cb,
                                       F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rb = warp_row0(), cb = warp_col0();
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rb + g + 8 * (e >> 1), j = cb + nb * 8 + t2 + (e & 1);
      const float sm = masked(s[nb][e], a.scale, s_cw[j], s_rt[i], s_cb[j]);
      const float p = prob(sm, s_m[i], s_l[i]);
      const float kf = keep_factor(a, b, h, i0 + i, j0 + j);
      const float t = __fsub_rn(__fmul_rn(kf, dp[nb][e]), s_dl[i]);
      f(i, j, __fmul_rn(__fmul_rn(p, t), a.scale), __fmul_rn(p, kf));
    }
}

template <int DH>
__host__ __device__ constexpr size_t dkdv_smem() {
  return (size_t)5 * kTile * stride<DH>() * 2 + (size_t)kBand * stride<DH>() * 2 +
         (size_t)2 * kTile * kSP * 2 + (size_t)kTile * kSS * 4 + (size_t)3 * kTile * 4 +
         (size_t)3 * kTile * 4;
}

// grid (K / 64, H, B): dK, dV of one key tile, (B, K, HD) bf16.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_train_dkdv_kernel(Params a, Grads g, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int SQ = stride<DH>();
  constexpr int NO = DH / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + kTile * SQ;
  bf16* s_qu = s_v + kTile * SQ;
  bf16* s_qv = s_qu + kTile * SQ;
  bf16* s_do = s_qv + kTile * SQ;
  bf16* s_r = s_do + kTile * SQ;
  bf16* s_ds = s_r + kBand * SQ;
  bf16* s_pd = s_ds + kTile * kSP;
  float* s_bd = reinterpret_cast<float*>(s_pd + kTile * kSP);
  float* s_m = s_bd + kTile * kSS;
  float* s_l = s_m + kTile;
  float* s_dl = s_l + kTile;
  int* s_rt = reinterpret_cast<int*>(s_dl + kTile);
  int* s_cw = s_rt + kTile;
  int* s_cb = s_cw + kTile;

  const int tid = threadIdx.x;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int HD = a.H * DH;
  const int j0 = kt * kTile;
  const int nq = a.L / kTile;
  const int rb = warp_row0(), cb = warp_col0();
  load_rows<DH>(s_k, a.k + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
  load_rows<DH>(s_v, a.v + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
  load_cols(s_cw, s_cb, a, b, j0);

  const int oc = (DH / 2) * (tid >> 7);              // this warp's dK / dV columns
  float ak[NO][4], av[NO][4];
  zero(ak);
  zero(av);
  for (int qt = 0; qt < nq; ++qt) {
    const int i0 = qt * kTile;
    __syncthreads();
    load_query_side<DH>(s_qu, s_qv, s_do, s_m, s_l, s_dl, s_rt, a, g, b, h, i0);
    load_rows<DH>(s_r, a.wkr + h * DH, HD, band_first(a, i0, j0), kBand, a.K);
    __syncthreads();
    {
      float s[4][4], dp[4][4];
      scores<DH>(s_qu, s_qv, s_k, s_r, s_bd, s);
      zero(dp);
      warp_mma<DH, 4, false, true>(dp, s_do + rb * SQ, SQ, s_v + cb * SQ, SQ);
      for_ds(a, b, h, i0, j0, s, dp, s_m, s_l, s_dl, s_rt, s_cw, s_cb,
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

template <int DH>
__host__ __device__ constexpr size_t dq_smem() {
  return (size_t)5 * kTile * stride<DH>() * 2 + (size_t)kBand * stride<DH>() * 2 +
         (size_t)kTile * kSP * 2 + (size_t)kTile * kSB * 2 + (size_t)kTile * kSS * 4 +
         (size_t)3 * kTile * 4 + (size_t)3 * kTile * 4;
}

// grid (L / 64, H, B): dQ of one query tile, (B, L, HD) bf16, and its
// partial sums of dWkr, du and dv.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_train_dq_kernel(Params a, Grads g, bf16* __restrict__ dq, Partials part) {
  constexpr int SQ = stride<DH>();
  constexpr int NO = DH / 16;                        // dQ column blocks a warp
  constexpr int NW = DH / 8;                         // dWkr column blocks a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_qu = reinterpret_cast<bf16*>(smem);
  bf16* s_qv = s_qu + kTile * SQ;
  bf16* s_do = s_qv + kTile * SQ;
  bf16* s_k = s_do + kTile * SQ;
  bf16* s_v = s_k + kTile * SQ;
  bf16* s_r = s_v + kTile * SQ;
  bf16* s_ds = s_r + kBand * SQ;
  bf16* s_dbd = s_ds + kTile * kSP;                  // dS on the band: [i][j - i + 63]
  float* s_bd = reinterpret_cast<float*>(s_dbd + kTile * kSB);
  float* s_m = s_bd + kTile * kSS;
  float* s_l = s_m + kTile;
  float* s_dl = s_l + kTile;
  int* s_rt = reinterpret_cast<int*>(s_dl + kTile);
  int* s_cw = s_rt + kTile;
  int* s_cb = s_cw + kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int HD = a.H * DH;
  const int i0 = qt * kTile;
  const int nk = a.K / kTile;
  const int rb = warp_row0();
  const size_t slot = (size_t)b * (a.L / kTile) + qt;
  float* pw = part.w + slot * a.K * HD + h * DH;
  load_query_side<DH>(s_qu, s_qv, s_do, s_m, s_l, s_dl, s_rt, a, g, b, h, i0);
  // band entries off a row's 64 keys stay zero in every tile
  for (int x = tid; x < kTile * kSB / 2; x += kThreads)
    reinterpret_cast<uint32_t*>(s_dbd)[x] = 0u;

  const int oc = (DH / 2) * (tid >> 7);
  float aqu[NO][4], aqv[NO][4], aw[NW][4];
  zero(aqu);
  zero(aqv);
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
    const int first = band_first(a, i0, j0);
    __syncthreads();
    load_rows<DH>(s_k, a.k + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
    load_rows<DH>(s_v, a.v + (size_t)b * a.K * HD + h * DH, HD, j0, kTile, a.K);
    load_rows<DH>(s_r, a.wkr + h * DH, HD, first, kBand, a.K);
    load_cols(s_cw, s_cb, a, b, j0);
    __syncthreads();
    {
      float s[4][4], dp[4][4];
      scores<DH>(s_qu, s_qv, s_k, s_r, s_bd, s);
      zero(dp);
      warp_mma<DH, 4, false, true>(dp, s_do + rb * SQ, SQ, s_v + warp_col0() * SQ, SQ);
      for_ds(a, b, h, i0, j0, s, dp, s_m, s_l, s_dl, s_rt, s_cw, s_cb,
             [&](int i, int j, float ds, float) {
               const bf16 v = __float2bfloat16_rn(ds);
               s_ds[i * kSP + j] = v;
               s_dbd[i * kSB + j - i + kTile - 1] = v;
             });
    }
    __syncthreads();
    // dQ += dS K + unskew(dS) band: query rows rb .., columns oc ..
    warp_mma<kTile, NO, false, false>(aqu, s_ds + rb * kSP, kSP, s_k + oc, SQ);
    warp_mma<kBand, NO, false, false>(aqv, s_dbd + rb * kSB, kSB, s_r + oc, SQ);
    // dWkr += unskew(dS)^T qv on this warp's band rows
    const int blk = band_block(kt);
    warp_mma<kTile, NW, true, false>(aw, s_dbd + 16 * blk, kSB, s_qv, SQ);
    if (blk < 4) {                 // complete: the lower half of this tile's band
      store_rows(first, blk, false);
      zero(aw);
    }
  }
  // the last tile's upper half wraps onto the first tile's lower half, which
  // another warp may have written: sync, then add
  __syncthreads();
  if (band_block(nk - 1) >= 4) store_rows(band_first(a, i0, (nk - 1) * kTile),
                                          band_block(nk - 1), true);

  // dQ, and the tile's column sums of dQu and dQv (du, dv partials)
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) {
    bf16* dst = dq + ((size_t)b * a.L + i0 + rb) * HD + h * DH + oc + nb * 8 + t2;
    *reinterpret_cast<uint32_t*>(dst + (size_t)g8 * HD) =
        pack(aqu[nb][0] + aqv[nb][0], aqu[nb][1] + aqv[nb][1]);
    *reinterpret_cast<uint32_t*>(dst + (size_t)(g8 + 8) * HD) =
        pack(aqu[nb][2] + aqv[nb][2], aqu[nb][3] + aqv[nb][3]);
  }
  // s_bd is free after the sync above
  tile_column_sums<DH, NO>(aqu, aqv, oc, s_bd, part.u + slot * HD + h * DH,
                           part.v + slot * HD + h * DH);
}

template <int DH>
cudaError_t launch_fwd(const Params& a, void* out, float* m, float* l, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<DH>();
  cudaError_t err = set_smem(flash_train_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  flash_train_fwd_kernel<DH><<<dim3(a.L / kTile, a.H, a.B), kThreads, smem, st>>>(
      a, static_cast<bf16*>(out), m, l);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const Params& a, const Grads& g, void* dq, void* dk, void* dv,
                       Partials part, float* dwkr, float* du, float* dvb, cudaStream_t st) {
  cudaError_t err = set_smem(flash_train_dkdv_kernel<DH>, dkdv_smem<DH>());
  if (err != cudaSuccess) return err;
  err = set_smem(flash_train_dq_kernel<DH>, dq_smem<DH>());
  if (err != cudaSuccess) return err;
  flash_train_dkdv_kernel<DH><<<dim3(a.K / kTile, a.H, a.B), kThreads, dkdv_smem<DH>(), st>>>(
      a, g, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_train_dq_kernel<DH><<<dim3(a.L / kTile, a.H, a.B), kThreads, dq_smem<DH>(), st>>>(
      a, g, static_cast<bf16*>(dq), part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, a.B * (a.L / kTile), a.K, a.H * DH, dwkr, du, dvb, st);
}

Params make_params(const void* q, const void* k, const void* v, const void* wkr, const void* u,
                   const void* vb, const int* rt, const int* cw, const int* cb, const int* kp,
                   int B, int L, int K, int H, float scale, int dropout, uint32_t seed,
                   int thresh, float keep_scale) {
  Params a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.wkr = static_cast<const bf16*>(wkr);
  a.u = static_cast<const bf16*>(u);
  a.vb = static_cast<const bf16*>(vb);
  a.rt = rt;
  a.cw = cw;
  a.cb = cb;
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

// K >= kBand: a tile pair's band of wkr rows wraps around K at most once.
bool shapes_ok(int B, int L, int K, int H) {
  return B > 0 && H > 0 && L > 0 && L % kTile == 0 && K % kTile == 0 && K >= L &&
         K >= kBand;
}

}  // namespace

extern "C" {

const char* flash_train_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward. Device pointers into contiguous tensors: q, out (B, L, H*Dh) bf16;
// k, v (B, K, H*Dh) bf16; wkr (K, H*Dh) bf16; u, vb (H*Dh) bf16; rt (L), cw,
// cb (K), kp (B, K) int32; m, l (B, H, L) f32 out. Needs L, K multiples of
// 64, K >= L, K >= 128, Dh in {32, 64}. dropout != 0 switches dropout on:
// keep where the hash of seed + b CB + (h + 1) CH + i K + j, as int32, exceeds
// thresh, and scale the kept probabilities by keep_scale. Returns
// the CUDA error of the launch (0 = cudaSuccess); does not synchronize.
int flash_train_fwd(const void* q, const void* k, const void* v, const void* wkr,
                    const void* u, const void* vb, const int* rt, const int* cw, const int* cb,
                    const int* kp, void* out, float* m, float* l, int B, int L, int K, int H,
                    int Dh, float scale, int dropout, uint32_t seed, int thresh,
                    float keep_scale, void* stream) {
  if (!shapes_ok(B, L, K, H)) return (int)cudaErrorInvalidValue;
  const Params a = make_params(q, k, v, wkr, u, vb, rt, cw, cb, kp, B, L, K, H, scale, dropout,
                               seed, thresh, keep_scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return launch_fwd<32>(a, out, m, l, st);
    case 64: return launch_fwd<64>(a, out, m, l, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Backward. The forward's operands, then dout (B, L, H*Dh) bf16, delta
// (B, L, H) f32, the forward's m, l; out: dq (B, L, H*Dh), dk, dv (B, K,
// H*Dh) bf16, dwkr (K, H*Dh), du, dvb (H*Dh) f32; scratch: part_w
// (B * L / 64, K, H*Dh), part_u, part_v (B * L / 64, H*Dh) f32.
int flash_train_bwd(const void* q, const void* k, const void* v, const void* wkr,
                    const void* u, const void* vb, const int* rt, const int* cw, const int* cb,
                    const int* kp, const void* dout, const float* delta, const float* m,
                    const float* l, void* dq, void* dk, void* dv, float* dwkr, float* du,
                    float* dvb, float* part_w, float* part_u, float* part_v, int B, int L, int K,
                    int H, int Dh, float scale, int dropout, uint32_t seed, int thresh,
                    float keep_scale, void* stream) {
  if (!shapes_ok(B, L, K, H)) return (int)cudaErrorInvalidValue;
  const Params a = make_params(q, k, v, wkr, u, vb, rt, cw, cb, kp, B, L, K, H, scale, dropout,
                               seed, thresh, keep_scale);
  Grads g;
  g.dout = static_cast<const bf16*>(dout);
  g.delta = delta;
  g.m = m;
  g.l = l;
  Partials part;
  part.w = part_w;
  part.u = part_u;
  part.v = part_v;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return launch_bwd<32>(a, g, dq, dk, dv, part, dwkr, du, dvb, st);
    case 64: return launch_bwd<64>(a, g, dq, dk, dv, part, dwkr, du, dvb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
