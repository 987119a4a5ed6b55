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
// Design, for Hopper. One warpgroup (128 threads) a block, 64 query rows by
// 64 keys a tile pair. Every product is a warpgroup product (wgmma
// m64nNk16, bf16 in, f32 accumulate): S, the band chunks, dP, P.V, dV, dK,
// dQ and dWkr, with P and dS as register operands where the product's rows
// are query rows, and as bf16 core-matrix tiles in shared memory where they
// must be transposed (dV, dK, dWkr). Operand tiles come by TMA from 2-D
// tensor maps (128-byte swizzle at Dh 64, 64-byte at Dh 32, the layout the
// wgmma descriptors read), the mask and row-statistics vectors by bulk
// copy; one thread issues them and an mbarrier counts their bytes.
//
//   1. Tile skipping. The wrapper classifies every (batch row, query tile,
//      key tile) from the mask vectors (ops/flash_train.py::tile_map): 0
//      fully blocked, skipped (P is exactly 0 there: exp(-1e9 - m) with a
//      finite row max m); 1 mixed; 2 fully visible, no per-element test. A
//      query tile holding a row whose keys are all blocked (m = -1e9, P =
//      1 / K on every key) skips nothing. Each block walks only its listed
//      tiles, in the forward and both backward passes: at the flagship's
//      causal shape 1600 of 2048 tile pairs (1472 of them without a test).
//   2. The skew. A tile pair (i0, j0) reads the band of 128 wkr rows
//      starting at (j0 + L - 64 - i0) mod K, a multiple of 64: two aligned
//      64-row chunks of wkr, lo and hi. BD[i, j] is lo row j - i + 63 for
//      j <= i and hi row j - i - 1 for j > i: exactly one chunk product
//      lands on each (i, j), at j = (r + i + 1) mod 64 of chunk row r, which
//      is in the same row and so in the same warp. Each warp scatters its
//      rows through an XOR-swizzled f32 tile and reads them back with no
//      block barrier. The hi chunk of key tile kt is the lo chunk of kt + 1:
//      the forward keeps that product in registers from one key tile to the
//      next, one chunk product a pair (two after a skipped tile) where the
//      function needs one; the backward passes compute both (2 : 1).
//   3. One score path (mma_abt, scatter_band, scores_from, masked, prob_r)
//      in every pass, from products of the same shapes on the same
//      operands, so the backward recomputes the forward's P bit for bit.
//
// Forward (flash_train_fwd_kernel), one block per (query tile, head, batch
// row), two passes over its listed key tiles (the TPU's order: normalise
// over the whole row before dropout): the first finds each row's max and
// sum (online), the second forms the normalised probabilities, drops out,
// rounds them to bf16 and accumulates P.V. K, the hi chunk and V come
// through a three-stage ring, two steps ahead; at Dh 64 the band tile
// overlays the current stage's K and chunk once their products retire.
//
// Backward: dS = P * (keep * dP - delta) * scale with dP = dO . V^T and delta
// = sum_d dO * O (taken in f32 by the caller). Both passes run in one
// launch (flash_train_bwd_kernel): the dQ blocks first, heaviest query
// tiles first, then the dK/dV blocks, which fill the card while the long
// dQ blocks finish. Nothing is added across blocks in a varying order:
//   - dkdv_block, one per (key tile, head, batch row), over its listed query
//     tiles: dV += bf16(Pd)^T dO, dK += bf16(dS)^T qu, K and V resident;
//   - dq_block, one per (query tile, head, group of G batch rows), over its
//     listed key tiles: dQ += bf16(dS) K + D_c chunk_c, dWkr_c += D_c^T qv,
//     where D_c (64 x 64, bf16) is dS unskewed onto chunk c: the part above
//     the diagonal from key tile kt (as hi chunk), the rest from kt + 1 (as
//     lo chunk), so one product a chunk, not two. dWkr goes to one partial
//     slot per (group, query tile): the slot's rows are loaded as the
//     wgmma's initial accumulator and stored back, in the group's row
//     order;
//   - partials_reduce_kernel (flash_common.cuh) sums the slots in a fixed
//     order, so a backward gives the same bits on every run.
// The one-pass alternative (FA3's: dQ added across key-tile blocks in an
// order fixed by a semaphore) saves the recomputed S and dP of one pass but
// makes dQ and dWkr cross-block sums; it is not built. G is 4 at the genre
// flagship's shape (dWkr partials 100.7 MB, from 402.7 MB with one slot a
// batch row and query tile) and 2 at the multitask decoder's (67.1 MB, from
// 134.2): the largest that still gives two blocks an SM (ops/flash_train.py
// ::dq_group); with the one-launch order it costs no time at either shape.
//
// Bound. At the flagship's train shape (B 16, L 512, K 1024, 12 x 64 heads,
// bf16, causal with full memory) the products over the pairs the mask
// leaves visible (75.05% of the tile pairs) take 29.01 GFLOP forward and
// 77.36 GFLOP backward: 29.3 / 78.2 us at 989 TFLOP/s bf16, which bounds
// them (the bytes take ~23 / ~43 us). Executed against needed products a
// visible tile pair: forward 5 (AC and one chunk product in each pass, P.V)
// against 3; backward 13 (dK/dV pass: AC, two chunk products, dP, dV, dK;
// dQ pass: AC, two chunk products, dP, dQ's two terms, dWkr) against 8.
// What held the first wgmma version (cp.async tile copies, one or two
// steps ahead) was the copies, not the products: its time fell with each
// tile copy taken out and hardly with the products, the scatter or the
// softmax taken out (PERF.md, row 11). Moving the copies to TMA took the
// forward's device time a launch from 0.555 to ~0.37 ms and the backward's
// from 1.251 to ~0.81 ms (profile_train.py, PERF.md).
//
// Occupancy (nvcc 12.9 -Xptxas -v for sm_90a, Dh 64; the card's build log
// under ops/_build): forward 219 registers, no spills, 101,376 bytes of
// shared memory; backward 254 registers, no spills, 110,464 bytes (the dQ
// block's; the dK/dV block needs 93,952). Two blocks (8 warps) an SM each.

#include "hopper_common.cuh"

namespace {

// --- operands ---------------------------------------------------------------

struct Params {
  const bf16 *qu, *qv;          // (B, L, HD): q + u, q + v rounded to bf16
  const bf16 *k, *v, *wkr;      // (B, K, HD) x 2, (K, HD)
  const int *rt, *cw, *cblk;    // (L), (K), (B, K): cblk = cb | kp
  const int* tiles;             // (B, L / 64, K / 64): 0 skip, 1 mixed, 2 visible
  int B, L, K, H;
  float scale;
  uint32_t seed;       // attention seed as uint32
  int thresh;          // keep where the mix, as int32, exceeds it
  float keep_scale;    // 1 / (1 - p) in f32
  bool dropout;
};

// The masked, scaled score. The _rn intrinsics keep nvcc from contracting
// these steps into FMAs differently in different kernels, so every pass
// forms the same probability from the same score bits.
__device__ __forceinline__ float masked(float acc, float scale, int cw, int rt, int cb) {
  return (cw >= rt || cb) ? -1e9f : __fmul_rn(acc, scale);
}

// The chunks of a tile pair's band: lo = (kt + L/64 - 1 - qt) mod K/64, hi = lo + 1.
__device__ __forceinline__ int chunk_lo(int qt, int kt, int nq, int nk) {
  return (kt + nq - 1 - qt) % nk;
}

// Lands the pair's two chunk products (rows i, chunk rows r) on its (i, j):
// the lo chunk's row r at j = r - 63 + i where that is >= 0 (j <= i), the
// hi chunk's at j = r + 1 + i where that is < 64 (j > i); exactly one of
// the two lands, at j = (r + i + 1) mod 64.
__device__ __forceinline__ void scatter_band(float* s_bd, const float (&clo)[32],
                                             const float (&chi)[32]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = row_of(x >> 1), r = 8 * nb + col2() + (x & 1);
      s_bd[swz(i, (r + i + 1) & (kTile - 1))] = r + i >= kTile - 1 ? clo[4 * nb + x]
                                                                   : chi[4 * nb + x];
    }
}

// s = AC + BD: every pass forms its scores here, from products of the same
// shapes on the same operands, so the backward recomputes the forward's bits.
__device__ __forceinline__ void scores_from(float (&s)[32], const float* s_bd) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row_of(h);
      const float2 bd = *reinterpret_cast<const float2*>(s_bd + swz(i, 8 * nb + col2()));
      s[4 * nb + 2 * h] += bd.x;
      s[4 * nb + 2 * h + 1] += bd.y;
    }
}

// The masked, scaled scores of a tile pair in place; mode 2 (fully visible)
// skips the tests. col: the key tile's cw (0..63) and cb | kp (64..127).
__device__ __forceinline__ void mask_scores(float (&s)[32], float scale, int mode, const int* col,
                                            const int (&rt)[2]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = 8 * nb + col2() + (x & 1);
      s[4 * nb + x] = mode == 2 ? __fmul_rn(s[4 * nb + x], scale)
                                : masked(s[4 * nb + x], scale, col[j], rt[x >> 1], col[kTile + j]);
    }
}


// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kStages = 3;   // the forward's ring: copies run two steps ahead

// At Dh 64 a stage's K and hi-chunk tiles (16 KB) hold the f32 band tile
// once the products reading them retire; at Dh 32 it has its own.
template <int DH>
__host__ __device__ constexpr bool band_in_stage() { return 2 * tile_bytes<DH>() >= kBandBytes; }

template <int DH>
__host__ __device__ constexpr size_t fwd_smem(int nk) {
  return kBarBytes + (3 + 3 * kStages) * tile_bytes<DH>() +
         (band_in_stage<DH>() ? 0 : kBandBytes) + piece(kVec) +
         piece(2 * kStages * kVec) + piece((size_t)nk * 4 + 4);
}

// grid (L / 64, H, B). out (B, L, HD) bf16; m, l (B, H, L) f32: each query
// row's softmax max and sum.
template <int DH>
__global__ void __launch_bounds__(kWG, 2)
flash_train_fwd_kernel(Params a, const __grid_constant__ Maps maps, bf16* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int T = kTile * DH;
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* s_qu = cv.take<bf16>(T);
  bf16* s_qv = cv.take<bf16>(T);
  bf16* s_cl = cv.take<bf16>(T);                 // the lo chunk, loaded when needed
  // the stages: K, the hi chunk, V (second pass)
  bf16* s_stage = cv.take<bf16>(3 * kStages * T);
  float* s_bd_own = band_in_stage<DH>() ? nullptr : cv.take<float>(kTile * kTile);
  int* s_rt = cv.take<int>(kTile);
  int* s_col = cv.take<int>(2 * kStages * kTile);   // (cw, cb | kp) a stage
  uint64_t* bars = cv.take<uint64_t>(16);
  uint64_t *bar_q = bars, *bar_cl = bars + 1, *bar_s = bars + 2;   // bar_s: one a stage
  const int nq = a.L / kTile, nk = a.K / kTile;
  int* s_list = cv.take<int>(nk + 1);

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = qt * kTile, col = h * DH;

  if (tid == 0) {
    for (int x = 0; x < 2 + kStages; ++x) bar_init(bars + x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int cnt = list_tiles(s_list, s_list + nk, a.tiles + ((size_t)b * nq + qt) * nk, nk, 1);

  // the query side, once
  if (tid == 0) {
    bar_expect(bar_q, 2 * TB + kVec);
    tma_tile(s_qu, &maps.qu, col, b * a.L + i0, bar_q);
    tma_tile(s_qv, &maps.qv, col, b * a.L + i0, bar_q);
    tma_vec(s_rt, a.rt + i0, bar_q);
  }

  // step f (0 .. 2 cnt - 1) visits list entry f mod cnt in pass f / cnt;
  // its K, hi chunk and (second pass) V go to stage f % kStages. The lo
  // chunk's product is the step before's hi one, unless that step was not
  // the key tile before: then the lo chunk is copied on the spot
  auto fresh_lo = [&](int n) { return n == 0 || (s_list[n - 1] >> 2) != (s_list[n] >> 2) - 1; };
  auto issue = [&](int f) {
    if (tid != 0) return;
    const int pass = f >= cnt, n = f - pass * cnt, st = f % kStages;
    const int kt = s_list[n] >> 2;
    const int hi = (chunk_lo(qt, kt, nq, nk) + 1) % nk;
    bf16* stage = s_stage + 3 * st * T;
    uint64_t* bar = bar_s + st;
    bar_expect(bar, (pass ? 3 : 2) * TB + 2 * kVec);
    tma_tile(stage, &maps.k, col, b * a.K + kt * kTile, bar);
    tma_tile(stage + T, &maps.wkr, col, hi * kTile, bar);
    if (pass) tma_tile(stage + 2 * T, &maps.v, col, b * a.K + kt * kTile, bar);
    tma_vec(s_col + st * 2 * kTile, a.cw + kt * kTile, bar);
    tma_vec(s_col + st * 2 * kTile + kTile, a.cblk + (size_t)b * a.K + kt * kTile, bar);
  };
  // a map never empties a query tile's row (tile_map)
  for (int f = 0; f < kStages - 1 && f < 2 * cnt; ++f) issue(f);
  bar_wait(bar_q, 0);
  const int rt[2] = {s_rt[row_of(0)], s_rt[row_of(1)]};

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};
  float o[DH / 2];
  float clo[32];            // the lo chunk's product: the last tile's hi one
  zero(o);
  uint32_t fill_cl = 0;
  for (int f = 0; f < 2 * cnt; ++f) {
    const int pass = f >= cnt, n = f - pass * cnt, st = f % kStages;
    const int kt = s_list[n] >> 2, mode = s_list[n] & 3, j0 = kt * kTile;
    const bf16* stage = s_stage + 3 * st * T;
    // the lo chunk on the spot
    const bool fresh = fresh_lo(n);
    if (fresh) {
      if (tid == 0) {
        bar_expect(bar_cl, TB);
        tma_tile(s_cl, &maps.wkr, col, chunk_lo(qt, kt, nq, nk) * kTile, bar_cl);
      }
      bar_wait(bar_cl, fill_cl++ & 1);
    }
    // stage (f + 2) % 3 was freed at the end of step f - 1
    if (f + kStages - 1 < 2 * cnt) issue(f + kStages - 1);
    if (f == cnt) {
      rl[0] = __frcp_rn(l_r[0]);
      rl[1] = __frcp_rn(l_r[1]);
    }
    bar_wait(bar_s + st, (f / kStages) & 1);
    float s[32], chi[32];
    wg_fence();
    mma_abt<DH>(s, s_qu, stage);
    mma_abt<DH>(chi, s_qv, stage + T);
    if (fresh) mma_abt<DH>(clo, s_qv, s_cl);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(chi);
    reg_fence(clo);
    float* s_bd = band_in_stage<DH>() ? reinterpret_cast<float*>(s_stage + 3 * st * T)
                                      : s_bd_own;
    if (band_in_stage<DH>()) __syncthreads();   // every warp's products retired
    scatter_band(s_bd, clo, chi);    // this warp's rows: no other warp's data
#pragma unroll
    for (int x = 0; x < 32; ++x) clo[x] = chi[x];
    __syncwarp();
    scores_from(s, s_bd);
    mask_scores(s, a.scale, mode, s_col + st * 2 * kTile, rt);
    if (!pass) {
      // the online row max and sum; a row's 64 scores sit in one quad
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * hh], s[4 * nb + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[hh], mx);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          sum += ex(s[4 * nb + 2 * hh] - m_new) + ex(s[4 * nb + 2 * hh + 1] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_r[hh] = l_r[hh] * ex(m_r[hh] - m_new) + sum;   // ex(-inf) = 0 at first
        m_r[hh] = m_new;
      }
    } else {
      // normalised, dropped-out, bf16-rounded probabilities times V
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = row_of(x >> 1), j = 8 * nb + col2() + (x & 1);
          s[4 * nb + x] = __fmul_rn(prob_r(s[4 * nb + x], m_r[x >> 1], rl[x >> 1]),
                                    keep_factor(a, b, h, i0 + i, j0 + j));
        }
      uint32_t pa[4][4];
      to_frags(pa, s);
      wg_fence();
      mma_rb<DH>(o, pa, stage + 2 * T);
      wg_commit();
      wg_wait();
      reg_fence(o);
    }
    fence_stores();                    // the band's plain stores before the next TMA there
    __syncthreads();                   // stage f % 3 and the band read
  }

  const int HD = a.H * DH;
  store_rows<DH>(out + ((size_t)b * a.L + i0) * HD + col, HD, o);
  if ((tid & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t row = ((size_t)b * a.H + h) * a.L + i0 + row_of(hh);
      m_out[row] = m_r[hh];
      l_out[row] = l_r[hh];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct Grads {
  const bf16* dout;            // (B, L, HD)
  const float* delta;          // (B, H, L): sum_d dO * O
  const float *m, *l;          // (B, H, L): the forward's row max and sum
};

// The query tile's row statistics into st: m, l, delta (f32) and rt (int).
__device__ __forceinline__ void tma_stats(float* st, const Params& a, const Grads& g, int b,
                                          int h, int i0, uint64_t* bar) {
  const size_t row = ((size_t)b * a.H + h) * a.L + i0;
  tma_vec(st, g.m + row, bar);
  tma_vec(st + kTile, g.l + row, bar);
  tma_vec(st + 2 * kTile, g.delta + row, bar);
  tma_vec(st + 3 * kTile, a.rt + i0, bar);
}

template <int DH>
__host__ __device__ constexpr size_t dkdv_smem(int nq) {
  return kBarBytes + 9 * tile_bytes<DH>() + kBandBytes + 2 * piece(4 * kVec) +
         piece(2 * kVec) + piece((size_t)nq * 4 + 4);
}

// dK, dV of key tile kt of (head h, batch row b), (B, K, HD) bf16.
template <int DH>
__device__ __forceinline__ void dkdv_block(const Params& a, const Maps& maps, const Grads& g,
                                           bf16* __restrict__ dk, bf16* __restrict__ dv, int kt,
                                           int h, int b) {
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* s_k = cv.take<bf16>(kTile * DH);
  bf16* s_v = cv.take<bf16>(kTile * DH);
  bf16* s_qu = cv.take<bf16>(2 * kTile * DH);     // two slots
  bf16* s_do = cv.take<bf16>(2 * kTile * DH);
  bf16* s_qv = cv.take<bf16>(kTile * DH);
  // the two chunks: one piece of two tiles, freed once the chunk products
  // retire; a tile is a whole number of 128-byte pieces
  bf16* s_cl = cv.take<bf16>(2 * kTile * DH);
  bf16* s_ch = s_cl + kTile * DH;
  float* s_bd = cv.take<float>(kTile * kTile);    // then bf16 Pd and dS tiles
  bf16* s_pd = reinterpret_cast<bf16*>(s_bd);
  bf16* s_ds = s_pd + kTile * kTile;
  float* s_st = cv.take<float>(4 * kTile);        // slot 0: m, l, delta, rt
  cv.take<float>(4 * kTile);                      // slot 1 follows
  int* s_col = cv.take<int>(2 * kTile);
  uint64_t* bars = cv.take<uint64_t>(16);
  uint64_t *bar_kv = bars, *bar_a = bars + 1, *bar_b = bars + 3;   // bar_a: two slots
  const int nq = a.L / kTile, nk = a.K / kTile;
  int* s_list = cv.take<int>(nq + 1);

  const int tid = threadIdx.x;
  const int HD = a.H * DH;
  const int j0 = kt * kTile, col = h * DH;

  if (tid == 0) {
    for (int x = 0; x < 4; ++x) bar_init(bars + x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int cnt = list_tiles(s_list, s_list + nq, a.tiles + (size_t)b * nq * nk + kt, nq, nk);

  if (tid == 0) {
    bar_expect(bar_kv, 2 * TB + 2 * kVec);
    tma_tile(s_k, &maps.k, col, b * a.K + j0, bar_kv);
    tma_tile(s_v, &maps.v, col, b * a.K + j0, bar_kv);
    tma_vec(s_col, a.cw + j0, bar_kv);
    tma_vec(s_col + kTile, a.cblk + (size_t)b * a.K + j0, bar_kv);
  }

  // query tile n's qu, dO and statistics into slot n % 2; its qv and chunks
  auto issue_a = [&](int n) {
    if (tid != 0) return;
    const int i0 = (s_list[n] >> 2) * kTile, slot = n & 1;
    uint64_t* bar = bar_a + slot;
    bar_expect(bar, 2 * TB + 4 * kVec);
    tma_tile(s_qu + slot * kTile * DH, &maps.qu, col, b * a.L + i0, bar);
    tma_tile(s_do + slot * kTile * DH, &maps.dout, col, b * a.L + i0, bar);
    tma_stats(s_st + slot * 4 * kTile, a, g, b, h, i0, bar);
  };
  auto issue_b = [&](int n) {
    if (tid != 0) return;
    const int qt = s_list[n] >> 2;
    const int lo = chunk_lo(qt, kt, nq, nk), hi = lo + 1 == nk ? 0 : lo + 1;
    bar_expect(bar_b, 3 * TB);
    tma_tile(s_qv, &maps.qv, col, b * a.L + qt * kTile, bar_b);
    tma_tile(s_cl, &maps.wkr, col, lo * kTile, bar_b);
    tma_tile(s_ch, &maps.wkr, col, hi * kTile, bar_b);
  };
  if (cnt > 0) {
    issue_a(0);
    issue_b(0);
  }

  float ak[DH / 2], av[DH / 2];
  zero(ak);
  zero(av);
  bar_wait(bar_kv, 0);
  for (int n = 0; n < cnt; ++n) {
    const int qt = s_list[n] >> 2, mode = s_list[n] & 3, i0 = qt * kTile, slot = n & 1;
    const bf16* qu = s_qu + slot * kTile * DH;
    const bf16* dO = s_do + slot * kTile * DH;
    const float* st = s_st + slot * 4 * kTile;
    if (n + 1 < cnt) issue_a(n + 1);   // slot (n + 1) % 2 was freed at the end of n - 1
    bar_wait(bar_b, n & 1);
    float s[32], dp[32];
    {
      float clo[32], chi[32];
      wg_fence();
      mma_abt<DH>(clo, s_qv, s_cl);
      mma_abt<DH>(chi, s_qv, s_ch);
      wg_commit();
      wg_wait();
      reg_fence(clo);
      reg_fence(chi);
      __syncthreads();                 // qv and the chunks read
      if (n + 1 < cnt) issue_b(n + 1);
      scatter_band(s_bd, clo, chi);
    }
    bar_wait(bar_a + slot, (n >> 1) & 1);
    wg_fence();
    mma_abt<DH>(s, qu, s_k);
    mma_abt<DH>(dp, dO, s_v);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    __syncwarp();                      // this warp's band rows written
    scores_from(s, s_bd);
    const int rt[2] = {reinterpret_cast<const int*>(st)[3 * kTile + row_of(0)],
                       reinterpret_cast<const int*>(st)[3 * kTile + row_of(1)]};
    mask_scores(s, a.scale, mode, s_col, rt);
    form_ds(s, dp, a, st, b, h, i0, j0);
    __syncthreads();                   // every thread's band scores read
    store_tile(s_pd, s);
    store_tile(s_ds, dp);
    fence_stores();
    __syncthreads();
    // dV += Pd^T dO, dK += dS^T qu: rows are this block's keys
    wg_fence();
    mma_atb<DH>(av, s_pd, dO);
    mma_atb<DH>(ak, s_ds, qu);
    wg_commit();
    wg_wait();
    reg_fence(av);
    reg_fence(ak);
    __syncthreads();                   // slot n % 2, Pd and dS read
  }
  const size_t off = ((size_t)b * a.K + j0) * HD + h * DH;
  store_rows<DH>(dk + off, HD, ak);
  store_rows<DH>(dv + off, HD, av);
}

template <int DH>
__host__ __device__ constexpr size_t dq_smem(int nk) {
  return kBarBytes + 9 * tile_bytes<DH>() + kBandBytes + 2 * piece((size_t)kTile * kTile * 2) +
         piece(4 * kVec) + piece(4 * kVec) + piece((size_t)2 * DH * 4) +
         piece((size_t)nk * 4 + 4) + piece((size_t)nk);
}

// A partial slot's rows c * 64 .. (row t at pw + t * HD) and a 64 x DH f32
// accumulator: get_dw loads them (zero where this block has not written
// them yet), put_dw stores.
template <int DH>
__device__ __forceinline__ void get_dw(float (&dw)[DH / 2], const float* pw, int HD, int c,
                                       bool written) {
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2 v = make_float2(0.f, 0.f);
      if (written)
        v = *reinterpret_cast<const float2*>(pw + (size_t)(c * kTile + row_of(hh)) * HD +
                                             8 * nb + col2());
      dw[4 * nb + 2 * hh] = v.x;
      dw[4 * nb + 2 * hh + 1] = v.y;
    }
}
template <int DH>
__device__ __forceinline__ void put_dw(float* pw, int HD, int c, const float (&dw)[DH / 2]) {
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(pw + (size_t)(c * kTile + row_of(hh)) * HD + 8 * nb + col2()) =
          make_float2(dw[4 * nb + 2 * hh], dw[4 * nb + 2 * hh + 1]);
}

// dQ of query tile qt of head h, (B, L, HD) bf16, for each of the G batch
// rows of group gr, and their summed partials of dWkr, du and dv in slot
// gr * L / 64 + qt.
template <int DH>
__device__ __forceinline__ void dq_block(const Params& a, const Maps& maps, const Grads& g,
                                         bf16* __restrict__ dq, const Partials& part, int G,
                                         int qt, int h, int gr) {
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* s_qu = cv.take<bf16>(kTile * DH);
  bf16* s_qv = cv.take<bf16>(kTile * DH);
  bf16* s_do = cv.take<bf16>(kTile * DH);
  bf16* s_k = cv.take<bf16>(kTile * DH);
  bf16* s_v = cv.take<bf16>(kTile * DH);
  bf16* s_cl = cv.take<bf16>(2 * kTile * DH);     // two slots
  bf16* s_ch = cv.take<bf16>(2 * kTile * DH);
  float* s_bd = cv.take<float>(kTile * kTile);    // then the du / dv reduction
  bf16* s_d = cv.take<bf16>(kTile * kTile);       // D, two slots
  cv.take<bf16>(kTile * kTile);
  float* s_st = cv.take<float>(4 * kTile);        // m, l, delta, rt
  int* s_col = cv.take<int>(4 * kTile);           // two slots
  float* s_uv = cv.take<float>(2 * DH);           // du, dv summed over the group
  uint64_t* bars = cv.take<uint64_t>(16);
  uint64_t *bar_q = bars, *bar_k = bars + 1, *bar_v = bars + 2, *bar_c = bars + 3;  // bar_c: 2
  const int nq = a.L / kTile, nk = a.K / kTile;
  int* s_list = cv.take<int>(nk + 1);
  unsigned char* s_wr = cv.take<unsigned char>(nk);   // chunk rows of the slot written

  const int tid = threadIdx.x;
  const int HD = a.H * DH;
  const int i0 = qt * kTile, col = h * DH;
  const size_t slot = (size_t)gr * nq + qt;
  float* pw = part.w + slot * a.K * HD + col;

  if (tid == 0) {
    for (int x = 0; x < 5; ++x) bar_init(bars + x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int x = tid; x < nk; x += kWG) s_wr[x] = 0;
  if (tid < 2 * DH) s_uv[tid] = 0.f;

  uint32_t fill_k = 0, fill_v = 0, fill_c[2] = {0, 0}, fill_q = 0;
  float dqu[DH / 2], dqv[DH / 2];
  for (int bb = 0; bb < G; ++bb) {
    const int b = gr * G + bb;
    __syncthreads();                   // the previous row's tiles and list read
    const int cnt = list_tiles(s_list, s_list + nk, a.tiles + ((size_t)b * nq + qt) * nk, nk, 1);
    if (tid == 0) {
      bar_expect(bar_q, 3 * TB + 4 * kVec);
      tma_tile(s_qu, &maps.qu, col, b * a.L + i0, bar_q);
      tma_tile(s_qv, &maps.qv, col, b * a.L + i0, bar_q);
      tma_tile(s_do, &maps.dout, col, b * a.L + i0, bar_q);
      tma_stats(s_st, a, g, b, h, i0, bar_q);
    }
    auto issue_k = [&](int n) {
      if (tid != 0) return;
      bar_expect(bar_k, TB);
      tma_tile(s_k, &maps.k, col, b * a.K + (s_list[n] >> 2) * kTile, bar_k);
    };
    auto issue_v = [&](int n) {
      if (tid != 0) return;
      bar_expect(bar_v, TB);
      tma_tile(s_v, &maps.v, col, b * a.K + (s_list[n] >> 2) * kTile, bar_v);
    };
    auto issue_c = [&](int n) {        // the chunks and column flags, slot n % 2
      if (tid != 0) return;
      const int kt = s_list[n] >> 2, sl = n & 1;
      const int lo = chunk_lo(qt, kt, nq, nk), hi = lo + 1 == nk ? 0 : lo + 1;
      uint64_t* bar = bar_c + sl;
      bar_expect(bar, 2 * TB + 2 * kVec);
      tma_tile(s_cl + sl * kTile * DH, &maps.wkr, col, lo * kTile, bar);
      tma_tile(s_ch + sl * kTile * DH, &maps.wkr, col, hi * kTile, bar);
      tma_vec(s_col + sl * 2 * kTile, a.cw + kt * kTile, bar);
      tma_vec(s_col + sl * 2 * kTile + kTile, a.cblk + (size_t)b * a.K + kt * kTile, bar);
    };
    if (cnt > 0) {
      issue_k(0);
      issue_v(0);
      issue_c(0);
    }
    if (cnt > 1) issue_c(1);
    zero(dqu);
    zero(dqv);
    bar_wait(bar_q, fill_q++ & 1);
    const int rt[2] = {reinterpret_cast<const int*>(s_st)[3 * kTile + row_of(0)],
                       reinterpret_cast<const int*>(s_st)[3 * kTile + row_of(1)]};

    for (int n = 0; n < cnt; ++n) {
      const int kt = s_list[n] >> 2, mode = s_list[n] & 3, j0 = kt * kTile, sl = n & 1;
      const bool prev_ok = n > 0 && (s_list[n - 1] >> 2) == kt - 1;
      const bool next_ok = n + 1 < cnt && (s_list[n + 1] >> 2) == kt + 1;
      const int lo = chunk_lo(qt, kt, nq, nk), hi = lo + 1 == nk ? 0 : lo + 1;
      const bf16* cl = s_cl + sl * kTile * DH;
      const bf16* ch = s_ch + sl * kTile * DH;
      bf16* d_lo = s_d + sl * kTile * kTile;          // D of chunk lo: its upper part
      bf16* d_hi = s_d + (sl ^ 1) * kTile * kTile;    // came from step n - 1 as d_hi
      bar_wait(bar_c + sl, fill_c[sl]++ & 1);
      float s[32], dp[32];
      {
        float clo[32], chi[32];
        wg_fence();
        mma_abt<DH>(clo, s_qv, cl);
        mma_abt<DH>(chi, s_qv, ch);
        wg_commit();
        wg_wait();
        reg_fence(clo);
        reg_fence(chi);
        scatter_band(s_bd, clo, chi);     // s_bd was last read before step n - 1's end
      }
      bar_wait(bar_k, fill_k++ & 1);
      bar_wait(bar_v, fill_v++ & 1);
      wg_fence();
      mma_abt<DH>(s, s_qu, s_k);
      mma_abt<DH>(dp, s_do, s_v);
      wg_commit();
      wg_wait();
      reg_fence(s);
      reg_fence(dp);
      __syncthreads();                 // V read (the band rows are this warp's own)
      if (n + 1 < cnt) issue_v(n + 1);
      scores_from(s, s_bd);
      mask_scores(s, a.scale, mode, s_col + sl * 2 * kTile, rt);
      form_ds(s, dp, a, s_st, b, h, i0, j0);
      uint32_t da[4][4];
      to_frags(da, dp);
      // dS unskewed onto the two chunks: j <= i to d_lo row j - i + 63, j > i
      // to d_hi row j - i - 1; the part a skipped neighbour tile would have
      // written is zero
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = row_of(x >> 1), j = 8 * nb + col2() + (x & 1);
          const bf16 v = __float2bfloat16_rn(dp[4 * nb + x]);
          const bf16 z = __float2bfloat16_rn(0.f);
          if (j <= i) {
            d_lo[core_at<kTile>(i, j - i + kTile - 1)] = v;
            if (!next_ok) d_hi[core_at<kTile>(i, j - i + kTile - 1)] = z;
          } else {
            d_hi[core_at<kTile>(i, j - i - 1)] = v;
            if (!prev_ok) d_lo[core_at<kTile>(i, j - i - 1)] = z;
          }
        }
      // the lo chunk's rows of the slot as this step's dWkr accumulator:
      // zero, or what an earlier row of the group left there, loaded now so
      // that the load overlaps the dQu product
      float dw[DH / 2];
      get_dw<DH>(dw, pw, HD, lo, s_wr[lo] != 0);
      // dQu += dS K
      wg_fence();
      mma_rb<DH>(dqu, da, s_k);
      wg_commit();
      wg_wait();
      reg_fence(dqu);
      fence_stores();
      __syncthreads();                 // D complete, K read
      if (n + 1 < cnt) issue_k(n + 1);
      // chunk lo is complete: dQv += D chunk, dWkr rows += D^T qv; chunk hi
      // too when the next key tile is not visited
      for (int c = 0; c < (next_ok ? 1 : 2); ++c) {
        const bf16* dd = c ? d_hi : d_lo;
        const int chunk = c ? hi : lo;
        if (c) get_dw<DH>(dw, pw, HD, hi, s_wr[hi] != 0);
        wg_fence();
        mma_ab<DH>(dqv, dd, c ? ch : cl);
        mma_atb<DH>(dw, dd, s_qv);
        wg_commit();
        wg_wait();
        reg_fence(dqv);
        reg_fence(dw);
        put_dw<DH>(pw, HD, chunk, dw);
      }
      __syncthreads();                 // slot n % 2 and d_lo read; flags read
      if (tid == 0) {
        s_wr[lo] = 1;
        if (!next_ok) s_wr[hi] = 1;
      }
      if (n + 2 < cnt) issue_c(n + 2);
    }

    // dQ, and the tile's column sums of dQu and dQv added to the group's
    bf16* dst = dq + ((size_t)b * a.L + i0) * HD + h * DH;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row_of(hh) * HD + 8 * nb + col2()) =
            pack(dqu[4 * nb + 2 * hh] + dqv[4 * nb + 2 * hh],
                 dqu[4 * nb + 2 * hh + 1] + dqv[4 * nb + 2 * hh + 1]);
    __syncthreads();                   // s_bd free
    float* s_su = s_bd;                // [warp][DH] column sums of each warp's 16 rows
    float* s_sv = s_bd + 4 * DH;
    const int warp = tid >> 5, g8 = (tid & 31) >> 2;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = dqu[4 * nb + e] + dqu[4 * nb + 2 + e];
        float y = dqv[4 * nb + e] + dqv[4 * nb + 2 + e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, o);
          y += __shfl_xor_sync(0xffffffffu, y, o);
        }
        if (g8 == 0) {
          s_su[warp * DH + 8 * nb + col2() + e] = x;
          s_sv[warp * DH + 8 * nb + col2() + e] = y;
        }
      }
    __syncthreads();
    if (tid < DH) {
      float tu = 0.f, tv = 0.f;
      for (int w = 0; w < 4; ++w) {
        tu += s_su[w * DH + tid];
        tv += s_sv[w * DH + tid];
      }
      s_uv[tid] += tu;
      s_uv[DH + tid] += tv;
    }
  }
  __syncthreads();
  if (tid < DH) {
    part.u[slot * HD + h * DH + tid] = s_uv[tid];
    part.v[slot * HD + h * DH + tid] = s_uv[DH + tid];
  }
  // chunk rows no visited tile reached hold zero
  for (int c = 0; c < nk; ++c) {
    if (s_wr[c]) continue;
    for (int x = tid; x < kTile * DH / 4; x += kWG) {
      const int r = x / (DH / 4), c4 = x % (DH / 4);
      *reinterpret_cast<float4*>(pw + (size_t)(c * kTile + r) * HD + 4 * c4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Both backward passes in one launch, so that the dK/dV pass's short blocks
// fill the card while the dQ pass's long ones finish: blocks 0 .. n_dq - 1
// are dQ blocks, heaviest query tiles first (the causal mask gives the last
// query tiles the most key tiles), then the dK/dV blocks, key tile by key
// tile (memory tiles, visible to every query tile, first).
template <int DH>
__global__ void __launch_bounds__(kWG, 2)
flash_train_bwd_kernel(Params a, const __grid_constant__ Maps maps, Grads g,
                       bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       Partials part, int G) {
  const int nq = a.L / kTile;
  const int n_dq = nq * a.H * (a.B / G);
  int x = blockIdx.x;
  if (x < n_dq) {
    const int per_tile = a.H * (a.B / G);
    const int qt = nq - 1 - x / per_tile;
    x %= per_tile;
    dq_block<DH>(a, maps, g, dq, part, G, qt, x % a.H, x / a.H);
  } else {
    x -= n_dq;
    const int b = x % a.B;
    x /= a.B;
    dkdv_block<DH>(a, maps, g, dk, dv, x / a.H, x % a.H, b);
  }
}


template <int DH>
cudaError_t launch_fwd(const Params& a, void* out, float* m, float* l, cudaStream_t st) {
  Maps maps;
  if (!make_maps(&maps, a, nullptr, DH)) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem<DH>(a.K / kTile);
  static size_t done[2];
  cudaError_t err = set_smem_once(flash_train_fwd_kernel<DH>, smem, done);
  if (err != cudaSuccess) return err;
  flash_train_fwd_kernel<DH><<<dim3(a.L / kTile, a.H, a.B), kWG, smem, st>>>(
      a, maps, static_cast<bf16*>(out), m, l);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const Params& a, const Grads& g, void* dq, void* dk, void* dv,
                       Partials part, int G, float* dwkr, float* du, float* dvb, cudaStream_t st) {
  Maps maps;
  if (!make_maps(&maps, a, g.dout, DH)) return cudaErrorInvalidValue;
  const int nq = a.L / kTile, nk = a.K / kTile;
  const size_t s1 = dkdv_smem<DH>(nq), s2 = dq_smem<DH>(nk), smem = s1 > s2 ? s1 : s2;
  static size_t done[2];
  cudaError_t err = set_smem_once(flash_train_bwd_kernel<DH>, smem, done);
  if (err != cudaSuccess) return err;
  const unsigned n_blocks = (unsigned)(nq * a.H * (a.B / G) + nk * a.H * a.B);
  flash_train_bwd_kernel<DH><<<n_blocks, kWG, smem, st>>>(
      a, maps, g, static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), part,
      G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, (a.B / G) * nq, a.K, a.H * DH, dwkr, du, dvb, st);
}

Params make_params(const void* qu, const void* qv, const void* k, const void* v,
                   const void* wkr, const int* rt, const int* cw, const int* cblk,
                   const int* tiles, int B, int L, int K, int H, float scale, int dropout,
                   uint32_t seed, int thresh, float keep_scale) {
  Params a;
  a.qu = static_cast<const bf16*>(qu);
  a.qv = static_cast<const bf16*>(qv);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.wkr = static_cast<const bf16*>(wkr);
  a.rt = rt;
  a.cw = cw;
  a.cblk = cblk;
  a.tiles = tiles;
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

// K >= kBand: a tile pair's two band chunks are distinct rows of wkr.
bool shapes_ok(int B, int L, int K, int H) {
  return B > 0 && H > 0 && L > 0 && L % kTile == 0 && K % kTile == 0 && K >= L &&
         K >= kBand;
}

}  // namespace

extern "C" {

const char* flash_train_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward. Device pointers into contiguous tensors: q, out (B, L, H*Dh) bf16;
// k, v (B, K, H*Dh) bf16; wkr (K, H*Dh) bf16; u, vb (H*Dh) bf16; rt (L), cw
// (K), cblk (B, K) int32 (cblk = cb | kp); tiles (B, L / 64, K / 64) int32
// (ops/flash_train.py::tile_map); qu, qv (B, L, H*Dh) bf16 scratch; m, l
// (B, H, L) f32 out. Needs L, K multiples of 64, K >= L, K >= 128, Dh in
// {32, 64}. dropout != 0 switches dropout on: keep where the hash of seed +
// b CB + (h + 1) CH + i K + j, as int32, exceeds thresh, and scale the kept
// probabilities by keep_scale. Returns the CUDA error of the launches (0 =
// cudaSuccess); does not synchronize.
int flash_train_fwd(const void* q, const void* k, const void* v, const void* wkr,
                    const void* u, const void* vb, const int* rt, const int* cw,
                    const int* cblk, const int* tiles, void* qu, void* qv, void* out, float* m,
                    float* l, int B, int L, int K, int H, int Dh, float scale, int dropout,
                    uint32_t seed, int thresh, float keep_scale, void* stream) {
  if (!shapes_ok(B, L, K, H) || (Dh != 32 && Dh != 64)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_bias(q, u, vb, qu, qv, B, L, H * Dh, st);
  if (err != cudaSuccess) return (int)err;
  const Params a = make_params(qu, qv, k, v, wkr, rt, cw, cblk, tiles, B, L, K, H, scale,
                               dropout, seed, thresh, keep_scale);
  return (int)(Dh == 32 ? launch_fwd<32>(a, out, m, l, st) : launch_fwd<64>(a, out, m, l, st));
}

// Backward. The forward's operands, then qu, qv (B, L, H*Dh) bf16 scratch,
// dout (B, L, H*Dh) bf16, delta
// (B, H, L) f32, the forward's m, l; out: dq (B, L, H*Dh), dk, dv (B, K,
// H*Dh) bf16, dwkr (K, H*Dh), du, dvb (H*Dh) f32; scratch: part_w
// (B / G * L / 64, K, H*Dh), part_u, part_v (B / G * L / 64, H*Dh) f32: one
// slot per group of G batch rows (G divides B) and query tile.
int flash_train_bwd(const void* q, const void* k, const void* v, const void* wkr,
                    const void* u, const void* vb, const int* rt, const int* cw,
                    const int* cblk, const int* tiles, void* qu, void* qv, const void* dout,
                    const float* delta, const float* m, const float* l, void* dq, void* dk,
                    void* dv, float* dwkr, float* du, float* dvb, float* part_w, float* part_u,
                    float* part_v, int G, int B, int L, int K, int H, int Dh, float scale,
                    int dropout, uint32_t seed, int thresh, float keep_scale, void* stream) {
  if (!shapes_ok(B, L, K, H) || (Dh != 32 && Dh != 64) || G <= 0 || B % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_bias(q, u, vb, qu, qv, B, L, H * Dh, st);
  if (err != cudaSuccess) return (int)err;
  const Params a = make_params(qu, qv, k, v, wkr, rt, cw, cblk, tiles, B, L, K, H, scale,
                               dropout, seed, thresh, keep_scale);
  Grads g;
  g.dout = static_cast<const bf16*>(dout);
  g.delta = delta;
  g.m = m;
  g.l = l;
  Partials part;
  part.w = part_w;
  part.u = part_u;
  part.v = part_v;
  return (int)(Dh == 32 ? launch_bwd<32>(a, g, dq, dk, dv, part, G, dwkr, du, dvb, st)
                        : launch_bwd<64>(a, g, dq, dk, dv, part, G, dwkr, du, dvb, st));
}

}  // extern "C"
