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
// Design, for Hopper, after flash_train.cu (its header says more): one
// warpgroup a block, 64 query rows by 64 keys a tile pair, every product a
// warpgroup product (wgmma, bf16 in, f32 accumulate) on tiles copied by TMA
// from 2-D tensor maps and counted by mbarriers (hopper_common.cuh); qu and
// qv are formed once a call into scratch (launch_bias), so the maps read them.
//
//   1. Band chains. No band row wraps: BD reads wkr row W - 1 - (i - j) on
//      bidir's causal side, row j - i - 2 (with qv_{i+1}) on its spill side,
//      and row j + L - 1 - i < K on cross's band. A tile pair (i0, j0)
//      takes BD from two 64-row chunks of wkr, lo (its j <= i part: chunk
//      row j - i + 63) and hi (its j > i part: chunk row j - i - 1), each
//      multiplied by a 64-row qv operand:
//        causal chain: qv rows i0 .., chunks at rows 64 c;
//        spill chain:  qv rows i0 + 1 .. (the next tile's first; TMA reads
//                      the next batch row's there, and, after the last, a
//                      zero row: only row i0 + 64 = L meets it, on no score),
//                      chunks at rows 64 c - 1 (TMA fills row -1 with zeros:
//                      exactly the j = i + 1 column, whose BD is 0).
//      bidir: pairs below the diagonal take both chunks from the causal
//      chain, pairs above from the spill chain, the diagonal its lo chunk
//      from the causal and its hi chunk from the spill chain. cross: one
//      causal chain; the band's diagonal pair (j0 = i0 + K - L) takes only
//      its lo chunk, the pairs above it none. The hi chunk of key tile kt is
//      the lo chunk of kt + 1 (lo_src / hi_src; tests/test_torch_flash_mt_
//      tiles.py models the same schedule), so a walk over a query
//      tile's key tiles computes one chunk product a pair: the hi one, whose
//      j <= i part it leaves in the band tile as the next pair's lo part
//      (a warp's rows are its own: no block barrier). The first pair of a
//      walk, and a pair after a skipped one, compute their lo chunk too.
//   2. Tile skipping (bidir). The wrapper classifies every (batch row,
//      query tile, key tile) from the key padding (ops/flash_train.py::
//      tile_map): 0 every key padded, skipped (P is exactly 0 there); 1
//      mixed; 2 no key padded, no per-element test. A batch row with no
//      visible key skips nothing. Each block walks only its listed tiles in
//      every pass.
//   3. One score path in every pass (band_put, scores_from, mask_scores,
//      prob_r, form_ds): the same products on the same operands, so the
//      backward recomputes the forward's P bit for bit.
//
// Forward (flash_mt_fwd_kernel), one block per (query tile, head, batch
// row), two passes over its listed key tiles (the row max and sum online,
// then the normalised, dropped-out, bf16-rounded probabilities times V). K
// and the hi chunk come through a three-stage ring two steps ahead, V (second
// pass) through two slots one step ahead; a walk's fresh lo chunk lands in
// the band tile before the band does.
//
// Backward: dS = P * (keep * dP - delta) * scale with dP = dO . V^T and delta
// = sum_d dO * O (taken in f32 by the caller). One launch (flash_mt_bwd_
// kernel): the dK/dV blocks, then the dQ blocks, the last query tiles first.
//   - dkdv_block, one per (key tile, head, batch row), over its listed query
//     tiles: dV += bf16(Pd)^T dO, dK += bf16(dS)^T qu; both chunks a pair.
//   - dq_block, one per (query tile, head, group of G batch rows), over its
//     listed key tiles: dQ += bf16(dS) K + D_c chunk_c, dWkr_c += D_c^T qv,
//     with D_c (64 x 64 bf16) dS unskewed onto chunk c from the two pairs
//     it serves, completed once, in the same wgmma group as dS K. A spill
//     chunk's D is stored one row down (row p pairs with qv row i0 + p); its
//     last row (qv row i0 + 64, the next tile's first) stays apart: its
//     dWkr term is added in registers, and its dQ term is the tile's seam
//     carry. The walk's chunk loads (a fresh lo chunk, then each pair's hi)
//     run through a three-slot ring. The unskew is written per chain pair
//     (d_scatter<LO, HI>), with no per-element test of the chain: that took
//     the backward's device time from 0.542 to 0.406 ms (bidir) and 0.48 to
//     0.30 (cross) at the train shape (PERF.md §6). dWkr goes
//     to one partial slot per (group, query tile), loaded as the wgmma's
//     initial accumulator and stored back in the group's row order.
//   - partials_reduce_kernel (flash_common.cuh) sums the slots in a fixed
//     order, and (bidir) forms each query tile's first dQ row from its f32
//     head and the previous tile's carry, so a backward gives the same bits
//     on every run.
//
// Bound. At the multitask train shape (B 16, W = L = K = 512, 8 x 64 heads,
// bf16) the forward's three products over the B H L K pairs take 12.9 GFLOP
// (13.0 us at 989 TFLOP/s bf16) and the backward's eight 34.4 GFLOP
// (34.7 us); the bytes take ~7.6 / ~15 us: operations bound both. Executed
// against needed dense 64 x 64 products a tile pair (bidir, nothing
// skipped): forward 5 (AC and one chunk product in each pass, P.V) against
// 3, plus one chunk product a query tile and pass for its walk's first lo
// chunk; backward 12 (dK/dV pass: AC, both chunks, dP, dV, dK; dQ pass: AC,
// one chunk, dP, dQ's two terms, dWkr) against 8. cross (L = K): the 28 of
// 64 tile pairs above the band compute no chunk product and no BD term.
//
// Occupancy (nvcc -Xptxas -v for sm_90a, Dh 64; the card's build log under
// ops/_build): forward 167 registers (cross 168), no spills, 108,544 bytes
// of shared memory (cross 99,584); backward 254 registers, no spills,
// 110,080 bytes (the dQ block's; the dK/dV block needs 101,376; cross
// 101,888 / 93,184). Two blocks (8 warps) an SM each.

#include "hopper_common.cuh"

namespace {

// --- operands ---------------------------------------------------------------

struct Params {
  const bf16 *qu, *qv;          // (B, L, HD): q + u, q + v rounded to bf16
  const bf16 *k, *v, *wkr;      // (B, K, HD) x 2, (K, HD)
  const int* kp;                // (B, K) key padding (bidir)
  const int* tiles;             // (B, L / 64, K / 64) (bidir): 0 skip, 1 mixed, 2 visible
  int B, L, K, H;
  float scale;
  uint32_t seed;       // attention seed as uint32
  int thresh;          // keep where the mix, as int32, exceeds it
  float keep_scale;    // 1 / (1 - p) in f32
  bool dropout;
};

// --- the band schedule --------------------------------------------------------

// A band chunk: wkr rows row .. row + 63 times the qv rows of chain ch (0:
// the query tile's own, i0 ..; 1: the spill's, i0 + 1 ..); ch < 0: none.
struct Src {
  int row, ch;
};

// The chunk of tile pair (qt, kt) whose rows land on its j <= i part (lo)
// and on its j > i part (hi); tests/test_torch_flash_mt_tiles.py::
// band_sources models the same.
template <bool BIDIR>
__device__ __forceinline__ Src lo_src(int qt, int kt, int nq, int nk) {
  if (BIDIR)
    return kt <= qt ? Src{kTile * (nk - 1 - qt + kt), 0} : Src{kTile * (kt - qt - 1) - 1, 1};
  return kt - qt <= nk - nq ? Src{kTile * (kt + nq - 1 - qt), 0} : Src{0, -1};
}
template <bool BIDIR>
__device__ __forceinline__ Src hi_src(int qt, int kt, int nq, int nk) {
  if (BIDIR) return kt < qt ? Src{kTile * (nk - qt + kt), 0} : Src{kTile * (kt - qt) - 1, 1};
  return kt - qt < nk - nq ? Src{kTile * (kt + nq - qt), 0} : Src{0, -1};
}

// The band tile (64 x 64 f32, swz): a chunk product's row r of query row i
// lands on (i, (r + i + 1) mod 64), on the pair whose hi chunk it is where
// r + i <= 62 (PART 1, j > i), on the pair whose lo chunk it is where
// r + i >= 63 (PART 0, j <= i). Each warp writes and reads only its rows.
template <int PART>
__device__ __forceinline__ void band_put(float* s_bd, const float (&c)[32]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = row_of(x >> 1), r = 8 * nb + col2() + (x & 1);
      if ((r + i >= kTile - 1) == (PART == 0))
        s_bd[swz(i, (r + i + 1) & (kTile - 1))] = c[4 * nb + x];
    }
}

// Zeros the j > i part (a pair with no hi chunk).
__device__ __forceinline__ void band_zero_hi(float* s_bd) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = row_of(x >> 1), j = 8 * nb + col2() + (x & 1);
      if (j > i) s_bd[swz(i, j)] = 0.f;
    }
}

// s = AC + BD: every pass forms its scores here.
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

// The masked, scaled scores of a tile pair in place: -1e9 on a padded key of
// a mixed tile (bidir); mode 2 (no key padded; cross) skips the tests. The
// _rn intrinsic keeps nvcc from contracting it differently in different
// kernels.
__device__ __forceinline__ void mask_scores(float (&s)[32], float scale, int mode, const int* kp) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = 8 * nb + col2() + (x & 1);
      s[4 * nb + x] = mode != 2 && kp[j] ? -1e9f : __fmul_rn(s[4 * nb + x], scale);
    }
}

// The block's walk: bidir, the listed tiles of its tile-map row; cross,
// every tile, fully visible.
template <bool BIDIR>
__device__ __forceinline__ int walk(int* s_list, const int* row, int n, int stride) {
  if constexpr (BIDIR) {
    return list_tiles(s_list, s_list + n, row, n, stride);
  } else {
    for (int x = threadIdx.x; x < n; x += kWG) s_list[x] = 4 * x + 2;
    __syncthreads();
    return n;
  }
}

// Element (r, c) of a (64 x DH) TMA tile, swizzled by its row width (the
// 128-byte pattern at DH 64, the 64-byte one at DH 32).
template <int DH>
__device__ __forceinline__ int sw_at(int r, int c) {
  return DH == 64 ? r * 64 + (c ^ ((r & 7) << 3)) : r * 32 + (c ^ (((r >> 1) & 3) << 3));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kStages = 3;   // K and the hi chunk: copies run two steps ahead

template <int DH, bool BIDIR>
__host__ __device__ constexpr size_t fwd_smem(int nk) {
  return kBarBytes + ((BIDIR ? 3 : 2) + 2 * kStages + 2) * tile_bytes<DH>() + kBandBytes +
         (BIDIR ? piece(kStages * kVec) : 0) + piece((size_t)nk * 4 + 4);
}

// grid (L / 64, H, B). out (B, L, HD) bf16; m, l (B, H, L) f32: each query
// row's softmax max and sum.
template <int DH, bool BIDIR>
__global__ void __launch_bounds__(kWG, 2)
flash_mt_fwd_kernel(Params a, const __grid_constant__ Maps maps, bf16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int T = kTile * DH;
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* s_qu = cv.take<bf16>(T);
  bf16* s_qv = cv.take<bf16>(T);
  bf16* s_qs = BIDIR ? cv.take<bf16>(T) : s_qv;    // qv rows i0 + 1 ..: the spill chain's
  bf16* s_stage = cv.take<bf16>(2 * kStages * T);   // the stages: K, the hi chunk
  bf16* s_v = cv.take<bf16>(2 * T);                 // V, two slots (second pass)
  float* s_bd = cv.take<float>(kTile * kTile);      // the band; a fresh lo chunk first
  int* s_kp = BIDIR ? cv.take<int>(kStages * kTile) : nullptr;   // a stage's key padding
  uint64_t* bars = cv.take<uint64_t>(16);
  uint64_t *bar_q = bars, *bar_cl = bars + 1, *bar_s = bars + 2;  // bar_s: one a stage
  uint64_t* bar_v = bars + 2 + kStages;                           // two
  const int nq = a.L / kTile, nk = a.K / kTile;
  int* s_list = cv.take<int>(nk + 1);

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = qt * kTile, col = h * DH;

  if (tid == 0) {
    for (int x = 0; x < 4 + kStages; ++x) bar_init(bars + x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int cnt = walk<BIDIR>(s_list, a.tiles + ((size_t)b * nq + qt) * nk, nk, 1);

  if (tid == 0) {
    bar_expect(bar_q, (BIDIR ? 3 : 2) * TB);
    tma_tile(s_qu, &maps.qu, col, b * a.L + i0, bar_q);
    tma_tile(s_qv, &maps.qv, col, b * a.L + i0, bar_q);
    if (BIDIR) tma_tile(s_qs, &maps.qv, col, b * a.L + i0 + 1, bar_q);
  }

  // step f (0 .. 2 cnt - 1) visits list entry f mod cnt in pass f / cnt;
  // its K and hi chunk go to stage f % kStages, its V (second pass) to slot
  // (f - cnt) % 2
  auto issue = [&](int f) {
    if (tid != 0) return;
    const int n = f >= cnt ? f - cnt : f, st = f % kStages;
    const int kt = s_list[n] >> 2;
    const Src hi = hi_src<BIDIR>(qt, kt, nq, nk);
    bf16* stage = s_stage + 2 * st * T;
    uint64_t* bar = bar_s + st;
    bar_expect(bar, (hi.ch >= 0 ? 2 : 1) * TB + (BIDIR ? kVec : 0));
    tma_tile(stage, &maps.k, col, b * a.K + kt * kTile, bar);
    if (hi.ch >= 0) tma_tile(stage + T, &maps.wkr, col, hi.row, bar);
    if (BIDIR) tma_vec(s_kp + st * kTile, a.kp + (size_t)b * a.K + kt * kTile, bar);
  };
  auto issue_v = [&](int f) {
    if (tid != 0) return;
    const int u = f - cnt;
    uint64_t* bar = bar_v + (u & 1);
    bar_expect(bar, TB);
    tma_tile(s_v + (u & 1) * T, &maps.v, col, b * a.K + (s_list[u] >> 2) * kTile, bar);
  };
  // a map never empties a query tile's row (tile_map)
  for (int f = 0; f < kStages - 1 && f < 2 * cnt; ++f) issue(f);
  bar_wait(bar_q, 0);

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};
  float o[DH / 2];
  zero(o);
  uint32_t fill_cl = 0;
  for (int f = 0; f < 2 * cnt; ++f) {
    const int pass = f >= cnt, n = f - pass * cnt, st = f % kStages;
    const int kt = s_list[n] >> 2, mode = s_list[n] & 3, j0 = kt * kTile;
    const bf16* stage = s_stage + 2 * st * T;
    const Src lo = lo_src<BIDIR>(qt, kt, nq, nk), hi = hi_src<BIDIR>(qt, kt, nq, nk);
    const bool fresh = lo.ch >= 0 && !(n > 0 && (s_list[n - 1] >> 2) == kt - 1);
    // stage (f + 2) % 3 and V slot (f + 1 - cnt) % 2 were freed at the end of step f - 1
    if (f + kStages - 1 < 2 * cnt) issue(f + kStages - 1);
    if (f + 1 >= cnt && f + 1 < 2 * cnt) issue_v(f + 1);
    if (f == cnt) {
      rl[0] = __frcp_rn(l_r[0]);
      rl[1] = __frcp_rn(l_r[1]);
    }
    float s[32];
    if (fresh) {
      // the lo chunk on the spot, into the band tile; its product's lo part
      bf16* s_cl = reinterpret_cast<bf16*>(s_bd);
      if (tid == 0) {
        bar_expect(bar_cl, TB);
        tma_tile(s_cl, &maps.wkr, col, lo.row, bar_cl);
      }
      bar_wait(bar_cl, fill_cl++ & 1);
      wg_fence();
      mma_abt<DH>(s, lo.ch ? s_qs : s_qv, s_cl);
      wg_commit();
      wg_wait();
      reg_fence(s);
      __syncthreads();                 // every warp's product read the chunk
      band_put<0>(s_bd, s);
    }
    bar_wait(bar_s + st, (f / kStages) & 1);
    {
      float c[32];
      wg_fence();
      mma_abt<DH>(s, s_qu, stage);
      if (hi.ch >= 0) mma_abt<DH>(c, hi.ch ? s_qs : s_qv, stage + T);
      wg_commit();
      wg_wait();
      reg_fence(s);
      reg_fence(c);
      if (lo.ch >= 0) {
        if (hi.ch >= 0)
          band_put<1>(s_bd, c);
        else
          band_zero_hi(s_bd);
        __syncwarp();
        scores_from(s, s_bd);
        __syncwarp();
        if (hi.ch >= 0) band_put<0>(s_bd, c);   // the next pair's lo part
      }
    }
    mask_scores(s, a.scale, BIDIR ? mode : 2, BIDIR ? s_kp + st * kTile : nullptr);
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
      bar_wait(bar_v + (n & 1), (n >> 1) & 1);
      wg_fence();
      mma_rb<DH>(o, pa, s_v + (n & 1) * T);
      wg_commit();
      wg_wait();
      reg_fence(o);
    }
    fence_stores();                    // the band's plain stores before a TMA there
    __syncthreads();                   // stage f % 3, V slot and the band read
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

// The query tile's row statistics into st: m, l, delta.
__device__ __forceinline__ void tma_stats(float* st, const Params& a, const Grads& g, int b,
                                          int h, int i0, uint64_t* bar) {
  const size_t row = ((size_t)b * a.H + h) * a.L + i0;
  tma_vec(st, g.m + row, bar);
  tma_vec(st + kTile, g.l + row, bar);
  tma_vec(st + 2 * kTile, g.delta + row, bar);
}

template <int DH, bool BIDIR>
__host__ __device__ constexpr size_t dkdv_smem(int nq) {
  return kBarBytes + ((BIDIR ? 10 : 9) * tile_bytes<DH>()) + kBandBytes +
         2 * piece(3 * kVec) + piece(kVec) + piece((size_t)nq * 4 + 4);
}

// dK, dV of key tile kt of (head h, batch row b), (B, K, HD) bf16.
template <int DH, bool BIDIR>
__device__ __forceinline__ void dkdv_block(const Params& a, const Maps& maps, const Grads& g,
                                           bf16* __restrict__ dk, bf16* __restrict__ dv, int kt,
                                           int h, int b) {
  constexpr int T = kTile * DH;
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* s_k = cv.take<bf16>(T);
  bf16* s_v = cv.take<bf16>(T);
  bf16* s_qu = cv.take<bf16>(2 * T);          // two slots
  bf16* s_do = cv.take<bf16>(2 * T);
  bf16* s_qa = cv.take<bf16>(T);              // the lo chunk's qv rows
  bf16* s_qb = BIDIR ? cv.take<bf16>(T) : s_qa;   // the hi chunk's, where the chain differs
  bf16* s_cl = cv.take<bf16>(2 * T);          // the two chunks, one piece
  bf16* s_ch = s_cl + T;
  float* s_bd = cv.take<float>(kTile * kTile);    // then bf16 Pd and dS tiles
  bf16* s_pd = reinterpret_cast<bf16*>(s_bd);
  bf16* s_ds = s_pd + kTile * kTile;
  float* s_st = cv.take<float>(3 * kTile);        // slot 0: m, l, delta
  cv.take<float>(3 * kTile);                      // slot 1 follows
  int* s_kp = cv.take<int>(kTile);
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
  const int cnt = walk<BIDIR>(s_list, a.tiles + (size_t)b * nq * nk + kt, nq, nk);

  if (tid == 0) {
    bar_expect(bar_kv, 2 * TB + (BIDIR ? kVec : 0));
    tma_tile(s_k, &maps.k, col, b * a.K + j0, bar_kv);
    tma_tile(s_v, &maps.v, col, b * a.K + j0, bar_kv);
    if (BIDIR) tma_vec(s_kp, a.kp + (size_t)b * a.K + j0, bar_kv);
  }

  // query tile n's qu, dO and statistics into slot n % 2; its band operands
  auto issue_a = [&](int n) {
    if (tid != 0) return;
    const int i0 = (s_list[n] >> 2) * kTile, slot = n & 1;
    uint64_t* bar = bar_a + slot;
    bar_expect(bar, 2 * TB + 3 * kVec);
    tma_tile(s_qu + slot * T, &maps.qu, col, b * a.L + i0, bar);
    tma_tile(s_do + slot * T, &maps.dout, col, b * a.L + i0, bar);
    tma_stats(s_st + slot * 3 * kTile, a, g, b, h, i0, bar);
  };
  auto issue_b = [&](int n) {
    if (tid != 0) return;
    const int qt = s_list[n] >> 2;
    const Src lo = lo_src<BIDIR>(qt, kt, nq, nk), hi = hi_src<BIDIR>(qt, kt, nq, nk);
    if (lo.ch < 0) return;
    const bool two = hi.ch >= 0 && hi.ch != lo.ch;
    bar_expect(bar_b, (2 + (hi.ch >= 0) + two) * TB);
    tma_tile(s_qa, &maps.qv, col, b * a.L + qt * kTile + lo.ch, bar_b);
    tma_tile(s_cl, &maps.wkr, col, lo.row, bar_b);
    if (hi.ch >= 0) tma_tile(s_ch, &maps.wkr, col, hi.row, bar_b);
    if (two) tma_tile(s_qb, &maps.qv, col, b * a.L + qt * kTile + hi.ch, bar_b);
  };
  if (cnt > 0) {
    issue_a(0);
    issue_b(0);
  }

  float ak[DH / 2], av[DH / 2];
  zero(ak);
  zero(av);
  bar_wait(bar_kv, 0);
  uint32_t fill_b = 0;
  for (int n = 0; n < cnt; ++n) {
    const int qt = s_list[n] >> 2, mode = s_list[n] & 3, i0 = qt * kTile, slot = n & 1;
    const Src lo = lo_src<BIDIR>(qt, kt, nq, nk), hi = hi_src<BIDIR>(qt, kt, nq, nk);
    const bf16* qu = s_qu + slot * T;
    const bf16* dO = s_do + slot * T;
    const float* st = s_st + slot * 3 * kTile;
    if (n + 1 < cnt) issue_a(n + 1);   // slot (n + 1) % 2 was freed at the end of n - 1
    float s[32], dp[32];
    if (lo.ch >= 0) {
      float clo[32], chi[32];
      bar_wait(bar_b, fill_b++ & 1);
      wg_fence();
      mma_abt<DH>(clo, s_qa, s_cl);
      if (hi.ch >= 0) mma_abt<DH>(chi, hi.ch != lo.ch ? s_qb : s_qa, s_ch);
      wg_commit();
      wg_wait();
      reg_fence(clo);
      reg_fence(chi);
      __syncthreads();                 // the band operands read
      if (n + 1 < cnt) issue_b(n + 1);
      band_put<0>(s_bd, clo);
      if (hi.ch >= 0)
        band_put<1>(s_bd, chi);
      else
        band_zero_hi(s_bd);
    } else if (n + 1 < cnt) {
      issue_b(n + 1);                  // the band operands were read in step n - 1
    }
    bar_wait(bar_a + slot, (n >> 1) & 1);
    wg_fence();
    mma_abt<DH>(s, qu, s_k);
    mma_abt<DH>(dp, dO, s_v);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    if (lo.ch >= 0) {
      __syncwarp();                    // this warp's band rows written
      scores_from(s, s_bd);
    }
    mask_scores(s, a.scale, BIDIR ? mode : 2, s_kp);
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

constexpr int kRing = 3;   // the dQ blocks' chunk ring

template <int DH, bool BIDIR>
__host__ __device__ constexpr size_t dq_smem(int nk, int K) {
  return kBarBytes + (((BIDIR ? 6 : 5) + kRing) * tile_bytes<DH>()) + kBandBytes +
         2 * piece((size_t)kTile * kTile * 2) + piece(3 * kVec) + piece(kVec) +
         piece(2 * kTile * 2) + piece((size_t)2 * DH * 4) + piece((size_t)nk * 4 + 4) +
         piece((size_t)K);
}

// Entry (i, r) of a chunk's D tile (core tile [row][r], bf16): row i of the
// causal chain (CH 0), row i + 1 of the spill (CH 1); the spill's row 64
// goes to its r63 vector, and its row 0 (no query row of this tile) is then
// zero.
template <int CH>
__device__ __forceinline__ void d_put(bf16* d, bf16* r63, int i, int r, bf16 v) {
  if (CH == 0 || i + 1 < kTile) {
    d[core_at<kTile>(i + CH, r)] = v;
  } else {
    r63[r] = v;
    d[core_at<kTile>(0, r)] = __float2bfloat16_rn(0.f);
  }
}

// This thread's entries of dS onto the pair's two chunks: j <= i to the lo
// chunk's chunk row j - i + 63, j > i to the hi chunk's row j - i - 1; LO /
// HI: their chains, -1 for none.
template <int LO, int HI>
__device__ __forceinline__ void d_scatter(bf16* d_lo, bf16* r_lo, bf16* d_hi, bf16* r_hi,
                                          const float (&ds)[32]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = row_of(x >> 1), j = 8 * nb + col2() + (x & 1);
      const bf16 v = __float2bfloat16_rn(ds[4 * nb + x]);
      if (j <= i) {
        if (LO >= 0) d_put<LO>(d_lo, r_lo, i, j - i + kTile - 1, v);
      } else if (HI >= 0) {
        d_put<HI>(d_hi, r_hi, i, j - i - 1, v);
      }
    }
}

// Zeros in the part of a chunk's D tile that an unwalked neighbour pair
// would have written: PART 1 its j > i part (a fresh lo chunk), PART 0 its
// j <= i part (a hi chunk the next pair does not finish).
template <int CH, int PART>
__device__ __forceinline__ void d_zero(bf16* d, bf16* r63) {
  const bf16 z = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = row_of(x >> 1), j = 8 * nb + col2() + (x & 1);
      if (PART == 0 && j <= i) d_put<CH>(d, r63, i, j - i + kTile - 1, z);
      if (PART == 1 && j > i) d_put<CH>(d, r63, i, j - i - 1, z);
    }
}

// Rows row0 + (16 w + g (+ 8)) of a partial slot (row t at pw + t * HD) as a
// 64 x DH f32 accumulator: zero where the block has not written them yet (a
// row < 0, the spill's wkr row -1, is never written).
template <int DH>
__device__ __forceinline__ void get_rows(float (&dw)[DH / 2], const float* pw, int HD, int row0,
                                         const unsigned char* s_wr) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = row0 + row_of(hh);
    const bool have = t >= 0 && s_wr[t];
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      float2 v = make_float2(0.f, 0.f);
      if (have) v = *reinterpret_cast<const float2*>(pw + (size_t)t * HD + 8 * nb + col2());
      dw[4 * nb + 2 * hh] = v.x;
      dw[4 * nb + 2 * hh + 1] = v.y;
    }
  }
}
template <int DH>
__device__ __forceinline__ void put_rows(float* pw, int HD, int row0, const float (&dw)[DH / 2],
                                         unsigned char* s_wr) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = row0 + row_of(hh);
    if (t < 0) continue;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
      *reinterpret_cast<float2*>(pw + (size_t)t * HD + 8 * nb + col2()) =
          make_float2(dw[4 * nb + 2 * hh], dw[4 * nb + 2 * hh + 1]);
    s_wr[t] = 1;
  }
}

// dQ of query tile qt of head h, (B, L, HD) bf16, for each of the G batch
// rows of group gr (bidir: its first row in f32 to seam.head, the spill's
// row after it to seam.carry), and their summed partials of dWkr, du and dv
// in slot gr * L / 64 + qt.
template <int DH, bool BIDIR>
__device__ __forceinline__ void dq_block(const Params& a, const Maps& maps, const Grads& g,
                                         bf16* __restrict__ dq, const Partials& part,
                                         const Seam& seam, int G, int qt, int h, int gr) {
  constexpr int T = kTile * DH;
  constexpr uint32_t TB = tile_bytes<DH>();
  constexpr int NP = kWG / DH;                    // threads a carry column
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* s_qu = cv.take<bf16>(T);
  bf16* s_qv = cv.take<bf16>(T);
  bf16* s_qs = BIDIR ? cv.take<bf16>(T) : s_qv;   // qv rows i0 + 1 ..
  bf16* s_do = cv.take<bf16>(T);
  bf16* s_k = cv.take<bf16>(T);
  bf16* s_v = cv.take<bf16>(T);
  bf16* s_c = cv.take<bf16>(kRing * T);           // the walk's chunk loads, a ring
  float* s_bd = cv.take<float>(kTile * kTile);    // then the du / dv / carry reduction
  bf16* s_d = cv.take<bf16>(2 * kTile * kTile);   // D, two slots
  float* s_st = cv.take<float>(3 * kTile);        // m, l, delta
  int* s_kp = cv.take<int>(kTile);
  bf16* s_r63 = cv.take<bf16>(2 * kTile);         // the spill D's row 64, two slots
  float* s_uv = cv.take<float>(2 * DH);           // du, dv summed over the group
  uint64_t* bars = cv.take<uint64_t>(16);
  uint64_t *bar_q = bars, *bar_k = bars + 1, *bar_v = bars + 2;
  uint64_t* bar_c = bars + 3;                                      // one a ring slot
  const int nq = a.L / kTile, nk = a.K / kTile;
  int* s_list = cv.take<int>(nk + 1);
  unsigned char* s_wr = cv.take<unsigned char>(a.K);   // slot rows written

  const int tid = threadIdx.x;
  const int HD = a.H * DH;
  const int i0 = qt * kTile, col = h * DH;
  const size_t slot = (size_t)gr * nq + qt;
  float* pw = part.w + slot * a.K * HD + col;

  if (tid == 0) {
    for (int x = 0; x < 6; ++x) bar_init(bars + x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int x = tid; x < a.K; x += kWG) s_wr[x] = 0;
  if (tid < 2 * DH) s_uv[tid] = 0.f;

  uint32_t fill_q = 0, fill_k = 0, fill_v = 0;
  // chunk loads, counted over the block's walks: load c goes to ring slot
  // c % kRing; q_used loads are consumed, q_iss issued (thread 0)
  uint32_t q_used = 0, q_iss = 0;
  float dqu[DH / 2], dqv[DH / 2];
  for (int bb = 0; bb < G; ++bb) {
    const int b = gr * G + bb;
    __syncthreads();                   // the previous row's tiles and list read
    const int cnt = walk<BIDIR>(s_list, a.tiles + ((size_t)b * nq + qt) * nk, nk, 1);
    if (tid == 0) {
      bar_expect(bar_q, (BIDIR ? 4 : 3) * TB + 3 * kVec);
      tma_tile(s_qu, &maps.qu, col, b * a.L + i0, bar_q);
      tma_tile(s_qv, &maps.qv, col, b * a.L + i0, bar_q);
      if (BIDIR) tma_tile(s_qs, &maps.qv, col, b * a.L + i0 + 1, bar_q);
      tma_tile(s_do, &maps.dout, col, b * a.L + i0, bar_q);
      tma_stats(s_st, a, g, b, h, i0, bar_q);
    }
    auto issue_k = [&](int n) {        // K and its key padding
      if (tid != 0) return;
      const int kt = s_list[n] >> 2;
      bar_expect(bar_k, TB + (BIDIR ? kVec : 0));
      tma_tile(s_k, &maps.k, col, b * a.K + kt * kTile, bar_k);
      if (BIDIR) tma_vec(s_kp, a.kp + (size_t)b * a.K + kt * kTile, bar_k);
    };
    auto issue_v = [&](int n) {
      if (tid != 0) return;
      bar_expect(bar_v, TB);
      tma_tile(s_v, &maps.v, col, b * a.K + (s_list[n] >> 2) * kTile, bar_v);
    };
    // the walk's chunk loads in order: each pair's lo chunk where it is
    // fresh (the walk's first pair, or after a skipped one), then its hi
    // chunk; thread 0 issues them while fewer than `limit` are issued
    int cn = 0, cpart = 0;
    auto issue_chunks = [&](uint32_t limit) {
      if (tid != 0) return;
      while (q_iss < limit && cn < cnt) {
        const int kt = s_list[cn] >> 2;
        const Src src = cpart == 0 ? lo_src<BIDIR>(qt, kt, nq, nk) : hi_src<BIDIR>(qt, kt, nq, nk);
        const bool load = src.ch >= 0 &&
                          (cpart == 1 || cn == 0 || (s_list[cn - 1] >> 2) != kt - 1);
        if (load) {
          const uint32_t sl = q_iss++ % kRing;
          bar_expect(bar_c + sl, TB);
          tma_tile(s_c + sl * T, &maps.wkr, col, src.row, bar_c + sl);
        }
        cn += cpart;
        cpart ^= 1;
      }
    };
    if (cnt > 0) {
      issue_k(0);
      issue_v(0);
    }
    issue_chunks(q_used + kRing);
    zero(dqu);
    zero(dqv);
    float carry = 0.f;                 // column tid % DH of the carry, rows of part tid / DH
    bar_wait(bar_q, fill_q++ & 1);

    // chunk src's D complete: dQv += D chunk, its dWkr rows (dw, loaded by
    // the caller) += D^T qv; issued, not waited. The spill's D is one row
    // down (row p pairs with qv row i0 + p); its row 64 (r63, with qv row
    // i0 + 64 = qs row 63) is added by complete_rest, to dWkr and the carry,
    // which then stores the rows
    auto complete_mma = [&](const bf16* d, const bf16* chunk, float (&dw)[DH / 2]) {
      mma_ab<DH>(dqv, d, chunk);
      mma_atb<DH>(dw, d, s_qv);
    };
    auto complete_rest = [&](const Src& src, const bf16* r63, const bf16* chunk,
                             float (&dw)[DH / 2]) {
      if (BIDIR && src.ch) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float rv = __bfloat162float(r63[row_of(hh)]);
#pragma unroll
          for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dw[4 * nb + 2 * hh + e] +=
                  rv * __bfloat162float(s_qs[sw_at<DH>(kTile - 1, 8 * nb + col2() + e)]);
        }
        const int c = tid % DH, r0 = (tid / DH) * (kTile / NP);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < kTile / NP; ++r)
          part[r & 3] += __bfloat162float(r63[r0 + r]) *
                         __bfloat162float(chunk[sw_at<DH>(r0 + r, c)]);
        carry += (part[0] + part[1]) + (part[2] + part[3]);
      }
      put_rows<DH>(pw, HD, src.row, dw, s_wr);
    };

    for (int n = 0; n < cnt; ++n) {
      const int kt = s_list[n] >> 2, mode = s_list[n] & 3, j0 = kt * kTile, sl = n & 1;
      const Src lo = lo_src<BIDIR>(qt, kt, nq, nk), hi = hi_src<BIDIR>(qt, kt, nq, nk);
      const bool prev_ok = lo.ch >= 0 && n > 0 && (s_list[n - 1] >> 2) == kt - 1;
      const bool fresh = lo.ch >= 0 && !prev_ok;
      const bool next_ok = hi.ch >= 0 && n + 1 < cnt && (s_list[n + 1] >> 2) == kt + 1;
      // the lo chunk is the previous pair's hi one or a load of its own
      const uint32_t q_lo = fresh ? q_used++ : q_used - 1;
      const uint32_t q_hi = hi.ch >= 0 ? q_used++ : 0;
      const bf16* c_lo = s_c + (q_lo % kRing) * T;
      const bf16* c_hi = s_c + (q_hi % kRing) * T;
      bf16* d_hi = s_d + sl * kTile * kTile;            // its hi part is this pair's
      bf16* d_lo = s_d + (sl ^ 1) * kTile * kTile;      // came from pair n - 1 as d_hi
      bf16* r_hi = s_r63 + sl * kTile;
      bf16* r_lo = s_r63 + (sl ^ 1) * kTile;
      float s[32];
      if (fresh) {
        // the lo chunk's product: its lo part onto the band
        bar_wait(bar_c + q_lo % kRing, (q_lo / kRing) & 1);
        wg_fence();
        mma_abt<DH>(s, lo.ch ? s_qs : s_qv, c_lo);
        wg_commit();
        wg_wait();
        reg_fence(s);
        band_put<0>(s_bd, s);          // s_bd was last read before step n - 1's end
      }
      bar_wait(bar_k, fill_k++ & 1);
      if (hi.ch >= 0) bar_wait(bar_c + q_hi % kRing, (q_hi / kRing) & 1);
      {
        float c[32];
        wg_fence();
        mma_abt<DH>(s, s_qu, s_k);
        if (hi.ch >= 0) mma_abt<DH>(c, hi.ch ? s_qs : s_qv, c_hi);
        wg_commit();
        wg_wait();
        reg_fence(s);
        reg_fence(c);
        if (lo.ch >= 0) {
          if (hi.ch >= 0)
            band_put<1>(s_bd, c);
          else
            band_zero_hi(s_bd);
          __syncwarp();
          scores_from(s, s_bd);
          __syncwarp();
          if (hi.ch >= 0) band_put<0>(s_bd, c);   // the next pair's lo part
        }
      }
      mask_scores(s, a.scale, BIDIR ? mode : 2, s_kp);
      float dp[32];
      bar_wait(bar_v, fill_v++ & 1);
      wg_fence();
      mma_abt<DH>(dp, s_do, s_v);
      wg_commit();
      wg_wait();
      reg_fence(dp);
      __syncthreads();                 // V read (the band rows are this warp's own)
      if (n + 1 < cnt) issue_v(n + 1);
      form_ds(s, dp, a, s_st, b, h, i0, j0);
      uint32_t da[4][4];
      to_frags(da, dp);
      // dS unskewed onto the two chunks; the part a neighbour pair would
      // have written, had it been walked, is zero
      if (BIDIR && lo.ch == 1)
        d_scatter<1, 1>(d_lo, r_lo, d_hi, r_hi, dp);     // above the diagonal
      else if (BIDIR && hi.ch == 1)
        d_scatter<0, 1>(d_lo, r_lo, d_hi, r_hi, dp);     // the diagonal
      else if (hi.ch == 0)
        d_scatter<0, 0>(d_lo, r_lo, d_hi, r_hi, dp);
      else if (lo.ch == 0)
        d_scatter<0, -1>(d_lo, r_lo, d_hi, r_hi, dp);    // cross's band edge
      if (fresh) {
        if (BIDIR && lo.ch)
          d_zero<1, 1>(d_lo, r_lo);
        else
          d_zero<0, 1>(d_lo, r_lo);
      }
      if (hi.ch >= 0 && !next_ok) {
        if (BIDIR && hi.ch)
          d_zero<1, 0>(d_hi, r_hi);
        else
          d_zero<0, 0>(d_hi, r_hi);
      }
      // chunk lo's dWkr rows: zero, or what an earlier row of the group
      // left there, in flight across the barrier
      float dw[DH / 2];
      if (lo.ch >= 0) get_rows<DH>(dw, pw, HD, lo.row, s_wr);
      fence_stores();
      __syncthreads();                 // D complete
      // dQu += dS K and chunk lo's completion, one group (no branch inside
      // a group: ptxas would serialize its products)
      if (lo.ch >= 0) {
        wg_fence();
        mma_rb<DH>(dqu, da, s_k);
        complete_mma(d_lo, c_lo, dw);
        wg_commit();
        wg_wait();
        reg_fence(dqu);
        reg_fence(dqv);
        reg_fence(dw);
        complete_rest(lo, r_lo, c_lo, dw);
      } else {
        wg_fence();
        mma_rb<DH>(dqu, da, s_k);
        wg_commit();
        wg_wait();
        reg_fence(dqu);
      }
      __syncthreads();                 // K and the lo chunk read; its dWkr rows stored
      if (n + 1 < cnt) issue_k(n + 1);
      if (hi.ch >= 0 && !next_ok) {    // chunk hi is complete too
        get_rows<DH>(dw, pw, HD, hi.row, s_wr);
        wg_fence();
        complete_mma(d_hi, c_hi, dw);
        wg_commit();
        wg_wait();
        reg_fence(dqv);
        reg_fence(dw);
        complete_rest(hi, r_hi, c_hi, dw);
        __syncthreads();
      }
      // every load before the one the next pair keeps (this pair's hi) is
      // free: the ring runs up to kRing - 1 loads ahead of it
      issue_chunks((next_ok ? q_hi : q_used) + kRing);
    }

    // dQ (bidir: row 0 and the carry in f32 to the seam), and the tile's
    // column sums of dQu and dQv (the carry's too) added to the group's
    const size_t tile = (size_t)b * nq + qt;
    bf16* dst = dq + ((size_t)b * a.L + i0) * HD + h * DH;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = row_of(hh), c = 8 * nb + col2();
        const float x = dqu[4 * nb + 2 * hh] + dqv[4 * nb + 2 * hh];
        const float y = dqu[4 * nb + 2 * hh + 1] + dqv[4 * nb + 2 * hh + 1];
        if (BIDIR && i == 0)
          *reinterpret_cast<float2*>(seam.head + tile * HD + h * DH + c) = make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(dst + (size_t)i * HD + c) = pack(x, y);
      }
    __syncthreads();                   // s_bd free
    float* s_su = s_bd;                // [warp][DH] column sums of each warp's 16 rows
    float* s_sv = s_bd + 4 * DH;
    float* s_cr = s_bd + 8 * DH;       // [part][DH] the carry's parts
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
    if (BIDIR) s_cr[(tid / DH) * DH + tid % DH] = carry;
    __syncthreads();
    if (tid < DH) {
      float tu = 0.f, tv = 0.f, cr = 0.f;
      for (int w = 0; w < 4; ++w) {
        tu += s_su[w * DH + tid];
        tv += s_sv[w * DH + tid];
      }
      if (BIDIR) {
        for (int p = 0; p < NP; ++p) cr += s_cr[p * DH + tid];
        seam.carry[tile * HD + h * DH + tid] = cr;
      }
      s_uv[tid] += tu;
      s_uv[DH + tid] += tv + cr;
    }
  }
  __syncthreads();
  if (tid < DH) {
    part.u[slot * HD + h * DH + tid] = s_uv[tid];
    part.v[slot * HD + h * DH + tid] = s_uv[DH + tid];
  }
  // slot rows no completed chunk reached hold zero
  for (int x = tid; x < a.K * DH / 4; x += kWG) {
    const int r = x / (DH / 4), c4 = x % (DH / 4);
    if (!s_wr[r])
      *reinterpret_cast<float4*>(pw + (size_t)r * HD + 4 * c4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Both backward passes in one launch: blocks 0 .. n_dkdv - 1 are dK/dV
// blocks, key tile by key tile, then the dQ blocks, the last query tiles
// first (cross's hold the most band pairs). The short dK/dV blocks first and
// the long dQ blocks behind them measured ~3% faster than the other order
// (PERF.md §6).
template <int DH, bool BIDIR>
__global__ void __launch_bounds__(kWG, 2)
flash_mt_bwd_kernel(Params a, const __grid_constant__ Maps maps, Grads g,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    Partials part, Seam seam, int G) {
  const int nq = a.L / kTile, nk = a.K / kTile;
  const int n_dkdv = nk * a.H * a.B;
  int x = blockIdx.x;
  if (x < n_dkdv) {
    const int b = x % a.B;
    x /= a.B;
    dkdv_block<DH, BIDIR>(a, maps, g, dk, dv, x / a.H, x % a.H, b);
  } else {
    x -= n_dkdv;
    const int per_tile = a.H * (a.B / G);
    const int qt = nq - 1 - x / per_tile;
    x %= per_tile;
    dq_block<DH, BIDIR>(a, maps, g, dq, part, seam, G, qt, x % a.H, x / a.H);
  }
}

template <int DH, bool BIDIR>
cudaError_t launch_fwd(const Params& a, void* out, float* m, float* l, cudaStream_t st) {
  Maps maps;
  if (!make_maps(&maps, a, nullptr, DH)) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem<DH, BIDIR>(a.K / kTile);
  static size_t done[2];
  cudaError_t err = set_smem_once(flash_mt_fwd_kernel<DH, BIDIR>, smem, done);
  if (err != cudaSuccess) return err;
  flash_mt_fwd_kernel<DH, BIDIR><<<dim3(a.L / kTile, a.H, a.B), kWG, smem, st>>>(
      a, maps, static_cast<bf16*>(out), m, l);
  return cudaGetLastError();
}

template <int DH, bool BIDIR>
cudaError_t launch_bwd(const Params& a, const Grads& g, void* dq, void* dk, void* dv,
                       Partials part, Seam seam, int G, float* dwkr, float* du, float* dvb,
                       cudaStream_t st) {
  Maps maps;
  if (!make_maps(&maps, a, g.dout, DH)) return cudaErrorInvalidValue;
  const int nq = a.L / kTile, nk = a.K / kTile;
  const size_t s1 = dkdv_smem<DH, BIDIR>(nq), s2 = dq_smem<DH, BIDIR>(nk, a.K);
  const size_t smem = s1 > s2 ? s1 : s2;
  static size_t done[2];
  cudaError_t err = set_smem_once(flash_mt_bwd_kernel<DH, BIDIR>, smem, done);
  if (err != cudaSuccess) return err;
  const unsigned n_blocks = (unsigned)(nq * a.H * (a.B / G) + nk * a.H * a.B);
  flash_mt_bwd_kernel<DH, BIDIR><<<n_blocks, kWG, smem, st>>>(
      a, maps, g, static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), part,
      seam, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!BIDIR) seam.head = nullptr;
  return launch_reduce(part, (a.B / G) * nq, a.K, a.H * DH, dwkr, du, dvb, st, seam, a.B * nq,
                       nq, static_cast<bf16*>(dq));
}

Params make_params(const void* qu, const void* qv, const void* k, const void* v,
                   const void* wkr, const int* kp, const int* tiles, int B, int L, int K, int H,
                   float scale, int dropout, uint32_t seed, int thresh, float keep_scale) {
  Params a;
  a.qu = static_cast<const bf16*>(qu);
  a.qv = static_cast<const bf16*>(qv);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.wkr = static_cast<const bf16*>(wkr);
  a.kp = kp;
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

// bidir: a square grid, with key padding and its tile map; cross: K >= L.
bool shapes_ok(int bidir, int B, int L, int K, int H, int Dh, const int* kp, const int* tiles) {
  return B > 0 && H > 0 && L > 0 && L % kTile == 0 && K % kTile == 0 && K >= kBand &&
         (Dh == 32 || Dh == 64) &&
         (bidir ? (K == L && kp != nullptr && tiles != nullptr) : K >= L);
}

}  // namespace

extern "C" {

const char* flash_mt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward. bidir != 0: the bidirectional kernel (L == K; kp (B, K) int32 key
// padding, tiles (B, L / 64, K / 64) int32, ops/flash_train.py::tile_map of
// it); else the cross kernel (K >= L; kp and tiles unused). Device pointers
// into contiguous tensors: q, out (B, L, H*Dh) bf16; k, v (B, K, H*Dh) bf16;
// wkr (K, H*Dh) bf16; u, vb (H*Dh) bf16; qu, qv (B, L, H*Dh) bf16 scratch; m,
// l (B, H, L) f32 out. Needs L, K multiples of 64, K >= 128, Dh in {32, 64}.
// dropout != 0 switches dropout on: keep where the hash of seed + b CB + (h +
// 1) CH + i K + j, as int32, exceeds thresh, and scale the kept
// probabilities by keep_scale. Returns the CUDA error of the launches (0 =
// cudaSuccess); does not synchronize.
int flash_mt_fwd(int bidir, const void* q, const void* k, const void* v, const void* wkr,
                 const void* u, const void* vb, const int* kp, const int* tiles, void* qu,
                 void* qv, void* out, float* m, float* l, int B, int L, int K, int H, int Dh,
                 float scale, int dropout, uint32_t seed, int thresh, float keep_scale,
                 void* stream) {
  if (!shapes_ok(bidir, B, L, K, H, Dh, kp, tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_bias(q, u, vb, qu, qv, B, L, H * Dh, st);
  if (err != cudaSuccess) return (int)err;
  const Params a = make_params(qu, qv, k, v, wkr, kp, tiles, B, L, K, H, scale, dropout, seed,
                               thresh, keep_scale);
  switch (Dh * 2 + (bidir != 0)) {
    case 64: return (int)launch_fwd<32, false>(a, out, m, l, st);
    case 65: return (int)launch_fwd<32, true>(a, out, m, l, st);
    case 128: return (int)launch_fwd<64, false>(a, out, m, l, st);
    default: return (int)launch_fwd<64, true>(a, out, m, l, st);
  }
}

// Backward. The forward's operands, then dout (B, L, H*Dh) bf16, delta
// (B, H, L) f32, the forward's m, l; out: dq (B, L, H*Dh), dk, dv (B, K,
// H*Dh) bf16, dwkr (K, H*Dh), du, dvb (H*Dh) f32; scratch: part_w
// (B / G * L / 64, K, H*Dh), part_u, part_v (B / G * L / 64, H*Dh) f32: one
// slot per group of G batch rows (G divides B) and query tile; seam_head,
// seam_carry (B * L / 64, H*Dh) f32 (bidir).
int flash_mt_bwd(int bidir, const void* q, const void* k, const void* v, const void* wkr,
                 const void* u, const void* vb, const int* kp, const int* tiles, void* qu,
                 void* qv, const void* dout, const float* delta, const float* m, const float* l,
                 void* dq, void* dk, void* dv, float* dwkr, float* du, float* dvb, float* part_w,
                 float* part_u, float* part_v, float* seam_head, float* seam_carry, int G, int B,
                 int L, int K, int H, int Dh, float scale, int dropout, uint32_t seed, int thresh,
                 float keep_scale, void* stream) {
  if (!shapes_ok(bidir, B, L, K, H, Dh, kp, tiles) || G <= 0 || B % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_bias(q, u, vb, qu, qv, B, L, H * Dh, st);
  if (err != cudaSuccess) return (int)err;
  const Params a = make_params(qu, qv, k, v, wkr, kp, tiles, B, L, K, H, scale, dropout, seed,
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
  switch (Dh * 2 + (bidir != 0)) {
    case 64: return (int)launch_bwd<32, false>(a, g, dq, dk, dv, part, seam, G, dwkr, du, dvb, st);
    case 65: return (int)launch_bwd<32, true>(a, g, dq, dk, dv, part, seam, G, dwkr, du, dvb, st);
    case 128: return (int)launch_bwd<64, false>(a, g, dq, dk, dv, part, seam, G, dwkr, du, dvb, st);
    default: return (int)launch_bwd<64, true>(a, g, dq, dk, dv, part, seam, G, dwkr, du, dvb, st);
  }
}

}  // extern "C"
