// Causal Transformer-XL prefill attention over a left-padded prompt window,
// without materializing the (B, H, W, W) scores.
//
// Replaces the TPU kernels of deepmusicgeneration_tpu/ops/flash_prefill.py::
// flash_prefill_attention: the whole-window pallas_call (_make_kernel,
// W <= 2048) and the row-blocked one (_blocked_prefill_call /
// _make_blocked_kernel, 2048 < W <= 8192), which the TPU package also builds
// for the causal half of flash_encoder_attention. One launch serves every W
// and computes the same function:
//
//   qu = bf16(q + u), qv = bf16(q + v)                       (per head, f32 add)
//   score[i, j] = (qu_i . k_j + qv_i . wkr[j + W - 1 - i]) * scale   (f32)
//   score[i, j] = -1e9 where j > i, key j is left padding, or j >= W
//   out_i = softmax_j(score[i, :]) . V                        (bf16 out)
//
// Two entries, chosen by the head width alone (ops/flash_prefill.py::
// prefill_entry): flash_prefill_wgmma_fwd at Dh 32 and 64, the widths of
// every shipped configuration, and flash_prefill_cuda_core_fwd, the first
// version's kernel on the CUDA cores, at Dh 16 and 128.
//
// The wgmma entry (flash_prefill_wgmma_kernel) is flash_train.cu's forward
// at M = 0 made one pass. One warpgroup (128 threads) a block, one block per
// (64-row query tile qt, head, batch row), the query tiles with the most key
// tiles first; a block walks key tiles 0 .. qt only (the causal skip).
//   - Copies. K and V tiles come by TMA from 3-D tensor maps over (B, W,
//     H * Dh), so a tail tile's keys past W are zero-filled within their own
//     batch row (a 2-D map over B * W rows would hand it the next batch
//     row's keys); the band's hi chunk comes from a 2-D map over (W, H * Dh),
//     its rows past W - 1 zero-filled. They go through a ring of three
//     stages counted by mbarriers, two key tiles ahead. The block's threads
//     write qu and qv as core-matrix tiles, and the first key tile's lo
//     chunk, the only band rows that can lie below 0 (when W % 64 != 0),
//     zero there.
//   - The skew. Pair (i0, j0) reads the 128 wkr rows from base = W - 64 -
//     i0 + j0: BD[i, j] is lo chunk row j - i + 63 for j <= i and hi chunk
//     row j - i - 1 for j > i; exactly one chunk product lands on each
//     (i, j), in the same warp (flash_train.cu's scatter). base(kt + 1) =
//     base(kt) + 64, so key tile kt's hi chunk is kt + 1's lo chunk: its
//     product is carried in registers, one chunk product a tile pair. The
//     diagonal pair's hi chunk (wkr rows W .. W + 63) would land only on
//     masked j > i: it is neither copied nor multiplied.
//   - Products, all wgmma m64nNk16 (bf16 in, f32 accumulate): AC = qu K^T,
//     the chunk product qv chunk^T, and P.V with P as register operands.
//   - Masking and an online softmax in f32, one pass (no dropout, so no
//     second pass over the normalised row).
//   - P.V stays float32-accurate: the unnormalised exponentials e are split
//     into hi = bf16(e) and lo = bf16(e - hi) (16 significant bits), two
//     register-operand products into one f32 accumulator; each row is
//     divided by its f32 sum at the end, as flash_encoder.cu does with
//     mma.sync.
//
// Numerics against the TPU kernel: the mask fill stays the finite -1e9, so a
// padded query row (all its keys masked) averages V over the keys of the
// tiles it visits instead of all W keys; that value is finite and is read
// only by padded keys, which every real query masks. The TPU kernel rounds
// the normalized probabilities to bf16 before P.V; here the row is the f32
// function up to summation order.
//
// Bound. At B = 16, W = 512 on the flagship (12 x 64 heads) the call reads
// q, k, v and wkr once and writes the output: 51.13 MB, 15.3 us at 3.35
// TB/s; its 9.68 GFLOP of causal products (AC, BD and P.V over the B H W
// (W + 1) / 2 pairs) take 9.8 us at the bf16 tensor-core peak, so bytes
// bound it. Executed against needed products a tile pair: AC, one chunk
// product and P.V twice (hi and lo) against three, and the diagonal pairs
// in full.
//
// Measured (PERF.md row 4; H100 80GB HBM3 at 700 W): 0.094 ms of device
// time a launch at that shape, 0.33 ms at B = 64; the CUDA-core kernel took
// 0.62 / 2.15 ms.
//
// Occupancy (nvcc 12.9 -Xptxas -v for sm_90a; the card's build log under
// ops/_build): the wgmma entry 231 registers at Dh 64 and 207 at Dh 32, no
// spills; dynamic shared memory 107,648 bytes at Dh 64 and 62,592 at Dh 32:
// two blocks (8 warps) an SM.

#include "hopper_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// the wgmma entry (Dh 32, 64)
// ---------------------------------------------------------------------------

struct Params {
  const bf16 *q, *u, *vb, *wkr;   // q (B, W, HD); u, vb (HD); wkr (W, HD)
  const uint8_t* pad;              // (B, W), nonzero = left padding
  int B, W, H;
  float scale;
};

struct PrefillMaps {
  CUtensorMap k, v;   // 3-D: (B, W, HD)
  CUtensorMap wkr;    // (W, HD)
};

constexpr int kStages = 3;   // K, hi chunk, V a stage; copies two key tiles ahead

// Stages first (TMA tiles, whole 1024-byte swizzle atoms), the f32 band
// tile (the first lo chunk before it), qu, qv, the barriers.
template <int DH>
__host__ __device__ constexpr size_t wg_smem() {
  return kBarBytes + (3 * kStages + 2) * tile_bytes<DH>() + kBandBytes;
}

// d (64 x 64) = A . B^T over DH: a, a (64 x DH) core tile; b, a TMA tile
// (SW) or a core tile, both read K-major. Issues only.
template <int DH, bool SW>
__device__ __forceinline__ void mma_qt(float (&d)[32], const bf16* a, const bf16* b) {
  const uint64_t da = desc_k<DH>(a), db = SW ? desc_sw<DH>(b) : desc_k<DH>(b);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<0, 0>(d, da + 16 * kk, db + (SW ? 2 : 16) * kk, kk > 0);
}

// bf16(f32(x) + f32(y)) of two packed bf16 pairs.
__device__ __forceinline__ uint32_t add_pack(uint32_t x, uint32_t y) {
  const float2 a = unpack(x), b = unpack(y);
  return pack(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ uint4 add_pack4(uint4 x, uint4 y) {
  return make_uint4(add_pack(x.x, y.x), add_pack(x.y, y.y), add_pack(x.z, y.z),
                    add_pack(x.w, y.w));
}

// Lands the pair's two chunk products on its (i, j) through this warp's rows
// of the band tile: the lo chunk's row r at j = r - 63 + i where that is
// >= 0 (j <= i), the hi chunk's at j = r + 1 + i where that is < 64 (j > i);
// without the hi chunk (the diagonal pair) zeros there.
__device__ __forceinline__ void scatter_band(float* s_bd, const float (&clo)[32],
                                             const float (&chi)[32], bool has_hi) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = row_of(x >> 1), r = 8 * nb + col2() + (x & 1);
      s_bd[swz(i, (r + i + 1) & (kTile - 1))] =
          r + i >= kTile - 1 ? clo[4 * nb + x] : (has_hi ? chi[4 * nb + x] : 0.f);
    }
}

// s = AC + BD, from this warp's rows of the band tile.
__device__ __forceinline__ void add_band(float (&s)[32], const float* s_bd) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 bd = *reinterpret_cast<const float2*>(s_bd + swz(row_of(h), 8 * nb + col2()));
      s[4 * nb + 2 * h] += bd.x;
      s[4 * nb + 2 * h + 1] += bd.y;
    }
}

// grid (ceil(W / 64), H, B). out (B, W, HD) bf16.
template <int DH>
__global__ void __launch_bounds__(kWG, 2)
flash_prefill_wgmma_kernel(Params a, const __grid_constant__ PrefillMaps maps,
                           bf16* __restrict__ out) {
  constexpr int T = kTile * DH;
  constexpr uint32_t TB = tile_bytes<DH>();
  constexpr int V8 = DH / 8;                      // 16-byte vectors a tile row
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* s_stage = cv.take<bf16>(3 * kStages * T);  // K, hi chunk, V a stage
  float* s_bd = cv.take<float>(kTile * kTile);
  bf16* s_cl = reinterpret_cast<bf16*>(s_bd);     // the first lo chunk, until the band
  bf16* s_qu = cv.take<bf16>(T);
  bf16* s_qv = cv.take<bf16>(T);
  uint64_t* bar_s = cv.take<uint64_t>(kStages);

  const int tid = threadIdx.x, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;      // most key tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int W = a.W, HD = a.H * DH, col = h * DH;
  const int i0 = qt * kTile;

  if (tid == 0) {
    for (int x = 0; x < kStages; ++x) bar_init(bar_s + x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // key tile kt's K, hi chunk (but the diagonal's) and V to stage kt % 3
  auto issue = [&](int kt) {
    if (tid != 0) return;
    const int st = kt % kStages, j0 = kt * kTile;
    bf16* stage = s_stage + 3 * st * T;
    uint64_t* bar = bar_s + st;
    bar_expect(bar, (kt < qt ? 3 : 2) * TB);
    tma_tile3(stage, &maps.k, col, j0, b, bar);
    if (kt < qt) tma_tile(stage + T, &maps.wkr, col, W - i0 + j0, bar);
    tma_tile3(stage + 2 * T, &maps.v, col, j0, b, bar);
  };
  for (int kt = 0; kt < kStages - 1 && kt <= qt; ++kt) issue(kt);

  // qu, qv (rows past W zero) and key tile 0's lo chunk: wkr rows W - 64 - i0
  // + r, zero outside [0, W); every load first, then the stores. A thread's
  // 8 columns are the same in each of its rows.
  {
    constexpr int kRows = kTile * V8 / kWG;       // rows a thread fills
    const int c = 8 * (tid % V8);
    const bf16* qrow = a.q + ((size_t)b * W + i0) * HD + col + c;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    uint4 qq[kRows], ww[kRows];
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const int r = tid / V8 + n * (kWG / V8), t = W - kTile - i0 + r;
      qq[n] = i0 + r < W ? *reinterpret_cast<const uint4*>(qrow + (size_t)r * HD) : zero4;
      ww[n] = t >= 0 && t < W ? *reinterpret_cast<const uint4*>(a.wkr + (size_t)t * HD + col + c)
                              : zero4;
    }
    const uint4 uu = *reinterpret_cast<const uint4*>(a.u + col + c);
    const uint4 vv = *reinterpret_cast<const uint4*>(a.vb + col + c);
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const int at = core_at<DH>(tid / V8 + n * (kWG / V8), c);
      *reinterpret_cast<uint4*>(s_qu + at) = add_pack4(qq[n], uu);
      *reinterpret_cast<uint4*>(s_qv + at) = add_pack4(qq[n], vv);
      *reinterpret_cast<uint4*>(s_cl + at) = ww[n];
    }
  }
  fence_stores();      // qu, qv and the lo chunk before the products read them
  __syncthreads();

  // Key j's flag (padding, or past W). Each warp forms a key tile's 64 flags
  // by two ballots of the lanes' flags, read one key tile ahead.
  auto key_flag = [&](int j) { return j >= W || a.pad[(size_t)b * W + j] != 0; };
  bool f_lo = key_flag(lane), f_hi = key_flag(kTile / 2 + lane);

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float o[DH / 2];
  // the lo chunk's product: the last key tile's hi one. Only wgmma writes
  // an accumulator (c0, the first lo chunk's, then chi), so the compiler
  // keeps the products of a step in flight together.
  float clo[32];
  zero(o);
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt % kStages;
    const bf16* stage = s_stage + 3 * st * T;
    const bool diag = kt == qt;
    // stage (kt + 2) % 3 was freed at the end of step kt - 1
    if (kt + kStages - 1 <= qt) issue(kt + kStages - 1);
    bar_wait(bar_s + st, (kt / kStages) & 1);
    float s[32], chi[32], c0[32];
    wg_fence();
    mma_qt<DH, true>(s, s_qu, stage);
    if (!diag) mma_qt<DH, true>(chi, s_qv, stage + T);   // the diagonal's lands on j > i only
    if (kt == 0) mma_qt<DH, false>(c0, s_qv, s_cl);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(chi);
    reg_fence(c0);
    if (kt == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) clo[x] = c0[x];
      __syncthreads();   // every warp's lo chunk product retired: the band overlays it
    }
    scatter_band(s_bd, clo, chi, !diag);   // this warp's rows: no other warp's data
    if (!diag) {
#pragma unroll
      for (int x = 0; x < 32; ++x) clo[x] = chi[x];
    }
    __syncwarp();
    add_band(s, s_bd);

    // mask and scale; the online row max, the rescale of what was summed
    // so far, and e = exp(s - max); a row's 64 scores sit in one quad
    const uint64_t flags =
        __ballot_sync(0xffffffffu, f_lo) | (uint64_t)__ballot_sync(0xffffffffu, f_hi) << 32;
    if (!diag) {
      f_lo = key_flag((kt + 1) * kTile + lane);
      f_hi = key_flag((kt + 1) * kTile + kTile / 2 + lane);
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = row_of(x >> 1), j = 8 * nb + col2() + (x & 1);
        const bool masked = ((flags >> j) & 1) || (diag && j > i);
        s[4 * nb + x] = masked ? -1e9f : __fmul_rn(s[4 * nb + x], a.scale);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * hh], s[4 * nb + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      alpha[hh] = ex(m_r[hh] - m_new);   // ex(-inf) = 0 on the first tile
      m_r[hh] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float e = ex(s[4 * nb + x] - m_r[x >> 1]);
        s[4 * nb + x] = e;
        sum[x >> 1] += e;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l_r[hh] = l_r[hh] * alpha[hh] + sum[hh];
    }
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) o[x] *= alpha[(x >> 1) & 1];

    // o += (e_hi + e_lo) . V
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float e0 = s[8 * kk + 2 * x], e1 = s[8 * kk + 2 * x + 1];
        ph[kk][x] = pack(e0, e1);
        const float2 hi = unpack(ph[kk][x]);
        pl[kk][x] = pack(e0 - hi.x, e1 - hi.y);
      }
    wg_fence();
    mma_rb<DH>(o, ph, stage + 2 * T);
    mma_rb<DH>(o, pl, stage + 2 * T);
    wg_commit();
    wg_wait();
    reg_fence(o);
    __syncthreads();   // stage kt % 3 and the band read
  }

  // out = o / l on the rows that exist
  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
  bf16* dst = out + ((size_t)b * W + i0) * HD + col;
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(hh);
      if (i0 + r < W)
        *reinterpret_cast<uint32_t*>(dst + (size_t)r * HD + 8 * nb + col2()) =
            pack(o[4 * nb + 2 * hh] * inv[hh], o[4 * nb + 2 * hh + 1] * inv[hh]);
    }
}

template <int DH>
cudaError_t launch_wgmma(const Params& a, const void* k, const void* v, void* out,
                         cudaStream_t st) {
  const int HD = a.H * DH;
  PrefillMaps maps;
  if (!tile_map(&maps.k, k, a.W, HD, DH, a.B) || !tile_map(&maps.v, v, a.W, HD, DH, a.B) ||
      !tile_map(&maps.wkr, a.wkr, a.W, HD, DH))
    return cudaErrorInvalidValue;
  const int nq = (a.W + kTile - 1) / kTile;
  const size_t smem = wg_smem<DH>();
  static size_t done[2];
  const cudaError_t err = set_smem_once(flash_prefill_wgmma_kernel<DH>, smem, done);
  if (err != cudaSuccess) return err;
  flash_prefill_wgmma_kernel<DH><<<dim3(nq, a.H, a.B), kWG, smem, st>>>(
      a, maps, static_cast<bf16*>(out));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the CUDA-core entry (Dh 16, 128)
// ---------------------------------------------------------------------------
//
// One block of 256 threads owns (query tile of 64 rows, head, batch row) and
// streams 64-key tiles of K, V and the 127 wkr rows the tile pair needs
// through shared memory (row j + W - 1 - i indexed directly, no roll), with
// an online softmax in f32 and f32 products of the bf16 values on the CUDA
// cores; key tiles in the future of the whole query tile are skipped. A
// tail tile's query rows past W are zeros and are not written, its keys
// past W are masked like padding, and wkr rows outside [0, W) are zeros.

// Shared-memory words per tile row: DH / 2 bf16 pairs plus one, an odd count,
// so threads reading consecutive rows at the same column hit distinct banks.
template <int DH>
__host__ __device__ constexpr int row_words() { return DH / 2 + 1; }

template <int DH>
__host__ __device__ constexpr size_t core_smem() {
  return (size_t)6 * kTile * row_words<DH>() * 4     // qu, qv, k, v, 2 x wkr rows
         + (size_t)kTile * kSS * 4                    // scores / probabilities
         + (size_t)3 * kTile * 4                      // running max, sum, rescale
         + (size_t)kTile * 4;                         // key pad flags
}

// Copy rows first .. first + n_rows - 1 of a (W x DH) bf16 matrix whose row t
// starts at src + t * ld (elements) into shared memory, row_words<DH>() words
// per row; rows outside [0, W) are zero-filled.
template <int DH>
__device__ void load_rows(uint32_t* dst, const bf16* src, size_t ld, int first, int n_rows,
                          int W) {
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
flash_prefill_cuda_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ wkr,
                               const bf16* __restrict__ ub, const bf16* __restrict__ vb,
                               const uint8_t* __restrict__ pad, int W, int H, float scale,
                               bf16* __restrict__ out) {
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
  float* s_m = s_s + kTile * kSS;
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
      const uint32_t qq = i0 + r < W ? qsrc[(size_t)r * (HD / 2) + w] : 0u;
      s_qu[r * RW + w] = add_pack(qq, u2[w]);
      s_qv[r * RW + w] = add_pack(qq, v2[w]);
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
        s_s[ii * kSS + jj] = masked ? -1e9f : acc[a][c] * scale;
      }
    __syncthreads();

    // online softmax, 4 threads per query row, 16 columns each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = s_s + r * kSS + 16 * part;
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
        const float p = s_s[(rg + kRowGroups * a) * kSS + j];
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
cudaError_t launch_cuda_core(const Params& a, const void* k, const void* v, void* out,
                             cudaStream_t st) {
  constexpr size_t smem = core_smem<DH>();
  const cudaError_t err = set_smem(flash_prefill_cuda_core_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.W + kTile - 1) / kTile, a.H, a.B);
  flash_prefill_cuda_core_kernel<DH><<<grid, kThreads, smem, st>>>(
      a.q, static_cast<const bf16*>(k), static_cast<const bf16*>(v), a.wkr, a.u, a.vb, a.pad,
      a.W, a.H, a.scale, static_cast<bf16*>(out));
  return cudaGetLastError();
}

Params make_params(const void* q, const void* wkr, const void* u, const void* vb,
                   const uint8_t* pad, int B, int W, int H, float scale) {
  Params a;
  a.q = static_cast<const bf16*>(q);
  a.u = static_cast<const bf16*>(u);
  a.vb = static_cast<const bf16*>(vb);
  a.wkr = static_cast<const bf16*>(wkr);
  a.pad = pad;
  a.B = B;
  a.W = W;
  a.H = H;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out = causal TXL attention of (q, k, v, wkr, u, vb) under the key pad mask.
// Pointers are device pointers into contiguous tensors: q, k, v, out
// (B, W, H*Dh) bf16; wkr (W, H*Dh) bf16; u, vb (H*Dh) bf16; pad (B, W) bytes
// (nonzero = left padding). Needs B, W, H >= 1 and Dh in {32, 64} (the
// wgmma entry) or {16, 128} (the CUDA-core entry). Returns the CUDA error of
// the launch (0 = cudaSuccess); does not synchronize.
int flash_prefill_wgmma_fwd(const void* q, const void* k, const void* v, const void* wkr,
                            const void* u, const void* vb, const uint8_t* pad, void* out,
                            int B, int W, int H, int Dh, float scale, void* stream) {
  if (B <= 0 || W <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Params a = make_params(q, wkr, u, vb, pad, B, W, H, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return (int)launch_wgmma<32>(a, k, v, out, st);
    case 64: return (int)launch_wgmma<64>(a, k, v, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_prefill_cuda_core_fwd(const void* q, const void* k, const void* v, const void* wkr,
                                const void* u, const void* vb, const uint8_t* pad, void* out,
                                int B, int W, int H, int Dh, float scale, void* stream) {
  if (B <= 0 || W <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Params a = make_params(q, wkr, u, vb, pad, B, W, H, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 16: return (int)launch_cuda_core<16>(a, k, v, out, st);
    case 128: return (int)launch_cuda_core<128>(a, k, v, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
