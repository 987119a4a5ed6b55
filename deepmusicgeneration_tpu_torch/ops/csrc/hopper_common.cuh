// Hopper building blocks shared by the wgmma attention kernels
// (flash_train.cu: attention over [XL memory, window]; flash_mt.cu: the
// multitask model's bidirectional and cross attention; flash_prefill.cu:
// the causal inference prefill): TMA tile copies
// counted by mbarriers, wgmma descriptors and products on swizzled TMA tiles
// and core-matrix tiles, the accumulator layout's helpers, the tile list a
// block walks, the shared-memory carving, the tensor-map table, and the
// kernel that forms the biased query operands. Each .cu includes this header
// (after flash_common.cuh) into its own anonymous namespace, so the
// libraries share source, not symbols.

#pragma once

#include <cuda.h>

#include <mutex>

#include "flash_common.cuh"

namespace {

constexpr int kWG = 128;    // one warpgroup a block

// exp(x) as the special-function unit's 2^(x log2 e): the row sums, the
// forward's probabilities and the backward's recomputed ones all take it,
// so they agree bit for bit; exp(-1e9 - m) and exp(-inf) are 0.
__device__ __forceinline__ float ex(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// The normalised probability of a masked, scaled score s of a row with max
// m and reciprocal sum rl (= 1 / l, __frcp_rn): the same steps in every
// pass (the _rn intrinsics keep nvcc from contracting them differently).
__device__ __forceinline__ float prob_r(float s, float m, float rl) {
  return __fmul_rn(ex(__fsub_rn(s, m)), rl);
}

// --- shared memory, copies, barriers -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A (rows x C) bf16 tile in shared memory is stored as 8 x 8 core matrices
// of 128 contiguous bytes, row blocks of C / 8 of them: element (r, c) at
// core_at<C>(r, c).
template <int C>
__device__ __forceinline__ int core_at(int r, int c) {
  return (((r >> 3) * (C >> 3) + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7);
}

// The operand tiles come by TMA: one thread asks the copy engine for a
// (64 rows x DH) box of a 2-D bf16 tensor map (tensor rows, H * Dh columns),
// which lands swizzled (128-byte rows at DH 64, 64-byte at DH 32) as wgmma
// reads it; the 256-byte vectors (mask columns, row statistics) come by
// bulk copy. Both complete on an mbarrier that counts their bytes.

// The operand maps of a training-attention kernel.
struct Maps {
  CUtensorMap qu, qv, dout;     // (B L, HD)
  CUtensorMap k, v;             // (B K, HD)
  CUtensorMap wkr;              // (K, HD)
};

// A (64 x DH) bf16 tile, and a 64-entry vector, in bytes.
template <int DH>
__host__ __device__ constexpr uint32_t tile_bytes() { return kTile * DH * 2; }
constexpr uint32_t kVec = kTile * 4;

__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// The same from a 3-D map (H * Dh columns, rows, batch rows): `row` counts
// within batch row `b`, so a box past the batch row's last row is zero-filled.
__device__ __forceinline__ void tma_tile3(void* dst, const CUtensorMap* map, int col, int row,
                                          int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_vec(void* dst, const void* src, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)), "l"(src), "n"(kVec), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) by bulk copy,
// counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// The issuing thread's arrival: the phase completes when `bytes` have landed.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of phase `parity` (the fill count's low bit):
// the copies' bytes have landed and are visible to the waiting threads and
// to their wgmma. A phase that never completes (a fault) traps after ~2^24
// polls, so the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// After threads' plain stores to a tile a wgmma reads: the stores, then
// this, then a barrier, then the product.
__device__ __forceinline__ void fence_stores() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- warpgroup products ------------------------------------------------------------
//
// The accumulator of an m64nN product: thread (warp w, lane = 4 g + t) holds
// d[4 nb + 2 h + e] = D[16 w + g + 8 h][8 nb + 2 t + e]. A register A operand
// (bf16, one k16 step) is the same layout as mma.sync's m16n8k16 A fragment
// of the warp's 16 rows.

__device__ __forceinline__ uint64_t gdesc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// A core tile of C columns read K-major (rows are M or N, columns the
// reduction): the next core matrix along K is 128 bytes on, the next 8 rows
// C / 8 x 128. A k16 step is 256 bytes (16 descriptor units).
template <int C>
__device__ __forceinline__ uint64_t desc_k(const bf16* p) { return gdesc(p, 128, C * 16); }
// Read MN-major (rows are the reduction, columns M or N): the next 8 columns
// are 128 bytes on, the next 8 rows C / 8 x 128. A k16 step is 2 C units.
template <int C>
__device__ __forceinline__ uint64_t desc_mn(const bf16* p) { return gdesc(p, C * 16, 128); }

// A TMA tile (64 x DH, rows of DH * 2 bytes, swizzled by its row width):
// read K-major (rows M or N, the reduction along the row), the next 8 rows
// are 8 row widths on and a k16 step 32 bytes (2 units); read MN-major (rows
// the reduction), the next 8 rows likewise and a k16 step 16 rows (2 DH
// units). Swizzle mode: 1 = 128-byte, 2 = 64-byte rows.
template <int DH>
__device__ __forceinline__ uint64_t desc_sw(const bf16* p) {
  return gdesc(p, 16, 16 * DH) | ((uint64_t)(DH == 64 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across the asynchronous
// products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

#define WG_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_O16(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_O32(d)                                                                        \
  WG_O16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),            \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),      \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64) = (acc ? d : 0) + A . B, both operands in shared memory; TA /
// TB: the operand is read MN-major (1) or K-major (0).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_O32(d)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : WG_O16(d)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
// The same with A in registers (bf16 fragments of one k16 step).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_O32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : WG_O16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 64) = A . B^T: a, b (64 x DH) TMA tiles, K-major. Issues only.
template <int DH>
__device__ __forceinline__ void mma_abt(float (&d)[32], const bf16* a, const bf16* b) {
  const uint64_t da = desc_sw<DH>(a), db = desc_sw<DH>(b);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss<0, 0>(d, da + 2 * kk, db + 2 * kk, kk > 0);
}
// d (64 x N) += A^T . B: a (64 x 64) core tile [k][m], b (64 x N) TMA tile
// [k][n], both MN-major.
template <int N>
__device__ __forceinline__ void mma_atb(float (&d)[N / 2], const bf16* a, const bf16* b) {
  const uint64_t da = desc_mn<kTile>(a), db = desc_sw<N>(b);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_ss<1, 1>(d, da + 2 * kTile * kk, db + 2 * N * kk, 1);
}
// d (64 x N) += A . B: a (64 x 64) core tile [m][k] K-major, b (64 x N) TMA
// tile [k][n] MN-major.
template <int N>
__device__ __forceinline__ void mma_ab(float (&d)[N / 2], const bf16* a, const bf16* b) {
  const uint64_t da = desc_k<kTile>(a), db = desc_sw<N>(b);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) wgmma_ss<0, 1>(d, da + 16 * kk, db + 2 * N * kk, 1);
}
// d (64 x N) += A . B: A (64 x 64) as register fragments, b (64 x N) TMA tile
// [k][n] MN-major.
template <int N>
__device__ __forceinline__ void mma_rb(float (&d)[N / 2], const uint32_t (&a)[4][4], const bf16* b) {
  const uint64_t db = desc_sw<N>(b);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) wgmma_rs<1>(d, a[kk], db + 2 * N * kk, 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) d[x] = 0.f;
}

// This thread's rows of a 64-row accumulator: 16 w + g and 16 w + g + 8.
__device__ __forceinline__ int row_of(int h) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * h;
}
// Its first column in each 8-column block: 2 t.
__device__ __forceinline__ int col2() { return 2 * (threadIdx.x & 3); }

// The (64 x 64) f32 band scatter tile, XOR-swizzled by row so that a warp's
// float2 reads of its 8 rows spread over the banks.
__device__ __forceinline__ int swz(int i, int j) { return i * kTile + (j ^ ((i & 7) << 3)); }

// Columns [16 kk, 16 kk + 16) of a 64 x 64 accumulator as a bf16 A operand.
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = pack(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// A 64 x 64 accumulator as bf16 into a core tile [i][j].
__device__ __forceinline__ void store_tile(bf16* t, const float (&s)[32]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(t + core_at<kTile>(row_of(h), 8 * nb + col2())) =
          pack(s[4 * nb + 2 * h], s[4 * nb + 2 * h + 1]);
}

// A 64 x N accumulator as bf16 rows of a global matrix (row i at dst + i * ld).
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld, const float (&d)[N / 2]) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row_of(h) * ld + 8 * nb + col2()) =
          pack(d[4 * nb + 2 * h], d[4 * nb + 2 * h + 1]);
}

// The block's tiles to visit, in order: the nonzero entries of `row` (n
// entries at `stride`), each as index * 4 + mode. Warp 0 reads 32 entries at
// a time and compacts them with a ballot. Returns their count.
__device__ __forceinline__ int list_tiles(int* s_list, int* s_cnt, const int* row, int n,
                                          int stride) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int c = 0;
    for (int base = 0; base < n; base += 32) {
      const int x = base + lane;
      const int mode = x < n ? row[(size_t)x * stride] : 0;
      const uint32_t mask = __ballot_sync(0xffffffffu, mode != 0);
      if (mode) s_list[c + __popc(mask & ((1u << lane) - 1u))] = 4 * x + mode;
      c += __popc(mask);
    }
    if (lane == 0) *s_cnt = c;
  }
  __syncthreads();
  return *s_cnt;
}

// The dropout factor of (b, h, i, j) of a kernel's parameters P: 0 or
// keep_scale (1 without dropout).
template <typename P>
__device__ __forceinline__ float keep_factor(const P& a, int b, int h, int i, int j) {
  return a.dropout ? hash_keep(a.seed, a.thresh, a.keep_scale, b, h, i, a.K, j) : 1.f;
}

// P, then dS = P * (keep * dP - delta) * scale, as the TPU kernels form them,
// in place: s holds the masked scores on entry and Pd = P * keep on exit, dp
// holds dP on entry and dS on exit; st holds the query tile's m, l and
// delta.
template <typename P>
__device__ __forceinline__ void form_ds(float (&s)[32], float (&dp)[32], const P& a,
                                        const float* st, int b, int h, int i0, int j0) {
  float m_r[2], rl[2], dl_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m_r[hh] = st[row_of(hh)];
    rl[hh] = __frcp_rn(st[kTile + row_of(hh)]);
    dl_r[hh] = st[2 * kTile + row_of(hh)];
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int hh = x >> 1, i = row_of(hh), j = 8 * nb + col2() + (x & 1);
      const float p = prob_r(s[4 * nb + x], m_r[hh], rl[hh]);
      const float kf = keep_factor(a, b, h, i0 + i, j0 + j);
      const float t = __fsub_rn(__fmul_rn(kf, dp[4 * nb + x]), dl_r[hh]);
      dp[4 * nb + x] = __fmul_rn(__fmul_rn(p, t), a.scale);
      s[4 * nb + x] = __fmul_rn(p, kf);
    }
}

// Shared memory is carved in 128-byte pieces in a fixed order; the host
// sums the same pieces.
__host__ __device__ constexpr size_t piece(size_t bytes) { return (bytes + 127) & ~(size_t)127; }

// The base is rounded up to 1024 bytes (a 128-byte swizzle atom of 8 rows):
// the TMA tiles, carved first, are whole multiples of it.
struct Carve {
  unsigned char* p;
  __device__ explicit Carve(unsigned char* base)
      : p(base + ((1024u - (smem_u32(base) & 1023u)) & 1023u)) {}
  template <typename T>
  __device__ T* take(size_t n) {
    T* r = reinterpret_cast<T*>(p);
    p += piece(n * sizeof(T));
    return r;
  }
};

constexpr size_t kBarBytes = 128 + 1024;   // up to 16 mbarriers, and the base's alignment
constexpr size_t kBandBytes = (size_t)kTile * kTile * 4;          // the f32 scatter tile

// qu = bf16(f32(q) + f32(u)), qv likewise with vb, per head: the operands
// every pass copies tile by tile.
__global__ void __launch_bounds__(256)
bias_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ u,
              const bf16* __restrict__ vb, bf16* __restrict__ qu, bf16* __restrict__ qv,
              size_t n8, int HD) {
  const size_t x = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (x >= n8) return;
  const int c = (int)((x * 8) % HD);
  const uint4 qq = reinterpret_cast<const uint4*>(q)[x];
  const uint4 uu = *reinterpret_cast<const uint4*>(u + c);
  const uint4 vv = *reinterpret_cast<const uint4*>(vb + c);
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
  reinterpret_cast<uint4*>(qu)[x] = make_uint4(ou[0], ou[1], ou[2], ou[3]);
  reinterpret_cast<uint4*>(qv)[x] = make_uint4(ov[0], ov[1], ov[2], ov[3]);
}

cudaError_t launch_bias(const void* q, const void* u, const void* vb, void* qu, void* qv, int B,
                        int L, int HD, cudaStream_t st) {
  const size_t n8 = (size_t)B * L * HD / 8;
  bias_q_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(u), static_cast<const bf16*>(vb),
      static_cast<bf16*>(qu), static_cast<bf16*>(qv), n8, HD);
  return cudaGetLastError();
}

// --- tensor maps ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, H * Dh) bf16 matrix read in (64 rows x Dh) boxes, swizzled by the
// box's row width (Dh * 2 bytes: 128 or 64); with batches > 0 a
// (batches, rows, H * Dh) tensor read by tma_tile3 in (1 x 64 x Dh) boxes.
// Encoded maps are kept in a small table keyed by all they encode: a
// training step's tensors come back at the same addresses from PyTorch's
// caching allocator, and an encoding costs more host time than the launch.
bool tile_map(CUtensorMap* map, const void* base, int rows, int HD, int Dh, int batches = 0) {
  struct Entry {
    const void* base;
    int rows, HD, Dh, batches;
    CUtensorMap map;
  };
  static Entry table[64];
  static std::mutex lock;
  const std::lock_guard<std::mutex> hold(lock);
  const uintptr_t key = reinterpret_cast<uintptr_t>(base) ^ ((uintptr_t)rows << 3) ^
                        (uintptr_t)HD ^ ((uintptr_t)batches << 9);
  Entry& e = table[(key >> 8 ^ key >> 14) & 63];
  if (e.base == base && e.rows == rows && e.HD == HD && e.Dh == Dh && e.batches == batches) {
    *map = e.map;
    return true;
  }
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)rows, (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)rows * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Dh, (cuuint32_t)kTile, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, batches ? 3 : 2, const_cast<void*>(base), dims,
          strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
          Dh == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  e = Entry{base, rows, HD, Dh, batches, *map};
  return true;
}

// The maps of a kernel's operands P (dout null: the forward has no dout map).
template <typename P>
bool make_maps(Maps* m, const P& a, const void* dout, int Dh) {
  const int HD = a.H * Dh;
  return tile_map(&m->qu, a.qu, a.B * a.L, HD, Dh) && tile_map(&m->qv, a.qv, a.B * a.L, HD, Dh) &&
         (!dout || tile_map(&m->dout, dout, a.B * a.L, HD, Dh)) &&
         tile_map(&m->k, a.k, a.B * a.K, HD, Dh) && tile_map(&m->v, a.v, a.B * a.K, HD, Dh) &&
         tile_map(&m->wkr, a.wkr, a.K, HD, Dh);
}

// cudaFuncSetAttribute only when the kernel's size or the device changes (a
// launch's host time counts in a train step); `done` is the caller's own.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes, size_t (&done)[2]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (done[0] == bytes && done[1] == (size_t)dev + 1) return cudaSuccess;
  err = set_smem(kernel, bytes);
  if (err == cudaSuccess) {
    done[0] = bytes;
    done[1] = (size_t)dev + 1;
  }
  return err;
}

}  // namespace
