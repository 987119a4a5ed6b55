// The multitask decoder's token step at batch 1 as one persistent kernel
// (s2s_slab.cu: int8 slab caches; s2s_fused.cu: the exact bf16 caches).
//
// One cooperative launch walks all L decoder layers. A layer is a short
// sequence of phases separated by grid-wide barriers; the hidden state is
// carried in every block's shared memory, as the TPU kernel's sequential
// grid carries it in VMEM:
//
//   s2s layer: QKV  the qkv weight product, split-K partials
//              SSC  self scores over the ring and the fresh token, by
//                   (head, chunk of ring positions); each chunk's max
//              SPV  exp(s - the head's max) and P.V by (head, chunk);
//                   partial sums and partial denominators
//              Q2   every block: the chunks combined, h1 = LN1(h + attn);
//                   block 0: the fresh k1 / v1 into slot ptr; items: the
//                   q2 weight product
//              CSC  cross scores by (head, chunk of encoder positions)
//              CPV  cross P.V by (head, chunk)
//              FF1  every block: h2 = LN2(h1 + cross attn); items: ff1
//              FF2  items: the ff1 partials combined with bias and
//                   activation for the item's K rows, then ff2
//   the next layer's QKV (or the end) first folds h = LN3(h2 + ff2 + b2).
//   nw layer:  QKV, SSC, SPV; the next QKV (or the end) folds
//              h = LN1(h + attn) and block 0 writes the slot.
//
// Work items are fixed by the shape alone (step_plan below; mirrored by
// ops/fused_s2s.py::step_plan): blocks loop over them (item = block index,
// + grid size, ...). Every partial sum has its own slot and every combine
// adds in a fixed order, so a step is bit-identical from launch to launch and
// at any grid size. The softmax keeps the TPU kernel's rounding points: the
// probabilities are formed after the head's global max is known (the SSC /
// SPV barrier), and ring chunks run over ring positions i (slot
// (ptr + i) mod M), so no sum depends on where the ring starts.
//
// Memory: what an item reads and does not depend on h (its weight tile with
// the column scales, its ring K / V rows with their scales, relative keys,
// cross context) goes into the block's shared-memory stage buffer when the
// item starts: a run of contiguous rows (the bf16 caches' rows of a chunk, a
// column-scale row) as one bulk copy (cp.async.bulk) on the buffer's
// mbarrier, rows apart in memory (weight tiles, the int8 caches' rows) by
// every thread's cp.async copies, 16 bytes each (4 where a row is not 16-byte
// aligned). (Issuing the next item's copies before the current one runs, or
// before the grid barrier, measured slower on an H100; so did one bulk copy a
// strided row.) What the phases hand each other (partials, scores, maxima) is
// small, lives in the scratch buffer and is read where it is used, through
// L2 (ld.cg: other blocks wrote it in this launch). (Unrolling the loops of
// those sums, to have their loads in flight together, measured slower.) The
// arguments and the plan are read from shared-memory copies.

#pragma once

#include <cooperative_groups.h>

#include "hopper_common.cuh"
#include "slab_common.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kGemvCols = 64;                          // output columns a weight item
constexpr int kGemvColThreads = kGemvCols / 4;         // 16 threads x 4 columns
constexpr int kGemvSlices = kThreads / kGemvColThreads;      // 16 interleaved K slices
constexpr int kGemvItems = 128;                        // a product's item target
constexpr int kGemvMinChunk = 32, kGemvMaxChunk = 128;  // K rows an item
constexpr int kAttnItems = 64;                         // an attention phase's item target
constexpr int kAttnMinChunk = 16, kAttnMaxChunk = 256;  // positions an item
constexpr int kAttnTileElems = 8192;                   // cap on chunk x d_head
constexpr int kRedFloats = kGemvSlices * kGemvCols;    // 4 kThreads: either reduction's buffer

enum PhaseKind { kQKV = 0, kSSC, kSPV, kQ2, kCSC, kCPV, kFF1, kFF2 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int al16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// A weight product y = bf16(x) . W, W (K, N): items are (column tile of
// kGemvCols, K chunk of kc rows), item = tile * chunks + chunk; item
// (t, c) writes partial[c][t * 64 ..]. kc is the smallest power of two from
// kGemvMinChunk up to kGemvMaxChunk that keeps the items within kGemvItems.
struct GemvPlan {
  int K, N, kc, tiles, chunks;
};

__host__ __device__ inline GemvPlan gemv_plan(int K, int N) {
  GemvPlan g;
  g.K = K;
  g.N = N;
  g.tiles = cdiv(N, kGemvCols);
  g.kc = kGemvMinChunk;
  while (g.kc < kGemvMaxChunk && g.tiles * cdiv(K, g.kc) > kGemvItems) g.kc *= 2;
  g.chunks = cdiv(K, g.kc);
  return g;
}

// An attention phase over n positions: items (head, chunk of S positions),
// item = head * nc + chunk. S is the smallest power of two from
// kAttnMinChunk up to kAttnMaxChunk (and S * Dh <= kAttnTileElems / 2) that
// keeps the items within kAttnItems.
struct ChunkPlan {
  int n, S, nc;
};

__host__ __device__ inline ChunkPlan chunk_plan(int n, int H, int Dh) {
  ChunkPlan c;
  c.n = n;
  c.S = kAttnMinChunk;
  while (c.S < kAttnMaxChunk && 2 * c.S * Dh <= kAttnTileElems && H * cdiv(n, c.S) > kAttnItems)
    c.S *= 2;
  c.nc = n > 0 ? cdiv(n, c.S) : 0;
  return c;
}

// The whole step's plan: products, chunkings, scratch offsets (floats) and
// shared-memory sizes. Depends on the shape only.
struct StepPlan {
  int has_cross, L, D, Dff, H, DH, HD, M, Le, wbytes, cbytes, scaled;
  GemvPlan qkv, q2, ff1, ff2;
  ChunkPlan self, cross;
  size_t qkvp, ssc, sself, smax, spv, sden, q2p, csc, cmax, cpv, cden, ff1p, ff2p, scratch;
  int stage;    // bytes of one stage buffer
  int smem;     // dynamic shared memory of a block
};

__host__ __device__ inline int gemv_tile_bytes(const GemvPlan& g, int wbytes) {
  return al16(g.kc * kGemvCols * wbytes) + kGemvCols * 4;
}
// scores tile: S key rows, S + 1 relative-key rows (the last chunk of the
// self ring adds row M, the fresh token's), S key scales
__host__ __device__ inline int scores_wkr_at(int S, int DH, int cbytes) {
  return al16(S * DH * cbytes);
}
__host__ __device__ inline int scores_scale_at(int S, int DH, int cbytes) {
  return scores_wkr_at(S, DH, cbytes) + al16((S + 1) * DH * 2);
}
__host__ __device__ inline int pv_scale_at(int S, int DH, int cbytes) {
  return al16(S * DH * cbytes);
}

__host__ __device__ inline int r4(int x) { return (x + 3) & ~3; }

inline StepPlan step_plan(int has_cross, int L, int D, int Dff, int H, int DH, int M, int Le,
                          int wbytes, int cbytes, int scaled) {
  StepPlan p = {};
  p.has_cross = has_cross;
  p.L = L;
  p.D = D;
  p.Dff = Dff;
  p.H = H;
  p.DH = DH;
  p.HD = H * DH;
  p.M = M;
  p.Le = has_cross ? Le : 0;
  p.wbytes = wbytes;
  p.cbytes = cbytes;
  p.scaled = scaled;
  const int HD = p.HD;
  p.qkv = gemv_plan(D, 3 * HD);
  p.q2 = gemv_plan(D, HD);
  p.ff1 = gemv_plan(D, Dff);
  p.ff2 = gemv_plan(Dff, D);
  p.self = chunk_plan(M, H, DH);
  p.cross = chunk_plan(p.Le, H, DH);
  // scratch: partials by chunk, scores by head (rows of r4(n)), chunk
  // maxima and denominators by head (rows of r4(nc)), P.V partials
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 3) & ~(size_t)3;
    return at;
  };
  p.qkvp = take((size_t)2 * p.qkv.chunks * 3 * HD);   // by layer parity
  p.ssc = take((size_t)H * r4(M));
  p.sself = take(r4(H));
  p.smax = take((size_t)H * r4(p.self.nc));
  p.spv = take((size_t)H * p.self.nc * DH);
  p.sden = take((size_t)H * r4(p.self.nc));
  if (has_cross) {
    p.q2p = take((size_t)p.q2.chunks * HD);
    p.csc = take((size_t)H * r4(p.Le));
    p.cmax = take((size_t)H * r4(p.cross.nc));
    p.cpv = take((size_t)H * p.cross.nc * DH);
    p.cden = take((size_t)H * r4(p.cross.nc));
    p.ff1p = take((size_t)p.ff1.chunks * Dff);
    p.ff2p = take((size_t)p.ff2.chunks * D);
  }
  p.scratch = o;
  int stage = gemv_tile_bytes(p.qkv, wbytes);
  const int S = p.self.S;
  stage = imax(stage, scores_scale_at(S, DH, cbytes) + S * 4);
  stage = imax(stage, pv_scale_at(S, DH, cbytes) + S * 4);
  if (has_cross) {
    const int Sc = p.cross.S;
    stage = imax(stage, gemv_tile_bytes(p.q2, wbytes));
    stage = imax(stage, gemv_tile_bytes(p.ff1, wbytes));
    stage = imax(stage, gemv_tile_bytes(p.ff2, wbytes));
    stage = imax(stage, scores_scale_at(Sc, DH, cbytes) + Sc * 4);
    stage = imax(stage, pv_scale_at(Sc, DH, cbytes) + Sc * 4);
  }
  p.stage = al16(stage);
  // h, h1, h2 (D each), xs (max(D, kGemvMaxChunk)), red, qu / qv / k1 (DH
  // each), e (kAttnMaxChunk), per-head stats (2 H), warp partials (32)
  const int floats = 3 * r4(D) + r4(imax(D, kGemvMaxChunk)) + kRedFloats + 3 * r4(DH) +
                     kAttnMaxChunk + r4(2 * H) + 32;
  p.smem = p.stage + 4 * floats;
  return p;
}

// Where a cache row lives. Slab: slot-major int8 K / V (L, M, HD) with
// per-slot scales (L, M), relative keys (L, M + 1, HD), cross context
// (L, Le, HD) with scales (L, Le) and bf16 relative keys (L, Le, HD).
// Fused: head-major bf16 K / V (L, H, M, Dh), relative keys (L, H, M + 1,
// Dh), cross context (L, H, Le, Dh), no scales. In both, the next position's
// row is row_step elements on.
struct SlabCache {
  using CT = int8_t;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ size_t self_row(int l, int h, int m, const StepPlan& p) {
    return ((size_t)l * p.M + m) * p.HD + h * p.DH;
  }
  static __device__ __forceinline__ size_t wkr_row(int l, int h, int i, const StepPlan& p) {
    return ((size_t)l * (p.M + 1) + i) * p.HD + h * p.DH;
  }
  static __device__ __forceinline__ size_t cross_row(int l, int h, int j, const StepPlan& p) {
    return ((size_t)l * p.Le + j) * p.HD + h * p.DH;
  }
  static __device__ __forceinline__ size_t row_step(const StepPlan& p) { return p.HD; }
  static __device__ __forceinline__ float4 val4(const int8_t* x) {   // 4-byte aligned
    const char4 v = *reinterpret_cast<const char4*>(x);
    return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
  }
};

struct FusedCache {
  using CT = bf16;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ size_t self_row(int l, int h, int m, const StepPlan& p) {
    return (((size_t)l * p.H + h) * p.M + m) * p.DH;
  }
  static __device__ __forceinline__ size_t wkr_row(int l, int h, int i, const StepPlan& p) {
    return (((size_t)l * p.H + h) * (p.M + 1) + i) * p.DH;
  }
  static __device__ __forceinline__ size_t cross_row(int l, int h, int j, const StepPlan& p) {
    return (((size_t)l * p.H + h) * p.Le + j) * p.DH;
  }
  static __device__ __forceinline__ size_t row_step(const StepPlan& p) { return p.DH; }
  static __device__ __forceinline__ float4 val4(const bf16* x) {     // 8-byte aligned
    const uint2 v = *reinterpret_cast<const uint2*>(x);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

// Device pointers of one step (the layouts of ops/fused_s2s.py's wrappers).
template <typename WT, typename CT>
struct StepArgs {
  const WT* qkv_w;
  const WT* q2_w;
  const WT* ff1_w;
  const WT* ff2_w;
  const float* w_scales;   // (L, 8, smax) column scales of int8 panels, else null
  const bf16* qkv_b;
  const bf16* q2_b;
  const bf16* ff1_b;
  const bf16* ff2_b;
  const float* ln1_g;
  const float* ln1_b;
  const float* ln2_g;
  const float* ln2_b;
  const float* ln3_g;
  const float* ln3_b;
  const bf16* wkr;
  const bf16* u;
  const bf16* v;
  CT* kc;
  float* ks;               // per-slot scales (slab), else null
  CT* vc;
  float* vs;
  const CT* ck;
  const float* cks;
  const CT* cv;
  const float* cvs;
  const bf16* cwkr;
  const int32_t* cblocked;
  const float* h_in;
  const int32_t* blocked;
  float* h_out;
  float* scratch;
  int smax, ptr, act;
  float scale;
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A run of rows an item stages: `rows` rows of `bytes` from src (rows
// `stride` bytes apart) to dst (rows `pitch` bytes apart).
struct Rows {
  unsigned char* dst;
  const unsigned char* src;
  size_t stride;
  int pitch, rows, bytes;
};

// Whether a run goes as one bulk copy: contiguous rows (or one row) of
// whole 16-byte units at 16-byte aligned addresses.
__device__ __forceinline__ bool one_bulk(const Rows& r) {
  return r.rows > 0 && (r.rows == 1 || (r.stride == (size_t)r.bytes && r.pitch == r.bytes)) &&
         r.bytes % 16 == 0 && ((reinterpret_cast<uintptr_t>(r.src) | smem_u32(r.dst)) & 15) == 0;
}

// rows x upr units of U bytes (16: cp.async.cg, through L2; 4: cp.async.ca)
// of a run. Thread t takes units t, t + kThreads, ...: one division a call,
// then steps.
template <int U>
__device__ __forceinline__ void copy_units(const Rows& r, int upr) {
  const int n = r.rows * upr;
  int k = (int)threadIdx.x / upr, x = (int)threadIdx.x - k * upr;
  const int dk = kThreads / upr, dx = kThreads - dk * upr;
  for (int u = threadIdx.x; u < n; u += kThreads) {
    if (U == 16)
      cp16(r.dst + k * r.pitch + 16 * x, r.src + k * r.stride + 16 * x);
    else
      cp4(r.dst + k * r.pitch + 4 * x, r.src + k * r.stride + 4 * x);
    k += dk;
    x += dx;
    if (x >= upr) {
      x -= upr;
      ++k;
    }
  }
}

// Every thread stages N runs: thread 0 announces the bytes of the runs that
// go as one bulk copy each on bar and issues them; the others (rows apart
// in memory) go by cp.async, 16 bytes a copy where every row is 16-byte
// aligned, else 4, which the caller commits as one group. (Bulk copies of
// single strided rows of 64-128 bytes measured slower than these.)
template <int N>
__device__ void stage_runs(const Rows (&runs)[N], uint64_t* bar) {
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (one_bulk(runs[i])) bytes += (uint32_t)(runs[i].rows * runs[i].bytes);
    bar_expect(bar, bytes);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (one_bulk(runs[i]))
        bulk_copy(runs[i].dst, runs[i].src, (uint32_t)(runs[i].rows * runs[i].bytes), bar);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const Rows& r = runs[i];
    if (r.rows <= 0 || one_bulk(r)) continue;
    if (r.bytes % 16 == 0 && r.stride % 16 == 0 && r.pitch % 16 == 0 &&
        ((reinterpret_cast<uintptr_t>(r.src) | smem_u32(r.dst)) & 15) == 0)
      copy_units<16>(r, r.bytes / 16);
    else
      copy_units<4>(r, r.bytes / 4);
  }
}

__device__ __forceinline__ const unsigned char* bytes_of(const void* p) {
  return reinterpret_cast<const unsigned char*>(p);
}

// a read-only bf16 operand as f32
__device__ __forceinline__ float bf_ld(const bf16* p) { return __bfloat162float(__ldg(p)); }

// q . row over DH values: q in shared memory (16-byte aligned), the row in
// shared memory as int8 or bf16, both read in 16-byte loads; the products
// are added in index order
__device__ __forceinline__ float dot_row(const int8_t* row, const float* q, int DH) {
  const int4* r = reinterpret_cast<const int4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float t = 0.f;
  for (int c = 0; c < DH / 16; ++c) {
    const int4 w = r[c];
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 x = q4[4 * c + k];
      t = fmaf((float)b[4 * k], x.x, t);
      t = fmaf((float)b[4 * k + 1], x.y, t);
      t = fmaf((float)b[4 * k + 2], x.z, t);
      t = fmaf((float)b[4 * k + 3], x.w, t);
    }
  }
  return t;
}

__device__ __forceinline__ float dot_row(const bf16* row, const float* q, int DH) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float t = 0.f;
  for (int c = 0; c < DH / 8; ++c) {
    const uint4 w = r[c];
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 x = q4[2 * c + k];
      const float2 lo = __bfloat1622float2(b[2 * k]), hi = __bfloat1622float2(b[2 * k + 1]);
      t = fmaf(lo.x, x.x, t);
      t = fmaf(lo.y, x.y, t);
      t = fmaf(hi.x, x.z, t);
      t = fmaf(hi.y, x.w, t);
    }
  }
  return t;
}

// Shared memory of a block.
struct Smem {
  unsigned char* stage;
  uint64_t* bar;   // the stage buffer's mbarrier
  float *h, *h1, *h2, *xs, *red, *qu, *qv, *k1, *e, *hst, *red32;
};

// out = LN(x) * g + b over D floats in shared memory (out may alias x;
// g, b in global memory)
__device__ void layer_norm(const float* x, int D, const float* g, const float* b, float* out,
                           float* red32) {
  float s = 0.f;
  for (int n = threadIdx.x; n < D; n += kThreads) s += x[n];
  const float mu = block_sum(s, red32) / (float)D;
  float q = 0.f;
  for (int n = threadIdx.x; n < D; n += kThreads) {
    const float d = x[n] - mu;
    q += d * d;
  }
  const float var = block_sum(q, red32) / (float)D;
  const float rs = rsqrtf(var + 1e-5f);
  for (int n = threadIdx.x; n < D; n += kThreads)
    out[n] = (x[n] - mu) * rs * __ldg(g + n) + __ldg(b + n);
  __syncthreads();
}

// the sum over `lanes` adjacent lanes (a power of two up to 32), in a fixed order
__device__ __forceinline__ float lane_sum(float v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename WT, typename CF>
struct Step {
  using CT = typename CF::CT;
  const StepArgs<WT, CT>& a;
  const StepPlan& p;
  const Smem& s;
  const int DH;   // d_head

  __device__ float* sc(size_t off) const { return a.scratch + off; }
  __device__ float* qkvp(int l) const {
    return sc(p.qkvp) + (size_t)(l & 1) * p.qkv.chunks * 3 * p.HD;
  }
  __device__ const float* wscale(int l, int row) const {
    return a.w_scales != nullptr ? a.w_scales + ((size_t)l * 8 + row) * a.smax : nullptr;
  }

  __device__ int items(int kind) const {
    switch (kind) {
      case kQKV: return p.qkv.tiles * p.qkv.chunks;
      case kSSC: case kSPV: return p.H * p.self.nc;
      case kQ2: return p.q2.tiles * p.q2.chunks;
      case kCSC: case kCPV: return p.H * p.cross.nc;
      case kFF1: return p.ff1.tiles * p.ff1.chunks;
      case kFF2: return p.ff2.tiles * p.ff2.chunks;
    }
    return 0;
  }

  // ---- copies into the stage buffer (operands that do not depend on h) ----
  // a weight item's (K rows x 64 columns) tile and its column scales
  __device__ void stage_gemv(const WT* W, const float* scales, const GemvPlan& g,
                             int item) const {
    const int t = item / g.chunks, c = item % g.chunks;
    const int n0 = t * kGemvCols, k0 = c * g.kc;
    const int rows = min(g.kc, g.K - k0), nv = min(kGemvCols, g.N - n0);
    const int wb = (int)sizeof(WT);
    unsigned char* dst = s.stage;
    const Rows runs[2] = {
        {dst, bytes_of(W + (size_t)k0 * g.N + n0), (size_t)g.N * wb, kGemvCols * wb, rows,
         nv * wb},
        {dst + al16(g.kc * kGemvCols * wb), bytes_of(scales != nullptr ? scales + n0 : scales),
         0, 0, scales != nullptr ? 1 : 0, nv * 4}};
    stage_runs(runs, s.bar);
  }

  // the rows of one (head, chunk) item: K (or V) rows of its positions, in
  // two runs where the ring wraps (position i is slot (ptr + i) mod M), the
  // per-position scales, and for scores the relative-key rows (self: row i
  // of position i, the last chunk also row M; cross: row j)
  __device__ void stage_attn(int l, int item, bool self, bool scores) const {
    const ChunkPlan& cp = self ? p.self : p.cross;
    const int h = item / cp.nc, c = item % cp.nc;
    const int i0 = c * cp.S, n = min(cp.S, cp.n - i0);
    int m0 = i0, na = n;
    if (self) {
      m0 = (i0 + a.ptr) % p.M;
      na = min(n, p.M - m0);
    }
    const int nb = n - na;   // positions from slot 0 on
    const size_t step = CF::row_step(p);
    const int rb = DH * (int)sizeof(CT);
    const CT* base = self ? (scores ? a.kc : a.vc) : (scores ? a.ck : a.cv);
    auto row = [&](int m) {
      return bytes_of(base + (self ? CF::self_row(l, h, m, p) : CF::cross_row(l, h, m, p)));
    };
    const float* scl = self ? (scores ? a.ks : a.vs) : (scores ? a.cks : a.cvs);
    const float* sl = CF::kScaled ? scl + (size_t)l * (self ? p.M : p.Le) : nullptr;
    const int sn = CF::kScaled ? 1 : 0;
    unsigned char* dst = s.stage;
    unsigned char* sd =
        dst + (scores ? scores_scale_at(cp.S, DH, sizeof(CT)) : pv_scale_at(cp.S, DH, sizeof(CT)));
    const int wrows = scores ? n + (self && c == cp.nc - 1 ? 1 : 0) : 0;
    const bf16* wsrc =
        self ? a.wkr + CF::wkr_row(l, h, i0, p) : a.cwkr + CF::cross_row(l, h, i0, p);
    const Rows runs[5] = {
        {dst, row(m0), step * sizeof(CT), rb, na, rb},
        {dst + na * rb, row(0), step * sizeof(CT), rb, nb, rb},
        {sd, bytes_of(sl != nullptr ? sl + m0 : sl), 0, 0, na > 0 ? sn : 0, na * 4},
        {sd + 4 * na, bytes_of(sl), 0, 0, nb > 0 ? sn : 0, nb * 4},
        {dst + scores_wkr_at(cp.S, DH, sizeof(CT)), bytes_of(wsrc), step * 2, DH * 2, wrows,
         DH * 2}};
    stage_runs(runs, s.bar);
  }

  // item `item` of phase `kind` of layer l: its copies into the stage
  // buffer, then the wait for them (the mbarrier's phase `parity`)
  __device__ void stage(int kind, int l, int item, uint32_t parity) const {
    switch (kind) {
      case kQKV:
        stage_gemv(a.qkv_w + (size_t)l * p.D * 3 * p.HD, wscale(l, 0), p.qkv, item);
        break;
      case kSSC: stage_attn(l, item, true, true); break;
      case kSPV: stage_attn(l, item, true, false); break;
      case kQ2: stage_gemv(a.q2_w + (size_t)l * p.D * p.HD, wscale(l, 1), p.q2, item); break;
      case kCSC: stage_attn(l, item, false, true); break;
      case kCPV: stage_attn(l, item, false, false); break;
      case kFF1: stage_gemv(a.ff1_w + (size_t)l * p.D * p.Dff, wscale(l, 2), p.ff1, item); break;
      case kFF2: stage_gemv(a.ff2_w + (size_t)l * p.Dff * p.D, wscale(l, 3), p.ff2, item); break;
    }
    cp_commit();
    cp_wait<0>();
    bar_wait(s.bar, parity);
    __syncthreads();
  }

  // ---- work items --------------------------------------------------------
  // partial[c][n0 .. n0 + 63] of bf16(x) . W over the item's K rows; x holds
  // the whole input (x_chunk false) or only the item's rows (true).
  __device__ void run_gemv(const unsigned char* tile, bool scaled, const GemvPlan& g, int item,
                           const float* x, bool x_chunk, float* part) const {
    const int t = item / g.chunks, c = item % g.chunks;
    const int n0 = t * kGemvCols, k0 = c * g.kc, rows = min(g.kc, g.K - k0);
    const int cg4 = 4 * (threadIdx.x % kGemvColThreads), ks = threadIdx.x / kGemvColThreads;
    const WT* w = reinterpret_cast<const WT*>(tile);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (n0 + cg4 < g.N) {
      float scl[4] = {0.f, 0.f, 0.f, 0.f};
      if (scaled) {
        const float* sp =
            reinterpret_cast<const float*>(tile + al16(g.kc * kGemvCols * (int)sizeof(WT)));
#pragma unroll
        for (int j = 0; j < 4; ++j) scl[j] = sp[cg4 + j];
      }
      for (int r = ks; r < rows; r += kGemvSlices) {
        const float4 w4 = Panel<WT>::value(
            *reinterpret_cast<const typename Panel<WT>::Raw*>(w + r * kGemvCols + cg4), scl);
        const float xv = bf16_round(x[x_chunk ? r : k0 + r]);
        acc[0] = fmaf(xv, w4.x, acc[0]);
        acc[1] = fmaf(xv, w4.y, acc[1]);
        acc[2] = fmaf(xv, w4.z, acc[2]);
        acc[3] = fmaf(xv, w4.w, acc[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s.red[ks * kGemvCols + cg4 + j] = acc[j];
    __syncthreads();
    // column col summed over the slices by 8 adjacent lanes, in a fixed order
    constexpr int kLanes = kThreads / kGemvCols;
    const int col = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    float t2 = 0.f;
    for (int i = lane; i < kGemvSlices; i += kLanes) t2 += s.red[i * kGemvCols + col];
    t2 = lane_sum(t2, kLanes);
    if (lane == 0 && n0 + col < g.N) part[(size_t)c * g.N + n0 + col] = t2;
  }

  // qu = bf16(bf16(q) + u), qv = bf16(bf16(q) + v) of head h: q the
  // partials (`chunks` rows `stride` floats apart) summed in chunk order
  // plus the bias qb; with k1 also the head's fresh key (f32, bias kb)
  __device__ void queries(int h, const float* q, const float* k1, int chunks, size_t stride,
                          const bf16* qb, const bf16* kb) const {
    for (int d = threadIdx.x; d < DH; d += kThreads) {
      float t = 0.f;
      for (int c = 0; c < chunks; ++c) t += __ldcg(q + c * stride + d);
      const float qq = bf16_round(t + bf_ld(qb + d));
      s.qu[d] = bf16_round(qq + bf_ld(a.u + h * DH + d));
      s.qv[d] = bf16_round(qq + bf_ld(a.v + h * DH + d));
      if (k1 != nullptr) {
        float k = 0.f;
        for (int c = 0; c < chunks; ++c) k += __ldcg(k1 + c * stride + d);
        s.k1[d] = k + bf_ld(kb + d);
      }
    }
    __syncthreads();
  }

  // scores of one (head, chunk) item into scores[h][pos]; its max into mx[h][c]
  __device__ void run_scores(const unsigned char* tile, int l, int item, bool self) const {
    const ChunkPlan& cp = self ? p.self : p.cross;
    const int h = item / cp.nc, c = item % cp.nc;
    const int i0 = c * cp.S, n = min(cp.S, cp.n - i0);
    const bool last = self && c == cp.nc - 1;
    const int HD = p.HD;
    if (self) {
      const bf16* qb = a.qkv_b + (size_t)l * 3 * HD + h * DH;
      queries(h, qkvp(l) + h * DH, last ? qkvp(l) + HD + h * DH : nullptr, p.qkv.chunks,
              3 * HD, qb, qb + HD);
    } else {
      queries(h, sc(p.q2p) + h * DH, nullptr, p.q2.chunks, HD,
              a.q2_b + (size_t)l * HD + h * DH, nullptr);
    }
    const CT* K = reinterpret_cast<const CT*>(tile);
    const bf16* W = reinterpret_cast<const bf16*>(tile + scores_wkr_at(cp.S, DH, sizeof(CT)));
    const float* kscale =
        reinterpret_cast<const float*>(tile + scores_scale_at(cp.S, DH, sizeof(CT)));
    float* out = sc(self ? p.ssc : p.csc) + (size_t)h * r4(cp.n);
    float mx = -INFINITY;
    for (int j = threadIdx.x; j < n; j += kThreads) {   // a thread a position
      int m = i0 + j;
      if (self) {
        m += a.ptr;
        if (m >= p.M) m -= p.M;
      }
      const bool masked = __ldg((self ? a.blocked : a.cblocked) + m) != 0;
      const float ac = dot_row(K + j * DH, s.qu, DH), bd = dot_row(W + j * DH, s.qv, DH);
      const float t = CF::kScaled ? ac * kscale[j] : ac;
      const float v = masked ? -1e9f : (t + bd) * a.scale;
      out[i0 + j] = v;
      mx = fmaxf(mx, v);
    }
    if (last && threadIdx.x < 32) {   // the fresh token: k1 and relative-key row M
      float t = 0.f, w = 0.f;
      for (int d = threadIdx.x; d < DH; d += 32) {
        t = fmaf(s.qu[d], s.k1[d], t);
        w = fmaf(__bfloat162float(W[n * DH + d]), s.qv[d], w);
      }
      t = warp_sum(t);
      w = warp_sum(w);
      const float v = (t + w) * a.scale;
      if (threadIdx.x == 0) {
        sc(p.sself)[h] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = block_max(mx, s.red32);
    if (threadIdx.x == 0) sc(self ? p.smax : p.cmax)[(size_t)h * r4(cp.nc) + c] = mx;
  }

  // e = exp(s - the head's max), sum_j bf16(e_j [* v scale_j]) V_j and
  // sum_j e_j over one (head, chunk) item, into pv[h][c][:] and den[h][c]
  __device__ void run_pv(const unsigned char* tile, int item, bool self) const {
    const ChunkPlan& cp = self ? p.self : p.cross;
    const int h = item / cp.nc, c = item % cp.nc;
    const int i0 = c * cp.S, n = min(cp.S, cp.n - i0);
    const float* mxs = sc(self ? p.smax : p.cmax) + (size_t)h * r4(cp.nc);
    float mx = -INFINITY;
    for (int k = 0; k < cp.nc; ++k) mx = fmaxf(mx, __ldcg(mxs + k));
    float ej = 0.f;
    if ((int)threadIdx.x < n) {
      ej = expf(__ldcg(sc(self ? p.ssc : p.csc) + (size_t)h * r4(cp.n) + i0 + threadIdx.x) - mx);
      s.e[threadIdx.x] = ej;
    }
    const float den = block_sum(ej, s.red32);   // its barriers publish e
    const CT* V = reinterpret_cast<const CT*>(tile);
    const float* vscale = reinterpret_cast<const float*>(tile + pv_scale_at(cp.S, DH, sizeof(CT)));
    const int groups = DH / 4, c4 = 4 * (threadIdx.x % groups), g = threadIdx.x / groups;
    const int G = kThreads / groups;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int j = g; j < n; j += G) {
      const float ew = bf16_round(CF::kScaled ? s.e[j] * vscale[j] : s.e[j]);
      const float4 v4 = CF::val4(V + j * DH + c4);
      a0 = fmaf(ew, v4.x, a0);
      a1 = fmaf(ew, v4.y, a1);
      a2 = fmaf(ew, v4.z, a2);
      a3 = fmaf(ew, v4.w, a3);
    }
    float* mine = s.red + g * DH + c4;
    mine[0] = a0;
    mine[1] = a1;
    mine[2] = a2;
    mine[3] = a3;
    __syncthreads();
    // column d summed over the G groups by kThreads / DH adjacent lanes
    const int lanes = kThreads / DH, d = threadIdx.x / lanes, lane = threadIdx.x % lanes;
    float t = 0.f;
    for (int k = lane; k < G; k += lanes) t += s.red[k * DH + d];
    t = lane_sum(t, lanes);
    const size_t at = (size_t)h * cp.nc + c;
    if (lane == 0) sc(self ? p.spv : p.cpv)[at * DH + d] = t;
    if (threadIdx.x == 0) sc(self ? p.sden : p.cden)[(size_t)h * r4(cp.nc) + c] = den;
  }

  __device__ void run(int kind, int l, int item, const unsigned char* tile) const {
    const bool scaled = a.w_scales != nullptr;
    switch (kind) {
      case kQKV: run_gemv(tile, scaled, p.qkv, item, s.h, false, qkvp(l)); break;
      case kSSC: run_scores(tile, l, item, true); break;
      case kSPV: run_pv(tile, item, true); break;
      case kQ2: run_gemv(tile, scaled, p.q2, item, s.h1, false, sc(p.q2p)); break;
      case kCSC: run_scores(tile, l, item, false); break;
      case kCPV: run_pv(tile, item, false); break;
      case kFF1: run_gemv(tile, scaled, p.ff1, item, s.h2, false, sc(p.ff1p)); break;
      case kFF2: {
        // this item's K rows of bf16(act(ff1 + b1)), the partials in chunk order
        const int k0 = (item % p.ff2.chunks) * p.ff2.kc, rows = min(p.ff2.kc, p.Dff - k0);
        const float* part = sc(p.ff1p) + k0;
        const bf16* b1 = a.ff1_b + (size_t)l * p.Dff + k0;
        for (int r = threadIdx.x; r < rows; r += kThreads) {
          float t = 0.f;
          for (int c = 0; c < p.ff1.chunks; ++c) t += __ldcg(part + (size_t)c * p.Dff + r);
          s.xs[r] = bf16_round(activate(t + bf_ld(b1 + r), a.act));
        }
        __syncthreads();
        run_gemv(tile, scaled, p.ff2, item, s.xs, true, sc(p.ff2p));
        break;
      }
    }
  }

  // ---- what every block folds at a phase's start ---------------------------
  // out = LN1(resid + self attention of layer l), the chunks combined in
  // order; with `write` (block 0) first the fresh k1 / v1 into slot ptr
  __device__ void self_fold(int l, const float* resid, float* out, bool write) const {
    const int nc = p.self.nc, ncp = r4(nc), HD = p.HD;
    const size_t stride = 3 * (size_t)HD;
    const float* kv1 = qkvp(l) + HD;   // k1 / v1 partials: kv1[c * 3 HD + j], v1 at j + HD
    const bf16* kvb = a.qkv_b + (size_t)l * 3 * HD + HD;
    if (write) slot_write(l, kv1, kvb);
    if ((int)threadIdx.x < p.H) {
      const int h = threadIdx.x;
      float mx = -INFINITY, den = 0.f;
      for (int c = 0; c < nc; ++c) mx = fmaxf(mx, __ldcg(sc(p.smax) + h * ncp + c));
      for (int c = 0; c < nc; ++c) den += __ldcg(sc(p.sden) + h * ncp + c);
      const float es = expf(__ldcg(sc(p.sself) + h) - mx);
      s.hst[2 * h] = es;
      s.hst[2 * h + 1] = den + es;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < HD; d += kThreads) {
      const int h = d / DH;
      float v1 = 0.f, pv = 0.f;
      for (int c = 0; c < p.qkv.chunks; ++c) v1 += __ldcg(kv1 + c * stride + HD + d);
      v1 += bf_ld(kvb + HD + d);
      for (int c = 0; c < nc; ++c) pv += __ldcg(sc(p.spv) + (h * nc + c) * DH + d % DH);
      s.xs[d] = resid[d] + (pv + s.hst[2 * h] * v1) / s.hst[2 * h + 1];
    }
    __syncthreads();
    layer_norm(s.xs, p.D, a.ln1_g + (size_t)l * p.D, a.ln1_b + (size_t)l * p.D, out, s.red32);
  }

  // h2 = LN2(h1 + cross attention of layer l)
  __device__ void cross_fold(int l) const {
    const int nc = p.cross.nc, ncp = r4(nc);
    if ((int)threadIdx.x < p.H) {
      float den = 0.f;
      for (int c = 0; c < nc; ++c) den += __ldcg(sc(p.cden) + threadIdx.x * ncp + c);
      s.hst[threadIdx.x] = den;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < p.HD; d += kThreads) {
      const int h = d / DH;
      float pv = 0.f;
      for (int c = 0; c < nc; ++c) pv += __ldcg(sc(p.cpv) + (h * nc + c) * DH + d % DH);
      s.xs[d] = s.h1[d] + pv / s.hst[h];
    }
    __syncthreads();
    layer_norm(s.xs, p.D, a.ln2_g + (size_t)l * p.D, a.ln2_b + (size_t)l * p.D, s.h2, s.red32);
  }

  // h = LN3(h2 + ff2 + b2) of layer l, the partials in chunk order
  __device__ void ff_fold(int l) const {
    const bf16* b2 = a.ff2_b + (size_t)l * p.D;
    for (int n = threadIdx.x; n < p.D; n += kThreads) {
      float t = 0.f;
      for (int c = 0; c < p.ff2.chunks; ++c) t += __ldcg(sc(p.ff2p) + c * p.D + n);
      s.xs[n] = s.h2[n] + (t + bf_ld(b2 + n));
    }
    __syncthreads();
    layer_norm(s.xs, p.D, a.ln3_g + (size_t)l * p.D, a.ln3_b + (size_t)l * p.D, s.h, s.red32);
  }

  // the fresh k1 / v1 of layer l (kv1: their partials, kvb: their bf16
  // biases) into slot ptr: quantized by the row's absmax (scale
  // max(amax, 1e-6) / 127, round half to even), or rounded to bf16
  __device__ void slot_write(int l, const float* kv1, const bf16* kvb) const {
    const int HD = p.HD, chunks = p.qkv.chunks;
    const size_t stride = 3 * (size_t)HD;
    auto k1 = [&](int j) {
      float t = 0.f;
      for (int c = 0; c < chunks; ++c) t += __ldcg(kv1 + c * stride + j);
      return t + bf_ld(kvb + j);
    };
    auto v1 = [&](int j) {
      float t = 0.f;
      for (int c = 0; c < chunks; ++c) t += __ldcg(kv1 + c * stride + HD + j);
      return t + bf_ld(kvb + HD + j);
    };
    float k_scale = 1.f, v_scale = 1.f;
    if (CF::kScaled) {
      float ka = 0.f, va = 0.f;
      for (int j = threadIdx.x; j < HD; j += kThreads) {
        ka = fmaxf(ka, fabsf(k1(j)));
        va = fmaxf(va, fabsf(v1(j)));
      }
      ka = block_max(ka, s.red32);
      va = block_max(va, s.red32);
      k_scale = fmaxf(ka, 1e-6f) * (float)(1.0 / 127.0);
      v_scale = fmaxf(va, 1e-6f) * (float)(1.0 / 127.0);
    }
    for (int j = threadIdx.x; j < HD; j += kThreads) {
      const size_t at = CF::self_row(l, j / DH, a.ptr, p) + j % DH;
      if constexpr (CF::kScaled) {
        a.kc[at] = (int8_t)quantize(k1(j), k_scale, 127.f);
        a.vc[at] = (int8_t)quantize(v1(j), v_scale, 127.f);
      } else {
        a.kc[at] = __float2bfloat16_rn(k1(j));
        a.vc[at] = __float2bfloat16_rn(v1(j));
      }
    }
    if (CF::kScaled && threadIdx.x == 0) {
      a.ks[(size_t)l * p.M + a.ptr] = k_scale;
      a.vs[(size_t)l * p.M + a.ptr] = v_scale;
    }
    __syncthreads();
  }

  __device__ void prelude(int kind, int l) const {
    if (kind == kQKV) {
      if (l == 0) {
        for (int n = threadIdx.x; n < p.D; n += kThreads) s.h[n] = __ldg(a.h_in + n);
        __syncthreads();
      } else if (p.has_cross) {
        ff_fold(l - 1);
      } else {
        self_fold(l - 1, s.h, s.h, blockIdx.x == 0);
      }
    } else if (kind == kQ2) {
      self_fold(l, s.h, s.h1, blockIdx.x == 0);
    } else if (kind == kFF1) {
      cross_fold(l);
    }
  }
};

template <typename WT, typename CF>
__global__ void __launch_bounds__(kThreads, 1)
s2s_step_kernel(const __grid_constant__ StepArgs<WT, typename CF::CT> a,
                const __grid_constant__ StepPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the arguments, the plan and the buffer layout in shared memory: every
  // phase reads them many times, and a read through a reference to a kernel
  // parameter is a generic load of some hundred cycles
  __shared__ StepArgs<WT, typename CF::CT> sa;
  __shared__ StepPlan sp;
  __shared__ Smem s;
  __shared__ uint64_t bars[1];
  if (threadIdx.x == 0) {
    sa = a;
    sp = p;
    s.stage = smem;
    s.bar = bars;
    float* f = reinterpret_cast<float*>(smem + p.stage);
    s.h = f;
    s.h1 = s.h + r4(p.D);
    s.h2 = s.h1 + r4(p.D);
    s.xs = s.h2 + r4(p.D);
    s.red = s.xs + r4(imax(p.D, kGemvMaxChunk));
    s.qu = s.red + kRedFloats;
    s.qv = s.qu + r4(p.DH);
    s.k1 = s.qv + r4(p.DH);
    s.e = s.k1 + r4(p.DH);
    s.hst = s.e + kAttnMaxChunk;
    s.red32 = s.hst + r4(2 * p.H);
    bar_init(bars);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Step<WT, CF> st{sa, sp, s, p.DH};
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, bid = blockIdx.x;
  const int ppl = p.has_cross ? 8 : 3, np = p.L * ppl;
  uint32_t parity = 0;   // the phase of the mbarrier's next completion
  for (int P = 0; P < np; ++P) {
    const int l = P / ppl, kind = P % ppl;
    st.prelude(kind, l);
    const int n = st.items(kind);
    for (int it = bid; it < n; it += G) {
      st.stage(kind, l, it, parity);
      parity ^= 1u;
      st.run(kind, l, it, s.stage);
      __syncthreads();
    }
    grid.sync();
  }
  if (bid == 0) {
    if (p.has_cross)
      st.ff_fold(p.L - 1);
    else
      st.self_fold(p.L - 1, s.h, s.h, true);
    for (int n = threadIdx.x; n < p.D; n += kThreads) a.h_out[n] = s.h[n];
  }
}

// The kernel's dynamic shared-memory limit raised to the card's opt-in
// maximum once per device: no size needs setting again, two host threads
// with different shapes cannot undo each other, and a token step's launch
// does not pay the call.
template <typename WT, typename CF>
cudaError_t allow_max_smem() {
  const auto kern = s2s_step_kernel<WT, CF>;
  static int done[64] = {};   // by device ordinal, for this kernel
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  cudaFuncAttributes fa;
  if ((err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
      (err = cudaFuncGetAttributes(&fa, kern)))
    return err;
  // the opt-in maximum less the kernel's static shared memory
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes - (int)fa.sharedSizeBytes)))
    return err;
  if (dev < 64) done[dev] = 1;
  return cudaSuccess;
}

// Co-resident blocks of the step kernel for plan p (occupancy x SMs), or a
// negative CUDA error.
template <typename WT, typename CF>
int step_grid(const StepPlan& p) {
  const auto kern = s2s_step_kernel<WT, CF>;
  cudaError_t err = allow_max_smem<WT, CF>();
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, p.smem)))
    return -(int)err;
  if ((err = cudaGetDevice(&dev))) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return -(int)err;
  return per_sm * sms;
}

// One cooperative launch of the step on `grid` blocks; returns the CUDA error.
template <typename WT, typename CF>
cudaError_t step_launch(const StepArgs<WT, typename CF::CT>& a, const StepPlan& p, int grid,
                        cudaStream_t st) {
  const auto kern = s2s_step_kernel<WT, CF>;
  cudaError_t err = allow_max_smem<WT, CF>();
  if (err != cudaSuccess) return err;
  StepArgs<WT, typename CF::CT> args = a;
  StepPlan plan = p;
  void* params[] = {&args, &plan};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads), params,
                                    (size_t)p.smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
