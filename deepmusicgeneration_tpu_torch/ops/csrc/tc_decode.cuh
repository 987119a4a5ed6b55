// The tensor-core decode chain of the slab4_w8, slab4, slab_int8, slab and
// multirow_int8 steps at B >= kTcMinRows and of the multirow and slab_w8
// steps and row 10's fused_stack / fused_batched steps at any B
// (slab_decode.cu's slab4_w8_tc_step, slab4_tc_step, slab_int8_tc_step,
// slab_tc_step and slab_w8_tc_step, multirow_decode.cu's
// multirow_int8_tc_step, multirow_tc_step and head_major_tc_step). It computes the function of decode_step in
// slab_common.cuh (the same bf16 cast points, int8 panels dequantized by
// their column scales and rounded to bf16, bf16 panels as they are, float32
// sums) with a layer in 7 kernels instead of 10:
//
//   tc_product (qkv, split-K partials) -> group_attention (sums the qkv
//   partials, writes the summed qkv and bf16(attn)) -> tc_product (out,
//   partials) -> tc_layer_norm (h1 and bf16(h1); then the fresh slot's
//   write, kv_slot_write's, after every head's attention has read the old
//   one) -> tc_product (ff1, its K chunks a cluster that sums them in shared
//   memory, adds the bias and applies the activation, bf16) -> tc_product
//   (ff2, partials) -> tc_layer_norm (h and bf16(h))
//
// slab_int8 (q.K and P.V as int8 x int8 products) takes 9: its attention is
// three kernels (qkv_sum_i8, group_scores_i8, pv_i8; see "Int8-score
// attention" below), because its scales span heads and rows.
//
// Every launch allows programmatic dependent launch: a kernel's blocks may
// be scheduled while its predecessor finishes, and wait (griddepcontrol)
// before they touch memory, so the chain's 56 launches a step (flagship)
// do not each pay a launch gap.
//
// What sets the old chain's pace at B = 64 and what this design does:
// - The weight products (gemv_partial) re-read each weight panel once per 8
//   rows on the CUDA cores. tc_product reads each weight tile once for up
//   to kTcRows batch rows and multiplies on the tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate), weights as the A operand
//   (a warp owns 16 weight columns), the batch rows, zero-padded to a
//   multiple of 8, as the B operand. The product is bound by bytes
//   (2 B FLOP a weight, B <= 64 is far below the card's ridge), so a block
//   keeps kTcStages stages of (kTcStageK K rows x kTcCols columns) of weights
//   and of x in flight by cp.async, and consumes them in order; int8 stages
//   are dequantized once into shared memory for all rows. Split-K only as far
//   as filling the 132 SMs needs (tc_k_chunk: from K and N alone, never from
//   B), and the partials are summed in chunk order by their consumer, so a
//   step is bit-identical across launches and a row's result does not depend
//   on the other rows of its batch.
// - gemv_finish's two passes are gone: the qkv partials are summed where the
//   attention reads them; ff1's K chunks of a column tile are one thread
//   block cluster, whose blocks sum each other's tiles in chunk order
//   through distributed shared memory, a third of the rows each at the
//   flagship, add bias and activation and write the bf16 operand of ff2; the
//   LayerNorms sum at most ~16 partials (flagship) with their loads unrolled.
// - Every (row, head) block of slab_attention reads its head's (M + 1) x Dh
//   relative table: 50 MB a layer at B = 64. group_attention keeps a block
//   a (row, head), and makes the kGroupRows blocks of consecutive rows of a
//   head one cluster that reads the table once: block q forms the dot over
//   its quarter of d of every cluster row's (q + v) with every table row
//   (a slot-major table: those DH / 4 columns of each row in 16-byte loads;
//   a head-major panel, whose odd M + 1 stride rules out vector loads per
//   slot: its quarter of the head's slice, one contiguous run, staged by
//   cp.async), and each row sums the four shares from the cluster's shared
//   memory. K and V come 16 bytes a thread: the int4 ring a packed row a
//   load (both of its slots, the high and the low nibble), the int8
//   head-major K panel 16 slots a load (a warp's load a 512-byte panel row).
//
// Sums stay in ring order where the old attention has them so (softmax
// denominator and P.V over ring positions, oldest first). No reduction
// crosses rows. The slot write cannot go into the attention: a row's slot
// scales are read by every head's block.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "slab_common.cuh"

namespace {

using tc_bf16 = __nv_bfloat16;

constexpr int kTcMinRows = 8;          // the chain serves B >= this (an entry may take fewer)
constexpr int kTcCols = 64;            // weight columns a product block owns
constexpr int kTcWarps = kTcCols / 16;  // a warp per 16 columns (the m16 of the MMA)
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 64;            // batch rows a product block applies (8 n8 tiles)
constexpr int kTcStageK = 64;          // K rows a pipeline stage brings
constexpr int kTcStages = 4;           // stages in flight
constexpr int kTcTargetBlocks = 132;   // the H100's SMs
constexpr int kTcWPitch = kTcCols + 8;       // bf16 stride of a staged weight row
constexpr int kTcXPitch = kTcStageK + 8;     // bf16 stride of a staged x row
constexpr int kTcXPitchF = kTcStageK + 4;    // f32 stride of a staged x row
constexpr int kGroupRows = 4;          // batch rows a group_attention block takes
constexpr int kTcKernelsPerLayer = 7;
constexpr int kTcI8KernelsPerLayer = 9;  // slab_int8: the attention in three
constexpr size_t kMaxSmem = 232448;    // the most dynamic shared memory a block may have
constexpr int kTcMaxCluster = 8;       // the most blocks of a portable cluster
constexpr int kTcPPitch = kTcCols + 4;  // f32 stride of a block's output tile

enum TcEpilogue { kTcPartials = 0, kTcBiasAct = 1 };

inline int tc_round_up(int a, int b) { return (a + b - 1) / b * b; }

// K rows a product block takes: K split into as few chunks (of whole
// stages) as fill kTcTargetBlocks blocks with the ceil(N / kTcCols) column
// tiles, and at most max_chunks of them. It depends on K and N alone, so a
// row's sums do not depend on B.
inline int tc_k_chunk(int K, int N, int max_chunks = 1 << 30) {
  int splits = ceil_div(kTcTargetBlocks, ceil_div(N, kTcCols));
  splits = splits < max_chunks ? splits : max_chunks;
  return tc_round_up(ceil_div(K, splits), kTcStageK);
}

inline int tc_k_blocks(int K, int N, int max_chunks = 1 << 30) {
  return ceil_div(K, tc_k_chunk(K, N, max_chunks));
}

__device__ __forceinline__ uint32_t tc_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src to shared dst by cp.async, or 16 zero bytes (src unread)
__device__ __forceinline__ void tc_cp16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc_smem(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void tc_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void tc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tc_ldsm_x4_t(uint32_t (&r)[4], const tc_bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc_smem(p)));
}

__device__ __forceinline__ void tc_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Programmatic dependent launch: wait until the previous kernel on the
// stream has completed and its writes are visible, then let the next one's
// blocks be scheduled. Every chain kernel calls this before it touches
// memory.
__device__ __forceinline__ void tc_grid_sync() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch with programmatic stream serialization allowed and, for cluster_x
// x cluster_y > 1, that cluster shape.
template <typename... KArgs, typename... Args>
cudaError_t tc_launch(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                      int cluster_x, int cluster_y, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cluster_x * cluster_y > 1) {
    attrs[1].id = cudaLaunchAttributeClusterDimension;
    attrs[1].val.clusterDim.x = cluster_x;
    attrs[1].val.clusterDim.y = cluster_y;
    attrs[1].val.clusterDim.z = 1;
    n = 2;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

__device__ __forceinline__ uint32_t tc_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The weight panel types: a stage of raw weights in shared memory (int8
// rows of kTcCols bytes, dequantized into a bf16 tile before the product;
// bf16 rows at kTcWPitch, read by the product as they are).
template <typename WT>
struct TcPanel;

template <>
struct TcPanel<int8_t> {
  static constexpr int kChunk = 16;  // weights a 16-byte copy brings
  static constexpr int kStageBytes = kTcStageK * kTcCols;
  static constexpr bool kDequant = true;
  static __device__ __forceinline__ int offset(int r, int c) { return r * kTcCols + c; }
};

template <>
struct TcPanel<tc_bf16> {
  static constexpr int kChunk = 8;
  static constexpr int kStageBytes = kTcStageK * kTcWPitch * 2;
  static constexpr bool kDequant = false;
  static __device__ __forceinline__ int offset(int r, int c) { return (r * kTcWPitch + c) * 2; }
};

// The x operand types: bf16 rows (the chain's own operands) staged as they
// are, or f32 rows (h_in, layer 0's qkv operand) rounded to bf16 as the
// fragments are formed.
template <typename XT>
struct TcX;

template <>
struct TcX<tc_bf16> {
  static constexpr int kChunk = 8;
  static constexpr int kPitch = kTcXPitch;
  static __device__ __forceinline__ uint32_t pair(const tc_bf16* row, int k) {
    return *reinterpret_cast<const uint32_t*>(row + k);
  }
};

template <>
struct TcX<float> {
  static constexpr int kChunk = 4;
  static constexpr int kPitch = kTcXPitchF;
  static __device__ __forceinline__ uint32_t pair(const float* row, int k) {
    const float2 f = *reinterpret_cast<const float2*>(row + k);
    return tc_pack(f.x, f.y);
  }
};

template <typename WT, typename XT, int NT>
__host__ __device__ constexpr size_t tc_stage_smem() {
  return (size_t)kTcStages * TcPanel<WT>::kStageBytes +
         (size_t)kTcStages * NT * 8 * TcX<XT>::kPitch * sizeof(XT) +
         (TcPanel<WT>::kDequant ? (size_t)kTcStageK * kTcWPitch * 2 + kTcCols * 4 : 0);
}

// the stages, and after them (in the same bytes) the block's output tile
template <typename WT, typename XT, int NT>
__host__ __device__ constexpr size_t tc_product_smem() {
  return tc_stage_smem<WT, XT, NT>() > (size_t)NT * 8 * kTcPPitch * 4
             ? tc_stage_smem<WT, XT, NT>()
             : (size_t)NT * 8 * kTcPPitch * 4;
}

// y = bf16(x) . w for the rows b0 .. b0 + 63 of blockIdx.z, the columns
// n0 .. n0 + 63 of blockIdx.x and the K rows of chunk kb = blockIdx.y (kc
// rows, a multiple of kTcStageK), where w is bf16(W[k][n] * s[n]) for an
// int8 panel and W[k][n] for a bf16 one (s null). NT n8 tiles of rows (8 NT
// >= the rows of the group; rows past B are zeros). Epilogue kTcPartials:
// partial[kb][b][n] = y. kTcBiasAct: launched with the gridDim.y K chunks of
// a column tile as one cluster; each block leaves y in shared memory, and
// block kb sums rows kb, kb + gridDim.y, ... of the cluster's tiles in chunk
// order and writes yb[b][n] = bf16(act(sum + bias[n])). N and K multiples
// of 16; W (K, N), x (B, K) row-major.
template <typename WT, typename XT, int NT, int EPI>
__global__ void __launch_bounds__(kTcThreads)
tc_product(const XT* __restrict__ x, int B, int K, int N, const WT* __restrict__ W,
           const float* __restrict__ s, int kc, float* __restrict__ partial,
           const tc_bf16* __restrict__ bias, int act, tc_bf16* __restrict__ yb) {
  extern __shared__ __align__(16) unsigned char tc_sm[];
  using P = TcPanel<WT>;
  using X = TcX<XT>;
  unsigned char* wst = tc_sm;                                              // weight stages
  XT* xst = reinterpret_cast<XT*>(tc_sm + (size_t)kTcStages * P::kStageBytes);  // x stages
  constexpr int kXStage = NT * 8 * X::kPitch;                              // XT a stage
  tc_bf16* wd = reinterpret_cast<tc_bf16*>(xst + (size_t)kTcStages * kXStage);  // dequantized
  float* scs = reinterpret_cast<float*>(wd + kTcStageK * kTcWPitch);       // column scales
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTcCols;
  const int kb = blockIdx.y;
  const int b0 = blockIdx.z * kTcRows;
  const int k_begin = kb * kc, k_end = min(K, k_begin + kc);
  const int n_k = (k_end - k_begin + kTcStageK - 1) / kTcStageK;
  // the weights and their scales are no kernel's output: the slice's rows
  // head for L2 (a line a row) while the previous kernel finishes
  for (int r = tid; r < k_end - k_begin; r += kTcThreads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(W + (size_t)(k_begin + r) * N + n0));
  if (P::kDequant)
    for (int c = tid; c < kTcCols; c += kTcThreads) scs[c] = n0 + c < N ? s[n0 + c] : 0.f;
  tc_grid_sync();

  // stage st (kTcStageK K rows from k_begin + st * kTcStageK) into ring slot `slot`;
  // rows past k_end, columns past N and batch rows past B are zero-filled
  auto load_stage = [&](int slot, int st) {
    const int k0 = k_begin + st * kTcStageK;
    constexpr int kWChunks = kTcStageK * (kTcCols / P::kChunk);
    for (int i = tid; i < kWChunks; i += kTcThreads) {
      const int r = i / (kTcCols / P::kChunk), c = (i % (kTcCols / P::kChunk)) * P::kChunk;
      const bool ok = k0 + r < k_end && n0 + c < N;
      tc_cp16(wst + (size_t)slot * P::kStageBytes + P::offset(r, c),
              ok ? (const void*)(W + (size_t)(k0 + r) * N + n0 + c) : (const void*)W, ok);
    }
    constexpr int kXChunks = NT * 8 * (kTcStageK / X::kChunk);
    for (int i = tid; i < kXChunks; i += kTcThreads) {
      const int r = i / (kTcStageK / X::kChunk), c = (i % (kTcStageK / X::kChunk)) * X::kChunk;
      const bool ok = b0 + r < B && k0 + c < k_end;
      tc_cp16(xst + (size_t)slot * kXStage + r * X::kPitch + c,
              ok ? (const void*)(x + (size_t)(b0 + r) * K + k0 + c) : (const void*)x, ok);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    tc_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row: k offset (lane / 16) * 8 + lane % 8, column offset
  // ((lane / 8) % 2) * 8 within the warp's 16 columns
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = warp * 16 + (((lane >> 3) & 1) << 3);
  for (int it = 0; it < n_k; ++it) {
    tc_wait<kTcStages - 2>();  // this thread's copies of stage `it` have landed
    __syncthreads();           // everyone's have; and stage it - 1's readers are done
    {
      const int nx = it + kTcStages - 1;
      if (nx < n_k) load_stage(nx % kTcStages, nx);
      tc_commit();
    }
    const unsigned char* raw = wst + (size_t)(it % kTcStages) * P::kStageBytes;
    const tc_bf16* a_tile = reinterpret_cast<const tc_bf16*>(raw);
    if (P::kDequant) {
      // int8 -> bf16(q * s[n]), as Panel<int8_t>::value, once for all rows
      for (int i = tid; i < kTcStageK * (kTcCols / 16); i += kTcThreads) {
        const int r = i / (kTcCols / 16), c = (i % (kTcCols / 16)) * 16;
        const int4 q = *reinterpret_cast<const int4*>(raw + r * kTcCols + c);
        const int8_t* qb = reinterpret_cast<const int8_t*>(&q);
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = tc_pack((float)qb[2 * j] * scs[c + 2 * j], (float)qb[2 * j + 1] * scs[c + 2 * j + 1]);
        uint4* dst = reinterpret_cast<uint4*>(wd + r * kTcWPitch + c);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      a_tile = wd;
    }
    const XT* xs = xst + (size_t)(it % kTcStages) * kXStage;
#pragma unroll
    for (int kk = 0; kk < kTcStageK; kk += 16) {
      uint32_t a[4];
      tc_ldsm_x4_t(a, a_tile + (kk + a_row) * kTcWPitch + a_col);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const XT* row = xs + (j * 8 + g) * X::kPitch + kk + 2 * t;
        tc_mma(acc[j], a, X::pair(row, 0), X::pair(row, 8));
      }
    }
  }
  tc_wait<0>();  // no copy outlives the block (the trailing groups are empty)
  // acc[j][e] is y[b0 + 8 j + 2 t + e % 2][n0 + 16 warp + g + 8 (e / 2)]
  if (EPI == kTcPartials) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + j * 8 + 2 * t + (e & 1);
        const int n = n0 + warp * 16 + g + ((e >> 1) << 3);
        if (b < B && n < N) partial[((size_t)kb * B + b) * N + n] = acc[j][e];
      }
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* pt = reinterpret_cast<float*>(tc_sm);  // NT * 8 rows x kTcPPitch
    __syncthreads();                              // every warp is done with the stages
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pt[(j * 8 + 2 * t + (e & 1)) * kTcPPitch + warp * 16 + g + ((e >> 1) << 3)] = acc[j][e];
    cluster.sync();  // every block's tile is written and visible to the cluster
    const int KB = gridDim.y, rows = min(NT * 8, B - b0), cols = min(kTcCols, N - n0);
    const int mine = rows > kb ? (rows - kb + KB - 1) / KB * kTcCols : 0;  // rows kb, kb + KB, ...
    constexpr int U = 4;  // outputs a thread sums at once, every load issued first
    for (int i0 = tid; i0 < mine; i0 += U * kTcThreads) {
      float v[U][kTcMaxCluster];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = min(i0 + u * kTcThreads, mine - 1);
        const int off = (kb + i / kTcCols * KB) * kTcPPitch + i % kTcCols;
#pragma unroll
        for (int q = 0; q < kTcMaxCluster; ++q)
          v[u][q] = q < KB ? *(cluster.map_shared_rank(pt, q) + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kTcThreads, c = i % kTcCols;
        if (i < mine && c < cols) {
          float y = 0.f;
#pragma unroll
          for (int q = 0; q < kTcMaxCluster; ++q)
            if (q < KB) y += v[u][q];
          const int b = b0 + kb + i / kTcCols * KB, n = n0 + c;
          yb[(size_t)b * N + n] = __float2bfloat16_rn(activate(y + __bfloat162float(bias[n]), act));
        }
      }
    }
    cluster.sync();  // no block leaves while the others read its tile
  }
}

template <typename WT, typename XT, int NT, int EPI>
cudaError_t tc_product_nt(const XT* x, int B, int K, int N, const WT* W, const float* s, int kc,
                          float* partial, const tc_bf16* bias, int act, tc_bf16* yb,
                          cudaStream_t st) {
  constexpr size_t smem = tc_product_smem<WT, XT, NT>();
  dim3 grid(ceil_div(N, kTcCols), ceil_div(K, kc), ceil_div(B, kTcRows));
  // kTcBiasAct: a column tile's K chunks are one cluster
  if (EPI == kTcBiasAct && grid.y > (unsigned)kTcMaxCluster) return cudaErrorInvalidValue;
  return tc_launch(tc_product<WT, XT, NT, EPI>, grid, kTcThreads, smem, 1,
                   EPI == kTcBiasAct ? (int)grid.y : 1, st, x, B, K, N, W, s, kc, partial, bias,
                   act, yb);
}

// tc_product (K chunks of tc_k_chunk(K, N) rows, at most kTcMaxCluster for
// kTcBiasAct) at the fewest n8 tiles (1, 2, 4 or 8) that hold min(B,
// kTcRows) rows; every row group of a launch takes that many.
template <typename WT, typename XT, int EPI>
cudaError_t tc_gemm(const XT* x, int B, int K, int N, const WT* W, const float* s,
                    float* partial, const tc_bf16* bias, int act, tc_bf16* yb, cudaStream_t st) {
  const int rows = min(B, kTcRows);
  const int kc = EPI == kTcBiasAct ? tc_k_chunk(K, N, kTcMaxCluster) : tc_k_chunk(K, N);
#define TC_GEMM_ARGS x, B, K, N, W, s, kc, partial, bias, act, yb, st
  if (rows <= 8) return tc_product_nt<WT, XT, 1, EPI>(TC_GEMM_ARGS);
  if (rows <= 16) return tc_product_nt<WT, XT, 2, EPI>(TC_GEMM_ARGS);
  if (rows <= 32) return tc_product_nt<WT, XT, 4, EPI>(TC_GEMM_ARGS);
  return tc_product_nt<WT, XT, 8, EPI>(TC_GEMM_ARGS);
#undef TC_GEMM_ARGS
}

// sum over kb < KB of p[kb * stride] in kb order, sixteen loads in flight
__device__ __forceinline__ float tc_sum_chunks(const float* p, int KB, size_t stride) {
  float t = 0.f;
  for (int kb0 = 0; kb0 < KB; kb0 += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = kb0 + u < KB ? p[(size_t)(kb0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (kb0 + u < KB) t += v[u];
  }
  return t;
}

constexpr int kLnThreads = 512;  // a LayerNorm block: a column a thread at d_model 512

// No fresh-slot write (tc_layer_norm's format argument of LN2).
struct NoSlot {
  using KT = int8_t;
  using VT = int8_t;
};

// out[b] = LN(resid[b] + sum_kb partial[kb][b] + bias) * g + beta, and its
// bf16 copy out_b (the next product's operand); one block per row, the
// partials summed in chunk order. `out` must not alias `resid`. For a cache
// format F (not NoSlot) the block then writes row b's fresh k1 / v1 (of qkv
// (B, 3HD)) into slot ptr of the layer's caches, as kv_slot_write does.
template <typename F>
__global__ void __launch_bounds__(kLnThreads)
tc_layer_norm(const float* __restrict__ resid, const float* __restrict__ partial, int KB, int B,
              int N, const tc_bf16* __restrict__ bias, const float* __restrict__ g,
              const float* __restrict__ beta, float* __restrict__ out,
              tc_bf16* __restrict__ out_b, const float* __restrict__ qkv, int HD, int M, int ptr,
              typename F::KT* __restrict__ kt, float* __restrict__ ks,
              typename F::VT* __restrict__ vc, float* __restrict__ vs) {
  extern __shared__ float ln_x[];  // N floats
  __shared__ float red[32];
  tc_grid_sync();
  const int b = blockIdx.x;
  float sum = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float t = tc_sum_chunks(partial + (size_t)b * N + n, KB, (size_t)B * N);
    if (bias != nullptr) t += __bfloat162float(bias[n]);
    const float v = resid[(size_t)b * N + n] + t;
    ln_x[n] = v;
    sum += v;
  }
  const float mu = block_sum(sum, red) / (float)N;
  float sq = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float d = ln_x[n] - mu;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / (float)N;
  const float rs = rsqrtf(var + 1e-5f);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float y = (ln_x[n] - mu) * rs * g[n] + beta[n];
    out[(size_t)b * N + n] = y;
    out_b[(size_t)b * N + n] = __float2bfloat16_rn(y);
  }
  if constexpr (!std::is_same<F, NoSlot>::value) {
    const float* k1 = qkv + (size_t)b * 3 * HD + HD;
    const float* v1 = k1 + HD;
    float k_scale = 1.f, v_scale = 1.f;  // a bf16 cache has no scales (ks, vs null)
    if constexpr (F::kScaled) {
      float ka = 0.f, va = 0.f;
      for (int j = threadIdx.x; j < HD; j += blockDim.x) {
        ka = fmaxf(ka, fabsf(k1[j]));
        va = fmaxf(va, fabsf(v1[j]));
      }
      ka = block_max(ka, red);
      va = block_max(va, red);
      k_scale = fmaxf(ka, 1e-6f) * F::inv_qmax();
      v_scale = fmaxf(va, 1e-6f) * F::inv_qmax();
    }
    for (int j = threadIdx.x; j < HD; j += blockDim.x) {
      F::put_k(kt, b, j, M, HD, ptr, k1[j], k_scale);
      F::put_v(vc, b, j, M, HD, ptr, v1[j], v_scale);
    }
    if constexpr (F::kScaled) {
      if (threadIdx.x == 0) {
        ks[(size_t)b * M + ptr] = k_scale;
        vs[(size_t)b * M + ptr] = v_scale;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Grouped attention
// ---------------------------------------------------------------------------

// (q + v) . w for a table row held in registers (DH bf16, d ascending)
template <int DH>
__device__ __forceinline__ float tc_row_dot(const uint4 (&w8)[DH / 8], const float* qv) {
  float t = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w8[c]);
    const float4 qa = *reinterpret_cast<const float4*>(qv + c * 8);
    const float4 qb = *reinterpret_cast<const float4*>(qv + c * 8 + 4);
    const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p2[j]);
      t = fmaf(f.x, q[2 * j], t);
      t = fmaf(f.y, q[2 * j + 1], t);
    }
  }
  return t;
}

// Byte k of w (0..255) as a float, less `bias`, without an int-to-float
// conversion: the byte is the low mantissa of 2^23 + byte. Exact for the
// values here: a nibble less 8 (bias 2^23 + 8), or an int8 value stored as
// byte ^ 0x80 (bias 2^23 + 128).
__device__ __forceinline__ float tc_byte(uint32_t w, int k, float bias) {
  return __int_as_float((int)__byte_perm(w, 0x4B000000u, 0x7650u | (unsigned)k)) - bias;
}
constexpr float kNibbleBias = 8388616.f;  // 2^23 + 8
constexpr float kInt8Bias = 8388736.f;    // 2^23 + 128

// sixteen int8 values of a 16-byte load as floats
__device__ __forceinline__ void tc_int8x16(const int4& q, float (&f)[16]) {
  const uint32_t w[4] = {(uint32_t)q.x ^ 0x80808080u, (uint32_t)q.y ^ 0x80808080u,
                         (uint32_t)q.z ^ 0x80808080u, (uint32_t)q.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = tc_byte(w[j / 4], j % 4, kInt8Bias);
}

// the nibbles of a packed 16-byte load, each less 8, as floats: f1 the high
// ones (packed row m's slot m) and f2 the low ones (slot m + M/2), or the
// other way round when !hi_first
__device__ __forceinline__ void tc_nibbles16(const int4& q, bool hi_first, float (&f1)[16],
                                             float (&f2)[16]) {
  const uint32_t w[4] = {(uint32_t)q.x, (uint32_t)q.y, (uint32_t)q.z, (uint32_t)q.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t h = (w[c] >> 4) & 0x0F0F0F0Fu, l = w[c] & 0x0F0F0F0Fu;
    const uint32_t a = hi_first ? h : l, b = hi_first ? l : h;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f1[4 * c + k] = tc_byte(a, k, kNibbleBias);
      f2[4 * c + k] = tc_byte(b, k, kNibbleBias);
    }
  }
}

// ring position i (oldest first) -> slot
__device__ __forceinline__ int ring_slot(int i, int ptr, int M) {
  return i < M - ptr ? i + ptr : i + ptr - M;
}

// Loads a thread keeps in flight in the attention's P.V loops.
constexpr int kAttnLoads = 4;
// Warps of an attention block; the int8 K panel's dots split d over them.
constexpr int kAttnThreads = 256;  // threads of a group_attention block
constexpr int kAttnWarps = kAttnThreads / 32;
// group_attention blocks an SM holds: 48 registers a thread, no spills (at
// B = 64 the flagship's 768 blocks run in 1.2 waves; at 4 a SM, 1.45)
constexpr int kAttnBlocksPerSM = 5;

// The int4 slot-major ring (SlotI4: packed row m holds slot m high, m + M/2
// low) with its slot-major (M + 1, HD) relative table.
struct GroupI4 {
  using KT = int8_t;
  using VT = int8_t;
  static constexpr bool kScaled = true;
  // The cluster's shares of the relative scores: block q forms, for every
  // row of the cluster and every position, the dot over d in [q DH / G,
  // (q + 1) DH / G), reading those DH / G columns of each table row.
  static __host__ __device__ size_t part_floats(int M) { return (size_t)kGroupRows * (M + 1); }
  static __host__ __device__ size_t stage_bytes(int, int) { return 0; }
  template <int DH>
  static __device__ void stage(const tc_bf16*, int, int, int, tc_bf16*) {}
  template <int DH>
  static __device__ void rel_part(const tc_bf16* wkr, const tc_bf16*, int h, int M, int HD,
                                  int q, const float* qv, float* part) {
    constexpr int DQ = DH / kGroupRows;  // 4 .. 32 bf16: 8 to 64 bytes a row
    for (int m = threadIdx.x; m <= M; m += blockDim.x) {
      const tc_bf16* w = wkr + (size_t)m * HD + h * DH + q * DQ;
      float wf[DQ];
      if constexpr (DQ >= 8) {
        uint4 w8[DQ / 8];
#pragma unroll
        for (int c = 0; c < DQ / 8; ++c) w8[c] = reinterpret_cast<const uint4*>(w)[c];
#pragma unroll
        for (int c = 0; c < DQ / 8; ++c) {
          const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w8[c]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(p2[j]);
            wf[8 * c + 2 * j] = f.x;
            wf[8 * c + 2 * j + 1] = f.y;
          }
        }
      } else {
        const uint2 w4 = *reinterpret_cast<const uint2*>(w);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4.x));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4.y));
        wf[0] = a.x;
        wf[1] = a.y;
        wf[2] = c.x;
        wf[3] = c.y;
      }
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) {
        float t = 0.f;
#pragma unroll
        for (int d = 0; d < DQ; ++d) t = fmaf(wf[d], qv[r * DH + q * DQ + d], t);
        part[r * (M + 1) + m] = t;
      }
    }
  }
  // put(m, (q + u) . K[slot m]) for every slot of row b: a packed row a thread
  // (its DH bytes in 16-byte loads) for both of its slots
  template <int DH, typename Put>
  static __device__ void key_dots(const int8_t* kt, int b, int h, int M, int HD, const float* qu,
                                  float*, Put put) {
    const int M2 = M / 2;
    const int8_t* base = kt + (size_t)b * M2 * HD + h * DH;
    constexpr int U = DH <= 64 ? 2 : 1;  // packed rows in flight
    for (int p0 = threadIdx.x; p0 < M2; p0 += U * blockDim.x) {
      int4 k16[U][DH / 16];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int4* kr = reinterpret_cast<const int4*>(
            base + (size_t)min(p0 + u * (int)blockDim.x, M2 - 1) * HD);
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) k16[u][c] = kr[c];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
      const int pm = p0 + u * blockDim.x;
      if (pm >= M2) break;
      float hi = 0.f, lo = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        float fh[16], fl[16];
        tc_nibbles16(k16[u][c], true, fh, fl);
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qu + c * 16 + 4 * j4);
          const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            hi = fmaf(fh[4 * j4 + k], qq[k], hi);
            lo = fmaf(fl[4 * j4 + k], qq[k], lo);
          }
        }
      }
      put(pm, hi);
      put(pm + M2, lo);
      }
    }
  }
  // 16 columns (chunk c) of row b's P.V over ring positions s, s + M/2, s + S,
  // s + S + M/2, ... (a position and its partner, the other slot of the same
  // packed row, from one load); ew[m] = bf16(p[m] * vs[m]).
  template <int DH, int S>
  static __device__ void pv(const int8_t* vc, int b, int h, int M, int HD, int ptr, int c,
                            int s, const float* ew, float (&out)[16]) {
    const int M2 = M / 2;
#pragma unroll
    for (int j = 0; j < 16; ++j) out[j] = 0.f;
    const int8_t* col = vc + (size_t)b * M2 * HD + h * DH + 16 * c;
    for (int i0 = s; i0 < M2; i0 += kAttnLoads * S) {
      int4 q[kAttnLoads];
#pragma unroll
      for (int u = 0; u < kAttnLoads; ++u) {
        const int m = ring_slot(min(i0 + u * S, M2 - 1), ptr, M);
        q[u] = *reinterpret_cast<const int4*>(col + (size_t)(m < M2 ? m : m - M2) * HD);
      }
#pragma unroll
      for (int u = 0; u < kAttnLoads; ++u) {
        if (i0 + u * S < M2) {
          const int m = ring_slot(i0 + u * S, ptr, M);
          const int m2 = m < M2 ? m + M2 : m - M2;
          // slot m is the high nibble when m < M/2, its partner the other
          float f1[16], f2[16];
          tc_nibbles16(q[u], m < M2, f1, f2);
          const float e1 = ew[m], e2 = ew[m2];
#pragma unroll
          for (int j = 0; j < 16; ++j) out[j] = fmaf(e2, f2[j], fmaf(e1, f1[j], out[j]));
        }
      }
    }
  }
};

// int8 head-major K panels (B, HD, M) and slot-major V (B, M, HD) with
// per-slot scales (PanelI8 of multirow_decode.cu), and the (HD, M + 1)
// relative-table panel. A head's slice of the panel (DH rows of M + 1, one
// contiguous run) is staged a quarter a block of the cluster: block q copies
// rows [q DH / G, (q + 1) DH / G) and forms their share of every row's
// relative scores at every position; each row then sums the G shares.
struct GroupPanelI8 {
  using KT = int8_t;
  using VT = int8_t;
  static constexpr bool kScaled = true;
  static __host__ __device__ size_t part_floats(int M) { return (size_t)kGroupRows * (M + 1); }
  static __host__ __device__ size_t stage_bytes(int Dh, int M) {
    return ((size_t)Dh / kGroupRows * (M + 1) * sizeof(tc_bf16) + 15) / 16 * 16;
  }
  // rows [q DH / G, (q + 1) DH / G) of the head's slice into wk by cp.async
  // (16-byte copies where the run allows, else 8-byte), committed
  template <int DH>
  static __device__ void stage(const tc_bf16* wkr, int h, int M, int q, tc_bf16* wk) {
    constexpr int DQ = DH / kGroupRows;
    const size_t n = (size_t)DQ * (M + 1) * sizeof(tc_bf16);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        wkr + ((size_t)h * DH + q * DQ) * (M + 1));
    unsigned char* dst = reinterpret_cast<unsigned char*>(wk);
    if (((uintptr_t)src & 15) == 0 && n % 16 == 0) {
      for (size_t i = threadIdx.x * 16; i < n; i += blockDim.x * 16) tc_cp16(dst + i, src + i);
    } else {
      for (size_t i = threadIdx.x * 8; i < n; i += blockDim.x * 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(tc_smem(dst + i)),
                     "l"(src + i)
                     : "memory");
    }
    tc_commit();
  }
  template <int DH>
  static __device__ void rel_part(const tc_bf16*, const tc_bf16* wk, int, int M, int, int q,
                                  const float* qv, float* part) {
    constexpr int DQ = DH / kGroupRows;
    for (int m = threadIdx.x; m <= M; m += blockDim.x) {
      float acc[kGroupRows];
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) acc[r] = 0.f;
#pragma unroll
      for (int d = 0; d < DQ; ++d) {
        const float w = __bfloat162float(wk[(size_t)d * (M + 1) + m]);
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) acc[r] = fmaf(w, qv[r * DH + q * DQ + d], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) part[r * (M + 1) + m] = acc[r];
    }
  }
  // put(m, (q + u) . K[:, m]) for every slot of row b: warp w takes d in
  // [w DH / 8, (w + 1) DH / 8) and a lane 16 slots (one 16-byte load a d, a
  // warp's load 512 contiguous bytes of a panel row); the eight warps' sums
  // are added in warp order. M a multiple of 16; kp holds kAttnWarps x M.
  template <int DH, typename Put>
  static __device__ void key_dots(const int8_t* kt, int b, int h, int M, int HD, const float* qu,
                                  float* kp, Put put) {
    constexpr int DW = DH / kAttnWarps;
    constexpr int U = DW < 8 ? DW : 8;  // loads in flight
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, MC = M / 16;
    const int8_t* k = kt + ((size_t)b * HD + h * DH + warp * DW) * M;
    for (int c = lane; c < MC; c += 32) {
      float acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < DW; d0 += U) {
        int4 kv[U];
#pragma unroll
        for (int d = 0; d < U; ++d)
          kv[d] = *reinterpret_cast<const int4*>(k + (size_t)(d0 + d) * M + 16 * c);
#pragma unroll
        for (int d = 0; d < U; ++d) {
          float f[16];
          tc_int8x16(kv[d], f);
          const float qd = qu[warp * DW + d0 + d];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[j] = fmaf(f[j], qd, acc[j]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(kp + (size_t)warp * M + 16 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kAttnWarps; ++w) t += kp[(size_t)w * M + m];
      put(m, t);
    }
  }
  // 16 columns (chunk c) of row b's P.V over ring positions s, s + S, ...;
  // ew[m] = bf16(p[m] * vs[m])
  template <int DH, int S>
  static __device__ void pv(const int8_t* vc, int b, int h, int M, int HD, int ptr, int c,
                            int s, const float* ew, float (&out)[16]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) out[j] = 0.f;
    const int8_t* col = vc + (size_t)b * M * HD + h * DH + 16 * c;
    for (int i0 = s; i0 < M; i0 += kAttnLoads * S) {
      int4 q[kAttnLoads];
#pragma unroll
      for (int u = 0; u < kAttnLoads; ++u)
        q[u] = *reinterpret_cast<const int4*>(col + (size_t)ring_slot(min(i0 + u * S, M - 1), ptr, M) * HD);
#pragma unroll
      for (int u = 0; u < kAttnLoads; ++u) {
        if (i0 + u * S < M) {
          const float e = ew[ring_slot(i0 + u * S, ptr, M)];
          float f[16];
          tc_int8x16(q[u], f);
#pragma unroll
          for (int j = 0; j < 16; ++j) out[j] = fmaf(e, f[j], out[j]);
        }
      }
    }
  }
};

// bf16 head-major K panels (B, HD, M) and slot-major V (B, M, HD) with no
// scales (PanelBF16 of multirow_decode.cu): GroupPanelI8's relative-panel
// staging and shares; the key dots 8 slots a 16-byte load, V two loads a
// slot's 16 columns.
struct GroupPanelBF16 : GroupPanelI8 {
  using KT = tc_bf16;
  using VT = tc_bf16;
  static constexpr bool kScaled = false;
  // put(m, (q + u) . K[:, m]) for every slot of row b: warp w takes d in
  // [w DH / 8, (w + 1) DH / 8) and a lane 8 slots (one 16-byte load a d, a
  // warp's load 512 contiguous bytes of a panel row); the eight warps' sums
  // are added in warp order. M a multiple of 8; kp holds kAttnWarps x M.
  template <int DH, typename Put>
  static __device__ void key_dots(const tc_bf16* kt, int b, int h, int M, int HD,
                                  const float* qu, float* kp, Put put) {
    constexpr int DW = DH / kAttnWarps;
    constexpr int U = DW < 8 ? DW : 8;  // loads in flight
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, MC = M / 8;
    const tc_bf16* k = kt + ((size_t)b * HD + h * DH + warp * DW) * M;
    for (int c = lane; c < MC; c += 32) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < DW; d0 += U) {
        uint4 kv[U];
#pragma unroll
        for (int d = 0; d < U; ++d)
          kv[d] = *reinterpret_cast<const uint4*>(k + (size_t)(d0 + d) * M + 8 * c);
#pragma unroll
        for (int d = 0; d < U; ++d) {
          const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&kv[d]);
          const float qd = qu[warp * DW + d0 + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(p2[j]);
            acc[2 * j] = fmaf(f.x, qd, acc[2 * j]);
            acc[2 * j + 1] = fmaf(f.y, qd, acc[2 * j + 1]);
          }
        }
      }
      float4* dst = reinterpret_cast<float4*>(kp + (size_t)warp * M + 8 * c);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kAttnWarps; ++w) t += kp[(size_t)w * M + m];
      put(m, t);
    }
  }
  // 16 columns (chunk c) of row b's P.V over ring positions s, s + S, ...;
  // ew[m] = bf16(p[m]). A slot's 16 columns are 32 bytes, two loads, so
  // half as many slots are in flight as for an int8 V (the same bytes).
  template <int DH, int S>
  static __device__ void pv(const tc_bf16* vc, int b, int h, int M, int HD, int ptr, int c,
                            int s, const float* ew, float (&out)[16]) {
    pv_cols<S>(vc + (size_t)b * M * HD + h * DH + 16 * c, HD, M, ptr, s, ew, out);
  }
  // pv over the 16 columns at col of slot 0, a slot's at col + m * stride
  template <int S>
  static __device__ __forceinline__ void pv_cols(const tc_bf16* col, int stride, int M, int ptr,
                                                 int s, const float* ew, float (&out)[16]) {
    constexpr int U = kAttnLoads / 2;
#pragma unroll
    for (int j = 0; j < 16; ++j) out[j] = 0.f;
    for (int i0 = s; i0 < M; i0 += U * S) {
      uint4 q[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint4* p = reinterpret_cast<const uint4*>(
            col + (size_t)ring_slot(min(i0 + u * S, M - 1), ptr, M) * stride);
        q[u][0] = p[0];
        q[u][1] = p[1];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * S < M) {
          const float e = ew[ring_slot(i0 + u * S, ptr, M)];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&q[u][half]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(p2[j]);
              out[8 * half + 2 * j] = fmaf(e, f.x, out[8 * half + 2 * j]);
              out[8 * half + 2 * j + 1] = fmaf(e, f.y, out[8 * half + 2 * j + 1]);
            }
          }
        }
      }
    }
  }
};

// bf16 K (B, H, Dh, M), GroupPanelBF16's (B, HD, M) panel in memory, and
// head-major V (B, H, M, Dh) of fused_stack_decode / fused_batched_decode
// (HeadMajorBF16 of multirow_decode.cu), with the (H, Dh, M + 1) relative
// table, the (HD, M + 1) panel in memory: GroupPanelBF16 with V read
// head-major. A head's slot row is DH contiguous values, so a slot's
// 16-column chunk c is still two 16-byte loads, at ((b HD + h DH) M +
// m DH + 16 c).
struct GroupHeadMajorBF16 : GroupPanelBF16 {
  template <int DH, int S>
  static __device__ void pv(const tc_bf16* vc, int b, int h, int M, int HD, int ptr, int c,
                            int s, const float* ew, float (&out)[16]) {
    pv_cols<S>(vc + ((size_t)b * HD + h * DH) * M + 16 * c, DH, M, ptr, s, ew, out);
  }
};

// The int8 slot-major ring (SlotI8 of slab_common.cuh: K and V (B, M, HD)
// with per-slot scales) and its slot-major (M + 1, HD) relative table:
// GroupI4's table shares, and GroupPanelI8's P.V (the same V layout).
struct GroupSlotI8 : GroupI4 {
  // put(m, (q + u) . K[slot m]) for every slot of row b: a slot a thread (its
  // head's DH bytes in 16-byte loads, summed over d in order, as
  // SlotI8::key_dot), two slots in flight
  template <int DH, typename Put>
  static __device__ void key_dots(const int8_t* kt, int b, int h, int M, int HD, const float* qu,
                                  float*, Put put) {
    const int8_t* base = kt + (size_t)b * M * HD + h * DH;
    constexpr int U = DH <= 64 ? 2 : 1;  // slots in flight
    for (int m0 = threadIdx.x; m0 < M; m0 += U * blockDim.x) {
      int4 k16[U][DH / 16];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int4* kr = reinterpret_cast<const int4*>(
            base + (size_t)min(m0 + u * (int)blockDim.x, M - 1) * HD);
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) k16[u][c] = kr[c];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int m = m0 + u * blockDim.x;
        if (m >= M) break;
        float t = 0.f;
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) {
          float f[16];
          tc_int8x16(k16[u][c], f);
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qu + c * 16 + 4 * j4);
            t = fmaf(f[4 * j4], q4.x, t);
            t = fmaf(f[4 * j4 + 1], q4.y, t);
            t = fmaf(f[4 * j4 + 2], q4.z, t);
            t = fmaf(f[4 * j4 + 3], q4.w, t);
          }
        }
        put(m, t);
      }
    }
  }
  template <int DH, int S>
  static __device__ void pv(const int8_t* vc, int b, int h, int M, int HD, int ptr, int c,
                            int s, const float* ew, float (&out)[16]) {
    GroupPanelI8::pv<DH, S>(vc, b, h, M, HD, ptr, c, s, ew, out);
  }
};

// Row b's slot K scales, V scales and mask (M each, M % 16 == 0) into dst
// (3 M floats, 16-byte aligned) by cp.async, 16 bytes a copy, committed; a
// cache with no scales (!kScaled) stages the mask alone (at dst + 2 M).
template <bool kScaled>
__device__ __forceinline__ void stage_slot_meta(const float* ks, const float* vs,
                                                const int32_t* blocked, int b, int M,
                                                float* dst) {
  constexpr int a0 = kScaled ? 0 : 2;
  for (int i = threadIdx.x; i < (3 - a0) * M / 4; i += blockDim.x) {
    const int a = a0 + i / (M / 4), j = 4 * (i % (M / 4));
    const void* src = a == 0 ? (const void*)(ks + (size_t)b * M + j)
                    : a == 1 ? (const void*)(vs + (size_t)b * M + j)
                             : (const void*)(blocked + (size_t)b * M + j);
    tc_cp16(dst + a * M + j, src);
  }
  tc_commit();
}

// The self term's score, by the first warp: (q + u) . k1 a lane's d strided
// by 32, then the warp's sum; lane 0 writes (t + sd_self) * scale to *out.
template <int DH>
__device__ __forceinline__ void self_score(const float* qu, const float* k1, float sd_self,
                                           float scale, float* out) {
  float t = 0.f;
  for (int d = threadIdx.x; d < DH; d += 32) t = fmaf(qu[d], k1[d], t);
  t = warp_sum(t);
  if (threadIdx.x == 0) *out = (t + sd_self) * scale;
}

// sd[m] of cluster row q: the G blocks' shares (part[q][m] of each, part of
// G rows of M + 1) summed in block order
template <typename Cluster>
__device__ void gather_shares(Cluster& cluster, float* part, int M, int q, float* sd) {
  const float* src[kGroupRows];
#pragma unroll
  for (int o = 0; o < kGroupRows; ++o) src[o] = cluster.map_shared_rank(part, o) + q * (M + 1);
  for (int m = threadIdx.x; m <= M; m += blockDim.x) {
    float v[kGroupRows];
#pragma unroll
    for (int o = 0; o < kGroupRows; ++o) v[o] = src[o][m];
    float t = 0.f;
#pragma unroll
    for (int o = 0; o < kGroupRows; ++o) t += v[o];
    sd[m] = t;
  }
}

// Shared memory of a group_attention block, in floats: the cluster's rows'
// q + v (G x DH), this row's q + u, k1, v1 (DH each), its slots' K scales,
// V scales and mask (M each), sd and the scores (M + 1 each), the block
// reductions' 32, the cluster's relative-score shares; then (16-byte
// aligned, at group_attention_work) one region that holds first the staged
// table (until the shares are formed) and then the work buffer (the K
// panel's per-warp dots, kAttnWarps x M, then the P.V partials,
// kAttnThreads x 16).
template <typename F>
__host__ __device__ inline size_t group_attention_work(int Dh, int M) {  // 16-byte aligned
  return ((size_t)kGroupRows * Dh + 3 * Dh + 3 * M + 2 * (M + 1) + 32 + F::part_floats(M) + 3) /
         4 * 4;
}

template <typename F>
inline size_t group_attention_smem(int Dh, int M) {
  size_t work = (size_t)kAttnThreads * 16 > (size_t)kAttnWarps * M ? (size_t)kAttnThreads * 16
                                                                    : (size_t)kAttnWarps * M;
  work *= sizeof(float);
  const size_t stage = F::stage_bytes(Dh, M);
  return group_attention_work<F>(Dh, M) * sizeof(float) + (work > stage ? work : stage);
}

// Attention of one layer for batch row b = blockIdx.x and head h =
// blockIdx.y over a cache of policy F (GroupI4, GroupSlotI8, GroupPanelI8,
// GroupPanelBF16, GroupHeadMajorBF16). The
// kGroupRows blocks of consecutive rows of a head are one cluster: each
// forms a share of the relative scores (q + v) . wkr of all the cluster's
// rows, so the head's table leaves L2 once per cluster, and each row
// gathers its own from the cluster's shared memory. Rows past B (the last
// cluster's padding) do their share and nothing else. A block sums the KB
// qkv partials (chunk order) of its row's head columns into qkv (B, 3HD)
// f32, for the slot write, and writes attn_b (B, HD) = bf16(attention). The
// scores, softmax and P.V are slab_attention's: score = ((q+u).K[m] * ks[m]
// + roll((q+v).wkr, ptr)[m]) * scale, masked by blocked; the self term from
// the fresh k1; P.V of bf16(p * vs) . V; the softmax sums in ring order. A
// cache with no scales (!F::kScaled: ks, vs null) drops the ks and vs
// factors.
template <int DH, typename F>
__global__ void __launch_bounds__(kAttnThreads, kAttnBlocksPerSM)
group_attention(const float* __restrict__ qkv_part, int KB, int B, int H, int M,
                const tc_bf16* __restrict__ u, const tc_bf16* __restrict__ vb,
                const tc_bf16* __restrict__ wkr, const typename F::KT* __restrict__ kt,
                const float* __restrict__ ks, const typename F::VT* __restrict__ vc,
                const float* __restrict__ vs, const int32_t* __restrict__ blocked, int ptr,
                float scale, float* __restrict__ qkv, tc_bf16* __restrict__ attn_b) {
  constexpr int G = kGroupRows;
  constexpr int CH = DH / 16;           // 16-column chunks of a head
  constexpr int S = kAttnThreads / CH;  // slot groups of the P.V
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float ga_sm[];
  float* qv = ga_sm;               // G x DH: bf16(bf16(q) + v) of the cluster's rows
  float* qu = qv + G * DH;         // DH: bf16(bf16(q) + u) of this row
  float* k1 = qu + DH;             // DH: the fresh k1
  float* v1 = k1 + DH;             // DH: the fresh v1
  float* ksr = v1 + DH;            // M: this row's K scales (F::kScaled)
  float* vsr = ksr + M;            // M: its V scales (F::kScaled)
  int* blk = reinterpret_cast<int*>(vsr + M);  // M: its mask
  float* sd = vsr + 2 * M;         // M + 1: distance-space relative scores
  float* sc = sd + M + 1;          // M + 1: scores, then P.V weights (slot M: e_self)
  float* red = sc + M + 1;         // 32
  float* part = red + 32;          // the cluster's relative-score share
  float* work = ga_sm + group_attention_work<F>(DH, M);  // after the shares are formed
  tc_bf16* wk = reinterpret_cast<tc_bf16*>(work);        // until then
  const int b = blockIdx.x, h = blockIdx.y, q = b % G, b0 = b - q;
  const int HD = H * DH, tid = threadIdx.x;
  const bool live = b < B;
  // the table and this row's slot scales and mask are no output of the
  // chain's previous kernel (the caches' scales of this layer were last
  // written by its slot write in the previous step): their copies start
  // before the grid sync
  F::template stage<DH>(wkr, h, M, q, wk);
  if (live) stage_slot_meta<F::kScaled>(ks, vs, blocked, b, M, ksr);
  tc_grid_sync();
  // q + v of the cluster's rows; q + u, k1, v1 of this one: the KB partials
  // of every item a thread takes summed in chunk order, four chunks' loads
  // of all its items in flight together
  constexpr int NI = ((G + 2) * DH + kAttnThreads - 1) / kAttnThreads;
  const size_t pstride = (size_t)B * 3 * HD;
  float sums[NI];
  const float* srcs[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int i = tid + k * kAttnThreads, r = i / DH, d = i % DH;
    const int row = r < G ? b0 + r : b, part_ = r < G ? 0 : r - G + 1;
    srcs[k] = i < (G + 2) * DH && row < B
                  ? qkv_part + (size_t)row * 3 * HD + (size_t)part_ * HD + h * DH + d
                  : nullptr;
    sums[k] = 0.f;
  }
  for (int kb0 = 0; kb0 < KB; kb0 += 4) {
    float v[NI][4];
#pragma unroll
    for (int k = 0; k < NI; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[k][j] = srcs[k] != nullptr && kb0 + j < KB ? srcs[k][(kb0 + j) * pstride] : 0.f;
#pragma unroll
    for (int k = 0; k < NI; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kb0 + j < KB) sums[k] += v[k][j];
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int i = tid + k * kAttnThreads;
    if (i >= (G + 2) * DH) break;
    const int r = i / DH, d = i % DH;
    const int row = r < G ? b0 + r : b, part_ = r < G ? 0 : r - G + 1;
    const size_t col = (size_t)part_ * HD + h * DH + d;
    const float t = sums[k];
    if (r < G) {
      const float qb = bf16_round(t);
      qv[r * DH + d] = bf16_round(qb + __bfloat162float(vb[h * DH + d]));
      if (row == b) {
        qu[d] = bf16_round(qb + __bfloat162float(u[h * DH + d]));
        if (live) qkv[(size_t)b * 3 * HD + col] = t;
      }
    } else {
      (part_ == 1 ? k1 : v1)[d] = t;
      if (live) qkv[(size_t)b * 3 * HD + col] = t;
    }
  }
  tc_wait<0>();
  __syncthreads();
  F::template rel_part<DH>(wkr, wk, h, M, HD, q, qv, part);
  __syncthreads();  // the staged table (in the work buffer) is read no more
  // the raw dots (q + u) . K[m], while the cluster's other blocks form their
  // shares
  if (live) F::template key_dots<DH>(kt, b, h, M, HD, qu, work, [&](int m, float t) { sc[m] = t; });
  cluster.sync();  // every share is written
  gather_shares(cluster, part, M, q, sd);
  __syncthreads();
  if (live) {
    for (int m = tid; m < M; m += kAttnThreads) {
      const int src = (m - ptr < 0) ? m - ptr + M : m - ptr;  // roll by ptr
      if constexpr (F::kScaled)
        sc[m] = blk[m] ? -1e9f : (sc[m] * ksr[m] + sd[src]) * scale;
      else
        sc[m] = blk[m] ? -1e9f : (sc[m] + sd[src]) * scale;
    }
    if (tid < 32) self_score<DH>(qu, k1, sd[M], scale, sc + M);
    __syncthreads();
    float mx = -INFINITY;
    for (int m = tid; m <= M; m += kAttnThreads) mx = fmaxf(mx, sc[m]);
    mx = block_max(mx, red);
    // in ring order, oldest first (position i is slot (ptr + i) mod M, the
    // self term last), so the order does not depend on ptr; each slot's P.V
    // weight bf16(e * vs) then takes the place of its score
    float den = 0.f;
    for (int i = tid; i <= M; i += kAttnThreads) {
      const int m = i < M ? ring_slot(i, ptr, M) : M;
      const float e = expf(sc[m] - mx);
      if constexpr (F::kScaled)
        sc[m] = m < M ? bf16_round(e * vsr[m]) : e;
      else
        sc[m] = m < M ? bf16_round(e) : e;
      den += e;
    }
    den = block_sum(den, red);  // its barriers also publish sc
    const int c = tid % CH, s = tid / CH;
    float o[16];
    F::template pv<DH, S>(vc, b, h, M, HD, ptr, c, s, sc, o);
    float* mine = work + s * DH + 16 * c;
#pragma unroll
    for (int j = 0; j < 16; ++j) mine[j] = o[j];
    __syncthreads();
    // the S slot groups' sums, in group order: a quarter of them a thread,
    // then the four quarters
    constexpr int Q = kAttnThreads / DH < 4 ? (kAttnThreads / DH > 0 ? kAttnThreads / DH : 1) : 4;
    float* quarter = qv;  // qv is read no more
    if (tid < Q * DH) {
      const int d = tid % DH, qi = tid / DH;
      float t = 0.f;
      for (int g = qi * (S / Q); g < (qi + 1) * (S / Q); ++g) t += work[g * DH + d];
      quarter[qi * DH + d] = t;
    }
    __syncthreads();
    for (int d = tid; d < DH; d += kAttnThreads) {
      float t = 0.f;
#pragma unroll
      for (int qi = 0; qi < Q; ++qi) t += quarter[qi * DH + d];
      attn_b[(size_t)b * HD + h * DH + d] = __float2bfloat16_rn((t + sc[M] * v1[d]) / den);
    }
  }
  cluster.sync();  // no block leaves while the others read its share
}

template <int DH, typename F, typename... Args>
cudaError_t group_attention_dh(int B, int H, int M, cudaStream_t st, Args... args) {
  return tc_launch(group_attention<DH, F>, dim3(ceil_div(B, kGroupRows) * kGroupRows, H), kAttnThreads,
                   group_attention_smem<F>(DH, M), kGroupRows, 1, st, args...);
}

// group_attention<Dh, F> on (kGroupRows ceil(B / kGroupRows), H) blocks,
// clusters of kGroupRows; args as the kernel's
template <typename F>
cudaError_t tc_attention(int Dh, const float* qkv_part, int KB, int B, int H, int M,
                         const tc_bf16* u, const tc_bf16* v, const tc_bf16* wkr,
                         const typename F::KT* kt, const float* ks, const typename F::VT* vc,
                         const float* vs,
                         const int32_t* blocked, int ptr, float scale, float* qkv,
                         tc_bf16* attn_b, cudaStream_t st) {
#define TC_ATTENTION_ARGS \
  qkv_part, KB, B, H, M, u, v, wkr, kt, ks, vc, vs, blocked, ptr, scale, qkv, attn_b
  switch (Dh) {
    case 16: return group_attention_dh<16, F>(B, H, M, st, TC_ATTENTION_ARGS);
    case 32: return group_attention_dh<32, F>(B, H, M, st, TC_ATTENTION_ARGS);
    case 64: return group_attention_dh<64, F>(B, H, M, st, TC_ATTENTION_ARGS);
    case 128: return group_attention_dh<128, F>(B, H, M, st, TC_ATTENTION_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef TC_ATTENTION_ARGS
}

// ---------------------------------------------------------------------------
// Int8-score attention (slab_int8 on the chain)
// ---------------------------------------------------------------------------
//
// score_mode="int8" takes q.K and P.V as int8 x int8 products summed in
// int32 (slab_decode.cu's slab_int8_step states the function): q is
// quantized with one scale per cell of R rows over every head, and the P.V
// weights e * v_scale with one scale per row over every head. No (row,
// head) block can form either scale alone, so the attention is three
// kernels, each a block a (row, head):
//   qkv_sum_i8: sums the qkv partials of its row's head columns (q, k, v)
//     in chunk order into qkv (the LN1 slot write and the next two kernels
//     read it), and writes hmax[b][h] = max |bf16(bf16(q) + u)| over the
//     head;
//   group_scores_i8, clusters of kGroupRows rows of a head as
//     group_attention's: the cell's query scale qs = max(max of hmax over
//     the cell's R rows and H heads, 1e-6) / 127 (a max, so every block of
//     the cell forms the same bits), q_i = int8(qu / qs); the relative
//     scores shared by the cluster (GroupI4::rel_part: the slot-major table
//     leaves L2 once per cluster); q_i . K[m] in int32 by __dp4a from
//     16-byte K loads; the softmax in ring order; writes ev[b][h][m] = e[m]
//     * vs[m] and stats[b][h] = (max_m ev, denominator, e_self);
//   pv_i8: es = max(max over the row's H heads of max ev, 1e-9) / 127, e_i
//     = clip(rint(ev / es), 0, 127) and attn_b = bf16((int32 sum_m e_i[m]
//     V[m] * es + e_self v1) / den), 4 slots x 16 columns a thread by __dp4a.
// The int32 sums are exact, so only the two quantizations can differ from
// the plain version (where a value lies within float32 noise of a
// half-point). No reduction crosses cells: a row's result depends on its
// cell alone.

// tc_decode_step's attention format for slab_int8
struct ScoresI8 {};

constexpr int kSumThreads = 128;  // threads of a qkv_sum_i8 block
constexpr int kScoreThreads = 256;  // threads of a group_scores_i8 block
constexpr int kScoreBlocksPerSM = 6;  // 40 registers a thread
constexpr int kPvThreads = 128;   // threads of a pv_i8 block

// The int8-score attention's scratch after the chain's (TcScratch), in
// float32 units, each run a multiple of 16 bytes: ev (B x H x M), stats
// (B x H x 3), hmax (B x H).
struct TcI8Scratch {
  size_t ev, stats, hmax, total;
  TcI8Scratch(int B, int H, int M) {
    auto r4 = [](size_t n) { return (n + 3) / 4 * 4; };
    ev = 0;
    stats = ev + r4((size_t)B * H * M);
    hmax = stats + r4((size_t)B * H * 3);
    total = hmax + r4((size_t)B * H);
  }
};

// qkv[b] columns of head h = blockIdx.y (q, k and v) for row b = blockIdx.x:
// the KB partials summed in chunk order; hmax[b][h] = the largest |bf16(
// bf16(q) + u)| of the head.
template <int DH>
__global__ void __launch_bounds__(kSumThreads)
qkv_sum_i8(const float* __restrict__ qkv_part, int KB, int B, int H,
           const tc_bf16* __restrict__ u, float* __restrict__ qkv, float* __restrict__ hmax) {
  __shared__ float red[32];
  tc_grid_sync();
  const int b = blockIdx.x, h = blockIdx.y, HD = H * DH;
  const size_t pstride = (size_t)B * 3 * HD;
  float mx = 0.f;
  for (int i = threadIdx.x; i < 3 * DH; i += kSumThreads) {
    const int part = i / DH, d = i % DH;
    const size_t at = (size_t)b * 3 * HD + (size_t)part * HD + h * DH + d;
    const float t = tc_sum_chunks(qkv_part + at, KB, pstride);
    qkv[at] = t;
    if (part == 0)
      mx = fmaxf(mx, fabsf(bf16_round(bf16_round(t) + __bfloat162float(u[h * DH + d]))));
  }
  mx = block_max(mx, red);
  if (threadIdx.x == 0) hmax[(size_t)b * H + h] = mx;
}

// Shared memory of a group_scores_i8 block, in floats: the cluster's rows'
// q + v (G x DH), this row's q + u and k1 (DH each), its slots' K scales, V
// scales and mask (M each), sd and the scores (M + 1 each), the block
// reductions' 32, q_i (DH / 4 words), the cluster's relative-score shares
// (G x (M + 1)).
__host__ __device__ inline size_t scores_i8_floats(int Dh, int M) {
  return (size_t)kGroupRows * Dh + 2 * Dh + 3 * M + 2 * (M + 1) + 32 + Dh / 4 +
         (size_t)kGroupRows * (M + 1);
}

inline size_t scores_i8_smem(int Dh, int M) { return scores_i8_floats(Dh, M) * sizeof(float); }

// Scores and softmax numerators of row b = blockIdx.x, head h = blockIdx.y
// (kGroupRows consecutive rows of a head one cluster, as group_attention's;
// rows past B form their share of the relative scores and nothing else):
// score = (int32 dot(K_int8[m], q_i) * (ks[m] * qs) + roll((q + v) . wkr,
// ptr)[m]) * scale, masked by blocked; the self term from the fresh k1 and
// the float q + u; the denominator in ring order, oldest first. Writes
// ev[b][h][m] = e[m] * vs[m] and stats[b][h] = (max_m ev, den, e_self).
template <int DH>
__global__ void __launch_bounds__(kScoreThreads, kScoreBlocksPerSM)
group_scores_i8(const float* __restrict__ qkv, const float* __restrict__ hmax, int B, int H,
                int M, int R, const tc_bf16* __restrict__ u, const tc_bf16* __restrict__ vb,
                const tc_bf16* __restrict__ wkr, const int8_t* __restrict__ kt,
                const float* __restrict__ ks, const float* __restrict__ vs,
                const int32_t* __restrict__ blocked, int ptr, float scale,
                float* __restrict__ ev, float* __restrict__ stats) {
  constexpr int G = kGroupRows;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float gs_sm[];
  float* qv = gs_sm;               // G x DH: bf16(bf16(q) + v) of the cluster's rows
  float* qu = qv + G * DH;         // DH: bf16(bf16(q) + u) of this row
  float* k1 = qu + DH;             // DH: the fresh k1
  float* ksr = k1 + DH;            // M: this row's K scales
  float* vsr = ksr + M;            // M: its V scales
  int* blk = reinterpret_cast<int*>(vsr + M);  // M: its mask
  float* sd = vsr + 2 * M;         // M + 1: distance-space relative scores
  float* sc = sd + M + 1;          // M + 1: scores, then numerators (slot M: e_self)
  float* red = sc + M + 1;         // 32
  int* qw = reinterpret_cast<int*>(red + 32);  // DH / 4: q_i, four int8 a word
  float* part = red + 32 + DH / 4;             // the cluster's relative-score share
  const int b = blockIdx.x, h = blockIdx.y, q = b % G, b0 = b - q;
  const int HD = H * DH, tid = threadIdx.x;
  const bool live = b < B;
  if (live) stage_slot_meta<true>(ks, vs, blocked, b, M, ksr);  // no output of the previous kernel
  tc_grid_sync();
  for (int i = tid; i < G * DH; i += kScoreThreads) {
    const int r = i / DH, d = i % DH, row = b0 + r;
    float x = 0.f;
    if (row < B) {
      const float qb = bf16_round(qkv[(size_t)row * 3 * HD + h * DH + d]);
      x = bf16_round(qb + __bfloat162float(vb[h * DH + d]));
      if (row == b) qu[d] = bf16_round(qb + __bfloat162float(u[h * DH + d]));
    }
    qv[i] = x;
  }
  if (live)
    for (int d = tid; d < DH; d += kScoreThreads) k1[d] = qkv[(size_t)b * 3 * HD + HD + h * DH + d];
  // the cell's query scale: the largest head maximum of its R rows
  float mx = 0.f;
  if (live) {
    const float* hm = hmax + (size_t)(b - b % R) * H;
    for (int i = tid; i < R * H; i += kScoreThreads) mx = fmaxf(mx, hm[i]);
  }
  const float qs = fmaxf(block_max(mx, red), 1e-6f) * (float)(1.0 / 127.0);  // its barriers publish qu
  if (live)
    for (int w = tid; w < DH / 4; w += kScoreThreads) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        word |= ((uint32_t)(int)quantize(qu[4 * w + k], qs, 127.f) & 0xFFu) << (8 * k);
      qw[w] = (int)word;
    }
  tc_wait<0>();
  __syncthreads();
  GroupI4::rel_part<DH>(wkr, nullptr, h, M, HD, q, qv, part);
  // q_i . K[m] in int32, every slot of this row: a slot row (DH bytes of
  // 16-byte loads, at most 4 in flight: 40 registers) a thread
  if (live) {
    const int8_t* base = kt + (size_t)b * M * HD + h * DH;
    constexpr int NC = DH / 16 < 4 ? DH / 16 : 4;
    for (int m = tid; m < M; m += kScoreThreads) {
      const int4* kr = reinterpret_cast<const int4*>(base + (size_t)m * HD);
      int acc = 0;
#pragma unroll
      for (int c0 = 0; c0 < DH / 16; c0 += NC) {
        int4 k16[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) k16[c] = kr[c0 + c];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int* w = qw + 4 * (c0 + c);
          acc = __dp4a(k16[c].x, w[0], acc);
          acc = __dp4a(k16[c].y, w[1], acc);
          acc = __dp4a(k16[c].z, w[2], acc);
          acc = __dp4a(k16[c].w, w[3], acc);
        }
      }
      sc[m] = (float)acc;  // exact: |acc| <= 127^2 DH < 2^24
    }
  }
  cluster.sync();  // every share is written
  gather_shares(cluster, part, M, q, sd);
  __syncthreads();
  if (live) {
    for (int m = tid; m < M; m += kScoreThreads) {
      const int src = (m - ptr < 0) ? m - ptr + M : m - ptr;  // roll by ptr
      sc[m] = blk[m] ? -1e9f : (sc[m] * (ksr[m] * qs) + sd[src]) * scale;
    }
    if (tid < 32) self_score<DH>(qu, k1, sd[M], scale, sc + M);
    __syncthreads();
    float smax = -INFINITY;
    for (int m = tid; m <= M; m += kScoreThreads) smax = fmaxf(smax, sc[m]);
    smax = block_max(smax, red);
    float den = 0.f;  // in ring order, oldest first, the self term last
    for (int i = tid; i <= M; i += kScoreThreads) {
      const int m = i < M ? ring_slot(i, ptr, M) : M;
      const float e = expf(sc[m] - smax);
      sc[m] = e;
      den += e;
    }
    den = block_sum(den, red);  // its barriers also publish sc
    float* out = ev + ((size_t)b * H + h) * M;
    float emax = 0.f;
    for (int m = tid; m < M; m += kScoreThreads) {
      const float x = sc[m] * vsr[m];
      out[m] = x;
      emax = fmaxf(emax, x);
    }
    emax = block_max(emax, red);
    if (tid == 0) {
      float* st = stats + ((size_t)b * H + h) * 3;
      st[0] = emax;
      st[1] = den;
      st[2] = sc[M];
    }
  }
  cluster.sync();  // no block leaves while the others read its share
}

// word j (0..3) of a 16-byte load
__device__ __forceinline__ unsigned tc_word(const int4& v, int j) {
  return (unsigned)(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
}

// Shared memory of a pv_i8 block: the slot groups' int32 sums (S x DH) and
// the row's quantized weights (M bytes).
inline size_t pv_i8_smem(int Dh, int M) {
  return (size_t)kPvThreads / (Dh / 16) * Dh * sizeof(int) + ((size_t)M + 15) / 16 * 16;
}

// P.V of row b = blockIdx.x, head h = blockIdx.y as an int8 x int8 product:
// es = max(max over the row's H heads of max ev, 1e-9) / 127, e_i =
// clip(rint(ev / es), 0, 127), attn_b = bf16((int32 sum_m e_i[m] V[m] * es +
// e_self v1) / den). A thread owns 16 columns (one 16-byte load of a slot
// row) of a group of 4 slots at a time: the 4 x 16 int8 block is transposed
// by byte permutes so that each column's 4 slots form one word for __dp4a
// with the 4 slots' e_i; the slot groups' int32 sums are added in shared
// memory (exact, in any order).
template <int DH>
__global__ void __launch_bounds__(kPvThreads)
pv_i8(const float* __restrict__ qkv, const float* __restrict__ ev,
      const float* __restrict__ stats, int H, int M, const int8_t* __restrict__ vc,
      tc_bf16* __restrict__ attn_b) {
  constexpr int CH = DH / 16;         // 16-column chunks of a head
  constexpr int S = kPvThreads / CH;  // slot groups
  extern __shared__ __align__(16) int pv_sm[];
  int* sums = pv_sm;                                         // S x DH
  uint8_t* eq = reinterpret_cast<uint8_t*>(pv_sm + S * DH);  // M: e_i
  __shared__ float es_s;
  const int b = blockIdx.x, h = blockIdx.y, HD = H * DH, tid = threadIdx.x;
  tc_grid_sync();
  if (tid < 32) {
    float mx = 0.f;
    for (int g = tid; g < H; g += 32) mx = fmaxf(mx, stats[((size_t)b * H + g) * 3]);
    mx = warp_max(mx);
    if (tid == 0) es_s = fmaxf(mx, 1e-9f) * (float)(1.0 / 127.0);
  }
  __syncthreads();
  const float es = es_s;
  const float* e = ev + ((size_t)b * H + h) * M;
  for (int m = tid; m < M; m += kPvThreads)
    eq[m] = (uint8_t)(int)fminf(fmaxf(rintf(e[m] / es), 0.f), 127.f);
  __syncthreads();
  const int c = tid % CH, s = tid / CH;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  const int8_t* col = vc + (size_t)b * M * HD + h * DH + 16 * c;
  constexpr int U = 2;  // slot groups in flight
  for (int m0 = 4 * s; m0 < M; m0 += U * 4 * S) {
    int4 r[U][4];
#pragma unroll
    for (int uu = 0; uu < U; ++uu)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r[uu][k] = *reinterpret_cast<const int4*>(
            col + (size_t)min(m0 + uu * 4 * S + k, M - 1) * HD);
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const int mq = m0 + uu * 4 * S;
      if (mq < M) {
        const int ew = *reinterpret_cast<const int*>(eq + mq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // word j of each slot row: columns 4 j .. 4 j + 3 of slots mq .. mq + 3
          const unsigned w0 = tc_word(r[uu][0], j), w1 = tc_word(r[uu][1], j);
          const unsigned w2 = tc_word(r[uu][2], j), w3 = tc_word(r[uu][3], j);
          const unsigned lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
          const unsigned hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
          acc[4 * j] = __dp4a((int)__byte_perm(lo01, lo23, 0x5410), ew, acc[4 * j]);
          acc[4 * j + 1] = __dp4a((int)__byte_perm(lo01, lo23, 0x7632), ew, acc[4 * j + 1]);
          acc[4 * j + 2] = __dp4a((int)__byte_perm(hi01, hi23, 0x5410), ew, acc[4 * j + 2]);
          acc[4 * j + 3] = __dp4a((int)__byte_perm(hi01, hi23, 0x7632), ew, acc[4 * j + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) sums[s * DH + 16 * c + j] = acc[j];
  __syncthreads();
  for (int d = tid; d < DH; d += kPvThreads) {
    int t = 0;
    for (int g = 0; g < S; ++g) t += sums[g * DH + d];
    const float* st = stats + ((size_t)b * H + h) * 3;
    const float v1 = qkv[(size_t)b * 3 * HD + 2 * HD + h * DH + d];
    attn_b[(size_t)b * HD + h * DH + d] = __float2bfloat16_rn(((float)t * es + st[2] * v1) / st[1]);
  }
}

// The three kernels of the int8-score attention of one layer; extra holds
// TcI8Scratch(B, H, M).
template <int DH>
cudaError_t tc_attention_i8_dh(const float* qkv_part, int KB, int B, int H, int M, int R,
                               const tc_bf16* u, const tc_bf16* v, const tc_bf16* wkr,
                               const int8_t* kt, const float* ks, const int8_t* vc,
                               const float* vs, const int32_t* blocked, int ptr, float scale,
                               float* qkv, float* extra, tc_bf16* attn_b, cudaStream_t st) {
  const TcI8Scratch at(B, H, M);
  float* ev = extra + at.ev;
  float* stats = extra + at.stats;
  float* hmax = extra + at.hmax;
  cudaError_t err = tc_launch(qkv_sum_i8<DH>, dim3(B, H), kSumThreads, 0, 1, 1, st, qkv_part,
                              KB, B, H, u, qkv, hmax);
  if (err != cudaSuccess) return err;
  err = tc_launch(group_scores_i8<DH>, dim3(ceil_div(B, kGroupRows) * kGroupRows, H),
                  kScoreThreads, scores_i8_smem(DH, M), kGroupRows, 1, st, (const float*)qkv,
                  (const float*)hmax, B, H, M, R, u, v, wkr, kt, ks, vs, blocked, ptr, scale, ev,
                  stats);
  if (err != cudaSuccess) return err;
  return tc_launch(pv_i8<DH>, dim3(B, H), kPvThreads, pv_i8_smem(DH, M), 1, 1, st,
                   (const float*)qkv, (const float*)ev, (const float*)stats, H, M, vc, attn_b);
}

template <typename... Args>
cudaError_t tc_attention_i8(int Dh, Args... args) {
  switch (Dh) {
    case 16: return tc_attention_i8_dh<16>(args...);
    case 32: return tc_attention_i8_dh<32>(args...);
    case 64: return tc_attention_i8_dh<64>(args...);
    case 128: return tc_attention_i8_dh<128>(args...);
    default: return cudaErrorInvalidValue;
  }
}

// Whether the chain takes these widths: B >= min_rows (the step's own rule:
// kTcMinRows, or fewer where its chain was measured faster there), D and Dff
// multiples of 16 (whole 16-byte copies of every operand row), M a multiple
// of 16 (the K panel's 16-slot loads; the int4 ring's M is one of 64), and
// the attention's shared memory within a block's (F: a grouped policy, or
// ScoresI8 for the int8-score attention's two kernels).
template <typename F>
inline bool tc_accepts(int min_rows, int B, int D, int Dff, int Dh, int M) {
  if (!(B >= min_rows && D % 16 == 0 && Dff % 16 == 0 && M % 16 == 0 &&
        (Dh == 16 || Dh == 32 || Dh == 64 || Dh == 128)))
    return false;
  if constexpr (std::is_same<F, ScoresI8>::value)
    return scores_i8_smem(Dh, M) <= kMaxSmem && pv_i8_smem(Dh, M) <= kMaxSmem;
  else
    return group_attention_smem<F>(Dh, M) <= kMaxSmem;
}

// tc_decode_step's scratch, in float32 units, each run a multiple of 16
// bytes: the qkv partials, the summed qkv (B x 3HD), h1 (B x D), the out /
// ff2 partials, then bf16 attn (B x HD), h1 and h (B x D each), ffx (B x Dff).
struct TcScratch {
  size_t qkv_part, qkv, h1, part, attn_b, h1_b, h_b, ffx_b, total;
  TcScratch(int B, int D, int Dff, int HD) {
    auto r4 = [](size_t n) { return (n + 3) / 4 * 4; };
    auto bf = [&](size_t n) { return r4((n + 1) / 2); };
    const size_t kbq = tc_k_blocks(D, 3 * HD), kbo = tc_k_blocks(HD, D);
    const size_t kbf = tc_k_blocks(Dff, D);
    const size_t part_n = (kbo > kbf ? kbo : kbf) * D;
    qkv_part = 0;
    qkv = qkv_part + r4(kbq * B * 3 * HD);
    h1 = qkv + r4((size_t)B * 3 * HD);
    part = h1 + r4((size_t)B * D);
    attn_b = part + r4(part_n * B);
    h1_b = attn_b + bf((size_t)B * HD);
    h_b = h1_b + bf((size_t)B * D);
    ffx_b = h_b + bf((size_t)B * D);
    total = ffx_b + bf((size_t)B * Dff);
  }
};

inline size_t tc_scratch_floats(int B, int D, int Dff, int HD) {
  return TcScratch(B, D, Dff, HD).total;
}

// One token step for all B rows through all L layers on the tensor-core
// chain: decode_step's arguments and the caches (layer l's K / V at kt, vc
// + l * kv_layer, of F's element types; scales at ks, vs + l * B * M where
// F::kScaled, else null; relative table at wkr + l * (M + 1) * HD), read by
// the grouped attention of policy GF (or, GF = ScoresI8, the int8-score
// attention at R rows a cell, its scratch after TcScratch's) and written
// (slot ptr) in the format F. Layer 0 reads h_in as it is (its qkv operand
// is rounded as the fragments are formed); h_out holds h after every layer.
// Returns the first CUDA error.
template <typename WT, typename GF, typename F>
int tc_decode_step(const WT* qkv_w, const WT* out_w, const WT* ff1_w, const WT* ff2_w,
                   const float* w_scales, const tc_bf16* ff1_b, const tc_bf16* ff2_b,
                   const float* ln1_g, const float* ln1_b, const float* ln2_g,
                   const float* ln2_b, const tc_bf16* wkr, const tc_bf16* u, const tc_bf16* v,
                   typename F::KT* kt, float* ks, typename F::VT* vc, float* vs,
                   const float* h_in, const int32_t* blocked, float* h_out, float* scratch,
                   int L, int B, int D, int Dff, int H, int Dh, int M, int smax, int ptr, int R,
                   float scale, int act, size_t kv_layer, cudaStream_t st) {
  const int HD = H * Dh;
  const TcScratch at(B, D, Dff, HD);
  float* qkv_part = scratch + at.qkv_part;
  float* qkv = scratch + at.qkv;
  float* h1 = scratch + at.h1;
  float* part = scratch + at.part;
  tc_bf16* attn_b = reinterpret_cast<tc_bf16*>(scratch + at.attn_b);
  tc_bf16* h1_b = reinterpret_cast<tc_bf16*>(scratch + at.h1_b);
  tc_bf16* h_b = reinterpret_cast<tc_bf16*>(scratch + at.h_b);
  tc_bf16* ffx_b = reinterpret_cast<tc_bf16*>(scratch + at.ffx_b);
  const int kbq = tc_k_blocks(D, 3 * HD), kbo = tc_k_blocks(HD, D), kbf = tc_k_blocks(Dff, D);
  const size_t ln_smem = (size_t)D * sizeof(float);
  cudaError_t err;
  for (int l = 0; l < L; ++l) {
    auto sc = [&](int row) -> const float* {
      return w_scales != nullptr ? w_scales + ((size_t)l * 8 + row) * smax : nullptr;
    };
    typename F::KT* kl = kt + l * kv_layer;
    typename F::VT* vl = vc + l * kv_layer;
    float* ksl = F::kScaled ? ks + (size_t)l * B * M : nullptr;
    float* vsl = F::kScaled ? vs + (size_t)l * B * M : nullptr;
    const tc_bf16* wl = wkr + (size_t)l * (M + 1) * HD;
    const float* resid = l == 0 ? h_in : h_out;
    err = l == 0 ? tc_gemm<WT, float, kTcPartials>(h_in, B, D, 3 * HD, qkv_w, sc(0), qkv_part,
                                                   nullptr, kNone, nullptr, st)
                 : tc_gemm<WT, tc_bf16, kTcPartials>(h_b, B, D, 3 * HD,
                                                     qkv_w + (size_t)l * D * 3 * HD, sc(0),
                                                     qkv_part, nullptr, kNone, nullptr, st);
    if (err != cudaSuccess) return err;
    // attention over the old cache + self; it also sums the qkv partials into qkv
    if constexpr (std::is_same<GF, ScoresI8>::value)
      err = tc_attention_i8(Dh, (const float*)qkv_part, kbq, B, H, M, R, u, v, wl,
                            (const int8_t*)kl, (const float*)ksl, (const int8_t*)vl,
                            (const float*)vsl, blocked, ptr, scale, qkv, scratch + at.total,
                            attn_b, st);
    else
      err = tc_attention<GF>(Dh, qkv_part, kbq, B, H, M, u, v, wl, kl, ksl, vl, vsl, blocked,
                             ptr, scale, qkv, attn_b, st);
    if (err != cudaSuccess) return err;
    if ((err = tc_gemm<WT, tc_bf16, kTcPartials>(attn_b, B, HD, D, out_w + (size_t)l * HD * D,
                                                 sc(1), part, nullptr, kNone, nullptr, st)))
      return err;
    // LN1, then the fresh slot: after every head's attention read the old one
    if ((err = tc_launch(tc_layer_norm<F>, dim3(B), kLnThreads, ln_smem, 1, 1, st, resid,
                         (const float*)part, kbo, B, D, (const tc_bf16*)nullptr,
                         ln1_g + (size_t)l * D, ln1_b + (size_t)l * D, h1, h1_b,
                         (const float*)qkv, HD, M, ptr, kl, ksl, vl, vsl)))
      return err;
    if ((err = tc_gemm<WT, tc_bf16, kTcBiasAct>(h1_b, B, D, Dff, ff1_w + (size_t)l * D * Dff,
                                                sc(2), nullptr, ff1_b + (size_t)l * Dff, act,
                                                ffx_b, st)))
      return err;
    if ((err = tc_gemm<WT, tc_bf16, kTcPartials>(ffx_b, B, Dff, D, ff2_w + (size_t)l * Dff * D,
                                                 sc(3), part, nullptr, kNone, nullptr, st)))
      return err;
    if ((err = tc_launch(tc_layer_norm<NoSlot>, dim3(B), kLnThreads, ln_smem, 1, 1, st,
                         (const float*)h1, (const float*)part, kbf, B, D, ff2_b + (size_t)l * D,
                         ln2_g + (size_t)l * D, ln2_b + (size_t)l * D, h_out, h_b,
                         (const float*)nullptr, HD, M, ptr, (int8_t*)nullptr, (float*)nullptr,
                         (int8_t*)nullptr, (float*)nullptr)))
      return err;
  }
  return cudaSuccess;
}

}  // namespace
