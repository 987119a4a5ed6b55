// One decode token step through the whole Transformer-XL layer stack over a
// slot-major KV ring, in the seven modes of fused_slab_core and
// fused_slab_allrows_core; first, int8 weights and an int8 ring ("slab_w8").
//
// Replaces the TPU kernel deepmusicgeneration_tpu/ops/fused_decode.py::
// fused_slab_core (pallas_call built by _make_slab_kernel) in the mode
// score_mode="bf16", weights_int8=True, and computes the same function:
//
//   per layer l, per batch row b
//     qkv   = bf16(h) . bf16(W_qkv_int8 * col_scale)           (f32 accumulate)
//     score = ((q+u) . K_int8[slot] * k_scale[slot] + roll((q+v) . wkr, ptr)[slot])
//             * scale, slots masked by `blocked`; self term from the fresh
//             unquantized k1 at distance 0; softmax over M + 1 keys
//     attn  = (sum_slot bf16(p * v_scale) . V_int8 + p_self * v1) / denom
//     the fresh k1/v1 rows are quantized (scale = max(|x|, 1e-6) / 127,
//     round half to even, clip +-127) and written into slot `ptr` only,
//     after the layer's attention has read the old slot
//     h1 = LN(h + bf16(attn) . W_out);  h = LN(h1 + W_ff2 . gelu_tanh(W_ff1 . h1 + b1) + b2)
//
// The Pallas kernel walks a sequential (layer, row-group) grid and carries h
// in VMEM across layers. Hopper blocks cannot carry state across a grid, so
// each layer is a short chain of kernels on one stream; the hidden state
// stays in device memory between them (it is a few KB).
//
// Bound. At batch 1 on the 41M flagship (8 layers, d 512, d_inner 3072,
// 12 x 64 heads, mem_len 512) one step must read ~51 MB: 37.7 MB of int8
// weights, 6.3 MB of bf16 wkr and 6.3 MB of int8 K/V; at 3.35 TB/s that is
// ~15 us. The arithmetic (~2 FLOP per weight byte) is far below the card's
// ridge, so the step is bound by bytes. Design for that bound: weights stay
// int8 in memory and are dequantized in registers; the GEMV splits the
// reduction dimension over blocks (partials summed in a fixed order, so the
// result is deterministic) to have enough loads in flight; attention reads
// each wkr and K/V slot row once, a whole row per thread in 16-byte loads.
// This version is simple, not tuned: it launches 10 kernels per layer.
//
// The same file holds the all-rows step ("slab_ar_w8"), which replaces
// fused_decode.py::fused_slab_allrows_core (pallas_call built by
// _make_slab_allrows_kernel) with weights_int8=True. It computes the same
// function; what defines that TPU kernel is that each layer's weights are read
// once for all B rows. Here the four weight products go through
// gemm_partial, a skinny GEMM: one block owns a
// (128 K rows x 64 columns) weight slice, holds it dequantized in shared
// memory, and applies up to 64 batch rows to it, so the weights leave device
// memory once per step for B <= 64 (the row-tiled GEMV above reads them
// B / 8 times). The GEMM's larger blocks (a 64 KB slice in shared memory)
// cost more per launch than the GEMV's, so at small B the GEMV step is the
// faster one; chip_smoke.py times both steps across B and PERF.md records
// where each wins. Attention, the fresh-slot write and the
// residual + LayerNorm kernels are shared with slab_w8. At B = 64, M = 512 on
// the flagship one step must read ~449 MB (37.7 MB int8 weights, 6.3 MB wkr,
// 402.7 MB int8 K/V, ~2.1 MB scales): ~134 us at 3.35 TB/s, bound by bytes.
//
// The bf16-weight modes ("slab" and "slab_ar", the same two TPU kernels with
// weights_int8=False) run the same chain with the weight products reading
// bf16 panels as they are, with no column scale: the TPU kernel's else branch
// feeds the bf16 panels to the MXU directly. The weight products are templates
// on the panel type (Panel<int8_t> dequantizes and rounds to bf16,
// Panel<__nv_bfloat16> reads the value), so attention, the slot write and
// LayerNorm stay shared. At B = 16 on the flagship a bf16 step must read
// 75.5 MB of weights (twice the int8 panels' 37.7 MB) besides wkr and K/V.
//
// The int8-score mode ("slab_int8", fused_slab_core with score_mode="int8",
// bf16 weights) takes q.K and P.V as int8 x int8 products summed in int32,
// as the TPU kernel feeds its MXU: q (bf16(q) + u) is quantized with one
// scale per cell of rows_per_cell rows (max |q| over the cell's rows and
// heads / 127), and the probabilities times the V scales with one scale per
// row over all its heads (max / 127, clipped to [0, 127]). A row's scale
// needs every head's probabilities, so the attention is split: a per-cell
// query quantization, a scores kernel per (row, head) that writes
// e * v_scale and its maximum, and a P.V kernel per (row, head). Both
// products use __dp4a (four int8 pairs into an int32 per instruction); the
// integer sums are exact, so only the two quantizations can differ from the
// plain version, where a value lies within float32 noise of a half-point.
// 12 kernels a layer. Bound at B = 64, M = 512 on the flagship: the int8
// K/V (402.7 MB) and the bf16 weights (75.5 MB), ~0.15 ms at 3.35 TB/s.
// With int8 weight panels ("slab_int8_w8", weights_int8=True) the same
// attention runs in the chain of slab_w8: the TPU kernel upcasts the panels
// to bf16 by their column scales whatever the score mode.
//
// The int4 modes ("slab4", "slab4_w8", kv_int4=True with bf16 or int8
// panels) keep K and V two slots a byte (SlotI4 in slab_common.cuh): packed
// row m holds slot m in its high nibble and slot m + M/2 in its low one. The
// attention unpacks the nibbles in registers; the fresh slot is quantized to
// +-7 and written as a read-modify-write of its own nibble, in the slot
// write kernel that follows the layer's attention on the same stream: the
// byte's other nibble is the row's slot ptr +- M/2, which every head's
// attention block of that row reads in the same step. At B = 64, M = 512
// the int4 K/V are 201.3 MB a step.
//
// At B >= 8, slab4_w8, slab4, slab_int8, slab, slab_ar and slab_ar_w8 run
// the tensor-core chain of tc_decode.cuh (slab4_w8_tc_step, slab4_tc_step,
// slab_int8_tc_step, slab_tc_step for slab and slab_ar, slab_w8_tc_step for
// slab_ar_w8), and slab_w8 from kSlabW8TcMinRows rows: the
// weight products on the tensor cores, each weight tile read once a step for
// up to 64 rows, and an attention that reads a head's relative table once
// per cluster of rows: GroupI4's for the int4 ring and GroupSlotI8's for the
// int8 ring of slab and the all-rows steps (a slot's head slice a thread in
// 16-byte loads; 7 kernels a layer), and for slab_int8 the int8-score
// attention of tc_decode.cuh (its query scale reduced from per-(row, head)
// maxima over the cell, its P.V scale from the row's per-head maxima; 9
// kernels a layer). Since the chain reads each weight tile once for all rows
// in every mode, the all-rows steps are the chain of slab (bf16 panels) and
// of slab over int8 panels, and that chain over int8 panels is slab_w8's too.
// Below a step's minimum B, and at sizes tc_accepts refuses, the steps keep
// the chain above (<mode>_step). slab is the continuous service's step:
// a request that joins a busy batch decodes as it does alone at the same B,
// because no sum of the chain crosses rows or takes its order from B.
//
// Order contract of every step: attention reads the OLD slot `ptr` of every
// row (on a full ring that slot holds the oldest token, at distance exactly
// M, which is visible), and the fresh-slot write is a separate kernel
// launched after it on the same stream. The TPU all-rows kernel overlaps its
// slot-write DMA with later row groups' reads of that slot; that race is not
// carried over.

#include "slab_common.cuh"
#include "tc_decode.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// int8 scores (slab_int8)
// ---------------------------------------------------------------------------

// q_i[b] = int8(bf16(bf16(q[b]) + u) / qs) and qs[b] for the rows of one
// cell, one block per cell of R rows: qs = max(max |qu| over the cell, 1e-6)
// / 127, as the TPU kernel quantizes its (R*H, HD) head-masked query block.
__global__ void __launch_bounds__(kThreads)
quantize_queries(const float* __restrict__ qkv, int HD, int R, const bf16* __restrict__ u,
                 int8_t* __restrict__ q_i, float* __restrict__ qs) {
  __shared__ float red[32];
  const int b0 = blockIdx.x * R;
  auto qu_at = [&](int i) {
    const int b = b0 + i / HD, d = i % HD;
    const float qb = bf16_round(qkv[(size_t)b * 3 * HD + d]);
    return bf16_round(qb + __bfloat162float(u[d]));
  };
  float mx = 0.f;
  for (int i = threadIdx.x; i < R * HD; i += blockDim.x) mx = fmaxf(mx, fabsf(qu_at(i)));
  mx = block_max(mx, red);
  const float s = fmaxf(mx, 1e-6f) * (float)(1.0 / 127.0);
  for (int i = threadIdx.x; i < R * HD; i += blockDim.x)
    q_i[(size_t)b0 * HD + i] = (int8_t)quantize(qu_at(i), s, 127.f);
  for (int r = threadIdx.x; r < R; r += blockDim.x) qs[b0 + r] = s;
}

// Scores and softmax numerators of one (row b, head h), as slab_attention
// computes them but with q.K as an int8 x int8 product: score =
// (int32 dot(K_int8[slot], q_i) * (k_scale[slot] * qs[b]) + rolled
// (q + v) . wkr) * scale. Writes ev[b][h][m] = e[m] * v_scale[m] and
// stats[b][h] = (max_m ev, the softmax denominator with the self term, the
// self term's e).
template <int DH>
__global__ void __launch_bounds__(kThreads)
slab_scores_i8(const float* __restrict__ qkv, int H, int M, const bf16* __restrict__ u,
               const bf16* __restrict__ vb, const bf16* __restrict__ wkr,
               const int8_t* __restrict__ kt, const float* __restrict__ ks,
               const float* __restrict__ vs, const int32_t* __restrict__ blocked,
               const int8_t* __restrict__ q_i, const float* __restrict__ qs, int ptr,
               float scale, float* __restrict__ ev, float* __restrict__ stats) {
  extern __shared__ float sm[];
  float* qu = sm;            // DH: bf16(bf16(q) + u), for the self term
  float* qv = qu + DH;       // DH: bf16(bf16(q) + v)
  float* sd = qv + DH;       // M + 1 distance-space relative scores
  float* sc = sd + M + 1;    // M + 1 scores, then numerators (slot M = self)
  __shared__ int qw[DH / 4];  // q_i of this head, four int8 a word
  __shared__ float red[32];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int HD = H * DH;
  const float* q = qkv + (size_t)b * 3 * HD + h * DH;
  const float* k1 = q + HD;
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    const float qb = bf16_round(q[d]);
    qu[d] = bf16_round(qb + __bfloat162float(u[h * DH + d]));
    qv[d] = bf16_round(qb + __bfloat162float(vb[h * DH + d]));
  }
  for (int w = threadIdx.x; w < DH / 4; w += blockDim.x)
    qw[w] = reinterpret_cast<const int*>(q_i + (size_t)b * HD + h * DH)[w];
  __syncthreads();
  for (int m = threadIdx.x; m <= M; m += blockDim.x) sd[m] = wkr_row_dot<DH>(wkr, m, h, HD, qv);
  __syncthreads();
  const float qsb = qs[b];
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int4* kr = reinterpret_cast<const int4*>(kt + ((size_t)b * M + m) * HD + h * DH);
    int acc = 0;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const int4 k = kr[c];
      acc = __dp4a(k.x, qw[4 * c], acc);
      acc = __dp4a(k.y, qw[4 * c + 1], acc);
      acc = __dp4a(k.z, qw[4 * c + 2], acc);
      acc = __dp4a(k.w, qw[4 * c + 3], acc);
    }
    const float t = (float)acc * (ks[(size_t)b * M + m] * qsb);
    const int src = (m - ptr < 0) ? m - ptr + M : m - ptr;  // roll by ptr
    const float s = (t + sd[src]) * scale;
    sc[m] = blocked[(size_t)b * M + m] ? -1e9f : s;
  }
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int d = 0; d < DH; ++d) t = fmaf(qu[d], k1[d], t);
    sc[M] = (t + sd[M]) * scale;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int m = threadIdx.x; m <= M; m += blockDim.x) mx = fmaxf(mx, sc[m]);
  mx = block_max(mx, red);
  float den = 0.f;   // in ring order, oldest first, as slab_attention
  for (int i = threadIdx.x; i <= M; i += blockDim.x) {
    const int m = i < M - ptr ? i + ptr : (i < M ? i + ptr - M : M);
    const float e = expf(sc[m] - mx);
    sc[m] = e;
    den += e;
  }
  den = block_sum(den, red);  // its barriers also publish sc
  float* out = ev + ((size_t)b * H + h) * M;
  float emax = 0.f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float x = sc[m] * vs[(size_t)b * M + m];
    out[m] = x;
    emax = fmaxf(emax, x);
  }
  emax = block_max(emax, red);
  if (threadIdx.x == 0) {
    float* st = stats + ((size_t)b * H + h) * 3;
    st[0] = emax;
    st[1] = den;
    st[2] = sc[M];
  }
}

// P.V of one (row b, head h) as an int8 x int8 product: es = max(max over
// the row's heads of ev, 1e-9) / 127, e_i = clip(round(ev / es), 0, 127),
// attn = (int32 sum_m e_i[m] V_int8[m] * es + e_self v1) / denominator.
// Each thread owns 4 columns of one slot group and takes 4 slots at a time:
// the 4 x 4 int8 block of V is transposed with byte permutes so that each
// column's 4 slots form one word for __dp4a with the 4 slots' e_i.
template <int DH>
__global__ void __launch_bounds__(kThreads)
slab_pv_i8(const float* __restrict__ qkv, int H, int M, const int8_t* __restrict__ vc,
           const float* __restrict__ ev, const float* __restrict__ stats,
           float* __restrict__ attn) {
  constexpr int kColGroups = DH / 4;
  constexpr int kSlotGroups = kThreads / kColGroups;
  __shared__ int pv[kSlotGroups * DH];
  __shared__ float es_shared;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int HD = H * DH;
  if (threadIdx.x == 0) {
    float mx = 0.f;
    for (int g = 0; g < H; ++g) mx = fmaxf(mx, stats[((size_t)b * H + g) * 3]);
    es_shared = fmaxf(mx, 1e-9f) * (float)(1.0 / 127.0);
  }
  __syncthreads();
  const float es = es_shared;
  const float* e = ev + ((size_t)b * H + h) * M;
  const int c = threadIdx.x % kColGroups, grp = threadIdx.x / kColGroups;
  const int8_t* vcol = vc + (size_t)b * M * HD + h * DH + 4 * c;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int m0 = 4 * grp; m0 < M; m0 += 4 * kSlotGroups) {
    int ew = 0, w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int m = m0 + k;
      w[k] = 0;
      if (m < M) {
        ew |= (int)fminf(fmaxf(rintf(e[m] / es), 0.f), 127.f) << (8 * k);
        w[k] = *reinterpret_cast<const int*>(vcol + (size_t)m * HD);
      }
    }
    // w[k] holds slot m0 + k at columns 0..3; gather each column's 4 slots
    const unsigned lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
    const unsigned hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
    a0 = __dp4a((int)__byte_perm(lo01, lo23, 0x5410), ew, a0);
    a1 = __dp4a((int)__byte_perm(lo01, lo23, 0x7632), ew, a1);
    a2 = __dp4a((int)__byte_perm(hi01, hi23, 0x5410), ew, a2);
    a3 = __dp4a((int)__byte_perm(hi01, hi23, 0x7632), ew, a3);
  }
  int* mine = pv + grp * DH + 4 * c;
  mine[0] = a0;
  mine[1] = a1;
  mine[2] = a2;
  mine[3] = a3;
  __syncthreads();
  if (threadIdx.x < DH) {
    int t = 0;
    for (int g = 0; g < kSlotGroups; ++g) t += pv[g * DH + threadIdx.x];
    const float* st = stats + ((size_t)b * H + h) * 3;
    const float* v1 = qkv + (size_t)b * 3 * HD + 2 * HD + h * DH;
    attn[(size_t)b * HD + h * DH + threadIdx.x] = ((float)t * es + st[2] * v1[threadIdx.x]) / st[1];
  }
}

inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// Float32 scratch the int8-score attention needs beyond decode_step's: ev
// (B x H x M), stats (B x H x 3), qs (B) and q_i (B x HD int8).
inline size_t int8_scratch_floats(int B, int H, int Dh, int M) {
  return round4((size_t)B * H * M) + round4((size_t)B * H * 3) + round4(B) +
         round4(((size_t)B * H * Dh + 3) / 4);
}

template <int DH>
cudaError_t int8_attention_dh(const float* qkv, int B, int H, int M, int R, const bf16* u,
                              const bf16* v, const bf16* wkr, const int8_t* kt,
                              const float* ks, const int8_t* vc, const float* vs,
                              const int32_t* blocked, int ptr, float scale, float* extra,
                              float* attn, cudaStream_t st) {
  const int HD = H * DH;
  float* ev = extra;
  float* stats = ev + round4((size_t)B * H * M);
  float* qs = stats + round4((size_t)B * H * 3);
  int8_t* q_i = reinterpret_cast<int8_t*>(qs + round4(B));
  quantize_queries<<<B / R, kThreads, 0, st>>>(qkv, HD, R, u, q_i, qs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(2 * DH + 2 * (M + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(slab_scores_i8<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  slab_scores_i8<DH><<<B * H, kThreads, smem, st>>>(qkv, H, M, u, v, wkr, kt, ks, vs, blocked,
                                                   q_i, qs, ptr, scale, ev, stats);
  if ((err = cudaGetLastError())) return err;
  slab_pv_i8<DH><<<B * H, kThreads, 0, st>>>(qkv, H, M, vc, ev, stats, attn);
  return cudaGetLastError();
}

template <typename... Args>
cudaError_t int8_attention(int Dh, Args... args) {
  switch (Dh) {
    case 16: return int8_attention_dh<16>(args...);
    case 32: return int8_attention_dh<32>(args...);
    case 64: return int8_attention_dh<64>(args...);
    case 128: return int8_attention_dh<128>(args...);
    default: return cudaErrorInvalidValue;
  }
}

// One token step of the slab kernels: decode_step with the attention over a
// slot-major cache of format F (SlotI8 or SlotI4), bf16 scores, or with
// int8_scores the int8 x int8 attention over a SlotI8 cache.
template <typename F, typename WT>
int run_slab(bool allrows, bool int8_scores, DECODE_STEP_ARGS(WT, int8_t)) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * Dh;
  float* extra = scratch + step_scratch_floats(B, D, Dff, HD);
  const size_t smem = attention_smem(Dh, M);
  const size_t kv_layer = F::layer_elems(B, M, HD);
  auto attend = [=](int l, const float* qkv, float* attn) -> cudaError_t {
    int8_t* kl = kt + l * kv_layer;
    int8_t* vl = vc + l * kv_layer;
    float* ksl = ks + (size_t)l * B * M;
    float* vsl = vs + (size_t)l * B * M;
    const bf16* wl = wkr + (size_t)l * (M + 1) * HD;
    cudaError_t err =
        int8_scores
            ? int8_attention(Dh, qkv, B, H, M, rows_per_cell, u, v, wl, kl, ksl, vl, vsl,
                             blocked, ptr, scale, extra, attn, st)
            : attention<F>(Dh, B * H, smem, st, qkv, H, M, u, v, wl, kl, ksl, vl, vsl, blocked,
                           ptr, scale, attn);
    if (err != cudaSuccess) return err;
    kv_slot_write<F><<<B, kThreads, 0, st>>>(qkv, HD, M, ptr, kl, ksl, vl, vsl);
    return cudaGetLastError();
  };
  return decode_step<WT>(allrows, qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g,
                         ln1_b, ln2_g, ln2_b, h_in, h_out, scratch, L, B, D, Dff, HD, smax,
                         act, st, attend);
}

// Blocks a card holds at once of one launch of `kernel` with `threads`
// threads, `smem` bytes and clusters of `cluster` blocks (for the wave
// count: grid blocks over this).
template <typename... KArgs>
cudaError_t resident_blocks(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                            int cluster, int* out) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    *out = clusters * cluster;
    return err;
  }
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return err;
}

template <int DH, typename F>
int group_occupancy(dim3 grouped, int M, int* out) {
  out[0] = grouped.x * grouped.y;
  const cudaError_t err = resident_blocks(group_attention<DH, F>, grouped, kAttnThreads,
                                          group_attention_smem<F>(DH, M), kGroupRows, out + 1);
  return err != cudaSuccess ? -(int)err : 1;
}

// kind 0: group_attention<GroupI4>; 1: the int8-score attention's three
// kernels; 2: group_attention<GroupSlotI8> (slab, slab_ar, slab_ar_w8,
// slab_w8)
template <int DH>
int attention_occupancy_dh(int B, int H, int M, int kind, int* out) {
  const dim3 grouped(ceil_div(B, kGroupRows) * kGroupRows, H), rows(B, H);
  cudaError_t err;
  if (kind == 0) return group_occupancy<DH, GroupI4>(grouped, M, out);
  if (kind == 2) return group_occupancy<DH, GroupSlotI8>(grouped, M, out);
  out[0] = out[4] = B * H;
  out[2] = grouped.x * grouped.y;
  err = resident_blocks(qkv_sum_i8<DH>, rows, kSumThreads, 0, 1, out + 1);
  if (err == cudaSuccess)
    err = resident_blocks(group_scores_i8<DH>, grouped, kScoreThreads, scores_i8_smem(DH, M),
                          kGroupRows, out + 3);
  if (err == cudaSuccess)
    err = resident_blocks(pv_i8<DH>, rows, kPvThreads, pv_i8_smem(DH, M), 1, out + 5);
  return err != cudaSuccess ? -(int)err : 3;
}

// The chain over the slot-major int8 ring (GroupSlotI8, slot write SlotI8)
// with weight panels of WT, at B >= min_rows: slab_tc_step and
// slab_w8_tc_step. rows_per_cell does not enter its attention (bf16 scores),
// as it does not change the plain version's all-rows result.
template <typename WT>
int slot_i8_tc_step(int min_rows, DECODE_STEP_ARGS(WT, int8_t)) {
  if (!tc_accepts<GroupSlotI8>(min_rows, B, D, Dff, Dh, M)) return cudaErrorInvalidValue;
  return tc_decode_step<WT, GroupSlotI8, SlotI8>(
      qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v,
      kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, smax, ptr,
      rows_per_cell, scale, act, SlotI8::layer_elems(B, M, H * Dh), (cudaStream_t)stream);
}

// slab_w8's chain serves every B: at B = 1, 2 and 4 it took 0.54-0.78x the
// old chain's step in turns (flagship, M = 512, H100 80GB HBM3 at 700 W).
// slab_ar_w8, which binds the same entry, keeps kTcMinRows by its own rule
// (ops/fused_decode.py::TC_POLICY).
constexpr int kSlabW8TcMinRows = 1;

}  // namespace

extern "C" {

// Float32 scratch elements a step of any mode needs for these sizes. flags
// bit 0: the int8-score modes' extra buffers; bit 1: the tensor-core chain's
// scratch (the <mode>_tc_step functions; with bit 0, slab_int8_tc_step's).
size_t slab_decode_scratch_floats(int B, int D, int Dff, int H, int Dh, int M, int flags) {
  if (flags & 2)
    return tc_scratch_floats(B, D, Dff, H * Dh) + ((flags & 1) ? TcI8Scratch(B, H, M).total : 0);
  return step_scratch_floats(B, D, Dff, H * Dh) +
         ((flags & 1) ? int8_scratch_floats(B, H, Dh, M) : 0);
}

// Kernel launches a step makes per call (for the launch accounting): the
// chain of decode_step, or with tc the tensor-core chain.
int slab_decode_kernels_per_step(int L, int int8_scores, int tc) {
  if (tc) return L * (int8_scores ? kTcI8KernelsPerLayer : kTcKernelsPerLayer);
  return L * (kChainKernelsPerLayer + (int8_scores ? 4 : 2));
}

const char* slab_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The tensor-core chain's attention kernels at these sizes, kind 0: of
// slab4 / slab4_w8 (group_attention<GroupI4>), 1: of slab_int8 (qkv_sum_i8,
// group_scores_i8, pv_i8), 2: of slab, slab_ar, slab_ar_w8 and slab_w8
// (group_attention<GroupSlotI8>):
// out[2 k] = blocks of kernel k's launch, out[2 k + 1] = blocks the card
// holds at once (the occupancy API, clusters counted whole). Returns the
// number of kernels, or -(CUDA error).
int slab_decode_attention_occupancy(int B, int H, int Dh, int M, int kind, int* out) {
  switch (Dh) {
    case 16: return attention_occupancy_dh<16>(B, H, M, kind, out);
    case 32: return attention_occupancy_dh<32>(B, H, M, kind, out);
    case 64: return attention_occupancy_dh<64>(B, H, M, kind, out);
    case 128: return attention_occupancy_dh<128>(B, H, M, kind, out);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// One token step for all B rows through all L layers (DECODE_STEP_ARGS in
// slab_common.cuh): qkv_w (L,D,3HD) out_w (L,HD,D) ff1_w (L,D,Dff) ff2_w
// (L,Dff,D), int8 for the _w8 steps and bf16 otherwise; w_scales (L,8,smax)
// f32 (rows 0..3: qkv, out, ff1, ff2 column scales), null for bf16 panels;
// ff1_b (L,Dff) ff2_b (L,D) bf16; ln1_g/ln1_b/ln2_g/ln2_b (L,D) f32;
// wkr (L,M+1,HD) bf16; u, v (HD) bf16; kt, vc (L,B,M,HD) int8 ((L,B,M/2,HD)
// nibble pairs for slab4 / slab4_w8) and ks, vs (L,B,M) f32, updated in slot
// ptr only; h_in (B,D) f32; blocked (B,M) int32; h_out (B,D) f32; scratch of
// slab_decode_scratch_floats(...) floats; rows_per_cell divides B (read by
// slab_int8 only). Returns the first CUDA error (0 = cudaSuccess). Does not
// synchronize.
#define PASS_BF16_WEIGHTS                                                                  \
  qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v, \
      kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, 0, ptr,        \
      rows_per_cell, scale, act, stream
#define PASS_INT8_WEIGHTS                                                                  \
  qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, u,  \
      v, kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, smax, ptr, \
      rows_per_cell, scale, act, stream

int slab_w8_step(DECODE_STEP_ARGS(int8_t, int8_t)) {
  return run_slab<SlotI8, int8_t>(false, false, PASS_INT8_WEIGHTS);
}

// The all-rows step: the weight products through gemm_partial.
int slab_ar_w8_step(DECODE_STEP_ARGS(int8_t, int8_t)) {
  return run_slab<SlotI8, int8_t>(true, false, PASS_INT8_WEIGHTS);
}

// The bf16-weight steps ("slab", "slab_ar"): bf16 panels, w_scales ignored.
int slab_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  return run_slab<SlotI8, bf16>(false, false, PASS_BF16_WEIGHTS);
}

int slab_ar_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  return run_slab<SlotI8, bf16>(true, false, PASS_BF16_WEIGHTS);
}

// score_mode="int8" with bf16 panels ("slab_int8") and int8 panels
// ("slab_int8_w8": weights_int8=True, which no engine mode selects).
int slab_int8_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  return run_slab<SlotI8, bf16>(false, true, PASS_BF16_WEIGHTS);
}

int slab_int8_w8_step(DECODE_STEP_ARGS(int8_t, int8_t)) {
  return run_slab<SlotI8, int8_t>(false, true, PASS_INT8_WEIGHTS);
}

// kv_int4 with bf16 panels ("slab4") and int8 panels ("slab4_w8").
int slab4_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  return run_slab<SlotI4, bf16>(false, false, PASS_BF16_WEIGHTS);
}

int slab4_w8_step(DECODE_STEP_ARGS(int8_t, int8_t)) {
  return run_slab<SlotI4, int8_t>(false, false, PASS_INT8_WEIGHTS);
}

// The tensor-core chain (tc_decode.cuh), one entry an instantiation, each
// bound by the modes that ops/fused_decode.py::TC_POLICY names with it:
// slab4_w8, slab4 and slab_int8 for B >= 8; slab and slab_ar (slab_tc_step)
// for B >= 8; slab_w8 and slab_ar_w8 (slab_w8_tc_step) for B >=
// kSlabW8TcMinRows. The same arguments; scratch of
// slab_decode_scratch_floats(..., flags = 2; slab_int8: 3) floats. Each
// returns cudaErrorInvalidValue for sizes tc_accepts refuses (slab_int8 also
// where rows_per_cell does not divide B).
int slab4_w8_tc_step(DECODE_STEP_ARGS(int8_t, int8_t)) {
  if (!tc_accepts<GroupI4>(kTcMinRows, B, D, Dff, Dh, M)) return cudaErrorInvalidValue;
  return tc_decode_step<int8_t, GroupI4, SlotI4>(
      qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v,
      kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, smax, ptr,
      rows_per_cell, scale, act, SlotI4::layer_elems(B, M, H * Dh), (cudaStream_t)stream);
}

int slab4_tc_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  if (!tc_accepts<GroupI4>(kTcMinRows, B, D, Dff, Dh, M)) return cudaErrorInvalidValue;
  return tc_decode_step<bf16, GroupI4, SlotI4>(
      qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v,
      kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, 0, ptr,
      rows_per_cell, scale, act, SlotI4::layer_elems(B, M, H * Dh), (cudaStream_t)stream);
}

// The chain reads each weight tile once for up to 64 rows in every mode, so
// the all-rows steps take the slot-major steps' entries: slab_ar slab's,
// slab_ar_w8 slab_w8's (int8 panels).
int slab_tc_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  return slot_i8_tc_step<bf16>(kTcMinRows, PASS_BF16_WEIGHTS);
}

int slab_w8_tc_step(DECODE_STEP_ARGS(int8_t, int8_t)) {
  return slot_i8_tc_step<int8_t>(kSlabW8TcMinRows, PASS_INT8_WEIGHTS);
}

int slab_int8_tc_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  if (!tc_accepts<ScoresI8>(kTcMinRows, B, D, Dff, Dh, M) || rows_per_cell < 1 ||
      B % rows_per_cell)
    return cudaErrorInvalidValue;
  return tc_decode_step<bf16, ScoresI8, SlotI8>(
      qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v,
      kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, 0, ptr,
      rows_per_cell, scale, act, SlotI8::layer_elems(B, M, H * Dh), (cudaStream_t)stream);
}

}  // extern "C"
