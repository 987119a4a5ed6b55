// One decode token step through the whole multitask decoder stack, batch 1,
// over an int8 slot-major self-attention ring ("s2s/nw slab step").
//
// Replaces the TPU kernel deepmusicgeneration_tpu/ops/fused_s2s.py::
// fused_s2s_slab_core / fused_nw_slab_core (pallas_call built by
// _make_s2s_slab_kernel) in both weight modes: "slab_w8" (int8 weight
// panels with per-column scales, dequantized and rounded to bf16) and "slab"
// (bf16 panels used as they are). It computes the same function:
//
//   per layer l
//     qkv   = bf16(h) . W_qkv + b_qkv                               (f32 accumulate)
//     self attention of q over the M ring slots plus the fresh token, exactly
//     as the genre slab step (slab_common.cuh: slab_attention): scores
//     ((q+u) . K_int8 * k_scale + roll((q+v) . wkr, ptr)) * scale, slots
//     masked by `blocked`, the self term from the fresh unquantized k1 and v1,
//     P.V over bf16(p * v_scale); then the fresh k1/v1 quantized into slot
//     `ptr` (kv_slot_write) after the attention has read the old slot
//     h1 = LN1(h + attn)                        (no output projection)
//   s2s blocks only (has_cross):
//     q2 = bf16(h1) . W_q2 + b_q2
//     cross attention of q2 over the Le encode-time slots: scores
//     ((q2+u) . CK_int8 * ck_scale + (q2+v) . cwkr) * scale, encoder padding
//     masked (at one query token rel_shift is the identity and the tril mask
//     keeps every column), attn = sum bf16(p * cv_scale) . CV_int8 / denom
//     h2 = LN2(h1 + attn)
//     h  = LN3(h2 + W_ff2 . bf16(act(W_ff1 . bf16(h2) + b1)) + b2), act ReLU
//          or tanh GELU (the TPU kernel's; the exact path uses erf GELU)
//   nw blocks (no cross input): h = h1, attention only, the reference quirk.
//
// Like the genre step, each layer is a short chain of kernels on one stream
// (13 launches per s2s layer, 5 per nw layer) with the hidden state in
// device memory between them: Hopper blocks cannot carry state across a grid
// as the Pallas kernel's sequential grid carries it in VMEM.
//
// Bound. On the 85M flagship (10 decoder layers, d 512, 8 x 64 heads,
// d_inner 2048, mem_len 512) one s2s step at Le = 512 must read ~53 MB:
// 31.5 MB of int8 weights, 5.2 MB of int8 self K/V, 10.5 MB of int8 cross
// context and its bf16 relative keys, 5.3 MB of self wkr; ~16 us at
// 3.35 TB/s. The nw step reads ~18 MB. A few FLOP per byte: bound by bytes.
// The design follows from that: weights stay int8 in memory and are
// dequantized in registers (split-K GEMV, partials summed in a fixed order),
// attention reads each slot row once in 16-byte loads. The cross context is
// streamed from device memory slot by slot like the self ring (Le reaches
// 1024); only the Le scores sit in shared memory. A simple version, not
// tuned: at batch 1 the GEMVs fill few SMs.

#include "slab_common.cuh"

namespace {

// Cross attention of one query row over the encode-time context, one block
// per head. q2 (HD) f32 is the layer's cross query with its bias; ckq, cvq
// (Le, HD) int8 and cksc, cvsc (Le) f32 are the slot-major context and its
// per-slot scales; cwkr (Le, HD) bf16 the relative keys (row j <-> encoder
// position j); cblocked (Le) int32 the encoder padding. Each thread owns
// whole slot rows for the scores; for P.V each owns 4 output columns of one
// slot group, partials summed in a fixed order.
template <int DH>
__global__ void __launch_bounds__(kThreads)
cross_attention(const float* __restrict__ q2, int H, int Le,
                const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ vb,
                const __nv_bfloat16* __restrict__ cwkr, const int8_t* __restrict__ ckq,
                const float* __restrict__ cksc, const int8_t* __restrict__ cvq,
                const float* __restrict__ cvsc, const int32_t* __restrict__ cblocked,
                float scale, float* __restrict__ attn) {
  constexpr int kColGroups = DH / 4;
  constexpr int kSlotGroups = kThreads / kColGroups;
  extern __shared__ float sm[];
  float* qu = sm;          // DH: bf16(bf16(q2) + u)
  float* qv = qu + DH;     // DH: bf16(bf16(q2) + v)
  float* sc = qv + DH;     // Le scores, then exp(score - max)
  float* pv = sc + Le;     // kSlotGroups x DH partial P.V sums
  __shared__ float red[32];
  const int h = blockIdx.x;
  const int HD = H * DH;
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    const float qb = bf16_round(q2[h * DH + d]);
    qu[d] = bf16_round(qb + __bfloat162float(u[h * DH + d]));
    qv[d] = bf16_round(qb + __bfloat162float(vb[h * DH + d]));
  }
  __syncthreads();
  for (int m = threadIdx.x; m < Le; m += blockDim.x) {
    const int4* kr = reinterpret_cast<const int4*>(ckq + (size_t)m * HD + h * DH);
    const uint4* wr = reinterpret_cast<const uint4*>(cwkr + (size_t)m * HD + h * DH);
    int4 k16[DH / 16];
    uint4 w8[DH / 8];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) k16[c] = kr[c];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) w8[c] = wr[c];
    float ac = 0.f, bd = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const int8_t* kb = reinterpret_cast<const int8_t*>(&k16[c]);
#pragma unroll
      for (int j = 0; j < 16; ++j) ac = fmaf((float)kb[j], qu[c * 16 + j], ac);
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w8[c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p2[j]);
        bd = fmaf(f.x, qv[c * 8 + 2 * j], bd);
        bd = fmaf(f.y, qv[c * 8 + 2 * j + 1], bd);
      }
    }
    const float s = (ac * cksc[m] + bd) * scale;
    sc[m] = cblocked[m] ? -1e9f : s;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int m = threadIdx.x; m < Le; m += blockDim.x) mx = fmaxf(mx, sc[m]);
  mx = block_max(mx, red);
  float den = 0.f;
  for (int m = threadIdx.x; m < Le; m += blockDim.x) {
    const float e = expf(sc[m] - mx);
    sc[m] = e;
    den += e;
  }
  den = block_sum(den, red);  // its barriers also publish sc
  const int c = threadIdx.x % kColGroups, grp = threadIdx.x / kColGroups;
  const int8_t* vcol = cvq + h * DH + 4 * c;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int m = grp; m < Le; m += kSlotGroups) {
    const float ew = bf16_round(sc[m] * cvsc[m]);
    const char4 v4 = *reinterpret_cast<const char4*>(vcol + (size_t)m * HD);
    a0 = fmaf(ew, (float)v4.x, a0);
    a1 = fmaf(ew, (float)v4.y, a1);
    a2 = fmaf(ew, (float)v4.z, a2);
    a3 = fmaf(ew, (float)v4.w, a3);
  }
  float* mine = pv + grp * DH + 4 * c;
  mine[0] = a0;
  mine[1] = a1;
  mine[2] = a2;
  mine[3] = a3;
  __syncthreads();
  if (threadIdx.x < DH) {
    float t = 0.f;
    for (int g = 0; g < kSlotGroups; ++g) t += pv[g * DH + threadIdx.x];
    attn[h * DH + threadIdx.x] = t / den;
  }
}

template <int DH, typename... Args>
cudaError_t cross_dh(int blocks, size_t smem, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_attention<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cross_attention<DH><<<blocks, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename... Args>
cudaError_t cross(int Dh, int blocks, size_t smem, cudaStream_t st, Args... args) {
  switch (Dh) {
    case 16: return cross_dh<16>(blocks, smem, st, args...);
    case 32: return cross_dh<32>(blocks, smem, st, args...);
    case 64: return cross_dh<64>(blocks, smem, st, args...);
    case 128: return cross_dh<128>(blocks, smem, st, args...);
    default: return cudaErrorInvalidValue;
  }
}

// One token step through all L decoder layers at batch 1 (see s2s_slab_w8_step).
template <typename WT>
int s2s_step(const WT* qkv_w, const WT* q2_w, const WT* ff1_w, const WT* ff2_w,
             const float* w_scales, const __nv_bfloat16* qkv_b, const __nv_bfloat16* q2_b,
             const __nv_bfloat16* ff1_b, const __nv_bfloat16* ff2_b, const float* ln1_g,
             const float* ln1_b, const float* ln2_g, const float* ln2_b, const float* ln3_g,
             const float* ln3_b, const __nv_bfloat16* wkr, const __nv_bfloat16* u,
             const __nv_bfloat16* v, int8_t* kt, float* ks, int8_t* vc, float* vs,
             const int8_t* ckq, const float* cksc, const int8_t* cvq, const float* cvsc,
             const __nv_bfloat16* cwkr, const int32_t* cblocked, const float* h_in,
             const int32_t* blocked, float* h_out, float* scratch, int has_cross, int L,
             int D, int Dff, int H, int Dh, int M, int Le, int smax, int ptr, float scale,
             int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * Dh;
  float* qkv = scratch;
  float* attn = qkv + 3 * HD;
  float* h1 = attn + HD;
  float* h2 = h1 + D;
  float* q2 = h2 + D;
  float* ffx = q2 + HD;
  float* part = ffx + Dff;
  const size_t attn_smem = (size_t)(2 * Dh + 2 * (M + 1) + 4 * kThreads) * sizeof(float);
  const size_t cross_smem = (size_t)(2 * Dh + Le + 4 * kThreads) * sizeof(float);
  const size_t ln_smem = (size_t)D * sizeof(float);
  cudaError_t err;
  if (ln_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(add_layer_norm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ln_smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaMemcpyAsync(h_out, h_in, (size_t)D * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < L; ++l) {
    // column scales of the layer's qkv / q2 / ff1 / ff2 panels (int8 only)
    auto sc = [&](int row) -> const float* {
      return w_scales != nullptr ? w_scales + ((size_t)l * 8 + row) * smax : nullptr;
    };
    const size_t kv_off = (size_t)l * M;
    // qkv projection with its bias
    if ((err = gemv(false, h_out, 1, D, 3 * HD, qkv_w + (size_t)l * D * 3 * HD, sc(0), part, st)))
      return err;
    gemv_finish<<<ceil_div(3 * HD, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, kKChunk), 1, 3 * HD, qkv_b + (size_t)l * 3 * HD, kNone, qkv);
    if ((err = cudaGetLastError())) return err;
    // self attention over the old ring + the fresh token, then the slot write
    if ((err = attention<SlotI8>(Dh, H, attn_smem, st, qkv, H, M, u, v,
                                 wkr + (size_t)l * (M + 1) * HD, kt + kv_off * HD,
                                 ks + kv_off, vc + kv_off * HD, vs + kv_off, blocked, ptr,
                                 scale, attn)))
      return err;
    kv_slot_write<SlotI8><<<1, kThreads, 0, st>>>(qkv, HD, M, ptr, kt + kv_off * HD,
                                                  ks + kv_off, vc + kv_off * HD, vs + kv_off);
    if ((err = cudaGetLastError())) return err;
    // post-norm with no output projection; an nw block ends here
    add_layer_norm<<<1, kThreads, ln_smem, st>>>(h_out, attn, 1, 1, D, nullptr,
                                                 ln1_g + (size_t)l * D, ln1_b + (size_t)l * D,
                                                 has_cross ? h1 : h_out);
    if ((err = cudaGetLastError())) return err;
    if (!has_cross) continue;
    // cross attention over the encode-time context
    if ((err = gemv(false, h1, 1, D, HD, q2_w + (size_t)l * D * HD, sc(1), part, st))) return err;
    gemv_finish<<<ceil_div(HD, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, kKChunk), 1, HD, q2_b + (size_t)l * HD, kNone, q2);
    if ((err = cudaGetLastError())) return err;
    const size_t c_off = (size_t)l * Le;
    if ((err = cross(Dh, H, cross_smem, st, q2, H, Le, u, v, cwkr + c_off * HD, ckq + c_off * HD,
                     cksc + c_off, cvq + c_off * HD, cvsc + c_off, cblocked, scale, attn)))
      return err;
    add_layer_norm<<<1, kThreads, ln_smem, st>>>(h1, attn, 1, 1, D, nullptr,
                                                 ln2_g + (size_t)l * D, ln2_b + (size_t)l * D, h2);
    if ((err = cudaGetLastError())) return err;
    // feed-forward with biases, residual, post-norm
    if ((err = gemv(false, h2, 1, D, Dff, ff1_w + (size_t)l * D * Dff, sc(2), part, st)))
      return err;
    gemv_finish<<<ceil_div(Dff, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, kKChunk), 1, Dff, ff1_b + (size_t)l * Dff, act, ffx);
    if ((err = cudaGetLastError())) return err;
    if ((err = gemv(false, ffx, 1, Dff, D, ff2_w + (size_t)l * Dff * D, sc(3), part, st)))
      return err;
    add_layer_norm<<<1, kThreads, ln_smem, st>>>(h2, part, ceil_div(Dff, kKChunk), 1, D,
                                                 ff2_b + (size_t)l * D, ln3_g + (size_t)l * D,
                                                 ln3_b + (size_t)l * D, h_out);
    if ((err = cudaGetLastError())) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Float32 scratch elements a step needs for these widths (batch 1).
size_t s2s_slab_scratch_floats(int D, int Dff, int HD) {
  return (size_t)(3 * HD + HD + D + D + HD + Dff) + max_partial(1, D, Dff, HD, kKChunk);
}

// Kernel launches one step makes (for the launch accounting).
int s2s_slab_kernels_per_step(int L, int has_cross) { return (has_cross ? 13 : 5) * L; }

const char* s2s_slab_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One token step for one row through all L decoder layers. Pointers are
// device pointers into contiguous tensors with the layouts of
// fused_s2s_slab_core: qkv_w (L,D,3HD) q2_w (L,D,HD) ff1_w (L,D,Dff)
// ff2_w (L,Dff,D), int8 for s2s_slab_w8_step and bf16 for s2s_slab_step;
// w_scales (L,8,smax) f32 (rows 0..3: qkv, q2, ff1, ff2 column scales),
// ignored for bf16 panels; qkv_b (L,3HD) q2_b (L,HD) ff1_b (L,Dff) ff2_b (L,D)
// bf16; ln1..ln3 gains and offsets (L,D) f32; wkr (L,M+1,HD) bf16; u, v (HD)
// bf16; kt, vc (L,M,HD) int8 and ks, vs (L,M) f32, updated in slot ptr only;
// ckq, cvq (L,Le,HD) int8, cksc, cvsc (L,Le) f32, cwkr (L,Le,HD) bf16,
// cblocked (Le) int32; h_in, h_out (D) f32; blocked (M) int32; scratch of
// s2s_slab_scratch_floats(...) floats. has_cross = 0 runs the nw blocks
// (attention only) and reads none of q2_w, ff*, ln2, ln3 and the cross
// context. Returns the first CUDA error (0 = cudaSuccess). Does not
// synchronize.
#define S2S_STEP_ARGS(WT)                                                                  \
  const WT *qkv_w, const WT *q2_w, const WT *ff1_w, const WT *ff2_w, const float *w_scales, \
      const __nv_bfloat16 *qkv_b, const __nv_bfloat16 *q2_b, const __nv_bfloat16 *ff1_b,   \
      const __nv_bfloat16 *ff2_b, const float *ln1_g, const float *ln1_b,                  \
      const float *ln2_g, const float *ln2_b, const float *ln3_g, const float *ln3_b,      \
      const __nv_bfloat16 *wkr, const __nv_bfloat16 *u, const __nv_bfloat16 *v, int8_t *kt, \
      float *ks, int8_t *vc, float *vs, const int8_t *ckq, const float *cksc,              \
      const int8_t *cvq, const float *cvsc, const __nv_bfloat16 *cwkr,                      \
      const int32_t *cblocked, const float *h_in, const int32_t *blocked, float *h_out,     \
      float *scratch, int has_cross, int L, int D, int Dff, int H, int Dh, int M, int Le,   \
      int smax, int ptr, float scale, int act, void *stream

int s2s_slab_w8_step(S2S_STEP_ARGS(int8_t)) {
  return s2s_step<int8_t>(qkv_w, q2_w, ff1_w, ff2_w, w_scales, qkv_b, q2_b, ff1_b, ff2_b,
                          ln1_g, ln1_b, ln2_g, ln2_b, ln3_g, ln3_b, wkr, u, v, kt, ks, vc, vs,
                          ckq, cksc, cvq, cvsc, cwkr, cblocked, h_in, blocked, h_out, scratch,
                          has_cross, L, D, Dff, H, Dh, M, Le, smax, ptr, scale, act, stream);
}

int s2s_slab_step(S2S_STEP_ARGS(__nv_bfloat16)) {
  return s2s_step<__nv_bfloat16>(qkv_w, q2_w, ff1_w, ff2_w, nullptr, qkv_b, q2_b, ff1_b, ff2_b,
                                 ln1_g, ln1_b, ln2_g, ln2_b, ln3_g, ln3_b, wkr, u, v, kt, ks, vc,
                                 vs, ckq, cksc, cvq, cvsc, cwkr, cblocked, h_in, blocked, h_out,
                                 scratch, has_cross, L, D, Dff, H, Dh, M, Le, 0, ptr, scale, act,
                                 stream);
}

}  // extern "C"
