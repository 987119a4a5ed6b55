// One decode token step through the whole Transformer-XL layer stack with
// int8 weights and an int8 slot-major KV ring ("slab_w8").
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
// Order contract of all four steps: attention reads the OLD slot `ptr` of every
// row (on a full ring that slot holds the oldest token, at distance exactly
// M, which is visible), and the fresh-slot write is a separate kernel
// launched after it on the same stream. The TPU all-rows kernel overlaps its
// slot-write DMA with later row groups' reads of that slot; that race is not
// carried over.

#include "slab_common.cuh"

namespace {

// One token step for all B rows through all L layers (see slab_w8_step).
// WT is the weight panels' type; w_scales is null for bf16 panels.
template <typename WT>
int step(bool allrows, const WT* qkv_w, const WT* out_w, const WT* ff1_w,
         const WT* ff2_w, const float* w_scales, const __nv_bfloat16* ff1_b,
         const __nv_bfloat16* ff2_b, const float* ln1_g, const float* ln1_b,
         const float* ln2_g, const float* ln2_b, const __nv_bfloat16* wkr,
         const __nv_bfloat16* u, const __nv_bfloat16* v, int8_t* kt, float* ks,
         int8_t* vc, float* vs, const float* h_in, const int32_t* blocked, float* h_out,
         float* scratch, int L, int B, int D, int Dff, int H, int Dh, int M, int smax,
         int ptr, float scale, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * Dh;
  float* qkv = scratch;
  float* attn = qkv + (size_t)B * 3 * HD;
  float* h1 = attn + (size_t)B * HD;
  float* ffx = h1 + (size_t)B * D;
  float* part = ffx + (size_t)B * Dff;
  const size_t attn_smem = (size_t)(2 * Dh + 2 * (M + 1) + 4 * kThreads) * sizeof(float);
  const size_t ln_smem = (size_t)D * sizeof(float);
  const int ch = k_chunk(allrows);
  cudaError_t err;
  if (ln_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(add_layer_norm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ln_smem);
    if (err != cudaSuccess) return err;
  }
  if (allrows) {
    err = cudaFuncSetAttribute(gemm_partial<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kARSmem);
    if (err != cudaSuccess) return err;
  }
  err = cudaMemcpyAsync(h_out, h_in, (size_t)B * D * sizeof(float),
                        cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < L; ++l) {
    // column scales of the layer's qkv / out / ff1 / ff2 panels (int8 only)
    auto sc = [&](int row) -> const float* {
      return w_scales != nullptr ? w_scales + ((size_t)l * 8 + row) * smax : nullptr;
    };
    const size_t kv_off = (size_t)l * B * M;
    // qkv projection
    if ((err = gemv(allrows, h_out, B, D, 3 * HD, qkv_w + (size_t)l * D * 3 * HD, sc(0), part, st)))
      return err;
    gemv_finish<<<ceil_div(B * 3 * HD, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, ch), B, 3 * HD, nullptr, kNone, qkv);
    if ((err = cudaGetLastError())) return err;
    // attention over the old cache + self, then the fresh slot write
    if ((err = attention(Dh, B * H, attn_smem, st, qkv, H, M, u, v,
                         wkr + (size_t)l * (M + 1) * HD, kt + kv_off * HD, ks + kv_off,
                         vc + kv_off * HD, vs + kv_off, blocked, ptr, scale, attn)))
      return err;
    kv_slot_write<<<B, kThreads, 0, st>>>(qkv, HD, M, ptr, kt + kv_off * HD, ks + kv_off,
                                          vc + kv_off * HD, vs + kv_off);
    if ((err = cudaGetLastError())) return err;
    // out projection + residual + post-LN
    if ((err = gemv(allrows, attn, B, HD, D, out_w + (size_t)l * HD * D, sc(1), part, st)))
      return err;
    add_layer_norm<<<B, kThreads, ln_smem, st>>>(h_out, part, ceil_div(HD, ch), B, D,
                                                 nullptr, ln1_g + (size_t)l * D,
                                                 ln1_b + (size_t)l * D, h1);
    if ((err = cudaGetLastError())) return err;
    // feed-forward + residual + post-LN
    if ((err = gemv(allrows, h1, B, D, Dff, ff1_w + (size_t)l * D * Dff, sc(2), part, st)))
      return err;
    gemv_finish<<<ceil_div(B * Dff, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, ch), B, Dff, ff1_b + (size_t)l * Dff, act, ffx);
    if ((err = cudaGetLastError())) return err;
    if ((err = gemv(allrows, ffx, B, Dff, D, ff2_w + (size_t)l * Dff * D, sc(3), part, st)))
      return err;
    add_layer_norm<<<B, kThreads, ln_smem, st>>>(h1, part, ceil_div(Dff, ch), B, D,
                                                 ff2_b + (size_t)l * D,
                                                 ln2_g + (size_t)l * D,
                                                 ln2_b + (size_t)l * D, h_out);
    if ((err = cudaGetLastError())) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Float32 scratch elements any of the four steps needs for these sizes (the
// all-rows steps' larger K slices need fewer partial sums).
size_t slab_w8_scratch_floats(int B, int D, int Dff, int HD) {
  return (size_t)B * (3 * HD + HD + D + Dff) + max_partial(B, D, Dff, HD, k_chunk(false));
}

// Kernel launches any step makes per call (for the launch accounting).
int slab_w8_kernels_per_step(int L) { return 10 * L; }

const char* slab_w8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One token step for all B rows through all L layers. Pointers are device
// pointers into contiguous tensors with the layouts of fused_slab_core:
// qkv_w (L,D,3HD) out_w (L,HD,D) ff1_w (L,D,Dff) ff2_w (L,Dff,D), int8 for
// the _w8 steps and bf16 for slab_step / slab_ar_step; w_scales (L,8,smax)
// f32 (rows 0..3: qkv, out, ff1, ff2 column scales), null for bf16 panels;
// ff1_b (L,Dff) ff2_b (L,D) bf16; ln1_g/ln1_b/ln2_g/ln2_b (L,D) f32;
// wkr (L,M+1,HD) bf16; u, v (HD) bf16; kt, vc (L,B,M,HD) int8 and ks, vs
// (L,B,M) f32, updated in slot ptr only; h_in (B,D) f32; blocked (B,M) int32;
// h_out (B,D) f32; scratch of slab_w8_scratch_floats(...) floats.
// Returns the first CUDA error (0 = cudaSuccess). Does not synchronize.
#define SLAB_STEP_ARGS(WT)                                                              \
  const WT *qkv_w, const WT *out_w, const WT *ff1_w, const WT *ff2_w,                  \
      const float *w_scales, const __nv_bfloat16 *ff1_b, const __nv_bfloat16 *ff2_b,   \
      const float *ln1_g, const float *ln1_b, const float *ln2_g, const float *ln2_b,  \
      const __nv_bfloat16 *wkr, const __nv_bfloat16 *u, const __nv_bfloat16 *v,       \
      int8_t *kt, float *ks, int8_t *vc, float *vs, const float *h_in,                 \
      const int32_t *blocked, float *h_out, float *scratch, int L, int B, int D,       \
      int Dff, int H, int Dh, int M, int smax, int ptr, float scale, int act,          \
      void *stream
#define SLAB_STEP_PASS                                                                  \
  qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, \
      u, v, kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M,     \
      smax, ptr, scale, act, stream

int slab_w8_step(SLAB_STEP_ARGS(int8_t)) { return step<int8_t>(false, SLAB_STEP_PASS); }

// The all-rows step: the same arguments, scratch and result, weight products
// through gemm_partial.
int slab_ar_w8_step(SLAB_STEP_ARGS(int8_t)) { return step<int8_t>(true, SLAB_STEP_PASS); }

// The bf16-weight steps ("slab", "slab_ar"): bf16 panels, w_scales ignored.
int slab_step(SLAB_STEP_ARGS(__nv_bfloat16)) {
  return step<__nv_bfloat16>(false, qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b,
                             ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v, kt, ks, vc, vs, h_in,
                             blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, 0, ptr,
                             scale, act, stream);
}

int slab_ar_step(SLAB_STEP_ARGS(__nv_bfloat16)) {
  return step<__nv_bfloat16>(true, qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b,
                             ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v, kt, ks, vc, vs, h_in,
                             blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, 0, ptr,
                             scale, act, stream);
}

}  // extern "C"
