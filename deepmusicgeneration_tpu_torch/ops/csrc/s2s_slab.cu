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
//     `ptr` (absmax scale, round half to even) after the attention has read
//     the old slot
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
// Bound. On the 85M flagship (10 decoder layers, d 512, 8 x 64 heads,
// d_inner 2048, mem_len 512) one s2s step at Le = 512 must read ~53 MB:
// 31.5 MB of int8 weights, 5.2 MB of int8 self K/V, 10.5 MB of int8 cross
// context and its bf16 relative keys, 5.3 MB of self wkr; ~16 us at
// 3.35 TB/s. The nw step reads ~18 MB. A few FLOP per byte: bound by bytes,
// and at batch 1 by latency: ~5 MB a layer is too little to fill the card's
// memory pipes for long, so what costs is the number of dependent steps.
//
// Design (s2s_step.cuh). One cooperative launch a token step: a persistent
// grid of as many blocks as are co-resident walks the layers, 8 phases a s2s
// layer and 3 a nw layer with a grid-wide barrier between them, where the
// first port made 13 / 5 launches a layer. Each phase's work items (weight
// column tiles x K chunks, or heads x chunks of ring / encoder positions) are
// fixed by the shape, so any grid size gives the same bits. The weights stay
// int8 in memory and are dequantized in registers by their column scales;
// each item's weight tile and cache rows go into shared memory when it
// starts, by cp.async: the int8 rows lie HD bytes apart, and one bulk copy a
// row measured slower (so did issuing the next item's copies ahead of the
// current one, or of the barrier). The softmax keeps the TPU kernel's rounding: scores and each
// chunk's max first, then P.V under the head's global max. What bounds it
// on an H100 is fixed latency a phase, not bytes: the grid barrier, each
// phase's copies and waits even with no compute, and the LayerNorm folds
// every block repeats (PERF.md has the figures of a step with each of these
// taken out).

#include "s2s_step.cuh"

namespace {

template <typename WT>
StepPlan slab_plan(int has_cross, int L, int D, int Dff, int H, int Dh, int M, int Le) {
  return step_plan(has_cross, L, D, Dff, H, Dh, M, Le, (int)sizeof(WT), 1, 1);
}

// One token step for one row through all L decoder layers (see s2s_slab_w8_step).
template <typename WT>
int s2s_step(const WT* qkv_w, const WT* q2_w, const WT* ff1_w, const WT* ff2_w,
             const float* w_scales, const bf16* qkv_b, const bf16* q2_b, const bf16* ff1_b,
             const bf16* ff2_b, const float* ln1_g, const float* ln1_b, const float* ln2_g,
             const float* ln2_b, const float* ln3_g, const float* ln3_b, const bf16* wkr,
             const bf16* u, const bf16* v, int8_t* kt, float* ks, int8_t* vc, float* vs,
             const int8_t* ckq, const float* cksc, const int8_t* cvq, const float* cvsc,
             const bf16* cwkr, const int32_t* cblocked, const float* h_in,
             const int32_t* blocked, float* h_out, float* scratch, int has_cross, int L, int D,
             int Dff, int H, int Dh, int M, int Le, int smax, int ptr, float scale, int act,
             int grid, void* stream) {
  if (Dh < 16 || Dh > 128 || (Dh & (Dh - 1)) || D != H * Dh || grid < 1)
    return (int)cudaErrorInvalidValue;
  const StepPlan p = slab_plan<WT>(has_cross, L, D, Dff, H, Dh, M, Le);
  StepArgs<WT, int8_t> a = {qkv_w, q2_w, ff1_w, ff2_w, w_scales, qkv_b, q2_b, ff1_b, ff2_b,
                            ln1_g, ln1_b, ln2_g, ln2_b, ln3_g, ln3_b, wkr, u, v,
                            kt, ks, vc, vs, ckq, cksc, cvq, cvsc, cwkr, cblocked,
                            h_in, blocked, h_out, scratch, smax, ptr, act, scale};
  return (int)step_launch<WT, SlabCache>(a, p, grid, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Float32 scratch elements a step needs for this shape (batch 1).
size_t s2s_slab_scratch_floats(int has_cross, int L, int D, int Dff, int H, int Dh, int M,
                               int Le) {
  return slab_plan<int8_t>(has_cross, L, D, Dff, H, Dh, M, Le).scratch;
}

// Kernel launches one step makes (for the launch accounting).
int s2s_slab_kernels_per_step(int L, int has_cross) { return 1; }

// Blocks of a step's grid: as many as are co-resident on this card
// (occupancy x SMs) for this shape, or a negative CUDA error.
int s2s_slab_grid(int weights_int8, int has_cross, int L, int D, int Dff, int H, int Dh, int M,
                  int Le) {
  if (weights_int8)
    return step_grid<int8_t, SlabCache>(slab_plan<int8_t>(has_cross, L, D, Dff, H, Dh, M, Le));
  return step_grid<bf16, SlabCache>(slab_plan<bf16>(has_cross, L, D, Dff, H, Dh, M, Le));
}

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
// context. One cooperative launch of `grid` blocks (at most s2s_slab_grid's).
// Returns the CUDA error of the launch (0 = cudaSuccess). Does not
// synchronize.
#define S2S_STEP_ARGS(WT)                                                                  \
  const WT *qkv_w, const WT *q2_w, const WT *ff1_w, const WT *ff2_w, const float *w_scales, \
      const bf16 *qkv_b, const bf16 *q2_b, const bf16 *ff1_b, const bf16 *ff2_b,           \
      const float *ln1_g, const float *ln1_b, const float *ln2_g, const float *ln2_b,      \
      const float *ln3_g, const float *ln3_b, const bf16 *wkr, const bf16 *u,              \
      const bf16 *v, int8_t *kt, float *ks, int8_t *vc, float *vs, const int8_t *ckq,      \
      const float *cksc, const int8_t *cvq, const float *cvsc, const bf16 *cwkr,            \
      const int32_t *cblocked, const float *h_in, const int32_t *blocked, float *h_out,     \
      float *scratch, int has_cross, int L, int D, int Dff, int H, int Dh, int M, int Le,   \
      int smax, int ptr, float scale, int act, int grid, void *stream
#define S2S_STEP_PASS                                                                      \
  qkv_w, q2_w, ff1_w, ff2_w, w_scales, qkv_b, q2_b, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g,     \
      ln2_b, ln3_g, ln3_b, wkr, u, v, kt, ks, vc, vs, ckq, cksc, cvq, cvsc, cwkr, cblocked, \
      h_in, blocked, h_out, scratch, has_cross, L, D, Dff, H, Dh, M, Le, smax, ptr, scale,  \
      act, grid, stream

int s2s_slab_w8_step(S2S_STEP_ARGS(int8_t)) { return s2s_step<int8_t>(S2S_STEP_PASS); }

int s2s_slab_step(S2S_STEP_ARGS(bf16)) {
  w_scales = nullptr;   // bf16 panels carry no scales
  return s2s_step<bf16>(S2S_STEP_PASS);
}

}  // extern "C"
