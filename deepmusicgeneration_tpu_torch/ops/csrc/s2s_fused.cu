// One decode token step through the whole multitask decoder stack, batch 1,
// exact bf16: a bf16 self-attention ring, a bf16 cross context and bf16
// weight panels ("fused" step).
//
// Replaces the TPU kernel deepmusicgeneration_tpu/ops/fused_s2s.py::
// fused_s2s_step_core / fused_nw_step_core (the pallas_call built by
// _make_s2s_kernel) and computes the same function, with its rounding points:
//
//   per layer l
//     qkv = bf16(h) . W_qkv + b_qkv                                (f32 sums)
//     qu  = bf16(bf16(q) + u), qv = bf16(bf16(q) + v)
//     self attention over the M ring slots (K, V bf16, head-major) and the
//     fresh token: s_m = (qu . K_m + roll(qv . wkr, ptr)_m) * scale, -1e9
//     where `blocked`; the fresh token's s = (qu . k1 + qv . wkr_M) * scale
//     from the f32 k1; e = exp(s - max);
//     attn = (sum_m bf16(e_m) V_m + e_self v1) / (sum_m e_m + e_self), v1 f32
//     then bf16(k1), bf16(v1) into slot `ptr` (after the attention has read
//     the old slot: blocked leaves slot ptr live at distance M)
//     h1 = LN1(h + attn)                       (f32; no output projection)
//   s2s blocks only (has_cross):
//     q2 = bf16(h1) . W_q2 + b_q2
//     cross attention over the Le encode-time slots (K, V and relative keys
//     bf16, head-major): s_m = (qu2 . CK_m + qv2 . CWKR_m) * scale, -1e9 on
//     encoder padding; attn = sum_m bf16(e_m) CV_m / sum_m e_m
//     h2 = LN2(h1 + attn)
//     h  = LN3(h2 + W_ff2 . bf16(act(W_ff1 . bf16(h2) + b1)) + b2), act ReLU
//          or the TPU kernel's tanh GELU
//   nw blocks (no cross input): h = h1, attention only, the reference quirk.
//
// Bound. On the 85M flagship (10 decoder layers, d 512, 8 x 64 heads,
// d_inner 2048, mem_len 512) one s2s step at Le = 512 must read ~94 MB:
// 62.9 MB of bf16 weights, 10.5 MB of self ring, 15.7 MB of cross context,
// 5.3 MB of self relative keys; ~28 us at 3.35 TB/s. The nw step reads
// ~31.5 MB. A few FLOP per byte: bound by bytes, and at batch 1 by the
// latency of the layers' dependent steps.
//
// Design: the persistent one-launch step of s2s_step.cuh (see there and
// s2s_slab.cu), over the cache format FusedCache: the ring, relative keys
// and cross context are bf16 and head-major, as the port's exact ring step
// keeps them, so a (head, chunk) item's rows are one contiguous run, staged
// by one bulk copy on an mbarrier (the weight tiles' rows lie apart and go by
// cp.async); no scales and no quantization; the probabilities are rounded to bf16
// unscaled; the slot write rounds k1 / v1 to bf16.

#include "s2s_step.cuh"

namespace {

StepPlan fused_plan(int has_cross, int L, int D, int Dff, int H, int Dh, int M, int Le) {
  return step_plan(has_cross, L, D, Dff, H, Dh, M, Le, 2, 2, 0);
}

}  // namespace

extern "C" {

// Float32 scratch elements a step needs for this shape.
size_t s2s_fused_scratch_floats(int has_cross, int L, int D, int Dff, int H, int Dh, int M,
                                int Le) {
  return fused_plan(has_cross, L, D, Dff, H, Dh, M, Le).scratch;
}

// Kernel launches one step makes (for the launch accounting).
int s2s_fused_kernels_per_step(int L, int has_cross) { return 1; }

// Blocks of a step's grid: as many as are co-resident on this card
// (occupancy x SMs) for this shape, or a negative CUDA error.
int s2s_fused_grid(int has_cross, int L, int D, int Dff, int H, int Dh, int M, int Le) {
  return step_grid<bf16, FusedCache>(fused_plan(has_cross, L, D, Dff, H, Dh, M, Le));
}

const char* s2s_fused_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One token step for one row through all L decoder layers. Device pointers
// into contiguous tensors with the layouts of fused_s2s_step_core: qkv_w
// (L,D,3HD) q2_w (L,D,HD) ff1_w (L,D,Dff) ff2_w (L,Dff,D) bf16; qkv_b (L,3HD)
// q2_b (L,HD) ff1_b (L,Dff) ff2_b (L,D) bf16; ln1..ln3 gains and offsets
// (L,D) f32; wkr (L,H,M+1,Dh) bf16; u, v (HD) bf16; kc, vc (L,H,M,Dh) bf16,
// updated in slot ptr only; ck, cv, cwkr (L,H,Le,Dh) bf16, cblocked (Le)
// int32; h_in, h_out (D) f32; blocked (M) int32; scratch of
// s2s_fused_scratch_floats(...) floats. has_cross = 0 runs the nw blocks
// (attention only) and reads none of q2_w, ff*, ln2, ln3 and the cross
// context. Needs Dh in {16, 32, 64, 128}, D == H * Dh and D, Dff
// multiples of 4. One cooperative launch of `grid` blocks (at most
// s2s_fused_grid's). Returns the CUDA error of the launch (0 =
// cudaSuccess). Does not synchronize.
int s2s_fused_step(const bf16* qkv_w, const bf16* q2_w, const bf16* ff1_w, const bf16* ff2_w,
                   const bf16* qkv_b, const bf16* q2_b, const bf16* ff1_b, const bf16* ff2_b,
                   const float* ln1_g, const float* ln1_b, const float* ln2_g,
                   const float* ln2_b, const float* ln3_g, const float* ln3_b, const bf16* wkr,
                   const bf16* u, const bf16* v, bf16* kc, bf16* vc, const bf16* ck,
                   const bf16* cv, const bf16* cwkr, const int32_t* cblocked,
                   const float* h_in, const int32_t* blocked, float* h_out, float* scratch,
                   int has_cross, int L, int D, int Dff, int H, int Dh, int M, int Le, int ptr,
                   float scale, int act, int grid, void* stream) {
  if (Dh < 16 || Dh > 128 || (Dh & (Dh - 1)) || D != H * Dh || grid < 1)
    return (int)cudaErrorInvalidValue;
  const StepPlan p = fused_plan(has_cross, L, D, Dff, H, Dh, M, Le);
  StepArgs<bf16, bf16> a = {qkv_w, q2_w, ff1_w, ff2_w, nullptr, qkv_b, q2_b, ff1_b, ff2_b,
                            ln1_g, ln1_b, ln2_g, ln2_b, ln3_g, ln3_b, wkr, u, v,
                            kc, nullptr, vc, nullptr, ck, nullptr, cv, nullptr, cwkr, cblocked,
                            h_in, blocked, h_out, scratch, 0, ptr, act, scale};
  return (int)step_launch<bf16, FusedCache>(a, p, grid, (cudaStream_t)stream);
}

}  // extern "C"
