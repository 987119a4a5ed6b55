// One decode token step through the whole Transformer-XL layer stack over
// head-major K/V panels: the "multirow" and "multirow_int8" modes, and the
// steps of fused_stack_decode / fused_batched_decode.
//
// Replaces the TPU kernels deepmusicgeneration_tpu/ops/fused_decode.py::
// fused_multirow_core (pallas_call built by _make_multirow_kernel: bf16
// panels) and fused_multirow_q_core (_make_multirow_q_kernel: int8 panels
// with per-slot scales), and computes the same function:
//
//   per layer l, per batch row b
//     qkv   = bf16(h) . W_qkv                                   (f32 accumulate)
//     score = ((q+u) . K[:, slot] (* k_scale[slot]) + roll((q+v) . wkr, ptr)[slot])
//             * scale, slots masked by `blocked`; self term from the fresh
//             unquantized k1 at distance 0; softmax over M + 1 keys
//     attn  = (sum_slot bf16(p (* v_scale[slot])) . V[slot] + p_self * v1) / denom
//     slot `ptr` of K and V takes the fresh k1 / v1: as bf16 (multirow), or
//     quantized by the row's absmax (scale max(amax, 1e-6) / 127, round half
//     to even, clip +-127; multirow_int8), after the layer's attention has
//     read the old slot
//     h1 = LN(h + bf16(attn) . W_out);  h = LN(h1 + W_ff2 . gelu_tanh(W_ff1 . h1 + b1) + b2)
//
// K is a head-major panel (B, HD, M) per layer (slot m of dimension d at
// d * M + m), V slot-major (B, M, HD), and the relative table wkr_f a
// (HD, M + 1) panel. The Pallas kernel keeps them so because its matrix unit
// wants the slot axis on lanes; here each thread of a (row, head) block owns
// slots, and walking a panel along M puts neighbouring threads on
// neighbouring addresses, so the panels are read as they are
// (PanelBF16 / PanelI8 below, formats of slab_common.cuh's slab_attention).
//
// The TPU kernel rewrites every cache block each step, the ring slot merged
// in with an iota select, because its memory writes are tile-grained. The
// port writes slot `ptr` alone, in place. On a full ring slot `ptr` holds the
// oldest token at distance exactly M and is read (the TPU kernel reads its
// input block, the old row), so the write is a separate kernel launched
// after the layer's attention on the same stream.
//
// The chain of kernels is the slab steps' (decode_step in slab_common.cuh:
// the row-tiled bf16 GEMV, add + LayerNorm), 10 kernels a layer; the
// weights are bf16 panels as the engine stacks them. Bound at B = 64,
// M = 512 on the 41M flagship: multirow reads 805.3 MB of bf16 K/V and
// 75.5 MB of weights a step (~0.26 ms at 3.35 TB/s), multirow_int8 402.7 MB
// of int8 K/V plus 0.26 MB of scales (~0.14 ms), both bound by bytes.
//
// The same file holds the steps of fused_decode.py::fused_stack_decode
// (pallas_call built by _make_kernel: B = 1, h as an 8-row block whose row 0
// is the token) and fused_batched_decode (_make_batched_kernel: grid
// (layer, row), each weight block read once a layer for the whole batch).
// Both compute multirow's function over other cache layouts: K (B, H, Dh, M)
// is PanelBF16's panel in memory, wkr (H, Dh, M + 1) its (HD, M + 1) panel;
// only V is head-major, (B, H, M, Dh) (HeadMajorBF16 below). The chain is
// multirow's, with the row-tiled GEMV for the weight products, so the two
// TPU kernels' one difference from multirow (how often weights leave
// memory) is not reproduced here. Bound at M = 512 on the flagship: 75.5 MB
// of bf16 weights, 6.3 MB of wkr and 12.6 MB of K/V a row (~26 us at B = 1,
// ~263 us at B = 64, 3.35 TB/s), bound by bytes.

#include "slab_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// (q + v) . wkr_f[:, m] for head h of an (HD, M + 1) panel
template <int DH>
__device__ __forceinline__ float wkr_panel_dot(const bf16* wkr, int m, int h, int M,
                                               const float* qv) {
  const bf16* w = wkr + (size_t)h * DH * (M + 1) + m;
  float t = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) t = fmaf(bf16_at(w + (size_t)d * (M + 1)), qv[d], t);
  return t;
}

// bf16 head-major panels: K (B, HD, M), V (B, M, HD), no scales.
struct PanelBF16 {
  using KT = bf16;
  using VT = bf16;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float inv_qmax() { return 1.f; }
  static size_t layer_elems(int B, int M, int HD) { return (size_t)B * M * HD; }
  template <int DH>
  static __device__ __forceinline__ float wkr_dot(const bf16* wkr, int m, int h, int M,
                                                  int HD, const float* qv) {
    return wkr_panel_dot<DH>(wkr, m, h, M, qv);
  }
  template <int DH>
  static __device__ __forceinline__ float key_dot(const KT* kt, int b, int m, int h, int M,
                                                  int HD, const float* qu) {
    const bf16* k = kt + ((size_t)b * HD + h * DH) * M + m;
    float t = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) t = fmaf(bf16_at(k + (size_t)d * M), qu[d], t);
    return t;
  }
  static __device__ __forceinline__ float4 value4(const VT* vc, int b, int m, int col, int M,
                                                  int HD) {
    const uint2 p = *reinterpret_cast<const uint2*>(vc + ((size_t)b * M + m) * HD + col);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.y));
    return make_float4(a.x, a.y, c.x, c.y);
  }
  static __device__ __forceinline__ void put_k(KT* kt, int b, int j, int M, int HD, int ptr,
                                               float x, float) {
    kt[((size_t)b * HD + j) * M + ptr] = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void put_v(VT* vc, int b, int j, int M, int HD, int ptr,
                                               float x, float) {
    vc[((size_t)b * M + ptr) * HD + j] = __float2bfloat16_rn(x);
  }
};

// int8 head-major panels with per-slot scales (B, M): the score of a slot is
// scaled after the product, the V scale folds into the probability before
// its bf16 cast, as the TPU kernel applies them.
struct PanelI8 {
  using KT = int8_t;
  using VT = int8_t;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ float inv_qmax() { return (float)(1.0 / 127.0); }
  static size_t layer_elems(int B, int M, int HD) { return (size_t)B * M * HD; }
  template <int DH>
  static __device__ __forceinline__ float wkr_dot(const bf16* wkr, int m, int h, int M,
                                                  int HD, const float* qv) {
    return wkr_panel_dot<DH>(wkr, m, h, M, qv);
  }
  template <int DH>
  static __device__ __forceinline__ float key_dot(const KT* kt, int b, int m, int h, int M,
                                                  int HD, const float* qu) {
    const int8_t* k = kt + ((size_t)b * HD + h * DH) * M + m;
    float t = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) t = fmaf((float)k[(size_t)d * M], qu[d], t);
    return t;
  }
  static __device__ __forceinline__ float4 value4(const VT* vc, int b, int m, int col, int M,
                                                  int HD) {
    return SlotI8::value4(vc, b, m, col, M, HD);
  }
  static __device__ __forceinline__ void put_k(KT* kt, int b, int j, int M, int HD, int ptr,
                                               float x, float s) {
    kt[((size_t)b * HD + j) * M + ptr] = (int8_t)quantize(x, s, 127.f);
  }
  static __device__ __forceinline__ void put_v(VT* vc, int b, int j, int M, int HD, int ptr,
                                               float x, float s) {
    SlotI8::put_v(vc, b, j, M, HD, ptr, x, s);
  }
};

// bf16 head-major K and V of fused_stack_decode / fused_batched_decode: K is
// (B, H, Dh, M), PanelBF16's (B, HD, M) panel in memory, and V (B, H, M, Dh),
// so a head's slot row is Dh contiguous values (128 bytes at Dh 64). V's
// index needs the head width, so the format is a template on it.
template <int DH>
struct HeadMajorBF16 : PanelBF16 {
  // V[b, h, m, d] for column col = h * DH + d
  static __device__ __forceinline__ size_t v_index(int b, int m, int col, int M, int HD) {
    return ((size_t)b * HD + (col / DH) * DH) * M + (size_t)m * DH + col % DH;
  }
  static __device__ __forceinline__ float4 value4(const VT* vc, int b, int m, int col, int M,
                                                  int HD) {
    const uint2 p = *reinterpret_cast<const uint2*>(vc + v_index(b, m, col, M, HD));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.y));
    return make_float4(a.x, a.y, c.x, c.y);
  }
  static __device__ __forceinline__ void put_v(VT* vc, int b, int j, int M, int HD, int ptr,
                                               float x, float) {
    vc[v_index(b, ptr, j, M, HD)] = __float2bfloat16_rn(x);
  }
};

// One token step over panels of format F with bf16 weight panels. A format
// built for one head width (HeadMajorBF16<DH>) passes it as DH, and its
// attention is built for that width alone.
template <typename F, int DH = 0>
int run_multirow(DECODE_STEP_ARGS(bf16, typename F::KT)) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * Dh;
  const size_t smem = attention_smem(Dh, M);
  const size_t kv_layer = F::layer_elems(B, M, HD);
  auto attend = [=](int l, const float* qkv, float* attn) -> cudaError_t {
    typename F::KT* kl = kt + l * kv_layer;
    typename F::VT* vl = vc + l * kv_layer;
    float* ksl = ks == nullptr ? nullptr : ks + (size_t)l * B * M;
    float* vsl = vs == nullptr ? nullptr : vs + (size_t)l * B * M;
    const bf16* wl = wkr + (size_t)l * HD * (M + 1);
    cudaError_t err;
    if constexpr (DH > 0)
      err = attention_dh<DH, F>(B * H, smem, st, qkv, H, M, u, v, wl, kl, ksl, vl, vsl,
                                blocked, ptr, scale, attn);
    else
      err = attention<F>(Dh, B * H, smem, st, qkv, H, M, u, v, wl, kl, ksl, vl, vsl, blocked,
                         ptr, scale, attn);
    if (err != cudaSuccess) return err;
    kv_slot_write<F><<<B, kThreads, 0, st>>>(qkv, HD, M, ptr, kl, ksl, vl, vsl);
    return cudaGetLastError();
  };
  return decode_step<bf16>(false, qkv_w, out_w, ff1_w, ff2_w, nullptr, ff1_b, ff2_b, ln1_g,
                           ln1_b, ln2_g, ln2_b, h_in, h_out, scratch, L, B, D, Dff, HD, 0, act,
                           st, attend);
}

#define PASS_STEP_ARGS                                                                     \
  qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, wkr, u, v, \
      kt, ks, vc, vs, h_in, blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, smax, ptr,     \
      rows_per_cell, scale, act, stream

// run_multirow over head-major K/V, its format built for the head width
int run_head_major(DECODE_STEP_ARGS(bf16, bf16)) {
  switch (Dh) {
    case 16: return run_multirow<HeadMajorBF16<16>, 16>(PASS_STEP_ARGS);
    case 32: return run_multirow<HeadMajorBF16<32>, 32>(PASS_STEP_ARGS);
    case 64: return run_multirow<HeadMajorBF16<64>, 64>(PASS_STEP_ARGS);
    case 128: return run_multirow<HeadMajorBF16<128>, 128>(PASS_STEP_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Float32 scratch elements a step needs for these sizes.
size_t multirow_decode_scratch_floats(int B, int D, int Dff, int H, int Dh, int M, int) {
  return step_scratch_floats(B, D, Dff, H * Dh);
}

// Kernel launches a step makes per call (for the launch accounting).
int multirow_decode_kernels_per_step(int L, int) { return L * (kChainKernelsPerLayer + 2); }

const char* multirow_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One token step for all B rows through all L layers (DECODE_STEP_ARGS in
// slab_common.cuh): bf16 weight panels qkv_w (L,D,3HD) out_w (L,HD,D) ff1_w
// (L,D,Dff) ff2_w (L,Dff,D) (w_scales and smax ignored); ff1_b (L,Dff)
// ff2_b (L,D) bf16; ln1_g/ln1_b/ln2_g/ln2_b (L,D) f32; wkr (L,HD,M+1) bf16;
// u, v (HD) bf16; kt (L,B,HD,M) and vc (L,B,M,HD), bf16 for multirow_step
// (ks, vs null) and int8 for multirow_int8_step with ks, vs (L,B,1,M) f32,
// updated in slot ptr only; h_in (B,D) f32; blocked (B,M) int32; h_out
// (B,D) f32; scratch of multirow_decode_scratch_floats(...) floats;
// rows_per_cell is not read. Returns the first CUDA error (0 = cudaSuccess).
// Does not synchronize.
int multirow_step(DECODE_STEP_ARGS(bf16, bf16)) {
  return run_multirow<PanelBF16>(qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g,
                                 ln1_b, ln2_g, ln2_b, wkr, u, v, kt, nullptr, vc, nullptr, h_in,
                                 blocked, h_out, scratch, L, B, D, Dff, H, Dh, M, smax, ptr,
                                 rows_per_cell, scale, act, stream);
}

int multirow_int8_step(DECODE_STEP_ARGS(bf16, int8_t)) {
  return run_multirow<PanelI8>(qkv_w, out_w, ff1_w, ff2_w, w_scales, ff1_b, ff2_b, ln1_g,
                               ln1_b, ln2_g, ln2_b, wkr, u, v, kt, ks, vc, vs, h_in, blocked,
                               h_out, scratch, L, B, D, Dff, H, Dh, M, smax, ptr,
                               rows_per_cell, scale, act, stream);
}

// The steps of fused_stack_decode (B = 1: the wrapper passes row 0 of its
// 8-row h block) and fused_batched_decode: the same arguments, with kt
// (L,B,H,Dh,M) and vc (L,B,H,M,Dh) bf16 (ks, vs null), updated in slot ptr
// only, and wkr (L,H,Dh,M+1) bf16, the (L,HD,M+1) panel in memory.
int fused_stack_step(DECODE_STEP_ARGS(bf16, bf16)) { return run_head_major(PASS_STEP_ARGS); }

int fused_batched_step(DECODE_STEP_ARGS(bf16, bf16)) { return run_head_major(PASS_STEP_ARGS); }

}  // extern "C"
