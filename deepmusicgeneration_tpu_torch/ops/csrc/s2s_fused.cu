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
// The structure is s2s_slab.cu's (the int8 slab step, row 6 of the port's
// kernel table): each layer is a short chain of kernels on one stream (13 a
// s2s layer, 5 a nw layer) with the hidden state in device memory between
// them, the weight products the shared split-K GEMV over bf16 panels
// (slab_common.cuh). What differs is the cache: bf16 and head-major, as the
// port's exact ring step keeps it, so no scales and no quantization, and the
// probabilities are rounded to bf16 unscaled.
//
// Bound. On the 85M flagship (10 decoder layers, d 512, 8 x 64 heads,
// d_inner 2048, mem_len 512) one s2s step at Le = 512 must read ~94 MB:
// 62.9 MB of bf16 weights, 10.5 MB of self ring, 15.7 MB of cross context,
// 5.3 MB of self relative keys; ~28 us at 3.35 TB/s. The nw step reads
// ~31.5 MB. A few FLOP per byte: bound by bytes. A simple version, not
// tuned: at batch 1 the GEMVs fill few SMs and each slot row is read by one
// thread.

#include "slab_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// The dot product of a head's DH f32 query (in shared memory) with one bf16
// row of DH values (16-byte loads).
template <int DH>
__device__ __forceinline__ float dot_row(const bf16* __restrict__ row, const float* q) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  uint4 w8[DH / 8];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) w8[c] = r[c];
  float t = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w8[c]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p2[j]);
      t = fmaf(f.x, q[c * 8 + 2 * j], t);
      t = fmaf(f.y, q[c * 8 + 2 * j + 1], t);
    }
  }
  return t;
}

// qu = bf16(bf16(q) + u), qv = bf16(bf16(q) + v) of head h into shared memory.
template <int DH>
__device__ __forceinline__ void biased_queries(const float* q, const bf16* u, const bf16* vb,
                                               int h, float* qu, float* qv) {
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    const float qb = bf16_round(q[d]);
    qu[d] = bf16_round(qb + __bfloat162float(u[h * DH + d]));
    qv[d] = bf16_round(qb + __bfloat162float(vb[h * DH + d]));
  }
}

// sum_m bf16(e[order(m)]) V[order(m)] over n slots, each thread 4 output
// columns of one slot group, partial sums added in a fixed order; the result
// of column d goes to out[d] (a shared buffer `pv` of kThreads * 4 floats).
// order(i) = (i + start) mod n visits the slots in ring order.
template <int DH>
__device__ __forceinline__ void weighted_values(const float* e, const bf16* __restrict__ V, int n,
                                                int start, float* pv, float* out) {
  constexpr int kColGroups = DH / 4;
  constexpr int kSlotGroups = kThreads / kColGroups;
  const int c = threadIdx.x % kColGroups, grp = threadIdx.x / kColGroups;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int i = grp; i < n; i += kSlotGroups) {
    const int m = i < n - start ? i + start : i + start - n;
    const float ew = bf16_round(e[m]);
    const uint2 v4 = *reinterpret_cast<const uint2*>(V + (size_t)m * DH + 4 * c);
    const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v4.x));
    const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v4.y));
    a0 = fmaf(ew, v01.x, a0);
    a1 = fmaf(ew, v01.y, a1);
    a2 = fmaf(ew, v23.x, a2);
    a3 = fmaf(ew, v23.y, a3);
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
    out[threadIdx.x] = t;
  }
}

// Self attention of the layer over the bf16 ring and the fresh token, one
// block per head. qkv (3 HD) f32; wkr (H, M+1, DH) bf16, row m <-> distance
// M - m; kc, vc (H, M, DH) bf16; blocked (M) int32; attn (HD) f32.
template <int DH>
__global__ void __launch_bounds__(kThreads)
ring_attention(const float* __restrict__ qkv, int H, int M, const bf16* __restrict__ u,
               const bf16* __restrict__ vb, const bf16* __restrict__ wkr,
               const bf16* __restrict__ kc, const bf16* __restrict__ vc,
               const int32_t* __restrict__ blocked, int ptr, float scale,
               float* __restrict__ attn) {
  extern __shared__ float sm[];
  float* qu = sm;            // DH
  float* qv = qu + DH;       // DH
  float* sd = qv + DH;       // M + 1 distance-space relative scores
  float* sc = sd + M + 1;    // M + 1 scores, then exponentials (slot M = self)
  float* pv = sc + M + 1;    // kThreads * 4 partial P.V sums
  __shared__ float red[32];
  __shared__ float res[DH];
  const int h = blockIdx.x;
  const int HD = H * DH;
  const float* q = qkv + h * DH;
  const float* k1 = q + HD;
  const float* v1 = q + 2 * HD;
  const bf16* wh = wkr + (size_t)h * (M + 1) * DH;
  const bf16* kh = kc + (size_t)h * M * DH;
  biased_queries<DH>(q, u, vb, h, qu, qv);
  __syncthreads();
  for (int m = threadIdx.x; m <= M; m += blockDim.x) sd[m] = dot_row<DH>(wh + (size_t)m * DH, qv);
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int src = (m - ptr < 0) ? m - ptr + M : m - ptr;   // roll by ptr
    const float s = (dot_row<DH>(kh + (size_t)m * DH, qu) + sd[src]) * scale;
    sc[m] = blocked[m] ? -1e9f : s;
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
  float den = 0.f;
  for (int m = threadIdx.x; m <= M; m += blockDim.x) {
    const float e = expf(sc[m] - mx);
    sc[m] = e;
    den += e;
  }
  den = block_sum(den, red);  // its barriers also publish sc
  weighted_values<DH>(sc, vc + (size_t)h * M * DH, M, ptr, pv, res);
  __syncthreads();
  if (threadIdx.x < DH)
    attn[h * DH + threadIdx.x] = (res[threadIdx.x] + sc[M] * v1[threadIdx.x]) / den;
}

// Cross attention of the layer's query over the encode-time context, one
// block per head. q2 (HD) f32 with its bias; ck, cv, cwkr (H, Le, DH) bf16
// (cwkr row j <-> encoder position j); cblocked (Le) int32.
template <int DH>
__global__ void __launch_bounds__(kThreads)
cross_attention(const float* __restrict__ q2, int H, int Le, const bf16* __restrict__ u,
                const bf16* __restrict__ vb, const bf16* __restrict__ cwkr,
                const bf16* __restrict__ ck, const bf16* __restrict__ cv,
                const int32_t* __restrict__ cblocked, float scale, float* __restrict__ attn) {
  extern __shared__ float sm[];
  float* qu = sm;
  float* qv = qu + DH;
  float* sc = qv + DH;       // Le scores, then exponentials
  float* pv = sc + Le;       // kThreads * 4 partial P.V sums
  __shared__ float red[32];
  __shared__ float res[DH];
  const int h = blockIdx.x;
  const size_t off = (size_t)h * Le * DH;
  biased_queries<DH>(q2 + h * DH, u, vb, h, qu, qv);
  __syncthreads();
  for (int m = threadIdx.x; m < Le; m += blockDim.x) {
    const float s = (dot_row<DH>(ck + off + (size_t)m * DH, qu) +
                     dot_row<DH>(cwkr + off + (size_t)m * DH, qv)) * scale;
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
  den = block_sum(den, red);
  weighted_values<DH>(sc, cv + off, Le, 0, pv, res);
  __syncthreads();
  if (threadIdx.x < DH) attn[h * DH + threadIdx.x] = res[threadIdx.x] / den;
}

// bf16(k1), bf16(v1) of qkv into slot `ptr` of the layer's head-major ring.
__global__ void __launch_bounds__(kThreads)
ring_slot_write(const float* __restrict__ qkv, int H, int DH, int M, int ptr,
                bf16* __restrict__ kc, bf16* __restrict__ vc) {
  const int HD = H * DH;
  for (int j = threadIdx.x; j < HD; j += blockDim.x) {
    const size_t slot = ((size_t)(j / DH) * M + ptr) * DH + j % DH;
    kc[slot] = __float2bfloat16_rn(qkv[HD + j]);
    vc[slot] = __float2bfloat16_rn(qkv[2 * HD + j]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
struct Heads {
  static cudaError_t self(int H, size_t smem, cudaStream_t st, const float* qkv, int M,
                          const bf16* u, const bf16* v, const bf16* wkr, const bf16* kc,
                          const bf16* vc, const int32_t* blocked, int ptr, float scale,
                          float* attn) {
    cudaError_t err = allow_smem(ring_attention<DH>, smem);
    if (err != cudaSuccess) return err;
    ring_attention<DH><<<H, kThreads, smem, st>>>(qkv, H, M, u, v, wkr, kc, vc, blocked, ptr,
                                                  scale, attn);
    return cudaGetLastError();
  }
  static cudaError_t cross(int H, size_t smem, cudaStream_t st, const float* q2, int Le,
                           const bf16* u, const bf16* v, const bf16* cwkr, const bf16* ck,
                           const bf16* cv, const int32_t* cblocked, float scale, float* attn) {
    cudaError_t err = allow_smem(cross_attention<DH>, smem);
    if (err != cudaSuccess) return err;
    cross_attention<DH><<<H, kThreads, smem, st>>>(q2, H, Le, u, v, cwkr, ck, cv, cblocked,
                                                   scale, attn);
    return cudaGetLastError();
  }
};

// One token step through all L decoder layers at batch 1 (see s2s_fused_step).
template <int DH>
int fused_step(const bf16* qkv_w, const bf16* q2_w, const bf16* ff1_w, const bf16* ff2_w,
               const bf16* qkv_b, const bf16* q2_b, const bf16* ff1_b, const bf16* ff2_b,
               const float* ln1_g, const float* ln1_b, const float* ln2_g, const float* ln2_b,
               const float* ln3_g, const float* ln3_b, const bf16* wkr, const bf16* u,
               const bf16* v, bf16* kc, bf16* vc, const bf16* ck, const bf16* cv,
               const bf16* cwkr, const int32_t* cblocked, const float* h_in,
               const int32_t* blocked, float* h_out, float* scratch, int has_cross, int L,
               int D, int Dff, int H, int M, int Le, int ptr, float scale, int act,
               cudaStream_t st) {
  const int HD = H * DH;
  float* qkv = scratch;
  float* attn = qkv + 3 * HD;
  float* h1 = attn + HD;
  float* h2 = h1 + D;
  float* q2 = h2 + D;
  float* ffx = q2 + HD;
  float* part = ffx + Dff;
  const size_t attn_smem = (size_t)(2 * DH + 2 * (M + 1) + 4 * kThreads) * sizeof(float);
  const size_t cross_smem = (size_t)(2 * DH + Le + 4 * kThreads) * sizeof(float);
  const size_t ln_smem = (size_t)D * sizeof(float);
  cudaError_t err = allow_smem(add_layer_norm, ln_smem);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(h_out, h_in, (size_t)D * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < L; ++l) {
    const size_t ring = (size_t)l * H * M * DH;
    // qkv projection with its bias
    if ((err = gemv(false, h_out, 1, D, 3 * HD, qkv_w + (size_t)l * D * 3 * HD, nullptr, part,
                    st)))
      return err;
    gemv_finish<<<ceil_div(3 * HD, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, kKChunk), 1, 3 * HD, qkv_b + (size_t)l * 3 * HD, kNone, qkv);
    if ((err = cudaGetLastError())) return err;
    // self attention over the old ring + the fresh token, then the slot write
    if ((err = Heads<DH>::self(H, attn_smem, st, qkv, M, u, v,
                               wkr + (size_t)l * H * (M + 1) * DH, kc + ring, vc + ring, blocked,
                               ptr, scale, attn)))
      return err;
    ring_slot_write<<<1, kThreads, 0, st>>>(qkv, H, DH, M, ptr, kc + ring, vc + ring);
    if ((err = cudaGetLastError())) return err;
    // post-norm with no output projection; an nw block ends here
    add_layer_norm<<<1, kThreads, ln_smem, st>>>(h_out, attn, 1, 1, D, nullptr,
                                                 ln1_g + (size_t)l * D, ln1_b + (size_t)l * D,
                                                 has_cross ? h1 : h_out);
    if ((err = cudaGetLastError())) return err;
    if (!has_cross) continue;
    // cross attention over the encode-time context
    if ((err = gemv(false, h1, 1, D, HD, q2_w + (size_t)l * D * HD, nullptr, part, st)))
      return err;
    gemv_finish<<<ceil_div(HD, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, kKChunk), 1, HD, q2_b + (size_t)l * HD, kNone, q2);
    if ((err = cudaGetLastError())) return err;
    const size_t c_off = (size_t)l * H * Le * DH;
    if ((err = Heads<DH>::cross(H, cross_smem, st, q2, Le, u, v, cwkr + c_off, ck + c_off,
                                cv + c_off, cblocked, scale, attn)))
      return err;
    add_layer_norm<<<1, kThreads, ln_smem, st>>>(h1, attn, 1, 1, D, nullptr,
                                                 ln2_g + (size_t)l * D, ln2_b + (size_t)l * D, h2);
    if ((err = cudaGetLastError())) return err;
    // feed-forward with biases, residual, post-norm
    if ((err = gemv(false, h2, 1, D, Dff, ff1_w + (size_t)l * D * Dff, nullptr, part, st)))
      return err;
    gemv_finish<<<ceil_div(Dff, kThreads), kThreads, 0, st>>>(
        part, ceil_div(D, kKChunk), 1, Dff, ff1_b + (size_t)l * Dff, act, ffx);
    if ((err = cudaGetLastError())) return err;
    if ((err = gemv(false, ffx, 1, Dff, D, ff2_w + (size_t)l * Dff * D, nullptr, part, st)))
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

// Float32 scratch elements a step needs for these widths.
size_t s2s_fused_scratch_floats(int D, int Dff, int HD) {
  return (size_t)(3 * HD + HD + D + D + HD + Dff) + max_partial(1, D, Dff, HD, kKChunk);
}

// Kernel launches one step makes (for the launch accounting).
int s2s_fused_kernels_per_step(int L, int has_cross) { return (has_cross ? 13 : 5) * L; }

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
// context. Needs Dh in {16, 32, 64, 128} and D, Dff multiples of 4. Returns
// the first CUDA error (0 = cudaSuccess). Does not synchronize.
int s2s_fused_step(const bf16* qkv_w, const bf16* q2_w, const bf16* ff1_w, const bf16* ff2_w,
                   const bf16* qkv_b, const bf16* q2_b, const bf16* ff1_b, const bf16* ff2_b,
                   const float* ln1_g, const float* ln1_b, const float* ln2_g,
                   const float* ln2_b, const float* ln3_g, const float* ln3_b, const bf16* wkr,
                   const bf16* u, const bf16* v, bf16* kc, bf16* vc, const bf16* ck,
                   const bf16* cv, const bf16* cwkr, const int32_t* cblocked,
                   const float* h_in, const int32_t* blocked, float* h_out, float* scratch,
                   int has_cross, int L, int D, int Dff, int H, int Dh, int M, int Le, int ptr,
                   float scale, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define S2S_FUSED_ARGS                                                                       \
  qkv_w, q2_w, ff1_w, ff2_w, qkv_b, q2_b, ff1_b, ff2_b, ln1_g, ln1_b, ln2_g, ln2_b, ln3_g,   \
      ln3_b, wkr, u, v, kc, vc, ck, cv, cwkr, cblocked, h_in, blocked, h_out, scratch,       \
      has_cross, L, D, Dff, H, M, Le, ptr, scale, act, st
  switch (Dh) {
    case 16: return fused_step<16>(S2S_FUSED_ARGS);
    case 32: return fused_step<32>(S2S_FUSED_ARGS);
    case 64: return fused_step<64>(S2S_FUSED_ARGS);
    case 128: return fused_step<128>(S2S_FUSED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2S_FUSED_ARGS
}

}  // extern "C"
