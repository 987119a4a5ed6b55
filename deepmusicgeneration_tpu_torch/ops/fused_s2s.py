"""Fused single-token step through the whole multitask decoder (seq2seq and
next-word), batch 1: over an int8 slot-major self-attention ring (the slab
steps), or exact in bf16 (the fused steps).

``fused_s2s_slab_core`` advances one row by one token through all decoder
layers: self-attention over the ring plus the fresh token (the relative
term rolled by the ring pointer), the in-place write of the fresh token's
quantized K/V into slot ``ptr``, cross-attention over the int8 encode-time
context, the feed-forward with biases, three post-norms.
``fused_nw_slab_core`` is the same step for the next-word task, whose
blocks are attention only. Together they replace the TPU kernel built by
``_make_s2s_slab_kernel`` in ``deepmusicgeneration_tpu/ops/fused_s2s.py``
(``fused_s2s_slab_core`` / ``fused_nw_slab_core``) in both weight modes:
``slab_w8`` (``weights_int8=True``: int8 panels with per-column scales) and
``slab`` (bf16 panels used as they are).

On a CUDA tensor each wrapper launches the hand-written kernel in
``csrc/s2s_slab.cu`` (built with nvcc on first use, bound with ctypes) or
raises; on a CPU tensor it runs :func:`s2s_slab_plain`, the same arithmetic
in plain PyTorch. Unlike the JAX functions, whose cache operands are
donated and aliased, the port updates ``kq``/``ksc``/``vq``/``vsc`` in place
and returns them. Each wrapper's ``launches`` dict counts its kernel
launches by mode.

``fused_s2s_step_core`` / ``fused_nw_step_core`` replace the TPU kernel built
by ``_make_s2s_kernel`` (``fused_s2s_step_core`` / ``fused_nw_step_core``):
the same sweep over a bf16 ring and a bf16 cross context with bf16 weights
and no quantization, through ``csrc/s2s_fused.cu`` on the card and
:func:`s2s_fused_plain` on the CPU. They take the port's head-major layouts
(the TPU kernel takes K transposed) and write the fresh token's K/V into
slot ``ptr`` in place.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple

import torch

from . import _build
from .fused_decode import (BF16, F32, KERNEL_HEAD_DIMS, NEG_INF, _ACT_CODES, _act_tanh,
                           _bf, _check, _ln)

SLAB = 32     # the TPU kernel's slab tile: the engines take the slab modes for mem_len % 32 == 0


def kernel_accepts(cfg) -> bool:
    """Whether ``csrc/s2s_slab.cu`` takes this multitask config's widths:
    d_head in :data:`KERNEL_HEAD_DIMS`, d_model == n_heads * d_head (the
    post-norm adds the attention to the residual with no output projection)
    and d_model, d_inner multiples of 4 (the weight products read four
    columns at a time)."""
    return (cfg.d_head in KERNEL_HEAD_DIMS and cfg.d_model == cfg.n_heads * cfg.d_head
            and cfg.d_model % 4 == 0 and cfg.d_inner % 4 == 0)


class StackedMTDec(NamedTuple):
    """Decoder-stack weights stacked on a leading layer axis.

    ``qkv_w`` joins mha1's q/k/v projections; ``q2_w`` is mha2's query
    projection (the cross K/V live in the encode-time cache). Biases are
    always present (zeros when ``cfg.bias`` is False)."""
    qkv_w: torch.Tensor   # (L, D, 3*H*Dh)
    qkv_b: torch.Tensor   # (L, 1, 3*H*Dh)
    ln1_g: torch.Tensor   # (L, 1, D) fp32, mha1 post-norm
    ln1_b: torch.Tensor
    q2_w: torch.Tensor    # (L, D, H*Dh)
    q2_b: torch.Tensor    # (L, 1, H*Dh)
    ln2_g: torch.Tensor   # (L, 1, D) fp32, mha2 post-norm
    ln2_b: torch.Tensor
    ff1_w: torch.Tensor   # (L, D, Dff)
    ff1_b: torch.Tensor   # (L, 1, Dff)
    ff2_w: torch.Tensor   # (L, Dff, D)
    ff2_b: torch.Tensor   # (L, 1, D)
    ff3_g: torch.Tensor   # (L, 1, D) fp32, feed-forward post-norm
    ff3_b: torch.Tensor
    u: torch.Tensor       # (1, H*Dh), shared by the stack
    v: torch.Tensor       # (1, H*Dh)


def stack_mt_dec_layers(params: Dict, dtype=BF16) -> StackedMTDec:
    ls = params["decoder"]["layers"]
    HD = ls[0]["mha1"]["q_w"].shape[1]
    dev = ls[0]["mha1"]["q_w"].device

    def b_of(x, n):
        return (x.to(dtype) if x is not None else torch.zeros(n, dtype=dtype, device=dev))

    st = lambda f: torch.stack([f(lp) for lp in ls]).contiguous()
    row = lambda f: st(lambda lp: f(lp)[None, :])
    f32 = lambda key, sub=None: row(lambda lp: (lp[sub][key] if sub else lp[key]).to(F32))
    return StackedMTDec(
        qkv_w=st(lambda lp: torch.cat([lp["mha1"][k] for k in ("q_w", "k_w", "v_w")],
                                      dim=1).to(dtype)),
        qkv_b=row(lambda lp: torch.cat([b_of(lp["mha1"][k], HD)
                                        for k in ("q_b", "k_b", "v_b")])),
        ln1_g=f32("ln_g", "mha1"), ln1_b=f32("ln_b", "mha1"),
        q2_w=st(lambda lp: lp["mha2"]["q_w"].to(dtype)),
        q2_b=row(lambda lp: b_of(lp["mha2"]["q_b"], HD)),
        ln2_g=f32("ln_g", "mha2"), ln2_b=f32("ln_b", "mha2"),
        ff1_w=st(lambda lp: lp["ff1_w"].to(dtype)),
        ff1_b=row(lambda lp: b_of(lp["ff1_b"], lp["ff1_w"].shape[1])),
        ff2_w=st(lambda lp: lp["ff2_w"].to(dtype)),
        ff2_b=row(lambda lp: b_of(lp["ff2_b"], lp["ff2_w"].shape[1])),
        ff3_g=f32("ff_ln_g"), ff3_b=f32("ff_ln_b"),
        u=params["decoder"]["u"].to(dtype).reshape(1, -1).contiguous(),
        v=params["decoder"]["v"].to(dtype).reshape(1, -1).contiguous(),
    )


def quantize_mt_weights(stacked: StackedMTDec):
    """Per-output-column int8 quantization of the four big weight panels
    (scale = max(max |w|, 1e-6) / 127, round half to even).

    Returns (StackedMTDec with int8 qkv/q2/ff1/ff2 panels, w_scales
    (L, 8, SMAX) f32: row 0 qkv, 1 q2, 2 ff1, 3 ff2, padded to the widest
    panel). Biases, LayerNorms, u and v are kept. Bit-identical to the JAX
    package's quantizer."""
    def q(panel):
        f = panel.to(F32)
        s = torch.clamp_min(f.abs().amax(dim=1), 1e-6) / 127.0          # (L, cols)
        return torch.clamp(torch.round(f / s[:, None, :]), -127, 127).to(torch.int8), s

    panels = [q(p) for p in (stacked.qkv_w, stacked.q2_w, stacked.ff1_w, stacked.ff2_w)]
    L = stacked.qkv_w.shape[0]
    smax = max(s.shape[1] for _, s in panels)
    w_scales = torch.zeros((L, 8, smax), dtype=F32, device=stacked.qkv_w.device)
    for row, (_, s) in enumerate(panels):
        w_scales[:, row, :s.shape[1]] = s
    (qkv, _), (q2, _), (ff1, _), (ff2, _) = panels
    return stacked._replace(qkv_w=qkv, q2_w=q2, ff1_w=ff1, ff2_w=ff2), w_scales


def quantize_cross_slot_major(cross):
    """A ``models.multitask.CrossCache`` (batch 1) → slot-major int8 panels,
    per-slot scales and the bf16 relative keys: (ckq (L, Le, HD) int8, cksc
    (L, Le, 1) f32, cvq, cvsc, cwkr_mt (L, Le, HD) bf16). Per-slot scales as
    the self cache's (``fused_decode.quantize_kv_slot_major``); bit-identical
    to the JAX package's quantizer."""
    def sm(x):
        if x.dim() == 5:
            x = x[:, 0]
        L, H, Le, Dh = x.shape
        return x.permute(0, 2, 1, 3).reshape(L, Le, H * Dh)

    def q(panel):
        f = panel.to(F32)
        s = torch.clamp_min(f.abs().amax(dim=-1, keepdim=True), 1e-6) / 127.0
        return (torch.clamp(torch.round(f / s), -127, 127).to(torch.int8).contiguous(),
                s.contiguous())

    ckq, cksc = q(sm(cross.k))
    cvq, cvsc = q(sm(cross.v))
    return ckq, cksc, cvq, cvsc, sm(cross.wkr).to(BF16).contiguous()


def s2s_slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kq, ksc, vq, vsc,
                   ckq, cksc, cvq, cvsc, cwkr_mt, cblocked, blocked, ptr: int, M: int,
                   acc: torch.dtype = F32):
    """Plain PyTorch version of the step (``ckq is None``: the next-word
    blocks), with the kernel's arithmetic and bf16 cast points; updates the
    self cache in place and returns (h_out, kq, ksc, vq, vsc). ``w_scales``
    given: int8 panels dequantized per column and rounded to bf16
    (``slab_w8``); ``None``: bf16 panels used as they are (``slab``).

    ``acc`` is the dtype of everything between the bf16 cast points:
    float32, as in the kernel, or float64 for a reference of how far a
    float32 summation order drifts."""
    L, D, Dff = cfg.dec_layers, cfg.d_model, cfg.d_inner
    H, Dh = cfg.n_heads, cfg.d_head
    HD = H * Dh
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    has_cross = ckq is not None
    h = h_in.to(acc)                                          # (1, D)
    masked = blocked[0] != 0                                  # (M,)
    if has_cross:
        cmasked = cblocked[0] != 0                            # (Le,)
    bias = lambda b, l: b[l].to(acc)                          # (1, n)

    def queries(q):
        """bf16(bf16(q) + u) and bf16(bf16(q) + v) per head: (H, Dh)."""
        qb = q.to(BF16)
        return ((qb + stacked.u).to(acc).reshape(H, Dh),
                (qb + stacked.v).to(acc).reshape(H, Dh))

    for l in range(L):
        if w_scales is None:
            deq = lambda w, row, n: w[l].to(acc)
        else:
            deq = lambda w, row, n: _bf(w[l].to(acc) * w_scales[l, row:row + 1, :n], acc)
        qkv = _bf(h, acc) @ deq(stacked.qkv_w, 0, 3 * HD) + bias(stacked.qkv_b, l)
        q, k1, v1 = qkv[0, :HD], qkv[0, HD:2 * HD], qkv[0, 2 * HD:]

        # self attention over the old ring slots and the fresh token
        qu, qv = queries(q)
        sd = torch.einsum("mhd,hd->hm", wkr_mt[l].to(acc).reshape(M + 1, H, Dh), qv)
        ac = torch.einsum("mhd,hd->hm", kq[l, 0].to(acc).reshape(M, H, Dh), qu)
        ac = ac * ksc[l, 0, :, 0]
        score = torch.where(masked, NEG_INF, (ac + torch.roll(sd[:, :M], ptr, dims=-1)) * scale)
        self_score = ((qu * k1.reshape(H, Dh)).sum(-1) + sd[:, M]) * scale
        mx = torch.maximum(score.amax(-1), self_score)
        e = torch.exp(score - mx[:, None])
        e_self = torch.exp(self_score - mx)
        denom = e.sum(-1) + e_self
        pv = torch.einsum("hm,mhd->hd", _bf(e * vsc[l, 0, :, 0], acc),
                          vq[l, 0].to(acc).reshape(M, H, Dh))
        attn = (pv + e_self[:, None] * v1.reshape(H, Dh)) / denom[:, None]

        for cache, scales, x in ((kq, ksc, k1), (vq, vsc, v1)):
            s = torch.clamp_min(x.abs().amax(), 1e-6) * (1.0 / 127.0)
            cache[l, 0, ptr] = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            scales[l, 0, ptr] = s

        h1 = _ln(h + attn.reshape(1, HD), stacked.ln1_g[l], stacked.ln1_b[l])
        if not has_cross:            # next-word blocks: attention only
            h = h1
            continue

        # cross attention over the encode-time context
        q2 = _bf(h1, acc) @ deq(stacked.q2_w, 1, HD) + bias(stacked.q2_b, l)
        qu2, qv2 = queries(q2[0])
        Le = ckq.shape[1]
        ac2 = torch.einsum("mhd,hd->hm", ckq[l].to(acc).reshape(Le, H, Dh), qu2)
        bd2 = torch.einsum("mhd,hd->hm", cwkr_mt[l].to(acc).reshape(Le, H, Dh), qv2)
        score2 = torch.where(cmasked, NEG_INF, (ac2 * cksc[l, :, 0] + bd2) * scale)
        e2 = torch.exp(score2 - score2.amax(-1, keepdim=True))
        pv2 = torch.einsum("hm,mhd->hd", _bf(e2 * cvsc[l, :, 0], acc),
                           cvq[l].to(acc).reshape(Le, H, Dh))
        attn2 = pv2 / e2.sum(-1)[:, None]
        h2 = _ln(h1 + attn2.reshape(1, HD), stacked.ln2_g[l], stacked.ln2_b[l])

        ffx = _act_tanh(_bf(h2, acc) @ deq(stacked.ff1_w, 2, Dff) + bias(stacked.ff1_b, l),
                        cfg.act)
        ffy = _bf(ffx, acc) @ deq(stacked.ff2_w, 3, D) + bias(stacked.ff2_b, l)
        h = _ln(h2 + ffy, stacked.ff3_g[l], stacked.ff3_b[l])
    return h, kq, ksc, vq, vsc


def s2s_fused_plain(stacked, cfg, h_in, wkr, kc, vc, ck, cv, cwkr, cblocked, blocked,
                    ptr: int, M: int, acc: torch.dtype = F32):
    """Plain PyTorch version of the fused step (``ck is None``: the
    next-word blocks), with the TPU kernel's arithmetic and bf16 cast points:
    qu / qv rounded after the bias add, the fresh token's self term from the
    float32 k1 / v1, the unnormalized exponentials rounded to bf16 before
    P.V and divided after, float32 post-norms, tanh GELU. Writes bf16(k1),
    bf16(v1) into slot ``ptr`` of ``kc`` / ``vc`` in place and returns
    (h_out, kc, vc).

    ``acc`` is the dtype of everything between the bf16 cast points:
    float32, as in the kernel, or float64 for a reference of how far a
    float32 summation order drifts."""
    L, D, Dff = cfg.dec_layers, cfg.d_model, cfg.d_inner
    H, Dh = cfg.n_heads, cfg.d_head
    HD = H * Dh
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    has_cross = ck is not None
    h = h_in.to(acc)                                          # (1, D)
    masked = blocked[0] != 0                                  # (M,)
    bias = lambda b, l: b[l].to(acc)                          # (1, n)
    w = lambda panel, l: panel[l].to(acc)

    def queries(q):
        """bf16(bf16(q) + u) and bf16(bf16(q) + v) per head: (H, Dh)."""
        qb = q.to(BF16)
        return ((qb + stacked.u).to(acc).reshape(H, Dh),
                (qb + stacked.v).to(acc).reshape(H, Dh))

    for l in range(L):
        qkv = _bf(h, acc) @ w(stacked.qkv_w, l) + bias(stacked.qkv_b, l)
        q, k1, v1 = qkv[0, :HD], qkv[0, HD:2 * HD], qkv[0, 2 * HD:]

        # self attention over the old ring slots and the fresh token
        qu, qv = queries(q)
        sd = torch.einsum("hmd,hd->hm", wkr[l].to(acc), qv)             # (H, M + 1)
        ac = torch.einsum("hmd,hd->hm", kc[l, 0].to(acc), qu)           # (H, M)
        score = torch.where(masked, NEG_INF, (ac + torch.roll(sd[:, :M], ptr, dims=-1)) * scale)
        self_score = ((qu * k1.reshape(H, Dh)).sum(-1) + sd[:, M]) * scale
        mx = torch.maximum(score.amax(-1), self_score)
        e = torch.exp(score - mx[:, None])
        e_self = torch.exp(self_score - mx)
        denom = e.sum(-1) + e_self
        pv = torch.einsum("hm,hmd->hd", _bf(e, acc), vc[l, 0].to(acc))
        attn = (pv + e_self[:, None] * v1.reshape(H, Dh)) / denom[:, None]
        kc[l, 0, :, ptr] = k1.reshape(H, Dh).to(kc.dtype)
        vc[l, 0, :, ptr] = v1.reshape(H, Dh).to(vc.dtype)

        h1 = _ln(h + attn.reshape(1, HD), stacked.ln1_g[l], stacked.ln1_b[l])
        if not has_cross:            # next-word blocks: attention only
            h = h1
            continue

        # cross attention over the encode-time context
        q2 = _bf(h1, acc) @ w(stacked.q2_w, l) + bias(stacked.q2_b, l)
        qu2, qv2 = queries(q2[0])
        score2 = (torch.einsum("hmd,hd->hm", ck[l].to(acc), qu2)
                  + torch.einsum("hmd,hd->hm", cwkr[l].to(acc), qv2)) * scale
        score2 = torch.where(cblocked[0] != 0, NEG_INF, score2)
        e2 = torch.exp(score2 - score2.amax(-1, keepdim=True))
        attn2 = torch.einsum("hm,hmd->hd", _bf(e2, acc), cv[l].to(acc)) / e2.sum(-1)[:, None]
        h2 = _ln(h1 + attn2.reshape(1, HD), stacked.ln2_g[l], stacked.ln2_b[l])

        ffx = _act_tanh(_bf(h2, acc) @ w(stacked.ff1_w, l) + bias(stacked.ff1_b, l), cfg.act)
        ffy = _bf(ffx, acc) @ w(stacked.ff2_w, l) + bias(stacked.ff2_b, l)
        h = _ln(h2 + ffy, stacked.ff3_g[l], stacked.ff3_b[l])
    return h, kc, vc


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fused_lib() -> ctypes.CDLL:
    lib = _build.load("s2s_fused")
    lib.s2s_fused_step.restype = ctypes.c_int
    lib.s2s_fused_step.argtypes = [_P] * 27 + [_I] * 9 + [ctypes.c_float, _I, _P]
    lib.s2s_fused_scratch_floats.restype = ctypes.c_size_t
    lib.s2s_fused_scratch_floats.argtypes = [_I] * 3
    lib.s2s_fused_kernels_per_step.restype = ctypes.c_int
    lib.s2s_fused_kernels_per_step.argtypes = [_I] * 2
    lib.s2s_fused_error_string.restype = ctypes.c_char_p
    lib.s2s_fused_error_string.argtypes = [_I]
    return lib


def fused_kernels_per_step(n_layers: int, has_cross: bool) -> int:
    """CUDA kernel launches inside one ``fused_s2s_step_core`` (``has_cross``)
    or ``fused_nw_step_core`` launch."""
    return _fused_lib().s2s_fused_kernels_per_step(n_layers, int(has_cross))


def _fused_core(wrapper, stacked, cfg, h_in, wkr, kc, vc, cross, blocked, ptr, M):
    """Check the operands of either fused step, then the plain version for
    CPU tensors or ``csrc/s2s_fused.cu``'s step; ``cross`` is (ck, cv, cwkr,
    cblocked) or None."""
    ptr = int(ptr)
    if not 0 <= ptr < M:
        raise ValueError(f"ptr={ptr} outside [0, {M})")
    if cfg.act not in _ACT_CODES:
        raise ValueError(f"unsupported activation {cfg.act!r}")
    L, D, Dff, H, Dh = cfg.dec_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head
    HD = H * Dh
    dev = h_in.device
    checks = [("qkv_w", stacked.qkv_w, BF16, (L, D, 3 * HD)),
              ("qkv_b", stacked.qkv_b, BF16, (L, 1, 3 * HD)),
              ("ln1_g", stacked.ln1_g, F32, (L, 1, D)), ("ln1_b", stacked.ln1_b, F32, (L, 1, D)),
              ("u", stacked.u, BF16, (1, HD)), ("v", stacked.v, BF16, (1, HD)),
              ("h_in", h_in, F32, (1, D)), ("wkr", wkr, BF16, (L, H, M + 1, Dh)),
              ("kc", kc, BF16, (L, 1, H, M, Dh)), ("vc", vc, BF16, (L, 1, H, M, Dh)),
              ("blocked", blocked, torch.int32, (1, M))]
    Le = 0
    if cross is not None:
        ck, cv, cwkr, cblocked = cross
        Le = ck.shape[2] if isinstance(ck, torch.Tensor) and ck.dim() == 4 else 0
        checks += [("q2_w", stacked.q2_w, BF16, (L, D, HD)),
                   ("q2_b", stacked.q2_b, BF16, (L, 1, HD)),
                   ("ln2_g", stacked.ln2_g, F32, (L, 1, D)),
                   ("ln2_b", stacked.ln2_b, F32, (L, 1, D)),
                   ("ff1_w", stacked.ff1_w, BF16, (L, D, Dff)),
                   ("ff1_b", stacked.ff1_b, BF16, (L, 1, Dff)),
                   ("ff2_w", stacked.ff2_w, BF16, (L, Dff, D)),
                   ("ff2_b", stacked.ff2_b, BF16, (L, 1, D)),
                   ("ff3_g", stacked.ff3_g, F32, (L, 1, D)),
                   ("ff3_b", stacked.ff3_b, F32, (L, 1, D)),
                   ("ck", ck, BF16, (L, H, Le, Dh)), ("cv", cv, BF16, (L, H, Le, Dh)),
                   ("cwkr", cwkr, BF16, (L, H, Le, Dh)),
                   ("cblocked", cblocked, torch.int32, (1, Le))]
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return s2s_fused_plain(stacked, cfg, h_in, wkr, kc, vc, *(cross or (None,) * 4),
                               blocked, ptr, M)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not kernel_accepts(cfg):
        raise ValueError(f"the fused s2s kernel needs d_head in {KERNEL_HEAD_DIMS}, "
                         "d_model == n_heads * d_head and widths that are multiples of 4")
    lib = _fused_lib()
    h_out = torch.empty((1, D), dtype=F32, device=dev)
    scratch = torch.empty(lib.s2s_fused_scratch_floats(D, Dff, HD), dtype=F32, device=dev)
    ck, cv, cwkr, cblocked = cross or (None,) * 4
    ptrs = [stacked.qkv_w, stacked.q2_w, stacked.ff1_w, stacked.ff2_w,
            stacked.qkv_b, stacked.q2_b, stacked.ff1_b, stacked.ff2_b,
            stacked.ln1_g, stacked.ln1_b, stacked.ln2_g, stacked.ln2_b,
            stacked.ff3_g, stacked.ff3_b, wkr, stacked.u, stacked.v, kc, vc,
            ck, cv, cwkr, cblocked, h_in, blocked, h_out, scratch]
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s2s_fused_step(*[None if t is None else t.data_ptr() for t in ptrs],
                                 int(cross is not None), L, D, Dff, H, Dh, M, Le, ptr, scale,
                                 _ACT_CODES[cfg.act], stream)
    if err != 0:
        raise RuntimeError(f"fused s2s kernel failed: CUDA error {err} "
                           f"({lib.s2s_fused_error_string(err).decode()})")
    wrapper.launches["fused"] += 1
    return h_out, kc, vc


def fused_s2s_step_core(
    stacked: StackedMTDec,       # bf16 panels
    cfg,
    h_in: torch.Tensor,          # (1, D) fp32 embedded token
    wkr: torch.Tensor,           # (L, H, M+1, Dh) bf16 self relative keys
    kc: torch.Tensor,            # (L, 1, H, M, Dh) bf16 self K ring
    vc: torch.Tensor,            # (L, 1, H, M, Dh) bf16 self V ring
    ck: torch.Tensor,            # (L, H, Le, Dh) bf16 cross K
    cv: torch.Tensor,            # (L, H, Le, Dh) bf16 cross V
    cwkr: torch.Tensor,          # (L, H, Le, Dh) bf16 cross relative keys
    cblocked: torch.Tensor,      # (1, Le) int32 encoder padding
    blocked: torch.Tensor,       # (1, M) int32 ring-slot mask
    ptr: int,                    # ring slot to overwrite, 0 <= ptr < M
    mem_len: int,
):
    """Exact bf16 seq2seq decode step. Returns (h_out (1, D) f32, kc, vc),
    the ring updated in place in slot ``ptr``. The TPU kernel's
    ``layers_per_cell`` grid tiling has no counterpart here."""
    return _fused_core(fused_s2s_step_core, stacked, cfg, h_in, wkr, kc, vc,
                       (ck, cv, cwkr, cblocked), blocked, ptr, mem_len)


def fused_nw_step_core(stacked, cfg, h_in, wkr, kc, vc, blocked, ptr, mem_len: int):
    """Exact bf16 next-word decode step: attention-only blocks, otherwise as
    :func:`fused_s2s_step_core`."""
    return _fused_core(fused_nw_step_core, stacked, cfg, h_in, wkr, kc, vc, None, blocked,
                       ptr, mem_len)


# kernel launches (CUDA tensors only)
fused_s2s_step_core.launches = {"fused": 0}
fused_nw_step_core.launches = {"fused": 0}


@functools.lru_cache(maxsize=None)
def _s2s_lib() -> ctypes.CDLL:
    lib = _build.load("s2s_slab")
    for step in (lib.s2s_slab_w8_step, lib.s2s_slab_step):
        step.restype = ctypes.c_int
        step.argtypes = [_P] * 32 + [_I] * 10 + [ctypes.c_float, _I, _P]
    lib.s2s_slab_scratch_floats.restype = ctypes.c_size_t
    lib.s2s_slab_scratch_floats.argtypes = [_I] * 3
    lib.s2s_slab_kernels_per_step.restype = ctypes.c_int
    lib.s2s_slab_kernels_per_step.argtypes = [_I] * 2
    lib.s2s_slab_error_string.restype = ctypes.c_char_p
    lib.s2s_slab_error_string.argtypes = [_I]
    return lib


def kernels_per_step(n_layers: int, has_cross: bool) -> int:
    """CUDA kernel launches inside one ``fused_s2s_slab_core`` (``has_cross``)
    or ``fused_nw_slab_core`` launch."""
    return _s2s_lib().s2s_slab_kernels_per_step(n_layers, int(has_cross))


def _launch(mode: str, stacked, w_scales, cfg, h_in, wkr_mt, kq, ksc, vq, vsc,
            cross, blocked, ptr: int, M: int):
    """Run ``csrc/s2s_slab.cu``'s step in ``mode`` (slab_w8 or slab);
    ``cross`` is (ckq, cksc, cvq, cvsc, cwkr_mt, cblocked) or None."""
    lib = _s2s_lib()
    L, D, Dff, H, Dh = cfg.dec_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head
    dev = h_in.device
    h_out = torch.empty((1, D), dtype=F32, device=dev)
    scratch = torch.empty(lib.s2s_slab_scratch_floats(D, Dff, H * Dh), dtype=F32, device=dev)
    Le = cross[0].shape[1] if cross is not None else 0
    ptrs = [stacked.qkv_w, stacked.q2_w, stacked.ff1_w, stacked.ff2_w, w_scales,
            stacked.qkv_b, stacked.q2_b, stacked.ff1_b, stacked.ff2_b,
            stacked.ln1_g, stacked.ln1_b, stacked.ln2_g, stacked.ln2_b,
            stacked.ff3_g, stacked.ff3_b, wkr_mt, stacked.u, stacked.v,
            kq, ksc, vq, vsc, *(cross or [None] * 6), h_in, blocked, h_out, scratch]
    smax = 0 if w_scales is None else w_scales.shape[2]
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    fn = lib.s2s_slab_w8_step if mode == "slab_w8" else lib.s2s_slab_step
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in ptrs],
                 int(cross is not None), L, D, Dff, H, Dh, M, Le, smax, ptr,
                 scale, _ACT_CODES[cfg.act], stream)
    if err != 0:
        raise RuntimeError(f"s2s slab kernel ({mode}) failed: CUDA error {err} "
                           f"({lib.s2s_slab_error_string(err).decode()})")
    return h_out, kq, ksc, vq, vsc


def _check_inputs(stacked, cfg, h_in, wkr_mt, kq, ksc, vq, vsc, cross, blocked,
                  ptr: int, M: int, weights_int8: bool, w_scales):
    """Validate the operands of either step; returns the device."""
    if weights_int8 and w_scales is None:
        raise ValueError("weights_int8=True requires w_scales (from quantize_mt_weights)")
    if M % SLAB:
        raise ValueError(f"mem_len={M} must be a multiple of {SLAB}")
    if not 0 <= ptr < M:
        raise ValueError(f"ptr={ptr} outside [0, {M})")
    if cfg.act not in _ACT_CODES:
        raise ValueError(f"unsupported activation {cfg.act!r}")
    L, D, Dff = cfg.dec_layers, cfg.d_model, cfg.d_inner
    HD = cfg.n_heads * cfg.d_head
    dev = h_in.device
    wdt = torch.int8 if weights_int8 else BF16
    checks = [("qkv_w", stacked.qkv_w, wdt, (L, D, 3 * HD)),
              ("qkv_b", stacked.qkv_b, BF16, (L, 1, 3 * HD)),
              ("ln1_g", stacked.ln1_g, F32, (L, 1, D)),
              ("ln1_b", stacked.ln1_b, F32, (L, 1, D)),
              ("u", stacked.u, BF16, (1, HD)), ("v", stacked.v, BF16, (1, HD)),
              ("h_in", h_in, F32, (1, D)),
              ("wkr_mt", wkr_mt, BF16, (L, M + 1, HD)),
              ("kq", kq, torch.int8, (L, 1, M, HD)), ("ksc", ksc, F32, (L, 1, M, 1)),
              ("vq", vq, torch.int8, (L, 1, M, HD)), ("vsc", vsc, F32, (L, 1, M, 1)),
              ("blocked", blocked, torch.int32, (1, M))]
    if cross is not None:
        ckq, cksc, cvq, cvsc, cwkr_mt, cblocked = cross
        Le = ckq.shape[1] if isinstance(ckq, torch.Tensor) else 0
        checks += [("q2_w", stacked.q2_w, wdt, (L, D, HD)),
                   ("q2_b", stacked.q2_b, BF16, (L, 1, HD)),
                   ("ln2_g", stacked.ln2_g, F32, (L, 1, D)),
                   ("ln2_b", stacked.ln2_b, F32, (L, 1, D)),
                   ("ff1_w", stacked.ff1_w, wdt, (L, D, Dff)),
                   ("ff1_b", stacked.ff1_b, BF16, (L, 1, Dff)),
                   ("ff2_w", stacked.ff2_w, wdt, (L, Dff, D)),
                   ("ff2_b", stacked.ff2_b, BF16, (L, 1, D)),
                   ("ff3_g", stacked.ff3_g, F32, (L, 1, D)),
                   ("ff3_b", stacked.ff3_b, F32, (L, 1, D)),
                   ("ckq", ckq, torch.int8, (L, Le, HD)), ("cksc", cksc, F32, (L, Le, 1)),
                   ("cvq", cvq, torch.int8, (L, Le, HD)), ("cvsc", cvsc, F32, (L, Le, 1)),
                   ("cwkr_mt", cwkr_mt, BF16, (L, Le, HD)),
                   ("cblocked", cblocked, torch.int32, (1, Le))]
    if weights_int8:
        checks.append(("w_scales", w_scales, F32, (L, 8, max(3 * HD, D, Dff))))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    if dev.type == "cuda" and not kernel_accepts(cfg):
        raise ValueError(f"the s2s slab kernel needs d_head in {KERNEL_HEAD_DIMS}, "
                         "d_model == n_heads * d_head and widths that are multiples of 4")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _core(wrapper, stacked, cfg, h_in, wkr_mt, kq, ksc, vq, vsc, cross, blocked, ptr,
          mem_len, weights_int8, w_scales):
    ptr = int(ptr)
    w_scales = w_scales if weights_int8 else None
    dev = _check_inputs(stacked, cfg, h_in, wkr_mt, kq, ksc, vq, vsc, cross, blocked,
                        ptr, mem_len, weights_int8, w_scales)
    if dev.type == "cpu":
        ckq, cksc, cvq, cvsc, cwkr_mt, cblocked = cross or [None] * 6
        return s2s_slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kq, ksc, vq, vsc,
                              ckq, cksc, cvq, cvsc, cwkr_mt, cblocked, blocked, ptr, mem_len)
    mode = "slab_w8" if weights_int8 else "slab"
    out = _launch(mode, stacked, w_scales, cfg, h_in, wkr_mt, kq, ksc, vq, vsc, cross,
                  blocked, ptr, mem_len)
    wrapper.launches[mode] += 1
    return out


def fused_s2s_slab_core(
    stacked: StackedMTDec,       # int8 panels when weights_int8
    cfg,
    h_in: torch.Tensor,          # (1, D) fp32 embedded token
    wkr_mt: torch.Tensor,        # (L, M+1, HD) bf16 self relative keys
    kq: torch.Tensor,            # (L, 1, M, HD) int8 slot-major self K
    ksc: torch.Tensor,           # (L, 1, M, 1) f32 per-slot scales
    vq: torch.Tensor,
    vsc: torch.Tensor,
    ckq: torch.Tensor,           # (L, Le, HD) int8 cross K
    cksc: torch.Tensor,          # (L, Le, 1) f32
    cvq: torch.Tensor,
    cvsc: torch.Tensor,
    cwkr_mt: torch.Tensor,       # (L, Le, HD) bf16 cross relative keys
    cblocked: torch.Tensor,      # (1, Le) int32 encoder padding
    blocked: torch.Tensor,       # (1, M) int32 ring-slot mask
    ptr: int,                    # ring slot to overwrite, 0 <= ptr < M
    mem_len: int,
    weights_int8: bool = False,
    w_scales: torch.Tensor = None,   # (L, 8, SMAX) f32
):
    """Slab seq2seq decode step. Returns (h_out (1, D) f32, kq, ksc, vq,
    vsc), the self cache updated in place in slot ``ptr``. The TPU kernel's
    ``layers_per_cell`` grid tiling has no counterpart here."""
    return _core(fused_s2s_slab_core, stacked, cfg, h_in, wkr_mt, kq, ksc, vq, vsc,
                 (ckq, cksc, cvq, cvsc, cwkr_mt, cblocked), blocked, ptr, mem_len,
                 weights_int8, w_scales)


def fused_nw_slab_core(stacked, cfg, h_in, wkr_mt, kq, ksc, vq, vsc, blocked, ptr,
                       mem_len: int, weights_int8: bool = False, w_scales=None):
    """Slab next-word decode step: attention-only blocks, otherwise as
    :func:`fused_s2s_slab_core`."""
    return _core(fused_nw_slab_core, stacked, cfg, h_in, wkr_mt, kq, ksc, vq, vsc, None,
                 blocked, ptr, mem_len, weights_int8, w_scales)


# kernel launches by mode (CUDA tensors only)
fused_s2s_slab_core.launches = {"slab_w8": 0, "slab": 0}
fused_nw_slab_core.launches = {"slab_w8": 0, "slab": 0}
