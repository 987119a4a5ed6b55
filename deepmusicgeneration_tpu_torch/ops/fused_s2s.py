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
from .flash_train import _on_device
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


# ---------------------------------------------------------------------------
# The persistent step's work plan (csrc/s2s_step.cuh: gemv_plan, chunk_plan,
# step_plan and the kernel's phase loop) with the kernel's constants, and a
# plain run of a step through it: the tests hold the schedule with these.

GEMV_COLS = 64                           # output columns a weight item
GEMV_ITEMS = 128                         # a product's item target
GEMV_MIN_CHUNK, GEMV_MAX_CHUNK = 32, 128  # K rows an item
ATTN_ITEMS = 64                          # an attention phase's item target
ATTN_MIN_CHUNK, ATTN_MAX_CHUNK = 16, 256  # positions an item
ATTN_TILE_ELEMS = 8192                   # cap on 2 x chunk x d_head


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemv_plan(K: int, N: int):
    """(kc, tiles, chunks) of a weight product (K, N): items are (column tile
    of GEMV_COLS, chunk of kc K rows), item = tile * chunks + chunk."""
    tiles, kc = _cdiv(N, GEMV_COLS), GEMV_MIN_CHUNK
    while kc < GEMV_MAX_CHUNK and tiles * _cdiv(K, kc) > GEMV_ITEMS:
        kc *= 2
    return kc, tiles, _cdiv(K, kc)


def chunk_plan(n: int, H: int, Dh: int):
    """(S, nc): positions a chunk and chunks a head of an attention phase
    over n positions; items are (head, chunk), item = head * nc + chunk."""
    S = ATTN_MIN_CHUNK
    while S < ATTN_MAX_CHUNK and 2 * S * Dh <= ATTN_TILE_ELEMS and H * _cdiv(n, S) > ATTN_ITEMS:
        S *= 2
    return S, (_cdiv(n, S) if n > 0 else 0)


class Phase(NamedTuple):
    """One phase of the persistent step, between two grid barriers.

    ``fold`` is what every block first computes from earlier phases'
    partials (``("ln3", l)``, ``("ln1", l)``, ``("ln2", l)`` or None);
    ``write`` the layer whose slot ``ptr`` block 0 then writes (-1: none);
    ``items`` the work items: ``("gemv", chunk, n0, n1, k0, k1)`` writes
    partial[chunk][n0:n1] of the product over K rows k0:k1; ``("attn",
    head, chunk, p0, p1)`` covers positions p0:p1 (ring positions of the
    self ring, slot (p + ptr) mod M; encoder positions of the cross
    context). The last phase, "end", is block 0's alone."""
    kind: str
    layer: int
    fold: tuple
    write: int
    items: tuple


def step_plan(cfg, M: int, Le: int, has_cross: bool):
    """The phases of one step in the kernel's order: 8 a s2s layer (qkv, ssc,
    spv, q2, csc, cpv, ff1, ff2), 3 a nw layer (qkv, ssc, spv), then "end".
    Depends on the shape only, never on the grid."""
    L, D, Dff, H, Dh = cfg.dec_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head
    HD = H * Dh

    def gemv(K, N):
        kc, tiles, chunks = gemv_plan(K, N)
        return tuple(("gemv", c, t * GEMV_COLS, min(N, (t + 1) * GEMV_COLS), c * kc,
                      min(K, (c + 1) * kc)) for t in range(tiles) for c in range(chunks))

    def attn(n):
        S, nc = chunk_plan(n, H, Dh)
        return tuple(("attn", h, c, c * S, min(n, (c + 1) * S)) for h in range(H)
                     for c in range(nc))

    phases = []
    for l in range(L):
        fold, write = None, -1
        if l and has_cross:
            fold = ("ln3", l - 1)
        elif l:
            fold, write = ("ln1", l - 1), l - 1
        phases += [Phase("qkv", l, fold, write, gemv(D, 3 * HD)),
                   Phase("ssc", l, None, -1, attn(M)), Phase("spv", l, None, -1, attn(M))]
        if has_cross:
            phases += [Phase("q2", l, ("ln1", l), l, gemv(D, HD)),
                       Phase("csc", l, None, -1, attn(Le)), Phase("cpv", l, None, -1, attn(Le)),
                       Phase("ff1", l, ("ln2", l), -1, gemv(D, Dff)),
                       Phase("ff2", l, None, -1, gemv(Dff, D))]
    end = ("ln3", L - 1) if has_cross else ("ln1", L - 1)
    phases.append(Phase("end", L - 1, end, -1 if has_cross else L - 1, ()))
    return phases


class _SlabFormat:
    """The slab step's operands as ``_planned_step`` reads them."""

    def __init__(self, stacked, w_scales, wkr_mt, kq, ksc, vq, vsc, cross, Dh, acc):
        self.s, self.ws, self.wkr, self.acc, self.Dh = stacked, w_scales, wkr_mt, acc, Dh
        self.kq, self.ksc, self.vq, self.vsc = kq, ksc, vq, vsc
        self.ckq, self.cksc, self.cvq, self.cvsc, self.cwkr = cross or (None,) * 5

    def weight(self, name, l):
        w = getattr(self.s, f"{name}_w")[l].to(self.acc)
        if self.ws is None:
            return w
        row = ("qkv", "q2", "ff1", "ff2").index(name)
        return _bf(w * self.ws[l, row:row + 1, :w.shape[1]], self.acc)

    def head(self, t, h):
        return t[..., h * self.Dh:(h + 1) * self.Dh].to(self.acc)

    def scores(self, self_, l, h, slots, pos, qu, qv):
        if self_:
            k, ks, w = self.kq[l, 0][slots], self.ksc[l, 0, slots, 0], self.wkr[l][pos]
        else:
            k, ks, w = self.ckq[l][slots], self.cksc[l, slots, 0], self.cwkr[l][slots]
        return (self.head(k, h) @ qu) * ks + self.head(w, h) @ qv

    def fresh_bd(self, l, h, qv):
        return self.head(self.wkr[l][-1], h) @ qv

    def values(self, self_, l, h, slots, e):
        v, vs = ((self.vq[l, 0][slots], self.vsc[l, 0, slots, 0]) if self_
                 else (self.cvq[l][slots], self.cvsc[l, slots, 0]))
        return _bf(e * vs, self.acc) @ self.head(v, h)

    def write(self, l, k1, v1, ptr):
        for cache, scales, x in ((self.kq, self.ksc, k1), (self.vq, self.vsc, v1)):
            s = torch.clamp_min(x.abs().amax(), 1e-6) * (1.0 / 127.0)
            cache[l, 0, ptr] = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            scales[l, 0, ptr] = s


class _FusedFormat:
    """The fused step's operands (bf16, head-major) as ``_planned_step``
    reads them."""

    def __init__(self, stacked, wkr, kc, vc, cross, acc):
        self.s, self.wkr, self.kc, self.vc, self.acc = stacked, wkr, kc, vc, acc
        self.ck, self.cv, self.cwkr = cross or (None,) * 3

    def weight(self, name, l):
        return getattr(self.s, f"{name}_w")[l].to(self.acc)

    def scores(self, self_, l, h, slots, pos, qu, qv):
        if self_:
            k, w = self.kc[l, 0, h][slots], self.wkr[l, h][pos]
        else:
            k, w = self.ck[l, h][slots], self.cwkr[l, h][slots]
        return k.to(self.acc) @ qu + w.to(self.acc) @ qv

    def fresh_bd(self, l, h, qv):
        return self.wkr[l, h, -1].to(self.acc) @ qv

    def values(self, self_, l, h, slots, e):
        v = self.vc[l, 0, h][slots] if self_ else self.cv[l, h][slots]
        return _bf(e, self.acc) @ v.to(self.acc)

    def write(self, l, k1, v1, ptr):
        H = self.kc.shape[2]
        self.kc[l, 0, :, ptr] = k1.reshape(H, -1).to(self.kc.dtype)
        self.vc[l, 0, :, ptr] = v1.reshape(H, -1).to(self.vc.dtype)


def _planned_step(plan, fmt, stacked, cfg, h_in, blocked, cblocked, ptr: int, M: int, acc,
                  grid: int):
    """One step through ``plan`` as a ``grid``-block launch walks it (block
    b takes items b, b + grid, ...): split-K partials, each chunk's scores
    and max, the probabilities under the head's global max, every combine in
    chunk order. Returns h_out (1, D)."""
    D, Dff, H, Dh = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head
    HD = H * Dh
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    width = {"qkv": 3 * HD, "q2": HD, "ff1": Dff, "ff2": D}
    bias = {n: getattr(stacked, f"{n}_b") for n in width}
    dev = h_in.device
    part, sc, mx, pv, den, fresh = {}, {}, {}, {}, {}, {}
    vec = {"h": h_in[0].to(acc)}

    def product(name, l):                   # partials summed in chunk order, then the bias
        chunks = part[name, l]
        return sum(chunks[c] for c in range(len(chunks))) + bias[name][l, 0].to(acc)

    def queries(q):
        qb = q.to(BF16)
        return ((qb + stacked.u[0]).to(acc).reshape(H, Dh),
                (qb + stacked.v[0]).to(acc).reshape(H, Dh))

    def attention(kind, l):                 # (H, Dh), the chunks combined in order
        nc = len(pv[kind, l, 0])
        out = torch.stack([sum(pv[kind, l, h][c] for c in range(nc)) for h in range(H)])
        total = torch.stack([sum(den[kind, l, h][c] for c in range(nc)) for h in range(H)])
        if kind == "cpv":
            return out / total[:, None]
        es = torch.exp(torch.stack([fresh[l, h] for h in range(H)])
                       - torch.stack([max(mx["ssc", l, h].values()) for h in range(H)]))
        v1 = product("qkv", l)[2 * HD:].reshape(H, Dh)
        return (out + es[:, None] * v1) / (total + es)[:, None]

    def fold(kind, l):
        if kind == "ln1":
            key = "h1" if cblocked is not None else "h"
            vec[key] = _ln(vec["h"] + attention("spv", l).reshape(HD),
                           stacked.ln1_g[l, 0], stacked.ln1_b[l, 0])
        elif kind == "ln2":
            vec["h2"] = _ln(vec["h1"] + attention("cpv", l).reshape(HD),
                            stacked.ln2_g[l, 0], stacked.ln2_b[l, 0])
        else:
            vec["h"] = _ln(vec["h2"] + product("ff2", l), stacked.ff3_g[l, 0],
                           stacked.ff3_b[l, 0])

    def run(kind, l, item):
        if item[0] == "gemv":
            _, c, n0, n1, k0, k1 = item
            if kind == "ff2":
                x = _act_tanh(product("ff1", l)[k0:k1], cfg.act)
            else:
                x = vec[{"qkv": "h", "q2": "h1", "ff1": "h2"}[kind]][k0:k1]
            chunk = part.setdefault((kind, l), {}).setdefault(
                c, torch.zeros(width[kind], dtype=acc, device=dev))
            chunk[n0:n1] = _bf(x, acc) @ fmt.weight(kind, l)[k0:k1, n0:n1]
            return
        _, h, c, p0, p1 = item
        is_self = kind in ("ssc", "spv")
        pos = torch.arange(p0, p1, device=dev)
        slots = (pos + ptr) % M if is_self else pos
        if kind in ("ssc", "csc"):
            q = product("qkv", l)[:HD] if is_self else product("q2", l)
            qu, qv = queries(q)
            masked = (blocked if is_self else cblocked)[0, slots] != 0
            s = torch.where(masked, NEG_INF, fmt.scores(is_self, l, h, slots, pos, qu[h],
                                                        qv[h]) * scale)
            sc[kind, l, h, c] = s
            m = s.amax()
            if is_self and p1 == M:          # the last chunk scores the fresh token too
                k1 = product("qkv", l)[HD:2 * HD].reshape(H, Dh)[h]
                fresh[l, h] = ((qu[h] * k1).sum() + fmt.fresh_bd(l, h, qv[h])) * scale
                m = torch.maximum(m, fresh[l, h])
            mx.setdefault((kind, l, h), {})[c] = m
            return
        score = "ssc" if is_self else "csc"
        e = torch.exp(sc[score, l, h, c] - max(mx[score, l, h].values()))
        pv.setdefault((kind, l, h), {})[c] = fmt.values(is_self, l, h, slots, e)
        den.setdefault((kind, l, h), {})[c] = e.sum()

    for ph in plan:
        if ph.fold is not None:
            fold(*ph.fold)
        if ph.write >= 0:
            qkv = product("qkv", ph.write)
            fmt.write(ph.write, qkv[HD:2 * HD], qkv[2 * HD:], ptr)
        for b in range(grid):
            for it in range(b, len(ph.items), grid):
                run(ph.kind, ph.layer, ph.items[it])
    return vec["h"][None]


def s2s_slab_planned(stacked, w_scales, cfg, h_in, wkr_mt, kq, ksc, vq, vsc, ckq, cksc,
                     cvq, cvsc, cwkr_mt, cblocked, blocked, ptr: int, M: int,
                     acc: torch.dtype = F32, grid: int = 1):
    """:func:`s2s_slab_plain`'s step computed through :func:`step_plan`, as
    ``csrc/s2s_slab.cu`` walks it with ``grid`` blocks; the same arguments
    and results."""
    has_cross = ckq is not None
    plan = step_plan(cfg, M, ckq.shape[1] if has_cross else 0, has_cross)
    fmt = _SlabFormat(stacked, w_scales, wkr_mt, kq, ksc, vq, vsc,
                      (ckq, cksc, cvq, cvsc, cwkr_mt) if has_cross else None, cfg.d_head, acc)
    h = _planned_step(plan, fmt, stacked, cfg, h_in, blocked, cblocked if has_cross else None,
                      ptr, M, acc, grid)
    return h, kq, ksc, vq, vsc


def s2s_fused_planned(stacked, cfg, h_in, wkr, kc, vc, ck, cv, cwkr, cblocked, blocked,
                      ptr: int, M: int, acc: torch.dtype = F32, grid: int = 1):
    """:func:`s2s_fused_plain`'s step computed through :func:`step_plan`, as
    ``csrc/s2s_fused.cu`` walks it with ``grid`` blocks; the same arguments
    and results."""
    has_cross = ck is not None
    plan = step_plan(cfg, M, ck.shape[2] if has_cross else 0, has_cross)
    fmt = _FusedFormat(stacked, wkr, kc, vc, (ck, cv, cwkr) if has_cross else None, acc)
    h = _planned_step(plan, fmt, stacked, cfg, h_in, blocked, cblocked if has_cross else None,
                      ptr, M, acc, grid)
    return h, kc, vc


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fused_lib() -> ctypes.CDLL:
    lib = _build.load("s2s_fused")
    lib.s2s_fused_step.restype = ctypes.c_int
    lib.s2s_fused_step.argtypes = [_P] * 27 + [_I] * 9 + [ctypes.c_float, _I, _I, _P]
    lib.s2s_fused_scratch_floats.restype = ctypes.c_size_t
    lib.s2s_fused_scratch_floats.argtypes = [_I] * 8
    lib.s2s_fused_grid.restype = ctypes.c_int
    lib.s2s_fused_grid.argtypes = [_I] * 8
    lib.s2s_fused_kernels_per_step.restype = ctypes.c_int
    lib.s2s_fused_kernels_per_step.argtypes = [_I] * 2
    lib.s2s_fused_error_string.restype = ctypes.c_char_p
    lib.s2s_fused_error_string.argtypes = [_I]
    return lib


def fused_kernels_per_step(n_layers: int, has_cross: bool) -> int:
    """CUDA kernel launches inside one ``fused_s2s_step_core`` (``has_cross``)
    or ``fused_nw_step_core`` launch: one, the persistent step."""
    return _fused_lib().s2s_fused_kernels_per_step(n_layers, int(has_cross))


def _shape(cfg, M: int, Le: int, has_cross: bool):
    """The C functions' shape arguments: has_cross, L, D, Dff, H, Dh, M, Le."""
    return (int(has_cross), cfg.dec_layers, cfg.d_model, cfg.d_inner, cfg.n_heads,
            cfg.d_head, M, Le if has_cross else 0)


@functools.lru_cache(maxsize=None)
def _grid(mode: str, shape, device_index: int) -> int:
    """Blocks of the persistent step's grid for ``mode`` at ``shape``
    (``_shape``) on the card: as many as are co-resident there (occupancy x
    SMs), queried once per shape and card."""
    fused = mode == "fused"
    lib = _fused_lib() if fused else _s2s_lib()
    with torch.cuda.device(device_index):
        n = (lib.s2s_fused_grid(*shape) if fused
             else lib.s2s_slab_grid(int(mode == "slab_w8"), *shape))
    if n < 0:
        text = (lib.s2s_fused_error_string if fused else lib.s2s_slab_error_string)(-n)
        raise RuntimeError(f"s2s step ({mode}): the occupancy query failed: CUDA error {-n} "
                           f"({text.decode()})")
    if n == 0:
        raise RuntimeError(f"s2s step ({mode}): no block of the step fits an SM at {shape}")
    return n


def step_grid(mode: str, cfg, M: int, Le: int, has_cross: bool, device) -> int:
    """Blocks the wrappers launch the ``mode`` step with (slab_w8, slab or
    fused) on ``device``: the co-resident count for this shape."""
    device = torch.device(device)
    return _grid(mode, _shape(cfg, M, Le, has_cross),
                 device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _fused_specs(L: int, D: int, Dff: int, H: int, Dh: int, M: int, Le: int, has_cross: bool):
    """(name, dtype, shape) of each operand of a fused step, in
    ``_fused_core``'s order."""
    HD = H * Dh
    specs = [("qkv_w", BF16, (L, D, 3 * HD)), ("qkv_b", BF16, (L, 1, 3 * HD)),
             ("ln1_g", F32, (L, 1, D)), ("ln1_b", F32, (L, 1, D)),
             ("u", BF16, (1, HD)), ("v", BF16, (1, HD)), ("h_in", F32, (1, D)),
             ("wkr", BF16, (L, H, M + 1, Dh)), ("kc", BF16, (L, 1, H, M, Dh)),
             ("vc", BF16, (L, 1, H, M, Dh)), ("blocked", torch.int32, (1, M))]
    if has_cross:
        specs += [("q2_w", BF16, (L, D, HD)), ("q2_b", BF16, (L, 1, HD)),
                  ("ln2_g", F32, (L, 1, D)), ("ln2_b", F32, (L, 1, D)),
                  ("ff1_w", BF16, (L, D, Dff)), ("ff1_b", BF16, (L, 1, Dff)),
                  ("ff2_w", BF16, (L, Dff, D)), ("ff2_b", BF16, (L, 1, D)),
                  ("ff3_g", F32, (L, 1, D)), ("ff3_b", F32, (L, 1, D)),
                  ("ck", BF16, (L, H, Le, Dh)), ("cv", BF16, (L, H, Le, Dh)),
                  ("cwkr", BF16, (L, H, Le, Dh)), ("cblocked", torch.int32, (1, Le))]
    return tuple(specs)


def _fused_core(wrapper, stacked, cfg, h_in, wkr, kc, vc, cross, blocked, ptr, M):
    """Check the operands of either fused step, then the plain version for
    CPU tensors or ``csrc/s2s_fused.cu``'s step; ``cross`` is (ck, cv, cwkr,
    cblocked) or None."""
    ptr = int(ptr)
    if not 0 <= ptr < M:
        raise ValueError(f"ptr={ptr} outside [0, {M})")
    if cfg.act not in _ACT_CODES:
        raise ValueError(f"unsupported activation {cfg.act!r}")
    dev = h_in.device
    tensors = [stacked.qkv_w, stacked.qkv_b, stacked.ln1_g, stacked.ln1_b, stacked.u,
               stacked.v, h_in, wkr, kc, vc, blocked]
    Le = 0
    if cross is not None:
        ck = cross[0]
        Le = ck.shape[2] if isinstance(ck, torch.Tensor) and ck.dim() == 4 else 0
        tensors += [stacked.q2_w, stacked.q2_b, stacked.ln2_g, stacked.ln2_b, stacked.ff1_w,
                    stacked.ff1_b, stacked.ff2_w, stacked.ff2_b, stacked.ff3_g, stacked.ff3_b,
                    *cross]
    _check_all(_fused_specs(cfg.dec_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head,
                            M, Le, cross is not None), tensors, dev)
    if dev.type == "cpu":
        return s2s_fused_plain(stacked, cfg, h_in, wkr, kc, vc, *(cross or (None,) * 4),
                               blocked, ptr, M)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not kernel_accepts(cfg):
        raise ValueError(f"the fused s2s kernel needs d_head in {KERNEL_HEAD_DIMS}, "
                         "d_model == n_heads * d_head and widths that are multiples of 4")
    out = _fused_launch(stacked, cfg, h_in, wkr, kc, vc, cross, blocked, ptr, M)
    wrapper.launches["fused"] += 1
    return out


def _fused_launch(stacked, cfg, h_in, wkr, kc, vc, cross, blocked, ptr: int, M: int,
                  grid: int = None):
    """Run ``csrc/s2s_fused.cu``'s step on checked CUDA operands, one
    cooperative launch of ``grid`` blocks (default: the co-resident count)."""
    lib = _fused_lib()
    D, Dh = cfg.d_model, cfg.d_head
    dev = h_in.device
    ck, cv, cwkr, cblocked = cross or (None,) * 4
    shape = _shape(cfg, M, ck.shape[2] if cross is not None else 0, cross is not None)
    if grid is None:
        grid = step_grid("fused", cfg, M, shape[-1], cross is not None, dev)
    h_out = torch.empty((1, D), dtype=F32, device=dev)
    scratch = torch.empty(lib.s2s_fused_scratch_floats(*shape), dtype=F32, device=dev)
    ptrs = [stacked.qkv_w, stacked.q2_w, stacked.ff1_w, stacked.ff2_w,
            stacked.qkv_b, stacked.q2_b, stacked.ff1_b, stacked.ff2_b,
            stacked.ln1_g, stacked.ln1_b, stacked.ln2_g, stacked.ln2_b,
            stacked.ff3_g, stacked.ff3_b, wkr, stacked.u, stacked.v, kc, vc,
            ck, cv, cwkr, cblocked, h_in, blocked, h_out, scratch]
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    with _on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s2s_fused_step(*[None if t is None else t.data_ptr() for t in ptrs],
                                 *shape, ptr, scale, _ACT_CODES[cfg.act], int(grid), stream)
    if err != 0:
        raise RuntimeError(f"fused s2s kernel failed: CUDA error {err} "
                           f"({lib.s2s_fused_error_string(err).decode()})")
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
        step.argtypes = [_P] * 32 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]
    lib.s2s_slab_scratch_floats.restype = ctypes.c_size_t
    lib.s2s_slab_scratch_floats.argtypes = [_I] * 8
    lib.s2s_slab_grid.restype = ctypes.c_int
    lib.s2s_slab_grid.argtypes = [_I] * 9
    lib.s2s_slab_kernels_per_step.restype = ctypes.c_int
    lib.s2s_slab_kernels_per_step.argtypes = [_I] * 2
    lib.s2s_slab_error_string.restype = ctypes.c_char_p
    lib.s2s_slab_error_string.argtypes = [_I]
    return lib


def kernels_per_step(n_layers: int, has_cross: bool) -> int:
    """CUDA kernel launches inside one ``fused_s2s_slab_core`` (``has_cross``)
    or ``fused_nw_slab_core`` launch: one, the persistent step."""
    return _s2s_lib().s2s_slab_kernels_per_step(n_layers, int(has_cross))


def _launch(mode: str, stacked, w_scales, cfg, h_in, wkr_mt, kq, ksc, vq, vsc,
            cross, blocked, ptr: int, M: int, grid: int = None):
    """Run ``csrc/s2s_slab.cu``'s step in ``mode`` (slab_w8 or slab), one
    cooperative launch of ``grid`` blocks (default: the co-resident count);
    ``cross`` is (ckq, cksc, cvq, cvsc, cwkr_mt, cblocked) or None."""
    lib = _s2s_lib()
    D, Dh = cfg.d_model, cfg.d_head
    dev = h_in.device
    shape = _shape(cfg, M, cross[0].shape[1] if cross is not None else 0, cross is not None)
    if grid is None:
        grid = step_grid(mode, cfg, M, shape[-1], cross is not None, dev)
    h_out = torch.empty((1, D), dtype=F32, device=dev)
    scratch = torch.empty(lib.s2s_slab_scratch_floats(*shape), dtype=F32, device=dev)
    ptrs = [stacked.qkv_w, stacked.q2_w, stacked.ff1_w, stacked.ff2_w, w_scales,
            stacked.qkv_b, stacked.q2_b, stacked.ff1_b, stacked.ff2_b,
            stacked.ln1_g, stacked.ln1_b, stacked.ln2_g, stacked.ln2_b,
            stacked.ff3_g, stacked.ff3_b, wkr_mt, stacked.u, stacked.v,
            kq, ksc, vq, vsc, *(cross or [None] * 6), h_in, blocked, h_out, scratch]
    smax = 0 if w_scales is None else w_scales.shape[2]
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    fn = lib.s2s_slab_w8_step if mode == "slab_w8" else lib.s2s_slab_step
    with _on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in ptrs], *shape, smax, ptr,
                 scale, _ACT_CODES[cfg.act], int(grid), stream)
    if err != 0:
        raise RuntimeError(f"s2s slab kernel ({mode}) failed: CUDA error {err} "
                           f"({lib.s2s_slab_error_string(err).decode()})")
    return h_out, kq, ksc, vq, vsc


@functools.lru_cache(maxsize=None)
def _slab_specs(L: int, D: int, Dff: int, HD: int, M: int, Le: int, has_cross: bool,
                weights_int8: bool):
    """(name, dtype, shape) of each operand of a slab step, in
    ``_slab_operands``' order."""
    wdt = torch.int8 if weights_int8 else BF16
    specs = [("qkv_w", wdt, (L, D, 3 * HD)), ("qkv_b", BF16, (L, 1, 3 * HD)),
             ("ln1_g", F32, (L, 1, D)), ("ln1_b", F32, (L, 1, D)),
             ("u", BF16, (1, HD)), ("v", BF16, (1, HD)), ("h_in", F32, (1, D)),
             ("wkr_mt", BF16, (L, M + 1, HD)),
             ("kq", torch.int8, (L, 1, M, HD)), ("ksc", F32, (L, 1, M, 1)),
             ("vq", torch.int8, (L, 1, M, HD)), ("vsc", F32, (L, 1, M, 1)),
             ("blocked", torch.int32, (1, M))]
    if has_cross:
        specs += [("q2_w", wdt, (L, D, HD)), ("q2_b", BF16, (L, 1, HD)),
                  ("ln2_g", F32, (L, 1, D)), ("ln2_b", F32, (L, 1, D)),
                  ("ff1_w", wdt, (L, D, Dff)), ("ff1_b", BF16, (L, 1, Dff)),
                  ("ff2_w", wdt, (L, Dff, D)), ("ff2_b", BF16, (L, 1, D)),
                  ("ff3_g", F32, (L, 1, D)), ("ff3_b", F32, (L, 1, D)),
                  ("ckq", torch.int8, (L, Le, HD)), ("cksc", F32, (L, Le, 1)),
                  ("cvq", torch.int8, (L, Le, HD)), ("cvsc", F32, (L, Le, 1)),
                  ("cwkr_mt", BF16, (L, Le, HD)), ("cblocked", torch.int32, (1, Le))]
    if weights_int8:
        specs.append(("w_scales", F32, (L, 8, max(3 * HD, D, Dff))))
    return tuple(specs)


def _check_all(specs, tensors, dev) -> None:
    """``_check`` of each operand against its spec: one pass of cheap
    comparisons where everything is as expected (a token step pays this
    host time), ``_check``'s message where something is not."""
    if len(specs) != len(tensors):
        raise ValueError(f"expected {len(specs)} operands, got {len(tensors)}")
    for (name, dtype, shape), t in zip(specs, tensors):
        if not (type(t) is torch.Tensor and t.dtype is dtype and t.shape == shape
                and t.device == dev and t.is_contiguous()):
            _check(name, t, dtype, shape, dev)


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
    dev = h_in.device
    tensors = [stacked.qkv_w, stacked.qkv_b, stacked.ln1_g, stacked.ln1_b, stacked.u,
               stacked.v, h_in, wkr_mt, kq, ksc, vq, vsc, blocked]
    Le = 0
    if cross is not None:
        ckq = cross[0]
        Le = ckq.shape[1] if isinstance(ckq, torch.Tensor) else 0
        tensors += [stacked.q2_w, stacked.q2_b, stacked.ln2_g, stacked.ln2_b, stacked.ff1_w,
                    stacked.ff1_b, stacked.ff2_w, stacked.ff2_b, stacked.ff3_g, stacked.ff3_b,
                    *cross]
    if weights_int8:
        tensors.append(w_scales)
    _check_all(_slab_specs(cfg.dec_layers, cfg.d_model, cfg.d_inner, cfg.n_heads * cfg.d_head,
                           M, Le, cross is not None, weights_int8), tensors, dev)
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
