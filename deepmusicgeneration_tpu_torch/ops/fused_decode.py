"""Fused single-token decode steps through the whole layer stack.

``fused_slab_core`` advances every batch row by one token through all L
layers: weight matvecs, attention over a slot-major KV ring with the
relative-position term rolled by the ring pointer, the in-place write of the
fresh token's quantized K/V into slot ``ptr``, and the post-norm block tail
with tanh GELU. It replaces the TPU kernel of the same name in
``deepmusicgeneration_tpu/ops/fused_decode.py`` in its six modes:
``slab_w8`` (int8 weight panels with per-column scales) and ``slab`` (bf16
panels) over an int8 ring; ``slab_int8`` / ``slab_int8_w8`` (bf16 or int8
panels, q.K and P.V as int8 x int8 products); ``slab4`` / ``slab4_w8`` (an
int4 ring, two slots a byte, bf16 or int8 panels).

``fused_slab_allrows_core`` computes the slab step with the same int8 cache
layout and result, in the modes ``slab_ar_w8`` and ``slab_ar``; its CUDA
version reads each layer's weights once for all B rows.

``fused_multirow_core`` (``multirow``) and ``fused_multirow_q_core``
(``multirow_int8``) compute the step over head-major K panels (L, B, HD, M)
and slot-major V panels, bf16 or int8 with per-slot scales; they replace
the TPU kernels of those names.

``fused_stack_decode`` (B = 1, the token in row 0 of an 8-row h block) and
``fused_batched_decode`` compute the same step over bf16 K (L, B, H, Dh, M)
and head-major V (L, B, H, M, Dh), the caches of the JAX tests' path from
``txl.ring_from_prefill``; they replace the TPU kernels of those names,
which no engine mode reaches.

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/slab_decode.cu`` or ``csrc/multirow_decode.cu`` (built with nvcc on
first use, bound with ctypes) or raises; every mode but ``slab_int8_w8``
takes the tensor-core chain of ``csrc/tc_decode.cuh`` where :func:`tc_path`
says so (from its :data:`TC_POLICY` minimum B: 8, or 1 for ``multirow``,
``slab_w8`` and row 10's ``fused_stack`` / ``fused_batched``), the old
chain below that and at the sizes the chain refuses; on a CPU tensor
it runs its plain version (:func:`slab_plain`, :func:`multirow_plain`,
:func:`multirow_q_plain`, :func:`stack_plain`), the same arithmetic in plain
PyTorch. Unlike the JAX functions, whose cache operands are donated and
aliased, the port updates the caches in place (slot ``ptr`` only) and
returns them. Each wrapper's ``launches`` dict counts its kernel launches
by mode.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple

import torch

from . import _build

NEG_INF = -1e9
F32 = torch.float32
BF16 = torch.bfloat16
KERNEL_HEAD_DIMS = (16, 32, 64, 128)   # the head widths the kernels are built for


def kernel_accepts(cfg) -> bool:
    """Whether the CUDA slab kernels take this config's widths: d_head in
    :data:`KERNEL_HEAD_DIMS` and d_model, d_inner multiples of 4 (the
    weight products read four columns at a time)."""
    return (cfg.d_head in KERNEL_HEAD_DIMS and cfg.d_model % 4 == 0
            and cfg.d_inner % 4 == 0)


class StackedTXL(NamedTuple):
    """Per-layer weights stacked on a leading layer axis."""
    qkv_w: torch.Tensor   # (L, D, 3*H*Dh)
    out_w: torch.Tensor   # (L, H*Dh, D)
    ff1_w: torch.Tensor   # (L, D, Dff)
    ff1_b: torch.Tensor   # (L, 1, Dff)
    ff2_w: torch.Tensor   # (L, Dff, D)
    ff2_b: torch.Tensor   # (L, 1, D)
    ln1_g: torch.Tensor   # (L, 1, D) fp32
    ln1_b: torch.Tensor
    ln2_g: torch.Tensor
    ln2_b: torch.Tensor
    u: torch.Tensor       # (1, H*Dh)
    v: torch.Tensor       # (1, H*Dh)


def stack_txl_layers(params: Dict, dtype=BF16) -> StackedTXL:
    ls = params["layers"]
    st = lambda k, dt: torch.stack([lp[k].to(dt) for lp in ls]).contiguous()
    return StackedTXL(
        qkv_w=st("qkv_w", dtype),
        out_w=st("out_w", dtype),
        ff1_w=st("ff1_w", dtype),
        ff1_b=st("ff1_b", dtype)[:, None, :].contiguous(),
        ff2_w=st("ff2_w", dtype),
        ff2_b=st("ff2_b", dtype)[:, None, :].contiguous(),
        ln1_g=st("ln1_g", F32)[:, None, :].contiguous(),
        ln1_b=st("ln1_b", F32)[:, None, :].contiguous(),
        ln2_g=st("ln2_g", F32)[:, None, :].contiguous(),
        ln2_b=st("ln2_b", F32)[:, None, :].contiguous(),
        u=params["u"].to(dtype).reshape(1, -1).contiguous(),
        v=params["v"].to(dtype).reshape(1, -1).contiguous(),
    )


def quantize_stacked_weights(stacked: StackedTXL):
    """Per-output-column int8 quantization of the big weight panels.

    Returns (StackedTXL with int8 qkv/out/ff1/ff2, w_scales (L, 8, SMAX) f32)
    where scale row 0/1/2/3 holds the qkv/out/ff1/ff2 column scales (padded
    to the widest panel). ln/bias/u/v stay full precision. Bit-identical to
    the JAX package's quantizer.
    """
    def q(w):
        w32 = w.to(F32)
        a = w32.abs().amax(dim=1, keepdim=True)
        s = torch.clamp_min(a, 1e-8) / 127.0                  # (L, 1, N)
        wq = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
        return wq, s[:, 0, :]
    qkv_q, s0 = q(stacked.qkv_w)
    out_q, s1 = q(stacked.out_w)
    ff1_q, s2 = q(stacked.ff1_w)
    ff2_q, s3 = q(stacked.ff2_w)
    L = qkv_q.shape[0]
    smax = max(s.shape[1] for s in (s0, s1, s2, s3))
    pad = lambda s: torch.nn.functional.pad(s, (0, smax - s.shape[1]))
    zero = torch.zeros((L, smax), dtype=F32, device=s0.device)
    w_scales = torch.stack([pad(s0), pad(s1), pad(s2), pad(s3),
                            zero, zero, zero, zero], dim=1)    # (L, 8, smax)
    return stacked._replace(qkv_w=qkv_q, out_w=out_q, ff1_w=ff1_q,
                            ff2_w=ff2_q), w_scales.contiguous()


def quantize_kv_slot_major(kt_s: torch.Tensor, vc_s: torch.Tensor):
    """Quantize slot-major (L, B, M, HD) K/V panels → int8 + (L, B, M, 1)
    scales; bit-identical to the JAX package's quantizer."""
    def q(a):
        a32 = a.to(F32)
        amax = a32.abs().amax(dim=3, keepdim=True)
        s = torch.clamp_min(amax, 1e-6) / 127.0
        return (torch.clamp(torch.round(a32 / s), -127, 127).to(torch.int8)
                .contiguous(), s.contiguous())
    kq, ks = q(kt_s)
    vq, vs = q(vc_s)
    return kq, ks, vq, vs


def quantize_kv_slot_major_int4(kt_s: torch.Tensor, vc_s: torch.Tensor):
    """int4 slot-major quantization: (L, B, M, HD) -> packed (L, B, M/2, HD)
    int8 bytes (slot m high nibble, slot m + M/2 low nibble, nibble = value
    + 8) plus full-resolution (L, B, M, 1) f32 per-slot scales
    (max(amax, 1e-6) / 7); bit-identical to the JAX package's quantizer."""
    M2 = kt_s.shape[2] // 2

    def q(a):
        a32 = a.to(F32)
        s = torch.clamp_min(a32.abs().amax(dim=3, keepdim=True), 1e-6) / 7.0
        q4 = torch.clamp(torch.round(a32 / s), -7, 7).to(torch.int32) + 8
        packed = (q4[:, :, :M2] << 4) | q4[:, :, M2:]
        return packed.to(torch.uint8).view(torch.int8).contiguous(), s.contiguous()
    kq, ks = q(kt_s)
    vq, vs = q(vc_s)
    return kq, ks, vq, vs


def quantize_kv_panels(kt: torch.Tensor, vc: torch.Tensor):
    """Quantize head-major K panels (L, B, HD, M) and slot-major V panels
    (L, B, M, HD) to int8 with per-slot scales max(amax, 1e-6) / 127 over
    HD, both laid out (L, B, 1, M); bit-identical to the JAX package's
    quantizer. Returns (kt_q, ks, vc_q, vs)."""
    k32, v32 = kt.to(F32), vc.to(F32)
    ks = torch.clamp_min(k32.abs().amax(dim=2, keepdim=True), 1e-6) / 127.0
    kt_q = torch.clamp(torch.round(k32 / ks), -127, 127).to(torch.int8)
    vs = torch.clamp_min(v32.abs().amax(dim=3, keepdim=True), 1e-6) / 127.0
    vc_q = torch.clamp(torch.round(v32 / vs), -127, 127).to(torch.int8)
    return (kt_q.contiguous(), ks.contiguous(), vc_q.contiguous(),
            vs[..., 0][:, :, None, :].contiguous())


def _ln(x32, g, b, eps=1e-5):
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * g + b


def _act_tanh(x, act: str):
    """tanh GELU, as the TPU kernel's block tail (Mosaic has no erf)."""
    if act == "gelu":
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))
    return torch.relu(x)


def _bf(x, acc=F32):
    """Round values to bfloat16 and back to ``acc`` (the kernel's cast points)."""
    return x.to(BF16).to(acc)


def _quantize_slot(x, qmax: float):
    """The fresh token's K or V rows (B, HD) quantized symmetrically to
    +-``qmax``: (values, scales (B, 1)), the TPU kernels' in-kernel floor
    max(amax, 1e-6) / qmax."""
    s = torch.clamp_min(x.abs().amax(1, keepdim=True), 1e-6) * (1.0 / qmax)
    return torch.clamp(torch.round(x / s), -qmax, qmax), s


def _unpack_int4(packed, acc):
    """Packed nibble pairs (B, M/2, HD) -> slot values (B, M, HD) in ``acc``:
    slot m is the high nibble of packed row m, slot m + M/2 the low one."""
    x = packed.to(torch.int32) & 255
    return torch.cat([(x >> 4) - 8, (x & 15) - 8], dim=1).to(acc)


def _write_nibbles(cache, l: int, ptr: int, q4):
    """Read-modify-write of slot ``ptr``'s nibble in its packed row of
    layer ``l``; the byte's other nibble (the partner slot) is kept."""
    M2 = cache.shape[2]
    pm, side = ptr % M2, ptr // M2
    n4 = (q4 + 8.0).to(torch.int32)
    old = cache[l, :, pm].to(torch.int32) & 255
    new = (old & 15) | (n4 << 4) if side == 0 else (old & 240) | n4
    cache[l, :, pm] = new.to(torch.uint8).view(torch.int8)


def _step_plain(stacked, w_scales, cfg, h_in, wkr_mt, blocked, ptr: int, acc,
                read_kv, write_kv, score_cell=None):
    """The decode step of every slab and multirow mode in plain PyTorch, with
    the TPU kernels' arithmetic and bf16 cast points. ``read_kv(l)`` gives
    layer l's cache as (K (B, M, HD), its per-slot scales (B, M) or None,
    V (B, M, HD), scales or None) in ``acc``; ``write_kv(l, k1, v1)`` writes
    the fresh slot after the layer's attention has read the old one.
    ``score_cell`` None takes q.K and P.V in ``acc`` on the bf16 values; R
    takes them as int8 x int8 products (``score_mode="int8"``): q quantized
    with one scale per cell of R rows, the probabilities with one scale per
    row over all its heads."""
    L, D, Dff = cfg.n_layers, cfg.d_model, cfg.d_inner
    H, Dh = cfg.n_heads, cfg.d_head
    HD = H * Dh
    B, M = blocked.shape
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    h = h_in.to(acc)
    masked = blocked[:, None, :] != 0
    for l in range(L):
        if w_scales is None:
            deq = lambda w, row, n: w[l].to(acc)
        else:
            deq = lambda w, row, n: _bf(w[l].to(acc) * w_scales[l, row:row + 1, :n], acc)
        W_qkv, W_out = deq(stacked.qkv_w, 0, 3 * HD), deq(stacked.out_w, 1, D)
        W_ff1, W_ff2 = deq(stacked.ff1_w, 2, Dff), deq(stacked.ff2_w, 3, D)
        qkv = _bf(h, acc) @ W_qkv
        q, k1, v1 = qkv[:, :HD], qkv[:, HD:2 * HD], qkv[:, 2 * HD:]

        qb = q.to(BF16)
        qu = (qb + stacked.u).to(acc).reshape(B, H, Dh)
        qv = (qb + stacked.v).to(acc).reshape(B, H, Dh)
        sd = torch.einsum("mhd,bhd->bhm", wkr_mt[l].to(acc).reshape(M + 1, H, Dh), qv)
        K, k_s, V, v_s = read_kv(l)
        K, V = K.reshape(B, M, H, Dh), V.reshape(B, M, H, Dh)
        if score_cell is None:
            ac = torch.einsum("bmhd,bhd->bhm", K, qu)
            if k_s is not None:
                ac = ac * k_s[:, None, :]
        else:
            qmax = qu.abs().reshape(B // score_cell, -1).amax(1)
            qs = (torch.clamp_min(qmax, 1e-6) * (1.0 / 127.0)).repeat_interleave(score_cell)
            q_i = torch.clamp(torch.round(qu / qs[:, None, None]), -127, 127)
            ac = torch.einsum("bmhd,bhd->bhm", K, q_i) * (k_s * qs[:, None])[:, None, :]
        score = (ac + torch.roll(sd[..., :M], ptr, dims=-1)) * scale
        score = torch.where(masked, NEG_INF, score)
        self_score = ((qu * k1.reshape(B, H, Dh)).sum(-1) + sd[..., M]) * scale
        mx = torch.maximum(score.amax(-1), self_score)
        e = torch.exp(score - mx[..., None])
        e_self = torch.exp(self_score - mx)
        denom = e.sum(-1) + e_self
        ev = e if v_s is None else e * v_s[:, None, :]
        if score_cell is None:
            pv = torch.einsum("bhm,bmhd->bhd", _bf(ev, acc), V)
        else:
            es = torch.clamp_min(ev.amax(dim=(1, 2)), 1e-9) * (1.0 / 127.0)   # (B,)
            e_i = torch.clamp(torch.round(ev / es[:, None, None]), 0, 127)
            pv = torch.einsum("bhm,bmhd->bhd", e_i, V) * es[:, None, None]
        attn = (pv + e_self[..., None] * v1.reshape(B, H, Dh)) / denom[..., None]
        write_kv(l, k1, v1)

        h1 = _ln(h + _bf(attn.reshape(B, HD), acc) @ W_out, stacked.ln1_g[l],
                 stacked.ln1_b[l])
        ffx = _act_tanh(_bf(h1, acc) @ W_ff1 + stacked.ff1_b[l].to(acc), cfg.act)
        ffy = _bf(ffx, acc) @ W_ff2 + stacked.ff2_b[l].to(acc)
        h = _ln(h1 + ffy, stacked.ln2_g[l], stacked.ln2_b[l])
    return h


def slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc, vs,
               blocked, ptr: int, acc: torch.dtype = F32,
               score_mode: str = "bf16", rows_per_cell: int = 8,
               kv_int4: bool = False):
    """Plain PyTorch version of the slab step in every mode (same
    arithmetic and rounding points as the kernels); updates the caches in
    place and returns (h_out, kt, ks, vc, vs). ``w_scales`` given: int8
    panels dequantized per column and rounded to bf16 (``slab_w8``,
    ``slab4_w8``, ``slab_ar_w8``); ``None``: bf16 panels used as they are.
    ``score_mode="int8"`` (``slab_int8``) takes q.K and P.V as int8 x int8
    products, q quantized per cell of ``rows_per_cell`` rows, so that
    argument changes the result there and nowhere else. ``kv_int4``
    (``slab4``, ``slab4_w8``): kt / vc hold packed nibble pairs
    (L, B, M/2, HD) and the fresh slot is quantized to +-7.

    ``acc`` is the dtype of everything between the bf16 cast points: float32,
    as in the kernels, or float64 for a reference of how far a float32
    summation order can drift."""
    int8_scores = score_mode == "int8"

    def read_kv(l):
        unpack = (lambda t: _unpack_int4(t[l], acc)) if kv_int4 else (lambda t: t[l].to(acc))
        return unpack(kt), ks[l][..., 0].to(acc), unpack(vc), vs[l][..., 0].to(acc)

    def write_kv(l, k1, v1):
        for cache, scales, x in ((kt, ks, k1), (vc, vs, v1)):
            xq, s = _quantize_slot(x, 7.0 if kv_int4 else 127.0)
            if kv_int4:
                _write_nibbles(cache, l, ptr, xq)
            else:
                cache[l, :, ptr] = xq.to(torch.int8)
            scales[l, :, ptr] = s.to(scales.dtype)

    h = _step_plain(stacked, w_scales, cfg, h_in, wkr_mt, blocked, ptr, acc,
                    read_kv, write_kv, rows_per_cell if int8_scores else None)
    return h, kt, ks, vc, vs


def multirow_plain(stacked, cfg, h_in, wkr_f, kt, vc, blocked, ptr: int,
                   acc: torch.dtype = F32):
    """Plain PyTorch version of the ``multirow`` step over bf16 head-major
    panels: kt (L, B, HD, M), vc (L, B, M, HD), wkr_f (L, HD, M+1). The
    fresh k1 / v1 go into slot ``ptr`` as bf16, in place, after the
    attention has read the old slot. Returns (h_out, kt, vc)."""
    def read_kv(l):
        return kt[l].transpose(1, 2).to(acc), None, vc[l].to(acc), None

    def write_kv(l, k1, v1):
        kt[l, :, :, ptr] = k1.to(kt.dtype)
        vc[l, :, ptr] = v1.to(vc.dtype)

    h = _step_plain(stacked, None, cfg, h_in, wkr_f.transpose(1, 2), blocked, ptr,
                    acc, read_kv, write_kv)
    return h, kt, vc


def multirow_q_plain(stacked, cfg, h_in, wkr_f, kt, ks, vc, vs, blocked,
                     ptr: int, acc: torch.dtype = F32):
    """Plain PyTorch version of the ``multirow_int8`` step: int8 head-major
    panels kt (L, B, HD, M), vc (L, B, M, HD) with per-slot scales ks, vs
    (L, B, 1, M); ks scales the scores after the product, vs folds into the
    probabilities before their bf16 cast. The fresh slot is quantized
    (max(amax, 1e-6) / 127) into slot ``ptr`` in place. Returns (h_out, kt,
    ks, vc, vs)."""
    def read_kv(l):
        return (kt[l].transpose(1, 2).to(acc), ks[l][:, 0].to(acc), vc[l].to(acc),
                vs[l][:, 0].to(acc))

    def write_kv(l, k1, v1):
        kq, k_s = _quantize_slot(k1, 127.0)
        vq, v_s = _quantize_slot(v1, 127.0)
        kt[l, :, :, ptr] = kq.to(torch.int8)
        vc[l, :, ptr] = vq.to(torch.int8)
        ks[l, :, 0, ptr] = k_s[:, 0].to(ks.dtype)
        vs[l, :, 0, ptr] = v_s[:, 0].to(vs.dtype)

    h = _step_plain(stacked, None, cfg, h_in, wkr_f.transpose(1, 2), blocked, ptr,
                    acc, read_kv, write_kv)
    return h, kt, ks, vc, vs


def stack_plain(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr: int,
                acc: torch.dtype = F32):
    """Plain PyTorch version of :func:`fused_stack_decode` /
    :func:`fused_batched_decode`: bf16 K (L, B, H, Dh, M), head-major V
    (L, B, H, M, Dh) and wkr_t (L, H, Dh, M+1), multirow's arithmetic. The
    step runs the first B = blocked.shape[0] rows of ``h_in``; any rows
    after them (rows 1-7 of the single-stream step's 8-row block) come back
    as they are. The fresh k1 / v1 go into slot ``ptr`` as bf16, in place,
    after the attention has read the old slot. Returns (h_out, kt, vc)."""
    L, B, H, Dh, M = kt.shape
    HD = H * Dh

    def read_kv(l):
        return (kt[l].reshape(B, HD, M).transpose(1, 2).to(acc), None,
                vc[l].transpose(1, 2).reshape(B, M, HD).to(acc), None)

    def write_kv(l, k1, v1):
        kt[l, :, :, :, ptr] = k1.reshape(B, H, Dh).to(kt.dtype)
        vc[l, :, :, ptr] = v1.reshape(B, H, Dh).to(vc.dtype)

    h = _step_plain(stacked, None, cfg, h_in[:B], wkr_t.reshape(L, HD, M + 1).transpose(1, 2),
                    blocked, ptr, acc, read_kv, write_kv)
    return torch.cat([h, h_in[B:].to(acc)]), kt, vc


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_ACT_CODES = {"gelu": 1, "relu": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
# every step function's C signature: 22 device pointers, L B D Dff H Dh M
# smax ptr rows_per_cell, scale, act, stream
_STEP_ARGTYPES = [_P] * 22 + [_I] * 10 + [ctypes.c_float, _I, _P]
SLAB_MODES = ("slab_w8", "slab_ar_w8", "slab", "slab_ar", "slab_int8", "slab_int8_w8",
              "slab4", "slab4_w8")
INT8_SCORE_MODES = ("slab_int8", "slab_int8_w8")
# csrc/multirow_decode.cu's steps: multirow's, and those of fused_stack_decode /
# fused_batched_decode
MULTIROW_MODES = ("multirow", "multirow_int8")
STACK_MODES = ("fused_stack", "fused_batched")
# csrc/tc_decode.cuh's plan, mirrored (tests/test_torch_tc_plan.py holds the
# tiling, the partial order, the attention's row groups and the launch count)
TC_MIN_ROWS = 8            # kTcMinRows


class TcPolicy(NamedTuple):
    """A mode's tensor-core chain: the attention's format in
    csrc/tc_decode.cuh (a grouped attention's cache policy, or ScoresI8,
    slab_int8's attention in three kernels); the library entry that runs it
    (one a template instantiation, bound by every mode that names it); the
    fewest rows the mode sends there, at least the entry's own ``tc_accepts``
    minimum; whether the format stages its quarter of a head's slice of the
    head-major (HD, M + 1) relative panel (the others read the slot-major
    (M + 1, HD) table as it is); and the ``kind`` of
    ``slab_decode_attention_occupancy`` that counts its attention blocks
    (None: not a step of csrc/slab_decode.cu)."""
    attention: str
    entry: str
    min_rows: int = TC_MIN_ROWS
    panel: bool = False
    occupancy: int = None


# multirow's chain serves every B: it took about half the old chain's step at
# B = 1, 2 and 4 (flagship, H100); so do slab_w8's and row 10's (PERF.md,
# Findings). The all-rows steps bind slab's and slab_w8's entries (bf16 or
# int8 panels); their B < 8 is not measured on the chain, so each states 8.
# Row 10's two steps bind one entry, GroupPanelBF16 with V read head-major.
TC_POLICY = {"slab4_w8": TcPolicy("GroupI4", "slab4_w8_tc_step", occupancy=0),
             "multirow_int8": TcPolicy("GroupPanelI8", "multirow_int8_tc_step", panel=True),
             "slab4": TcPolicy("GroupI4", "slab4_tc_step", occupancy=0),
             "slab_int8": TcPolicy("ScoresI8", "slab_int8_tc_step", occupancy=1),
             "multirow": TcPolicy("GroupPanelBF16", "multirow_tc_step", min_rows=1,
                                  panel=True),
             "slab": TcPolicy("GroupSlotI8", "slab_tc_step", occupancy=2),
             "slab_ar_w8": TcPolicy("GroupSlotI8", "slab_w8_tc_step", occupancy=2),
             "slab_ar": TcPolicy("GroupSlotI8", "slab_tc_step", occupancy=2),
             "slab_w8": TcPolicy("GroupSlotI8", "slab_w8_tc_step", min_rows=1, occupancy=2),
             "fused_stack": TcPolicy("GroupHeadMajorBF16", "head_major_tc_step", min_rows=1,
                                     panel=True),
             "fused_batched": TcPolicy("GroupHeadMajorBF16", "head_major_tc_step", min_rows=1,
                                       panel=True)}
TC_MODES = tuple(TC_POLICY)
TC_COLS = 64               # kTcCols: weight columns a product block owns
TC_ROWS = 64               # kTcRows: batch rows a product block applies
TC_STAGE_K = 64            # kTcStageK: K rows a pipeline stage brings
TC_TARGET_BLOCKS = 132     # kTcTargetBlocks: the H100's SMs
TC_MAX_CLUSTER = 8         # kTcMaxCluster: ff1's K chunks, one cluster
GROUP_ROWS = 4             # kGroupRows: batch rows an attention block takes
TC_KERNELS_PER_LAYER = 7   # kTcKernelsPerLayer
TC_I8_KERNELS_PER_LAYER = 9  # kTcI8KernelsPerLayer: slab_int8's attention in three
CHAIN_KERNELS_PER_LAYER = 8  # kChainKernelsPerLayer, besides the attention's
MAX_SMEM = 232448          # kMaxSmem: a block's dynamic shared memory
ATTN_THREADS = 256         # kAttnThreads
PV_THREADS = 128           # kPvThreads: threads of slab_int8's P.V block


def tc_k_chunk(K: int, N: int, max_chunks: int = None) -> int:
    """K rows a tensor-core product block takes (``tc_k_chunk``): K split
    into as few chunks of whole TC_STAGE_K-row stages as fill
    TC_TARGET_BLOCKS blocks with the ceil(N / TC_COLS) column tiles, and at
    most ``max_chunks`` of them. It depends on K and N alone, never on B."""
    up = lambda a, b: -(-a // b) * b
    splits = -(-TC_TARGET_BLOCKS // -(-N // TC_COLS))
    if max_chunks is not None:
        splits = min(splits, max_chunks)
    return up(-(-K // splits), TC_STAGE_K)


def tc_product_plan(B: int, K: int, N: int, cluster: bool = False) -> dict:
    """The grid of one tensor-core product: K chunks of ``kc`` rows (their
    partials summed in chunk order by the consumer; ``cluster``: ff1's,
    at most TC_MAX_CLUSTER chunks, one thread block cluster a column tile),
    column tiles, row groups of TC_ROWS rows, and the n8 tiles each group
    takes (the fewest of 1, 2, 4, 8 that hold min(B, TC_ROWS) rows; rows
    past B are zeros)."""
    kc = tc_k_chunk(K, N, TC_MAX_CLUSTER if cluster else None)
    rows = min(B, TC_ROWS)
    n8 = next(n for n in (1, 2, 4, 8) if 8 * n >= rows)
    return dict(kc=kc, k_blocks=-(-K // kc), col_tiles=-(-N // TC_COLS),
                row_groups=-(-B // TC_ROWS), n8_tiles=n8)


def tc_attention_clusters(B: int, H: int):
    """The clusters of the grouped attention, grid (GROUP_ROWS ceil(B /
    GROUP_ROWS), H): for each, its head and the rows of its GROUP_ROWS
    blocks (one row a block; rows past B only form their share of the
    relative scores)."""
    return [(h, list(range(b0, b0 + GROUP_ROWS)))
            for h in range(H) for b0 in range(0, B, GROUP_ROWS)]


def tc_attention_smem(Dh: int, M: int, mode: str) -> int:
    """Bytes of shared memory of a grouped-attention block of ``mode``'s
    chain (``group_attention_smem<F>`` of its TC_POLICY format): q + v of the
    cluster's rows, this row's q + u, k1 and v1, its slot scales and mask
    (the scales' room is kept where a bf16 cache has none), the relative and
    the full scores, 32 floats of reductions and the cluster's shares; then
    the work buffer, whose region a ``panel`` format first fills with its
    quarter of the head's relative-panel slice."""
    policy = TC_POLICY[mode]
    if policy.attention == "ScoresI8":
        raise ValueError(f"{mode!r} has no grouped attention")
    G = GROUP_ROWS
    floats = -(-(G * Dh + 3 * Dh + 3 * M + 2 * (M + 1) + 32 + G * (M + 1)) // 4) * 4
    work = 4 * max(ATTN_THREADS * 16, (ATTN_THREADS // 32) * M)
    stage = -(-(Dh // G * (M + 1) * 2) // 16) * 16 if policy.panel else 0
    return floats * 4 + max(work, stage)


def tc_scores_i8_smem(Dh: int, M: int) -> int:
    """Bytes of shared memory of slab_int8's scores block
    (``scores_i8_smem``): q + v of the cluster's rows, this row's q + u and
    k1, its slot scales and mask, the relative and the full scores, 32
    floats of reductions, q_i, the cluster's relative-score shares."""
    G = GROUP_ROWS
    return 4 * (G * Dh + 2 * Dh + 3 * M + 2 * (M + 1) + 32 + Dh // 4 + G * (M + 1))


def tc_pv_i8_smem(Dh: int, M: int) -> int:
    """Bytes of shared memory of slab_int8's P.V block (``pv_i8_smem``): the
    slot groups' int32 sums and the row's quantized weights."""
    return 4 * (PV_THREADS // (Dh // 16)) * Dh + -(-M // 16) * 16


def tc_path(mode: str, cfg, B: int, mem_len: int) -> bool:
    """Whether ``mode``'s step runs the tensor-core chain on the card (the
    library's ``tc_accepts``, mirrored): one of TC_MODES, B at least its
    policy's ``min_rows``, d_model, d_inner and mem_len multiples of 16, and
    the attention blocks' shared memory within MAX_SMEM."""
    if not (mode in TC_MODES and B >= TC_POLICY[mode].min_rows and cfg.d_model % 16 == 0
            and cfg.d_inner % 16 == 0 and mem_len % 16 == 0
            and cfg.d_head in KERNEL_HEAD_DIMS):
        return False
    Dh, M = cfg.d_head, mem_len
    if TC_POLICY[mode].attention == "ScoresI8":
        return max(tc_scores_i8_smem(Dh, M), tc_pv_i8_smem(Dh, M)) <= MAX_SMEM
    return tc_attention_smem(Dh, M, mode) <= MAX_SMEM


def planned_kernels_per_step(n_layers: int, mode: str, tc: bool) -> int:
    """:func:`kernels_per_step` mirrored: the tensor-core chain's 7 kernels
    a layer (9 in the int8-score modes: their attention is three), or the
    chain's 8 plus the attention's (2; 4 in the int8-score modes)."""
    int8 = mode in INT8_SCORE_MODES
    if tc:
        return n_layers * (TC_I8_KERNELS_PER_LAYER if int8 else TC_KERNELS_PER_LAYER)
    return n_layers * (CHAIN_KERNELS_PER_LAYER + (4 if int8 else 2))


def tc_scratch_layout(B: int, D: int, Dff: int, H: int, Dh: int, M: int,
                      int8_scores: bool = False) -> Dict[str, tuple]:
    """The tensor-core chain's float32 scratch (``TcScratch``, then with
    ``int8_scores`` slab_int8's ``TcI8Scratch``), mirrored: each buffer's
    (offset, floats it needs) in float32 units, every offset a multiple of 4
    (16 bytes), and ``total`` the floats the library's
    ``slab_decode_scratch_floats`` asks for."""
    HD = H * Dh
    r4 = lambda n: -(-n // 4) * 4
    kb = lambda K, N: -(-K // tc_k_chunk(K, N))
    part = max(kb(HD, D), kb(Dff, D)) * D * B
    runs = [("qkv_part", kb(D, 3 * HD) * B * 3 * HD), ("qkv", B * 3 * HD), ("h1", B * D),
            ("part", part), ("attn_b", -(-B * HD // 2)), ("h1_b", -(-B * D // 2)),
            ("h_b", -(-B * D // 2)), ("ffx_b", -(-B * Dff // 2))]
    if int8_scores:
        runs += [("ev", B * H * M), ("stats", B * H * 3), ("hmax", B * H)]
    layout, at = {}, 0
    for name, n in runs:
        layout[name] = (at, n)
        at += r4(n)
    layout["total"] = (at, 0)
    return layout


def tc_score_cells(B: int, R: int):
    """slab_int8's cells on the chain: rows [c, c + R) for c = 0, R, ...;
    R divides B."""
    return [list(range(c, c + R)) for c in range(0, B, R)]


def tc_scale_sources(B: int, H: int, R: int):
    """Which per-(row, head) maxima each (row, head) block of slab_int8's
    chain reads for its scales, mirrored: ``query[(b, h)]``, those of
    ``qkv_sum_i8`` (hmax) that set the query scale of the scores block, the
    R x H of b's cell; ``pv[(b, h)]``, those of the scores kernel (stats)
    that set the P.V block's weight scale, row b's H heads."""
    query = {(b, h): [(c, g) for c in range(b - b % R, b - b % R + R) for g in range(H)]
             for b in range(B) for h in range(H)}
    pv = {(b, h): [(b, g) for g in range(H)] for b in range(B) for h in range(H)}
    return query, pv


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    """Build and load ``csrc/<source>.cu``'s library (slab_decode or
    multirow_decode) and declare its functions: one ``<mode>_step`` per
    mode (multirow_decode: of MULTIROW_MODES and STACK_MODES), the chain
    entries that TC_POLICY names for its modes, and
    ``<source>_scratch_floats``, ``<source>_kernels_per_step``,
    ``<source>_error_string``."""
    lib = _build.load(source)
    modes = SLAB_MODES if source == "slab_decode" else MULTIROW_MODES + STACK_MODES
    entries = dict.fromkeys(TC_POLICY[m].entry for m in TC_MODES if m in modes)
    for name in [f"{m}_step" for m in modes] + list(entries):
        step = getattr(lib, name)
        step.restype = ctypes.c_int
        step.argtypes = _STEP_ARGTYPES
    for name, restype, argtypes in (("scratch_floats", ctypes.c_size_t, [_I] * 7),
                                    ("kernels_per_step", ctypes.c_int, [_I] * 3),
                                    ("error_string", ctypes.c_char_p, [_I])):
        fn = getattr(lib, f"{source}_{name}")
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _source(mode: str) -> str:
    return "multirow_decode" if mode in MULTIROW_MODES + STACK_MODES else "slab_decode"


def kernels_per_step(n_layers: int, mode: str = "slab_w8", tc: bool = False) -> int:
    """CUDA kernel launches inside one wrapper launch of ``mode`` (any of
    :data:`SLAB_MODES`, :data:`MULTIROW_MODES` and :data:`STACK_MODES`), as
    the kernel library counts them; ``tc``: on the tensor-core chain
    (:func:`tc_path`)."""
    source = _source(mode)
    return getattr(_lib(source), f"{source}_kernels_per_step")(
        n_layers, int(mode in INT8_SCORE_MODES), int(tc))


def _launch(mode: str, stacked, w_scales, cfg, h_in, wkr, kt, ks, vc, vs,
            blocked, ptr: int, rows_per_cell: int):
    """Run ``<mode>_step`` of ``csrc/slab_decode.cu`` or
    ``csrc/multirow_decode.cu`` on the card, or the chain entry of the
    mode's TC_POLICY where :func:`tc_path` says so (the library refuses, and
    this raises on, a size its own rule ``tc_accepts`` does not take);
    ``w_scales`` is None for bf16 weight panels,
    ``ks`` / ``vs`` None for bf16 caches. The step runs the first B =
    blocked.shape[0] rows of ``h_in``. Returns h_out (B, D)."""
    source = _source(mode)
    lib = _lib(source)
    L, D, Dff = cfg.n_layers, cfg.d_model, cfg.d_inner
    H, Dh = cfg.n_heads, cfg.d_head
    B, M = blocked.shape
    tc = tc_path(mode, cfg, B, M)
    dev = h_in.device
    h_out = torch.empty((B, D), dtype=F32, device=dev)
    n_scratch = getattr(lib, f"{source}_scratch_floats")(
        B, D, Dff, H, Dh, M, int(mode in INT8_SCORE_MODES) | (2 if tc else 0))
    scratch = torch.empty(n_scratch, dtype=F32, device=dev)
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    ptrs = [stacked.qkv_w, stacked.out_w, stacked.ff1_w, stacked.ff2_w, w_scales,
            stacked.ff1_b, stacked.ff2_b, stacked.ln1_g, stacked.ln1_b,
            stacked.ln2_g, stacked.ln2_b, wkr, stacked.u, stacked.v,
            kt, ks, vc, vs, h_in, blocked, h_out, scratch]
    smax = 0 if w_scales is None else w_scales.shape[2]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, TC_POLICY[mode].entry if tc else f"{mode}_step")(
            *[None if t is None else t.data_ptr() for t in ptrs],
            L, B, D, Dff, H, Dh, M, smax, ptr, rows_per_cell,
            scale, _ACT_CODES[cfg.act], stream)
    if err != 0:
        reason = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{mode} kernel failed: CUDA error {err} ({reason})")
    return h_out


def _check_common(stacked, cfg, h_in, blocked, ptr: int, mem_len: int,
                  rows_per_cell: int, weights_int8: bool, w_scales):
    """Validate the operands every decode step shares (weights, h_in,
    blocked, ptr, the row tiling); returns the device."""
    if weights_int8 and w_scales is None:
        raise ValueError("weights_int8=True requires w_scales (from "
                         "quantize_stacked_weights)")
    L, D, Dff = cfg.n_layers, cfg.d_model, cfg.d_inner
    HD, M = cfg.n_heads * cfg.d_head, mem_len
    B = h_in.shape[0]
    if B % rows_per_cell:
        raise ValueError(f"rows_per_cell={rows_per_cell} must divide batch {B}")
    if not 0 <= ptr < M:
        raise ValueError(f"ptr={ptr} outside [0, {M})")
    if cfg.act not in _ACT_CODES:
        raise ValueError(f"unsupported activation {cfg.act!r}")
    dev = h_in.device
    smax = max(3 * HD, D, Dff)
    wdt = torch.int8 if weights_int8 else BF16
    checks = [
            ("qkv_w", stacked.qkv_w, wdt, (L, D, 3 * HD)),
            ("out_w", stacked.out_w, wdt, (L, HD, D)),
            ("ff1_w", stacked.ff1_w, wdt, (L, D, Dff)),
            ("ff2_w", stacked.ff2_w, wdt, (L, Dff, D)),
            ("ff1_b", stacked.ff1_b, BF16, (L, 1, Dff)),
            ("ff2_b", stacked.ff2_b, BF16, (L, 1, D)),
            ("ln1_g", stacked.ln1_g, F32, (L, 1, D)),
            ("ln1_b", stacked.ln1_b, F32, (L, 1, D)),
            ("ln2_g", stacked.ln2_g, F32, (L, 1, D)),
            ("ln2_b", stacked.ln2_b, F32, (L, 1, D)),
            ("u", stacked.u, BF16, (1, HD)),
            ("v", stacked.v, BF16, (1, HD)),
            ("h_in", h_in, F32, (B, D)),
            ("blocked", blocked, torch.int32, (B, M))]
    if weights_int8:
        checks.append(("w_scales", w_scales, F32, (L, 8, smax)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    if dev.type == "cuda" and not kernel_accepts(cfg):
        raise ValueError(f"the decode kernels need d_head in {KERNEL_HEAD_DIMS} "
                         "and widths that are multiples of 4")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_caches(dev, *checks):
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)


def _slab_mode(score_mode: str, weights_int8: bool, kv_int4: bool) -> str:
    if score_mode not in ("bf16", "int8"):
        raise ValueError(f"score_mode {score_mode!r}: 'bf16' or 'int8'")
    if score_mode == "int8":
        if kv_int4:
            raise ValueError("kv_int4 supports score_mode='bf16' only")
        return "slab_int8_w8" if weights_int8 else "slab_int8"
    if kv_int4:
        return "slab4_w8" if weights_int8 else "slab4"
    return "slab_w8" if weights_int8 else "slab"


def fused_slab_core(
    stacked: StackedTXL,
    cfg,
    h_in: torch.Tensor,       # (B, D) fp32
    wkr_mt: torch.Tensor,     # (L, M+1, HD) bf16
    kt: torch.Tensor,         # (L, B, M, HD) int8; (L, B, M/2, HD) with kv_int4
    ks: torch.Tensor,         # (L, B, M, 1) fp32
    vc: torch.Tensor,         # (L, B, M, HD) int8; (L, B, M/2, HD) with kv_int4
    vs: torch.Tensor,         # (L, B, M, 1) fp32
    blocked: torch.Tensor,    # (B, M) int32
    ptr: int,                 # ring slot to overwrite, 0 <= ptr < M
    mem_len: int,
    rows_per_cell: int = 8,
    score_mode: str = "bf16",
    weights_int8: bool = False,
    w_scales: torch.Tensor = None,   # (L, 8, SMAX) f32
    kv_int4: bool = False,
):
    """Slab-write decode core. Returns (h_out, kt, ks, vc, vs), the caches
    updated in place in slot ``ptr``.

    Six modes, as the JAX function's arguments select them: ``slab_w8``
    (``weights_int8=True``: int8 panels and ``w_scales``) and ``slab`` (bf16
    panels; any ``w_scales`` is ignored, as in the JAX function);
    ``slab_int8`` / ``slab_int8_w8`` (``score_mode="int8"``, bf16 or int8
    panels): q.K and P.V as int8 x int8 products; ``slab4`` / ``slab4_w8``
    (``kv_int4``, bf16 or int8 panels): K/V hold two slots a byte,
    M % 64 == 0. ``rows_per_cell``
    is the TPU kernel's row tiling and must divide the batch; it changes the
    result in the int8-score modes only, where q is quantized with one scale
    per cell of that many rows.
    """
    ptr = int(ptr)
    mode = _slab_mode(score_mode, weights_int8, kv_int4)
    w_scales = w_scales if weights_int8 else None
    dev = _check_common(stacked, cfg, h_in, blocked, ptr, mem_len, rows_per_cell,
                        weights_int8, w_scales)
    L, HD, M, B = cfg.n_layers, cfg.n_heads * cfg.d_head, mem_len, h_in.shape[0]
    if kv_int4 and M % 64:
        raise ValueError(f"kv_int4 packs slot pairs in 32-row tiles: mem_len {M} "
                         "must be a multiple of 64")
    m_kv = M // 2 if kv_int4 else M
    _check_caches(dev, ("wkr_mt", wkr_mt, BF16, (L, M + 1, HD)),
                  ("kt", kt, torch.int8, (L, B, m_kv, HD)),
                  ("ks", ks, F32, (L, B, M, 1)),
                  ("vc", vc, torch.int8, (L, B, m_kv, HD)),
                  ("vs", vs, F32, (L, B, M, 1)))
    if dev.type == "cpu":
        return slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc, vs,
                          blocked, ptr, score_mode=score_mode,
                          rows_per_cell=rows_per_cell, kv_int4=kv_int4)
    h_out = _launch(mode, stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc, vs,
                    blocked, ptr, rows_per_cell)
    fused_slab_core.launches[mode] += 1
    return h_out, kt, ks, vc, vs


# kernel launches by mode (CUDA tensors only)
fused_slab_core.launches = {"slab_w8": 0, "slab": 0, "slab_int8": 0, "slab_int8_w8": 0,
                            "slab4": 0, "slab4_w8": 0}


def fused_slab_allrows_core(
    stacked: StackedTXL,
    cfg,
    h_in: torch.Tensor,       # (B, D) fp32
    wkr_mt: torch.Tensor,     # (L, M+1, HD) bf16
    kt: torch.Tensor,         # (L, B, M, HD) int8 (slot-major)
    ks: torch.Tensor,         # (L, B, M, 1) fp32
    vc: torch.Tensor,         # (L, B, M, HD) int8
    vs: torch.Tensor,         # (L, B, M, 1) fp32
    blocked: torch.Tensor,    # (B, M) int32
    ptr: int,                 # ring slot to overwrite, 0 <= ptr < M
    mem_len: int,
    rows_per_cell: int = 8,
    weights_int8: bool = False,
    w_scales: torch.Tensor = None,   # (L, 8, SMAX) f32
):
    """All-rows slab decode core. Returns (h_out, kt, ks, vc, vs), the caches
    updated in place in slot ``ptr``.

    The same contract and cache layout as :func:`fused_slab_core`'s bf16-score
    int8 modes; on the card each layer's weights are read once for all B
    rows. Both weight modes are ported: ``slab_ar_w8`` (``weights_int8=True``)
    and ``slab_ar`` (bf16 panels; any ``w_scales`` is ignored); at B >= 8
    both run the tensor-core chain (:func:`tc_path`), which is ``slab``'s.
    ``rows_per_cell`` is the TPU kernel's KV streaming group
    (``min(rows_per_cell, B)`` rows); it is checked to divide the batch, as
    there, and does not change the result (the scores are bf16 products)."""
    ptr = int(ptr)
    w_scales = w_scales if weights_int8 else None
    R = min(rows_per_cell, h_in.shape[0])
    dev = _check_common(stacked, cfg, h_in, blocked, ptr, mem_len, R,
                        weights_int8, w_scales)
    L, HD, M, B = cfg.n_layers, cfg.n_heads * cfg.d_head, mem_len, h_in.shape[0]
    _check_caches(dev, ("wkr_mt", wkr_mt, BF16, (L, M + 1, HD)),
                  ("kt", kt, torch.int8, (L, B, M, HD)), ("ks", ks, F32, (L, B, M, 1)),
                  ("vc", vc, torch.int8, (L, B, M, HD)), ("vs", vs, F32, (L, B, M, 1)))
    if dev.type == "cpu":
        return slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc,
                          vs, blocked, ptr)
    mode = "slab_ar_w8" if weights_int8 else "slab_ar"
    h_out = _launch(mode, stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc, vs,
                    blocked, ptr, R)
    fused_slab_allrows_core.launches[mode] += 1
    return h_out, kt, ks, vc, vs


# kernel launches by mode (CUDA tensors only)
fused_slab_allrows_core.launches = {"slab_ar_w8": 0, "slab_ar": 0}


def fused_multirow_core(
    stacked: StackedTXL,
    cfg,
    h_in: torch.Tensor,       # (B, D) fp32
    wkr_f: torch.Tensor,      # (L, HD, M+1) bf16 flattened W_kr panels
    kt: torch.Tensor,         # (L, B, HD, M) bf16 head-major K panels
    vc: torch.Tensor,         # (L, B, M, HD) bf16
    blocked: torch.Tensor,    # (B, M) int32
    ptr: int,
    mem_len: int,
    rows_per_cell: int = 8,
):
    """The ``multirow`` decode core over bf16 panels (any M). Returns (h_out,
    kt, vc), the fresh k1 / v1 written as bf16 into slot ``ptr`` in place;
    the TPU kernel rewrites every panel block with the slot merged in, the
    port writes the slot alone. bf16 weight panels. ``rows_per_cell`` is the
    TPU kernel's row tiling: it must divide the batch and does not change
    the result."""
    ptr = int(ptr)
    dev = _check_common(stacked, cfg, h_in, blocked, ptr, mem_len, rows_per_cell,
                        False, None)
    L, HD, M, B = cfg.n_layers, cfg.n_heads * cfg.d_head, mem_len, h_in.shape[0]
    _check_caches(dev, ("wkr_f", wkr_f, BF16, (L, HD, M + 1)),
                  ("kt", kt, BF16, (L, B, HD, M)), ("vc", vc, BF16, (L, B, M, HD)))
    if dev.type == "cpu":
        return multirow_plain(stacked, cfg, h_in, wkr_f, kt, vc, blocked, ptr)
    h_out = _launch("multirow", stacked, None, cfg, h_in, wkr_f, kt, None, vc, None,
                    blocked, ptr, rows_per_cell)
    fused_multirow_core.launches["multirow"] += 1
    return h_out, kt, vc


fused_multirow_core.launches = {"multirow": 0}


def fused_multirow_q_core(
    stacked: StackedTXL,
    cfg,
    h_in: torch.Tensor,       # (B, D) fp32
    wkr_f: torch.Tensor,      # (L, HD, M+1) bf16
    kt: torch.Tensor,         # (L, B, HD, M) int8
    ks: torch.Tensor,         # (L, B, 1, M) fp32
    vc: torch.Tensor,         # (L, B, M, HD) int8
    vs: torch.Tensor,         # (L, B, 1, M) fp32
    blocked: torch.Tensor,    # (B, M) int32
    ptr: int,
    mem_len: int,
    rows_per_cell: int = 8,
):
    """The ``multirow_int8`` decode core over int8 panels with per-slot
    scales (from :func:`quantize_kv_panels`). Returns (h_out, kt, ks, vc,
    vs), the fresh slot quantized into slot ``ptr`` in place. bf16 weight
    panels; ``rows_per_cell`` as in :func:`fused_multirow_core`."""
    ptr = int(ptr)
    dev = _check_common(stacked, cfg, h_in, blocked, ptr, mem_len, rows_per_cell,
                        False, None)
    L, HD, M, B = cfg.n_layers, cfg.n_heads * cfg.d_head, mem_len, h_in.shape[0]
    _check_caches(dev, ("wkr_f", wkr_f, BF16, (L, HD, M + 1)),
                  ("kt", kt, torch.int8, (L, B, HD, M)), ("ks", ks, F32, (L, B, 1, M)),
                  ("vc", vc, torch.int8, (L, B, M, HD)), ("vs", vs, F32, (L, B, 1, M)))
    if dev.type == "cpu":
        return multirow_q_plain(stacked, cfg, h_in, wkr_f, kt, ks, vc, vs, blocked, ptr)
    h_out = _launch("multirow_int8", stacked, None, cfg, h_in, wkr_f, kt, ks, vc, vs,
                    blocked, ptr, rows_per_cell)
    fused_multirow_q_core.launches["multirow_int8"] += 1
    return h_out, kt, ks, vc, vs


fused_multirow_q_core.launches = {"multirow_int8": 0}


def _check_stack(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr: int, mem_len: int,
                 B: int, rows: int):
    """Validate the operands of the two head-major steps: h_in (rows, D),
    whose first B rows the step runs; returns the device."""
    _check("h_in", h_in, F32, (rows, cfg.d_model), h_in.device)
    dev = _check_common(stacked, cfg, h_in[:B], blocked, ptr, mem_len, 1, False, None)
    L, H, Dh, M = cfg.n_layers, cfg.n_heads, cfg.d_head, mem_len
    _check_caches(dev, ("wkr_t", wkr_t, BF16, (L, H, Dh, M + 1)),
                  ("kt", kt, BF16, (L, B, H, Dh, M)), ("vc", vc, BF16, (L, B, H, M, Dh)))
    return dev


def fused_stack_decode(
    stacked: StackedTXL,
    cfg,
    h_in: torch.Tensor,       # (8, D) fp32, the embedded token in row 0
    wkr_t: torch.Tensor,      # (L, H, Dh, M+1) bf16
    kt: torch.Tensor,         # (L, 1, H, Dh, M) bf16 transposed K cache
    vc: torch.Tensor,         # (L, 1, H, M, Dh) bf16
    blocked: torch.Tensor,    # (1, M) int32
    ptr,                      # ring slot to overwrite, 0 <= ptr < M
    mem_len: int,
):
    """The single-stream decode step through the whole stack (batch 1,
    bf16 caches). Returns (h_out (8, D), kt, vc): row 0 of h_out is the
    token's output, rows 1-7 are h_in's as they are; the fresh k1 / v1 are
    written as bf16 into slot ``ptr`` of every layer, in place. On the card
    row 0 alone runs the tensor-core chain where :func:`tc_path` says so,
    else the old chain."""
    ptr = int(ptr)
    dev = _check_stack(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr, mem_len, 1, 8)
    if dev.type == "cpu":
        return stack_plain(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr)
    h0 = _launch("fused_stack", stacked, None, cfg, h_in, wkr_t, kt, None, vc, None,
                 blocked, ptr, 1)
    fused_stack_decode.launches["fused_stack"] += 1
    h_out = h_in.clone()
    h_out[:1] = h0
    return h_out, kt, vc


fused_stack_decode.launches = {"fused_stack": 0}


def fused_batched_decode(
    stacked: StackedTXL,
    cfg,
    h_in: torch.Tensor,       # (B, D) fp32 embedded tokens
    wkr_t: torch.Tensor,      # (L, H, Dh, M+1) bf16
    kt: torch.Tensor,         # (L, B, H, Dh, M) bf16
    vc: torch.Tensor,         # (L, B, H, M, Dh) bf16
    blocked: torch.Tensor,    # (B, M) int32
    ptr,                      # ring slot to overwrite (shared by all rows)
    mem_len: int,
):
    """The batched decode step over the caches of :func:`fused_stack_decode`,
    one token per batch row. Returns (h_out (B, D), kt, vc), the caches
    updated in place in slot ``ptr``. On the card it runs the tensor-core
    chain where :func:`tc_path` says so (every B at M % 16 == 0), else the
    old chain."""
    ptr = int(ptr)
    B = h_in.shape[0]
    dev = _check_stack(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr, mem_len, B, B)
    if dev.type == "cpu":
        return stack_plain(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr)
    h_out = _launch("fused_batched", stacked, None, cfg, h_in, wkr_t, kt, None, vc, None,
                    blocked, ptr, 1)
    fused_batched_decode.launches["fused_batched"] += 1
    return h_out, kt, vc


fused_batched_decode.launches = {"fused_batched": 0}

# The JAX package's jitted standalone wrappers of the three cores: PyTorch
# runs eagerly, so here they are the cores themselves (ptr an int).
fused_slab_decode = fused_slab_core
fused_multirow_q_decode = fused_multirow_q_core
fused_multirow_decode = fused_multirow_core
