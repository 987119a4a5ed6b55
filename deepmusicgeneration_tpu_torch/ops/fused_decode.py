"""Fused single-token decode step through the whole layer stack.

``fused_slab_core`` advances every batch row by one token through all L
layers: weight matvecs, attention over an int8 slot-major KV ring with the
relative-position term rolled by the ring pointer, the in-place write of the
fresh token's quantized K/V into slot ``ptr``, and the post-norm block tail
with tanh GELU. It replaces the TPU kernel of the same name in
``deepmusicgeneration_tpu/ops/fused_decode.py`` for ``score_mode="bf16"``
in two modes: ``slab_w8`` (``weights_int8=True``: int8 weight panels with
per-column scales) and ``slab`` (``weights_int8=False``: bf16 panels used as
they are). The int8-score and int4-cache modes are still to port.

``fused_slab_allrows_core`` computes the same step, with the same cache
layout and result, in the modes ``slab_ar_w8`` and ``slab_ar``; it replaces
the TPU kernel of that name. Its CUDA version reads each layer's weights
once for all B rows (the batched path, B % 8 == 0).

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/slab_decode.cu`` (built with nvcc on first use, bound with ctypes) or
raises; on a CPU tensor it runs :func:`slab_plain`, the same arithmetic in
plain PyTorch. Unlike the JAX functions, whose cache operands are donated
and aliased, the port updates ``kt``/``ks``/``vc``/``vs`` in place and
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


def slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc, vs,
               blocked, ptr: int, acc: torch.dtype = F32):
    """Plain PyTorch version of the slab step in both weight modes (same
    arithmetic and rounding points as the kernels); updates the caches in
    place. ``w_scales`` given: int8 panels dequantized per column and
    rounded to bf16 (``slab_w8``, ``slab_ar_w8``); ``None``: bf16 panels used
    as they are (``slab``, ``slab_ar``).

    ``acc`` is the dtype of everything between the bf16 cast points: float32,
    as in the kernels, or float64 for a reference of how far a float32
    summation order can drift."""
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
        ac = torch.einsum("bmhd,bhd->bhm", kt[l].to(acc).reshape(B, M, H, Dh), qu)
        ac = ac * ks[l][:, None, :, 0]
        score = (ac + torch.roll(sd[..., :M], ptr, dims=-1)) * scale
        score = torch.where(masked, NEG_INF, score)
        self_score = ((qu * k1.reshape(B, H, Dh)).sum(-1) + sd[..., M]) * scale
        mx = torch.maximum(score.amax(-1), self_score)
        e = torch.exp(score - mx[..., None])
        e_self = torch.exp(self_score - mx)
        denom = e.sum(-1) + e_self
        pv = torch.einsum("bhm,bmhd->bhd", _bf(e * vs[l][:, None, :, 0], acc),
                          vc[l].to(acc).reshape(B, M, H, Dh))
        attn = (pv + e_self[..., None] * v1.reshape(B, H, Dh)) / denom[..., None]

        for cache, scales, x in ((kt, ks, k1), (vc, vs, v1)):
            s = torch.clamp_min(x.abs().amax(1, keepdim=True), 1e-6) * (1.0 / 127.0)
            cache[l, :, ptr] = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            scales[l, :, ptr] = s

        h1 = _ln(h + _bf(attn.reshape(B, HD), acc) @ W_out, stacked.ln1_g[l],
                 stacked.ln1_b[l])
        ffx = _act_tanh(_bf(h1, acc) @ W_ff1 + stacked.ff1_b[l].to(acc), cfg.act)
        ffy = _bf(ffx, acc) @ W_ff2 + stacked.ff2_b[l].to(acc)
        h = _ln(h1 + ffy, stacked.ln2_g[l], stacked.ln2_b[l])
    return h, kt, ks, vc, vs


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


@functools.lru_cache(maxsize=None)
def _slab_lib() -> ctypes.CDLL:
    lib = _build.load("slab_decode")
    for step in (lib.slab_w8_step, lib.slab_ar_w8_step, lib.slab_step,
                 lib.slab_ar_step):
        step.restype = ctypes.c_int
        step.argtypes = [_P] * 22 + [_I] * 9 + [ctypes.c_float, _I, _P]
    lib.slab_w8_scratch_floats.restype = ctypes.c_size_t
    lib.slab_w8_scratch_floats.argtypes = [_I] * 4
    lib.slab_w8_kernels_per_step.restype = ctypes.c_int
    lib.slab_w8_kernels_per_step.argtypes = [_I]
    lib.slab_w8_error_string.restype = ctypes.c_char_p
    lib.slab_w8_error_string.argtypes = [_I]
    return lib


def kernels_per_step(n_layers: int) -> int:
    """CUDA kernel launches inside one ``fused_slab_core`` or
    ``fused_slab_allrows_core`` launch (any mode)."""
    return _slab_lib().slab_w8_kernels_per_step(n_layers)


def _launch_slab(mode: str, stacked, w_scales, cfg, h_in, wkr_mt, kt, ks,
                 vc, vs, blocked, ptr: int):
    """Run ``csrc/slab_decode.cu``'s ``<mode>_step`` (slab_w8, slab_ar_w8,
    slab or slab_ar; ``w_scales`` is None for the bf16 modes)."""
    lib = _slab_lib()
    L, D, Dff = cfg.n_layers, cfg.d_model, cfg.d_inner
    H, Dh = cfg.n_heads, cfg.d_head
    B, M = blocked.shape
    dev = h_in.device
    h_out = torch.empty((B, D), dtype=F32, device=dev)
    scratch = torch.empty(lib.slab_w8_scratch_floats(B, D, Dff, H * Dh),
                          dtype=F32, device=dev)
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    ptrs = [stacked.qkv_w, stacked.out_w, stacked.ff1_w, stacked.ff2_w, w_scales,
            stacked.ff1_b, stacked.ff2_b, stacked.ln1_g, stacked.ln1_b,
            stacked.ln2_g, stacked.ln2_b, wkr_mt, stacked.u, stacked.v,
            kt, ks, vc, vs, h_in, blocked, h_out, scratch]
    smax = 0 if w_scales is None else w_scales.shape[2]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{mode}_step")(
            *[None if t is None else t.data_ptr() for t in ptrs],
            L, B, D, Dff, H, Dh, M, smax, ptr,
            scale, _ACT_CODES[cfg.act], stream)
    if err != 0:
        raise RuntimeError(f"{mode} kernel failed: CUDA error {err} "
                           f"({lib.slab_w8_error_string(err).decode()})")
    return h_out, kt, ks, vc, vs


def _check_step_inputs(stacked, cfg, h_in, wkr_mt, kt, ks, vc, vs, blocked,
                       ptr: int, mem_len: int, rows_per_cell: int,
                       weights_int8: bool, w_scales):
    """Validate the operands of either slab step; returns the device."""
    if weights_int8 and w_scales is None:
        raise ValueError("weights_int8=True requires w_scales (from "
                         "quantize_stacked_weights)")
    L, D, Dff = cfg.n_layers, cfg.d_model, cfg.d_inner
    H, Dh, M = cfg.n_heads, cfg.d_head, mem_len
    HD = H * Dh
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
            ("wkr_mt", wkr_mt, BF16, (L, M + 1, HD)),
            ("kt", kt, torch.int8, (L, B, M, HD)),
            ("ks", ks, F32, (L, B, M, 1)),
            ("vc", vc, torch.int8, (L, B, M, HD)),
            ("vs", vs, F32, (L, B, M, 1)),
            ("blocked", blocked, torch.int32, (B, M))]
    if weights_int8:
        checks.append(("w_scales", w_scales, F32, (L, 8, smax)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    if dev.type == "cuda" and not kernel_accepts(cfg):
        raise ValueError(f"the slab kernels need d_head in {KERNEL_HEAD_DIMS} "
                         "and widths that are multiples of 4")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def fused_slab_core(
    stacked: StackedTXL,
    cfg,
    h_in: torch.Tensor,       # (B, D) fp32
    wkr_mt: torch.Tensor,     # (L, M+1, HD) bf16
    kt: torch.Tensor,         # (L, B, M, HD) int8
    ks: torch.Tensor,         # (L, B, M, 1) fp32
    vc: torch.Tensor,         # (L, B, M, HD) int8
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

    Ported: ``score_mode="bf16"`` without ``kv_int4``, with int8 weights
    (``weights_int8=True``, ``slab_w8``) or bf16 weights (``slab``; any
    ``w_scales`` is ignored, as in the JAX function). ``rows_per_cell`` is
    the TPU kernel's row tiling; it is checked to divide the batch, as
    there, and does not change the result.
    """
    if score_mode != "bf16" or kv_int4:
        raise NotImplementedError(
            "only the slab and slab_w8 modes (score_mode='bf16', "
            "kv_int4=False) are ported; slab_int8, slab4 and slab4_w8 are "
            "still to port (ROADMAP.md)")
    ptr = int(ptr)
    w_scales = w_scales if weights_int8 else None
    args = (stacked, cfg, h_in, wkr_mt, kt, ks, vc, vs, blocked, ptr)
    dev = _check_step_inputs(*args, mem_len, rows_per_cell, weights_int8, w_scales)
    if dev.type == "cpu":
        return slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc,
                          vs, blocked, ptr)
    mode = "slab_w8" if weights_int8 else "slab"
    out = _launch_slab(mode, stacked, w_scales, *args[1:])
    fused_slab_core.launches[mode] += 1
    return out


# kernel launches by mode (CUDA tensors only)
fused_slab_core.launches = {"slab_w8": 0, "slab": 0}


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

    The same contract and cache layout as :func:`fused_slab_core`; on the
    card each layer's weights are read once for all B rows. Both weight
    modes are ported: ``slab_ar_w8`` (``weights_int8=True``) and ``slab_ar``
    (bf16 panels; any ``w_scales`` is ignored). ``rows_per_cell`` is the TPU
    kernel's KV streaming group (``min(rows_per_cell, B)`` rows); it is
    checked to divide the batch, as there, and does not change the result."""
    ptr = int(ptr)
    w_scales = w_scales if weights_int8 else None
    args = (stacked, cfg, h_in, wkr_mt, kt, ks, vc, vs, blocked, ptr)
    dev = _check_step_inputs(*args, mem_len, min(rows_per_cell, h_in.shape[0]),
                             weights_int8, w_scales)
    if dev.type == "cpu":
        return slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, kt, ks, vc,
                          vs, blocked, ptr)
    mode = "slab_ar_w8" if weights_int8 else "slab_ar"
    out = _launch_slab(mode, stacked, w_scales, *args[1:])
    fused_slab_allrows_core.launches[mode] += 1
    return out


# kernel launches by mode (CUDA tensors only)
fused_slab_allrows_core.launches = {"slab_ar_w8": 0, "slab_ar": 0}
