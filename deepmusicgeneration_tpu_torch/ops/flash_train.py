"""Differentiable relative attention for training: the genre model's over
[memory, window], and the multitask model's bidirectional and cross attention.

``flash_train_attention`` computes the masked ``AC + skew(BD)`` relative
attention of the window's L queries against K = M + L keys (the XL memory,
then the window) under the causal-window curriculum mask, the memory's
validity and key padding, with attention-probability dropout inside, and
its gradients for q, k, v, wkr and the u / v biases. It replaces the TPU
kernel of the same name in ``deepmusicgeneration_tpu/ops/flash_train.py``
(the forward and backward ``pallas_call``s of ``_make_flash_train``) with
hand-written CUDA kernels, ``csrc/flash_train.cu``: neither pass writes the
(B, H, L, K) scores to device memory.

On a CUDA tensor the wrapper launches those kernels (built with nvcc on
first use, bound with ctypes) or raises; on a CPU tensor it runs
:func:`flash_train_attention_plain`, whose gradients autograd gives. Before
the kernels, the wrapper classifies every (batch row, 64-query tile, 64-key
tile) from the mask vectors (:func:`tile_map`), so that the kernels skip the
tile pairs the mask blocks whole and test no element of those it leaves
whole.

The mask is rebuilt from four vectors (:func:`mask_vectors`), exactly as
the TPU kernel's wrapper builds them: query row i is blocked from key j when
``cw[j] >= rt[i]`` (the curriculum window), ``cb[j]`` (a memory slot not yet
filled) or ``kp[b, j]`` (padding). Blocked scores are filled with -1e9, not
-inf, so a row whose keys are all blocked averages V uniformly, as there.

Dropout keeps or drops each probability by a counter hash of (seed, batch
row, head, query, key) (:func:`_hash_keep`), the TPU kernel's bit for bit,
so the forward, the recomputing backward and the plain version draw the
same mask.

The skew: ``BD[i, j] = (q + v)_i . wkr[(j + L - 1 - i) mod K]``. Wrapped
entries are masked only in the two regimes the train step emits (``win_size
== 1`` with ``win_k >= 1``, and ``win_size > 1`` with ``win_k == 0``); there
the result equals ``rel_attention`` under ``causal_window_mask`` with its
exact ``rel_shift`` spill.

The multitask train step's two other shapes replace the TPU kernels
``flash_bidir_attention`` and ``flash_cross_attention`` (``_make_flash_mt``)
with ``csrc/flash_mt.cu``, under the same rules (dropout by the same hash,
bf16 roundings where the TPU kernels round):

* :func:`flash_bidir_attention`, the encoder's self-attention over a square
  (W, W) grid with the EXACT ``rel_shift`` spill: ``BD[i, j]`` is the skew
  of row i for j <= i, 0 for j = i + 1, and row i + 1's for j >= i + 2;
  padded keys get -1e9.
* :func:`flash_cross_attention`, the decoder's attention to the encoder
  output: the skew of BD times the band ``j <= i + K - L`` (the band zeroes
  BD, it masks nothing), and no mask at all, not even for encoder padding.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from . import _build

BF16 = torch.bfloat16
NEG_INF = -1e9
KERNEL_HEAD_DIMS = (32, 64)   # the head widths the CUDA kernels are built for
TILE = 64                     # L and K must be multiples of it on the card

# lowbias32-style mixer constants of the TPU kernel (flash_train.py:80-110),
# as unsigned 32-bit values
_C1 = 0x7feb352d
_C2 = 0x846ca68b
_CH = 0x9E3779B9              # stride between heads
_CB = 0x632be59b              # stride between batch rows
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32), without overflowing
    int64: the low and high 16-bit halves of ``x`` are multiplied apart."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def keep_threshold(p: float) -> int:
    """Keep where the mixed value, read as a signed int32, exceeds this:
    P(x <= t) = (t + 2^31) / 2^32 = p."""
    return int(p * (1 << 32)) - (1 << 31)


def keep_scale(p: float) -> float:
    """The kept probabilities' factor, 1 / (1 - p) rounded to float32."""
    return float(np.float32(1.0 / (1.0 - p)))


def keep_mask(B: int, H: int, L: int, K: int, p: float, seed: int,
              device=None) -> torch.Tensor:
    """(B, H, L, K) float32 keep mask of every batch row and head: row b of
    head h is ``_hash_keep(seed + b * _CB, h, (L, K), p)``."""
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None, None, None]
    h = torch.arange(H, dtype=torch.int64, device=device)[None, :, None, None]
    i = torch.arange(L, dtype=torch.int64, device=device)[None, None, :, None]
    j = torch.arange(K, dtype=torch.int64, device=device)[None, None, None, :]
    x = _mix((int(seed) + b * _CB + (h + 1) * _CH + i * K + j) & _M32)
    signed = torch.where(x >= (1 << 31), x - (1 << 32), x)
    return (signed > keep_threshold(p)).to(torch.float32) * keep_scale(p)


def _hash_keep(seed, h: int, shape, p: float) -> torch.Tensor:
    """The TPU kernel's ``_hash_keep``: head ``h``'s keep mask of a (rows,
    cols) tile for a batch row whose seed is ``seed`` (the attention seed +
    b * _CB in int32)."""
    return keep_mask(1, h + 1, *shape, p, seed)[0, h]


def mask_vectors(B: int, L: int, K: int, win_size: int, win_k: int,
                 mem_valid: int, pad_mask: Optional[torch.Tensor] = None,
                 device=None):
    """The four int32 vectors the mask is rebuilt from
    (``flash_train.py:840-853``): rt (L,) the row window thresholds, cw (K,)
    the column window indices (-2^30 for memory columns and the
    always-visible first window column), cb (K,) 1 for memory slots not yet
    filled, kp (B, K) key padding."""
    M = K - L
    rt = (torch.arange(L, dtype=torch.int32, device=device) // int(win_size)
          + int(win_k))
    jw = torch.arange(K, dtype=torch.int32, device=device) - M
    cw = torch.where(jw <= 0, torch.full_like(jw, -(2 ** 30)),
                     torch.div(jw, int(win_size), rounding_mode="floor"))
    cb = (torch.arange(K, dtype=torch.int32, device=device)
          < M - int(mem_valid)).to(torch.int32)
    kp = torch.zeros((B, K), dtype=torch.int32, device=device)
    if pad_mask is not None:
        kp[:, M:] = pad_mask.to(torch.int32)
    return rt, cw, cb, kp


def blocked_mask(rt, cw, cb, kp) -> torch.Tensor:
    """(B, 1, L, K) bool, True = blocked (``_blocked_mask``)."""
    win = cw[None, :] >= rt[:, None]
    col = (cb[None, :] != 0) | (kp != 0)
    return win[None, None] | col[:, None, None, :]


SKIP, MIXED, VISIBLE = 0, 1, 2   # tile_map's classes


def tile_map(rt, cw, cb, kp) -> torch.Tensor:
    """(B, L / TILE, K / TILE) int32: how the kernels treat each (batch row,
    query tile, key tile) of :func:`blocked_mask`. VISIBLE: no pair blocked,
    no per-element test. SKIP: every pair blocked, so P is exactly 0 there
    (exp(-1e9 - m) for a row max m of a visible key), unless the query tile
    holds a row whose keys are ALL blocked: that row's P is 1 / K on every
    key, so nothing of its query tile is skipped. MIXED: the rest. Works for
    any vectors, from the tile's extreme thresholds: a pair is blocked when
    ``cw[j] >= rt[i]`` or its column is."""
    L, (B, K) = rt.shape[0], kp.shape
    nq, nk = L // TILE, K // TILE
    col = (cb != 0)[None, :] | (kp != 0)                           # (B, K)
    r = rt.reshape(nq, TILE)
    win_all = cw[None, :] >= r.amax(1)[:, None]   # (nq, K): blocked for every row
    win_any = cw[None, :] >= r.amin(1)[:, None]   # blocked for the lowest threshold's row
    tiles = lambda x: x.reshape(B, nq, nk, TILE).all(-1)
    blocked = tiles(col[:, None, :] | win_all[None])
    visible = tiles(~col[:, None, :] & ~win_any[None])
    # the lowest-threshold row is the first a tile has fully blocked
    row_blocked = (col[:, None, :] | win_any[None]).all(-1)      # (B, nq)
    skip = blocked & ~row_blocked[:, :, None]
    return torch.where(visible, VISIBLE, torch.where(skip, SKIP, MIXED)).to(torch.int32)


def kernel_plan(rt, cw, cb, kp):
    """The kernels' mask operands: rt, cw, the blocked columns ``cb | kp``
    (B, K) and :func:`tile_map`, all int32 and contiguous."""
    cblk = ((cb != 0)[None, :] | (kp != 0)).to(torch.int32)
    return (rt.contiguous(), cw.contiguous(), cblk.contiguous(),
            tile_map(rt, cw, cb, kp).contiguous())


@functools.lru_cache(maxsize=64)
def _unpadded_plan(B, L, K, win_size, win_k, mem_valid, device):
    return kernel_plan(*mask_vectors(B, L, K, win_size, win_k, mem_valid, None, device))


def train_plan(B, L, K, win_size, win_k, mem_valid, pad_mask, device):
    """:func:`kernel_plan` of :func:`mask_vectors`, built on ``device`` once
    a forward; without key padding it depends only on the shape and the
    curriculum, and is built once for them (the genre train step's case)."""
    if pad_mask is None:
        return _unpadded_plan(B, L, K, int(win_size), int(win_k), int(mem_valid),
                              torch.device(device))
    return kernel_plan(*mask_vectors(B, L, K, win_size, win_k, mem_valid, pad_mask, device))


class _Round(torch.autograd.Function):
    """Rounds to ``dtype`` where the kernel rounds, keeping the working type;
    the gradient passes through unrounded, so autograd gives the exact
    gradient of the rounded forward."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _round(x, dtype):
    return x if dtype == x.dtype else _Round.apply(x, dtype)


def skew_index(L: int, K: int, device=None) -> torch.Tensor:
    """(L, K) int64: the wkr row of each (query, key) pair,
    (j + L - 1 - i) mod K."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(K, device=device)[None, :]
    return (j + L - 1 - i) % K


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to ``dtype`` (kept in
    the working type): where the TPU kernels' backward rounds dS to bf16
    before its products."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _round_grad(x, dtype):
    return x if dtype == x.dtype else _RoundGrad.apply(x, dtype)


class _Block(torch.autograd.Function):
    """Fills blocked scores with -1e9; the gradient passes through every
    entry, blocked ones too, as the TPU kernels' backward forms dS = P (dP -
    delta) scale on the whole grid. It differs from the gradient of a plain
    ``torch.where`` only on a row whose keys are all blocked: P is uniform
    there, so its dS is not zero."""

    @staticmethod
    def forward(ctx, score, blocked):
        return torch.where(blocked, NEG_INF, score)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _rel_scores(q, k, wkr, u_bias, v_bias, H, dt, acc):
    """Per-head (ac, bd_rows) of the plain versions, ``bd_rows[..., i, c] =
    qv_i . wkr[c]``, with the biased q + u and q + v rounded to ``dt`` as the
    TPU kernels round them."""
    B, L, HD = q.shape
    K = k.shape[1]
    Dh = HD // H
    heads = lambda t, n: t.reshape(B, n, H, Dh).transpose(1, 2).to(acc)
    qh = heads(q, L)
    qu = _round(qh + u_bias.reshape(H, 1, Dh).to(acc), dt)
    qv = _round(qh + v_bias.reshape(H, 1, Dh).to(acc), dt)
    wh = wkr.reshape(K, H, Dh).transpose(0, 1).to(acc)              # (H, K, Dh)
    return qu @ heads(k, K).transpose(-1, -2), torch.einsum("bhld,hkd->bhlk", qv, wh)


def _softmax_pv(score, v, H, scale, dt, acc, attn_p, attn_seed, blocked=None):
    """dS rounded to ``dt`` in the backward, the scaled score masked, softmax,
    dropout, P rounded to ``dt``, P . V; returns (B, L, HD) in ``dt``."""
    B, _, L, K = score.shape
    Dh = v.shape[-1] // H
    sc = float(np.float32(1.0 / math.sqrt(Dh))) if scale else 1.0
    score = _round_grad(score, dt) * sc
    if blocked is not None:
        score = _Block.apply(score, blocked)
    e = torch.exp(score - score.amax(-1, keepdim=True))
    pf = e / e.sum(-1, keepdim=True)
    if attn_p > 0.0:
        pf = pf * keep_mask(B, H, L, K, attn_p, attn_seed or 0, score.device).to(acc)
    vh = v.reshape(B, K, H, Dh).transpose(1, 2).to(acc)
    out = _round(pf, dt) @ vh
    return out.transpose(1, 2).reshape(B, L, H * Dh).to(dt)


def flash_train_attention_plain(q, k, v, wkr, u_bias, v_bias, win_size, win_k,
                                mem_valid, n_heads: int, pad_mask=None,
                                scale: bool = True, attn_p: float = 0.0,
                                attn_seed: Optional[int] = None,
                                acc: torch.dtype = torch.float32):
    """Plain PyTorch version, differentiable by autograd: it materializes the
    (B, H, L, K) scores, gathers the skewed BD with :func:`skew_index`, and
    rounds to the inputs' dtype where the kernel does: q + u and q + v, the
    dropped-out probabilities before P.V, dS in the backward, the output.
    Everything else runs in ``acc`` (float32, or float64 for the card's
    check). The mask passes the gradient through (:class:`_Block`), as the
    kernels' backward does. Returns (B, L, HD) in the inputs' dtype."""
    flash_train_attention_plain.calls += 1
    B, L, HD = q.shape
    K = k.shape[1]
    H, dt, dev = n_heads, q.dtype, q.device
    blocked = blocked_mask(*mask_vectors(B, L, K, win_size, win_k, mem_valid, pad_mask, dev))
    ac, bd_rows = _rel_scores(q, k, wkr, u_bias, v_bias, H, dt, acc)
    bd = torch.gather(bd_rows, -1, skew_index(L, K, dev).expand(B, H, L, K))
    return _softmax_pv(ac + bd, v, H, scale, dt, acc, attn_p, attn_seed, blocked)


flash_train_attention_plain.calls = 0   # calls of the plain version


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_train")
    lib.flash_train_fwd.restype = ctypes.c_int
    lib.flash_train_fwd.argtypes = ([_P] * 6 + [_P] * 4 + [_P] * 2 + [_P] * 3 + [_I] * 5
                                    + [_F, _I, ctypes.c_uint32, _I, _F, _P])
    lib.flash_train_bwd.restype = ctypes.c_int
    lib.flash_train_bwd.argtypes = ([_P] * 6 + [_P] * 4 + [_P] * 2 + [_P] * 4 + [_P] * 6
                                    + [_P] * 3 + [_I] + [_I] * 5
                                    + [_F, _I, ctypes.c_uint32, _I, _F, _P])
    lib.flash_train_error_string.restype = ctypes.c_char_p
    lib.flash_train_error_string.argtypes = [_I]
    return lib


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"flash train {what} kernel failed: CUDA error {err} "
                           f"({lib.flash_train_error_string(err).decode()})")


def _dropout_args(attn_p: float, seed: int):
    """(dropout on, seed as uint32, keep threshold, keep scale) for the
    kernels."""
    if attn_p <= 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed) & _M32, keep_threshold(attn_p), keep_scale(attn_p)


def dq_group(B: int, L: int, H: int, n_sms: int) -> int:
    """Batch rows G a block of the dQ pass walks, each (G, query tile) with
    one dWkr partial slot: the largest of 4 and 2 that divides B and still
    gives two blocks an SM, else 1."""
    for g in (4, 2):
        if B % g == 0 and (L // TILE) * H * (B // g) >= 2 * n_sms:
            return g
    return 1


@functools.lru_cache(maxsize=None)
def _n_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def partial_slots(B: int, L: int, H: int, device) -> int:
    """The backward's dWkr partial slots on ``device``: (B / G) x L / 64."""
    return B // dq_group(B, L, H, _n_sms(torch.device(device))) * (L // TILE)


def _on_device(dev):
    """The device context for a launch on ``dev``: none when ``dev`` is
    already current (a context costs host time a train step pays 16 times)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch_fwd(q, k, v, wkr, u, vb, plan, H, sc, attn_p, seed):
    lib = _lib()
    B, L, HD = q.shape
    K = k.shape[1]
    out = torch.empty_like(q)
    quv = torch.empty((2, B, L, HD), dtype=q.dtype, device=q.device)   # q + u, q + v
    ml = torch.empty((2, B, H, L), dtype=torch.float32, device=q.device)
    p_quv, p_ml = quv.data_ptr(), ml.data_ptr()
    with _on_device(q.device):
        err = lib.flash_train_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wkr.data_ptr(), u.data_ptr(),
            vb.data_ptr(), *(t.data_ptr() for t in plan), p_quv, p_quv + q.numel() * 2,
            out.data_ptr(), p_ml, p_ml + B * H * L * 4, B, L, K, H, HD // H, sc,
            *_dropout_args(attn_p, seed), torch.cuda.current_stream(q.device).cuda_stream)
    _check(lib, err, "forward")
    return out, ml[0], ml[1]


def _launch_bwd(q, k, v, wkr, u, vb, plan, do, delta, m, l, H, sc, attn_p, seed):
    """``delta``: (B, H, L) float32, sum_d dO * O."""
    lib = _lib()
    B, L, HD = q.shape
    K = k.shape[1]
    dev = q.device
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty((K + 2, HD), dtype=torch.float32, device=dev)     # dwkr, du, dv
    # one scratch allocation: q + u and q + v (bf16), then the partial slots
    # (n_part, K, HD) of dwkr and (2, n_part, HD) of du and dv (float32)
    n_part = partial_slots(B, L, H, dev)
    n_q = 2 * q.numel() * 2
    scratch = torch.empty(n_q + n_part * (K + 2) * HD * 4, dtype=torch.uint8, device=dev)
    p_s, p_w = scratch.data_ptr(), dw.data_ptr()
    p_part = p_s + n_q
    p_uv = p_part + n_part * K * HD * 4
    with _on_device(dev):
        err = lib.flash_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wkr.data_ptr(), u.data_ptr(),
            vb.data_ptr(), *(t.data_ptr() for t in plan), p_s, p_s + n_q // 2, do.data_ptr(),
            delta.data_ptr(), m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), p_w, p_w + K * HD * 4, p_w + (K + 1) * HD * 4, p_part, p_uv,
            p_uv + n_part * HD * 4, B * (L // TILE) // n_part, B, L, K, H, HD // H, sc,
            *_dropout_args(attn_p, seed), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, "backward")
    return dq, dk, dv, dw[:K], dw[K], dw[K + 1]


class _FlashTrain(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op. The
    forward saves each query row's softmax max and sum and the tile map; the
    backward recomputes the probabilities from them and takes
    ``delta = sum_d dO * O`` in float32 outside the kernel, as the TPU
    kernel's backward does (``flash_train.py:321-326``)."""

    @staticmethod
    def forward(ctx, q, k, v, wkr, u, vb, rt, cw, cblk, tiles, H, sc, attn_p, seed):
        plan = (rt, cw, cblk, tiles)
        out, m, l = _launch_fwd(q, k, v, wkr, u, vb, plan, H, sc, attn_p, seed)
        flash_train_attention.launches["fwd"] += 1
        ctx.save_for_backward(q, k, v, wkr, u, vb, rt, cw, cblk, tiles, out, m, l)
        ctx.meta = (H, sc, attn_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, wkr, u, vb, rt, cw, cblk, tiles, out, m, l = ctx.saved_tensors
        H, sc, attn_p, seed = ctx.meta
        B, L, HD = q.shape
        delta = (do.float() * out.float()).reshape(B, L, H, HD // H).sum(-1)
        dq, dk, dv, dwkr, du, dvb = _launch_bwd(
            q, k, v, wkr, u, vb, (rt, cw, cblk, tiles), do.to(q.dtype).contiguous(),
            delta.transpose(1, 2).contiguous(), m, l, H, sc, attn_p, seed)
        flash_train_attention.launches["bwd"] += 1
        return (dq, dk, dv, dwkr.to(wkr.dtype), du.to(u.dtype), dvb.to(vb.dtype),
                None, None, None, None, None, None, None, None)


def _check_operands(q, k, v, wkr, u_bias, v_bias, pad_mask, pad_len, attn_p, attn_seed):
    """Raises on operands no version takes: k, v, wkr of (B, K, HD), (B, K,
    HD), (K, HD) on q's device, pad_mask of (B, pad_len), H * Dh bias
    values, a seed with dropout."""
    B, L, HD = q.shape
    K = k.shape[1]
    for name, t, shape in (("k", k, (B, K, HD)), ("v", v, (B, K, HD)),
                           ("wkr", wkr, (K, HD))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
    if pad_mask is not None and tuple(pad_mask.shape) != (B, pad_len):
        raise ValueError(f"pad_mask: shape {tuple(pad_mask.shape)}, expected {(B, pad_len)}")
    if u_bias.numel() != HD or v_bias.numel() != HD:
        raise ValueError(f"u_bias / v_bias must hold H*Dh = {HD} values")
    if attn_p > 0.0 and attn_seed is None:
        raise ValueError("attn_p > 0 needs an attn_seed")


def _bf16_operands(q, k, v, wkr, u_bias, v_bias):
    """The kernels' operands: contiguous bf16, the biases flat."""
    HD = q.shape[-1]
    ops = [t.contiguous() for t in (q, k, v, wkr, u_bias.reshape(HD), v_bias.reshape(HD))]
    for t in ops:
        if t.dtype != BF16:
            raise TypeError(f"dtype {t.dtype}, expected {BF16}")
    return ops


def kernel_supports(B: int, L: int, K: int, n_heads: int, HD: int, dtype) -> Optional[str]:
    """None if the CUDA kernels take these shapes, else the reason."""
    Dh = HD // n_heads
    if dtype != BF16:
        return f"dtype {dtype}, the kernels take {BF16}"
    if HD % n_heads or Dh not in KERNEL_HEAD_DIMS:
        return f"d_head={Dh}, the kernels take {KERNEL_HEAD_DIMS}"
    if L <= 0 or L % TILE or K % TILE or K < max(L, 2 * TILE):
        return (f"L={L}, K={K}: the kernels need L and K multiples of {TILE} "
                f"with K >= L and K >= {2 * TILE}")
    return None


def flash_train_attention(
    q: torch.Tensor,          # (B, L, HD): the window's queries, heads side by side
    k: torch.Tensor,          # (B, K, HD): [memory, window] keys, K = M + L
    v: torch.Tensor,          # (B, K, HD)
    wkr: torch.Tensor,        # (K, HD): backwards sinusoid through r_w
    u_bias: torch.Tensor,     # (H, Dh) or any shape of H * Dh values
    v_bias: torch.Tensor,
    win_size: int,            # the curriculum's window size
    win_k: int,               # its diagonal offset
    mem_valid: int,           # filled memory slots (0..M)
    n_heads: int,
    pad_mask: Optional[torch.Tensor] = None,   # (B, L) bool, True = pad (key blocked)
    scale: bool = True,
    attn_p: float = 0.0,
    attn_seed: Optional[int] = None,           # int32 seed, used when attn_p > 0
) -> torch.Tensor:
    """Differentiable rel-attention over [memory, window]; returns (B, L, HD).

    On the card: the CUDA kernels (bf16, d_head in :data:`KERNEL_HEAD_DIMS`,
    L and K multiples of :data:`TILE`; anything else raises). On the CPU:
    :func:`flash_train_attention_plain`."""
    B, L, HD = q.shape
    K = k.shape[1]
    H = n_heads
    _check_operands(q, k, v, wkr, u_bias, v_bias, pad_mask, L, attn_p, attn_seed)
    if q.device.type == "cpu":
        return flash_train_attention_plain(q, k, v, wkr, u_bias, v_bias, win_size,
                                           win_k, mem_valid, H, pad_mask, scale,
                                           attn_p, attn_seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_train_attention: unsupported device {q.device}")
    why = kernel_supports(B, L, K, H, HD, q.dtype)
    if why:
        raise ValueError(f"flash_train_attention: {why}")
    operands = _bf16_operands(q, k, v, wkr, u_bias, v_bias)
    plan = train_plan(B, L, K, win_size, win_k, mem_valid, pad_mask, q.device)
    sc = float(np.float32(1.0 / math.sqrt(HD // H))) if scale else 1.0
    return _FlashTrain.apply(*operands, *plan, H, sc, float(attn_p), int(attn_seed or 0))


# CUDA kernel launches (CUDA tensors only): "fwd" per forward, "bwd" per backward
flash_train_attention.launches = {"fwd": 0, "bwd": 0}


# ---------------------------------------------------------------------------
# The multitask train step's bidirectional and cross attention
# ---------------------------------------------------------------------------

def flash_bidir_attention_plain(q, k, v, wkr, u_bias, v_bias, n_heads: int, pad_mask=None,
                                scale: bool = True, attn_p: float = 0.0,
                                attn_seed: Optional[int] = None,
                                acc: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`flash_bidir_attention`, differentiable
    by autograd, with the TPU kernel's exact skew (``_skew_bidir``): for
    query row i, ``BD[i, j] = bd[i, j + W - 1 - i]`` (j <= i), 0 (j = i + 1),
    ``bd[i + 1, j - i - 2]`` (j >= i + 2). Rounds to the inputs' dtype where
    the kernels do: q + u and q + v, the dropped-out probabilities, dS in the
    backward, the output; the rest runs in ``acc``."""
    flash_bidir_attention_plain.calls += 1
    B, W, HD = q.shape
    H, dt, dev = n_heads, q.dtype, q.device
    ac, bd_rows = _rel_scores(q, k, wkr, u_bias, v_bias, H, dt, acc)
    # the spill reads the next query row's relative scores
    bd_next = torch.cat([bd_rows[:, :, 1:], torch.zeros_like(bd_rows[:, :, :1])], dim=2)
    i = torch.arange(W, device=dev)[:, None]
    j = torch.arange(W, device=dev)[None, :]
    idx = skew_index(W, W, dev).expand(B, H, W, W)
    bd = torch.where(j <= i, torch.gather(bd_rows, -1, idx),
                     torch.where(j == i + 1, 0.0, torch.gather(bd_next, -1, (idx - 1) % W)))
    blocked = None if pad_mask is None else pad_mask[:, None, None, :].to(torch.bool)
    return _softmax_pv(ac + bd, v, H, scale, dt, acc, attn_p, attn_seed, blocked)


flash_bidir_attention_plain.calls = 0


def flash_cross_attention_plain(q, k, v, wkr, u_bias, v_bias, n_heads: int,
                                scale: bool = True, attn_p: float = 0.0,
                                attn_seed: Optional[int] = None,
                                acc: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`flash_cross_attention`, differentiable
    by autograd: the skew of :func:`skew_index` times the band ``j <= i + K -
    L`` (``_skew(bd, L, K) * band``), no mask; rounds as
    :func:`flash_bidir_attention_plain`."""
    flash_cross_attention_plain.calls += 1
    B, L, HD = q.shape
    K = k.shape[1]
    H, dt, dev = n_heads, q.dtype, q.device
    ac, bd_rows = _rel_scores(q, k, wkr, u_bias, v_bias, H, dt, acc)
    band = (torch.arange(K, device=dev)[None, :]
            <= torch.arange(L, device=dev)[:, None] + (K - L)).to(acc)
    bd = torch.gather(bd_rows, -1, skew_index(L, K, dev).expand(B, H, L, K)) * band
    return _softmax_pv(ac + bd, v, H, scale, dt, acc, attn_p, attn_seed)


flash_cross_attention_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _mt_lib() -> ctypes.CDLL:
    lib = _build.load("flash_mt")
    lib.flash_mt_fwd.restype = ctypes.c_int
    lib.flash_mt_fwd.argtypes = ([_I] + [_P] * 7 + [_P] * 3 + [_I] * 5
                                 + [_F, _I, ctypes.c_uint32, _I, _F, _P])
    lib.flash_mt_bwd.restype = ctypes.c_int
    lib.flash_mt_bwd.argtypes = ([_I] + [_P] * 7 + [_P] * 4 + [_P] * 6 + [_P] * 5
                                 + [_I] * 5 + [_F, _I, ctypes.c_uint32, _I, _F, _P])
    lib.flash_mt_error_string.restype = ctypes.c_char_p
    lib.flash_mt_error_string.argtypes = [_I]
    return lib


def _mt_check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"flash mt {what} kernel failed: CUDA error {err} "
                           f"({lib.flash_mt_error_string(err).decode()})")


def _mt_launch_fwd(bidir, q, k, v, wkr, u, vb, kp, H, sc, attn_p, seed):
    lib = _mt_lib()
    B, L, HD = q.shape
    K = k.shape[1]
    out = torch.empty_like(q)
    m = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_mt_fwd(
            int(bidir), q.data_ptr(), k.data_ptr(), v.data_ptr(), wkr.data_ptr(),
            u.data_ptr(), vb.data_ptr(), kp.data_ptr() if bidir else None, out.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, L, K, H, HD // H, sc,
            *_dropout_args(attn_p, seed), stream)
    _mt_check(lib, err, "forward")
    return out, m, l


def _mt_launch_bwd(bidir, q, k, v, wkr, u, vb, kp, do, delta, m, l, H, sc, attn_p, seed):
    lib = _mt_lib()
    B, L, HD = q.shape
    K = k.shape[1]
    dev = q.device
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dwkr = torch.empty((K, HD), dtype=torch.float32, device=dev)
    du = torch.empty((HD,), dtype=torch.float32, device=dev)
    dvb = torch.empty_like(du)
    n_part = B * (L // TILE)      # per (batch row, query tile) partial sums
    part_w = torch.empty((n_part, K, HD), dtype=torch.float32, device=dev)
    part = torch.empty((4, n_part, HD), dtype=torch.float32, device=dev)  # u, v, seam
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_mt_bwd(
            int(bidir), q.data_ptr(), k.data_ptr(), v.data_ptr(), wkr.data_ptr(),
            u.data_ptr(), vb.data_ptr(), kp.data_ptr() if bidir else None, do.data_ptr(),
            delta.data_ptr(), m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dwkr.data_ptr(), du.data_ptr(), dvb.data_ptr(),
            part_w.data_ptr(), *(part[i].data_ptr() for i in range(4)),
            B, L, K, H, HD // H, sc, *_dropout_args(attn_p, seed), stream)
    _mt_check(lib, err, "backward")
    return dq, dk, dv, dwkr, du, dvb


class _FlashMT(torch.autograd.Function):
    """The CUDA forward and backward kernels of the bidirectional (``kp`` a
    (B, K) int32 padding tensor) or cross (``kp`` None) attention as one
    differentiable op; delta = sum_d dO * O from the bf16 output, as the TPU
    kernels' backward takes it (``flash_train.py:752-754``)."""

    @staticmethod
    def forward(ctx, q, k, v, wkr, u, vb, kp, H, sc, attn_p, seed):
        bidir = kp is not None
        out, m, l = _mt_launch_fwd(bidir, q, k, v, wkr, u, vb, kp, H, sc, attn_p, seed)
        (flash_bidir_attention if bidir else flash_cross_attention).launches["fwd"] += 1
        ctx.save_for_backward(q, k, v, wkr, u, vb, out, m, l)
        ctx.meta = (kp, H, sc, attn_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, wkr, u, vb, out, m, l = ctx.saved_tensors
        kp, H, sc, attn_p, seed = ctx.meta
        B, L, HD = q.shape
        delta = (do.float() * out.float()).reshape(B, L, H, HD // H).sum(-1).contiguous()
        dq, dk, dv, dwkr, du, dvb = _mt_launch_bwd(
            kp is not None, q, k, v, wkr, u, vb, kp, do.to(q.dtype).contiguous(), delta,
            m, l, H, sc, attn_p, seed)
        (flash_bidir_attention if kp is not None else flash_cross_attention).launches["bwd"] += 1
        return (dq, dk, dv, dwkr.to(wkr.dtype), du.to(u.dtype), dvb.to(vb.dtype),
                None, None, None, None, None)


def mt_kernel_supports(mode: str, B: int, L: int, K: int, n_heads: int, HD: int,
                       dtype) -> Optional[str]:
    """None if the CUDA kernels of ``mode`` ("bidir" or "cross") take these
    shapes, else the reason."""
    if mode == "bidir" and K != L:
        return f"L={L}, K={K}: the bidirectional kernels need a square grid"
    return kernel_supports(B, L, K, n_heads, HD, dtype)


def _mt_wrapper(name, mode, q, k, v, wkr, u_bias, v_bias, n_heads, pad_mask, scale, attn_p,
                attn_seed, plain):
    B, L, HD = q.shape
    K = k.shape[1]
    _check_operands(q, k, v, wkr, u_bias, v_bias, pad_mask, K, attn_p, attn_seed)
    if q.device.type == "cpu":
        return plain()
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    why = mt_kernel_supports(mode, B, L, K, n_heads, HD, q.dtype)
    if why:
        raise ValueError(f"{name}: {why}")
    if not scale:
        raise ValueError(f"{name}: the kernels scale the scores (scale=True)")
    operands = _bf16_operands(q, k, v, wkr, u_bias, v_bias)
    kp = None
    if mode == "bidir":
        kp = (torch.zeros((B, K), dtype=torch.int32, device=q.device) if pad_mask is None
              else pad_mask.to(torch.int32).contiguous())
    sc = float(np.float32(1.0 / math.sqrt(HD // n_heads)))
    return _FlashMT.apply(*operands, kp, n_heads, sc, float(attn_p), int(attn_seed or 0))


def flash_bidir_attention(
    q: torch.Tensor,          # (B, W, HD): queries, heads side by side
    k: torch.Tensor,          # (B, W, HD)
    v: torch.Tensor,          # (B, W, HD)
    wkr: torch.Tensor,        # (W, HD): backwards sinusoid through r_w
    u_bias: torch.Tensor,     # (H, Dh) or any shape of H * Dh values
    v_bias: torch.Tensor,
    n_heads: int,
    pad_mask: Optional[torch.Tensor] = None,   # (B, W) bool, True = pad (key blocked)
    scale: bool = True,
    attn_p: float = 0.0,
    attn_seed: Optional[int] = None,           # int32 seed, used when attn_p > 0
) -> torch.Tensor:
    """Differentiable bidirectional rel-attention with the exact ``rel_shift``
    spill the reference's encoder reads; returns (B, W, HD).

    On the card: the CUDA kernels (bf16, d_head in :data:`KERNEL_HEAD_DIMS`,
    W a multiple of :data:`TILE` and at least 128; anything else raises). On
    the CPU: :func:`flash_bidir_attention_plain`."""
    return _mt_wrapper(
        "flash_bidir_attention", "bidir", q, k, v, wkr, u_bias, v_bias, n_heads, pad_mask,
        scale, attn_p, attn_seed,
        lambda: flash_bidir_attention_plain(q, k, v, wkr, u_bias, v_bias, n_heads, pad_mask,
                                            scale, attn_p, attn_seed))


def flash_cross_attention(
    q: torch.Tensor,          # (B, L, HD): decoder queries
    k: torch.Tensor,          # (B, K, HD): encoder keys, K >= L
    v: torch.Tensor,          # (B, K, HD)
    wkr: torch.Tensor,        # (K, HD)
    u_bias: torch.Tensor,
    v_bias: torch.Tensor,
    n_heads: int,
    scale: bool = True,
    attn_p: float = 0.0,
    attn_seed: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable cross rel-attention: an unmasked softmax over every
    encoder key, BD zeroed above the band ``j <= i + K - L``; returns (B, L,
    HD). On the card the CUDA kernels (as :func:`flash_bidir_attention`, K >=
    L); on the CPU :func:`flash_cross_attention_plain`."""
    return _mt_wrapper(
        "flash_cross_attention", "cross", q, k, v, wkr, u_bias, v_bias, n_heads, None, scale,
        attn_p, attn_seed,
        lambda: flash_cross_attention_plain(q, k, v, wkr, u_bias, v_bias, n_heads, scale,
                                            attn_p, attn_seed))


# CUDA kernel launches (CUDA tensors only): "fwd" per forward, "bwd" per backward
flash_bidir_attention.launches = {"fwd": 0, "bwd": 0}
flash_cross_attention.launches = {"fwd": 0, "bwd": 0}
