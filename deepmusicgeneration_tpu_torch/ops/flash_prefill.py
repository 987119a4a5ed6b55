"""Causal Transformer-XL prefill attention over the prompt window.

``flash_prefill_attention`` computes, for a left-padded window, the masked
``AC + skew(BD)`` relative attention of every query row against every
earlier key (``rel_attention`` with ``shift=True`` under the causal and
key-pad mask), without materializing the ``(B, H, W, W)`` scores. It
replaces the TPU kernel of the same name in
``deepmusicgeneration_tpu/ops/flash_prefill.py``, both its whole-window
(W <= 2048) and its row-blocked (2048 < W <= 8192) pallas_calls, with one
hand-written kernel, ``csrc/flash_prefill.cu``, for any W (a tail tile
covers a W that is not a multiple of 64) and d_head in
:data:`KERNEL_HEAD_DIMS`.

On a CUDA tensor the wrapper launches that kernel (built with nvcc on first
use, bound with ctypes) or raises; on a CPU tensor it runs
:func:`flash_prefill_attention_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .rel_attention import rel_attention

BF16 = torch.bfloat16
KERNEL_HEAD_DIMS = (16, 32, 64, 128)   # the head widths the kernel is built for


def flash_prefill_attention_plain(q, k, v, wkr, u_bias, v_bias, pad_mask,
                                  n_heads: int, scale: bool = True):
    """Plain PyTorch version: the masked ``rel_attention`` with
    ``shift=True`` (it materializes the scores), reshaped to (B, W, HD)."""
    B, W, HD = q.shape
    H = n_heads
    Dh = HD // H
    heads = lambda t: t.reshape(B, W, H, Dh).transpose(1, 2)
    rows = torch.arange(W, device=q.device)
    mask = (rows[None, :] > rows[:, None])[None, None] | pad_mask[:, None, None, :]
    attn = rel_attention(heads(q), heads(k), heads(v),
                         wkr.reshape(W, H, Dh).transpose(0, 1),
                         u_bias.reshape(H, 1, Dh), v_bias.reshape(H, 1, Dh),
                         mask=mask, scale=scale, shift=True)
    return attn.transpose(1, 2).reshape(B, W, HD)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_prefill")
    lib.flash_prefill_fwd.restype = ctypes.c_int
    lib.flash_prefill_fwd.argtypes = [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P]
    lib.flash_prefill_error_string.restype = ctypes.c_char_p
    lib.flash_prefill_error_string.argtypes = [_I]
    return lib


def _launch(q, k, v, wkr, u, vb, pad, H: int, scale: float):
    lib = _lib()
    B, W, HD = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_prefill_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wkr.data_ptr(), u.data_ptr(),
            vb.data_ptr(), pad.data_ptr(), out.data_ptr(), B, W, H, HD // H,
            scale, stream)
    if err != 0:
        raise RuntimeError(f"flash prefill kernel failed: CUDA error {err} "
                           f"({lib.flash_prefill_error_string(err).decode()})")
    return out


def flash_prefill_attention(
    q: torch.Tensor,          # (B, W, HD) bf16
    k: torch.Tensor,          # (B, W, HD) bf16
    v: torch.Tensor,          # (B, W, HD) bf16
    wkr: torch.Tensor,        # (W, HD) bf16, R projected through r_w, head-major
    u_bias: torch.Tensor,     # (H, Dh) or (H, 1, Dh)
    v_bias: torch.Tensor,
    pad_mask: torch.Tensor,   # (B, W) bool, True = left padding (key blocked)
    n_heads: int,
    scale: bool = True,
    block_rows: int = 0,
) -> torch.Tensor:
    """Returns attn (B, W, HD): the same function as ``rel_attention`` under
    the causal + key-pad mask.

    ``block_rows`` is the TPU kernel's query-row blocking (0 = its automatic
    choice); it is checked to divide W, as there, and does not change the
    result: the CUDA kernel streams 64-row tiles at every W, the last one a
    tail tile when W % 64 != 0."""
    B, W, HD = q.shape
    H = n_heads
    if HD % H:
        raise ValueError(f"HD={HD} is not a multiple of n_heads={H}")
    if block_rows and W % block_rows:
        raise ValueError(f"W={W} not divisible by block_rows={block_rows}")
    for name, t, shape in (("k", k, (B, W, HD)), ("v", v, (B, W, HD)),
                           ("wkr", wkr, (W, HD)), ("pad_mask", pad_mask, (B, W))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
    if u_bias.numel() != HD or v_bias.numel() != HD:
        raise ValueError(f"u_bias / v_bias must hold H*Dh = {HD} values")
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, wkr, u_bias, v_bias,
                                             pad_mask, H, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_attention: unsupported device {q.device}")
    Dh = HD // H
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash prefill kernel needs d_head in "
                         f"{KERNEL_HEAD_DIMS}; got d_head={Dh}")
    if pad_mask.dtype != torch.bool:
        raise TypeError(f"pad_mask: dtype {pad_mask.dtype}, expected torch.bool")
    operands = {"q": q, "k": k, "v": v, "wkr": wkr,
                "u_bias": u_bias.reshape(HD), "v_bias": v_bias.reshape(HD)}
    for name, t in operands.items():
        if t.dtype != BF16:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {BF16}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
    out = _launch(*operands.values(), pad_mask.contiguous(), H,
                  1.0 / math.sqrt(Dh) if scale else 1.0)
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0  # kernel launches (CUDA tensors only)
