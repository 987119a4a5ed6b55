"""Flash relative attention over a prompt window: the causal prefill of the
Transformer-XL and of the multitask decoder, and the multitask encoder's
bidirectional self-attention.

``flash_prefill_attention`` computes, for a left-padded window, the masked
``AC + skew(BD)`` relative attention of every query row against every
earlier key (``rel_attention`` with ``shift=True`` under the causal and
key-pad mask), without materializing the ``(B, H, W, W)`` scores. It
replaces the TPU kernel of the same name in
``deepmusicgeneration_tpu/ops/flash_prefill.py``, both its whole-window
(W <= 2048) and its row-blocked (2048 < W <= 8192) pallas_calls, with one
hand-written source, ``csrc/flash_prefill.cu``, for any W (a tail tile
covers a W that is not a multiple of 64) and d_head in
:data:`KERNEL_HEAD_DIMS`. The source has two entries, chosen by d_head
alone (:func:`prefill_entry`): ``wgmma`` (warpgroup products on TMA tiles)
at d_head in :data:`WGMMA_HEAD_DIMS`, ``cuda_core`` (f32 products on the
CUDA cores) at the others.

``flash_encoder_attention`` replaces the TPU kernel of that name: with
``causal=False`` the multitask encoder's attention (no causal mask, the
``rel_shift`` cross-row spill included, key padding), through
``csrc/flash_encoder.cu`` for any W and d_head in
:data:`ENCODER_HEAD_DIMS`; with ``causal=True`` the same function as
``flash_prefill_attention``, through its kernel, as the TPU package builds
the same kernel for both.

On a CUDA tensor each wrapper launches its kernel (built with nvcc on first
use, bound with ctypes) or raises; on a CPU tensor it runs
:func:`flash_encoder_attention_plain`, which materializes the scores. Each
wrapper counts its launches (``.launches``) and, for the causal source, its
launches by entry (``.entries``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .rel_attention import rel_attention

BF16 = torch.bfloat16
KERNEL_HEAD_DIMS = (16, 32, 64, 128)   # the head widths the causal kernel is built for
ENCODER_HEAD_DIMS = (32, 64)           # those of the bidirectional kernel
WGMMA_HEAD_DIMS = (32, 64)             # the causal source's wgmma entry; cuda_core takes the rest


def prefill_entry(d_head: int) -> str:
    """The entry of ``csrc/flash_prefill.cu`` that a causal launch at this
    head width runs: ``wgmma`` or ``cuda_core``."""
    return "wgmma" if d_head in WGMMA_HEAD_DIMS else "cuda_core"


def flash_encoder_attention_plain(q, k, v, wkr, u_bias, v_bias, pad_mask,
                                  n_heads: int, scale: bool = True, causal: bool = False):
    """Plain PyTorch version of both wrappers: the materialized
    ``rel_attention`` with ``shift=True`` (the exact ``rel_shift``, spill
    included) under the key-pad mask, and the causal mask when ``causal``;
    reshaped to (B, W, HD)."""
    B, W, HD = q.shape
    H = n_heads
    Dh = HD // H
    heads = lambda t: t.reshape(B, W, H, Dh).transpose(1, 2)
    mask = pad_mask[:, None, None, :]
    if causal:
        rows = torch.arange(W, device=q.device)
        mask = (rows[None, :] > rows[:, None])[None, None] | mask
    attn = rel_attention(heads(q), heads(k), heads(v),
                         wkr.reshape(W, H, Dh).transpose(0, 1),
                         u_bias.reshape(H, 1, Dh), v_bias.reshape(H, 1, Dh),
                         mask=mask, scale=scale, shift=True)
    return attn.transpose(1, 2).reshape(B, W, HD)


def flash_prefill_attention_plain(q, k, v, wkr, u_bias, v_bias, pad_mask,
                                  n_heads: int, scale: bool = True):
    """Plain PyTorch version of :func:`flash_prefill_attention`."""
    return flash_encoder_attention_plain(q, k, v, wkr, u_bias, v_bias, pad_mask, n_heads,
                                         scale, causal=True)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fns(name: str, symbol: str):
    """``symbol`` of ``csrc/<name>.cu`` (flash_prefill or flash_encoder), built
    and bound (every entry takes the same arguments), and the library's
    error-string function."""
    lib = _build.load(name)
    fwd = getattr(lib, symbol)
    fwd.restype = ctypes.c_int
    fwd.argtypes = [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P]
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [_I]
    return fwd, err


def _launch(name: str, symbol: str, q, k, v, wkr, u, vb, pad, H: int, scale: float):
    fwd, error_string = _fns(name, symbol)
    B, W, HD = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), wkr.data_ptr(), u.data_ptr(),
                  vb.data_ptr(), pad.data_ptr(), out.data_ptr(), B, W, H, HD // H,
                  scale, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel failed: CUDA error {err} "
                           f"({error_string(err).decode()})")
    return out


def kernel_supports(n_heads: int, HD: int, causal: bool) -> str:
    """Why the CUDA kernel of ``flash_encoder_attention(causal=...)`` does not
    take these heads ("" if it does)."""
    dims = KERNEL_HEAD_DIMS if causal else ENCODER_HEAD_DIMS
    if HD % n_heads:
        return f"HD={HD} is not a multiple of n_heads={n_heads}"
    if HD // n_heads not in dims:
        return f"d_head={HD // n_heads} is not one of {dims}"
    return ""


def _run(q, k, v, wkr, u_bias, v_bias, pad_mask, H: int, scale: bool, causal: bool):
    """Check the operands; the plain version for CPU tensors (entry None),
    else the launch of ``csrc/flash_prefill.cu``'s entry for these heads
    (causal) or of ``csrc/flash_encoder.cu``. Returns (out, entry)."""
    name = "flash_prefill" if causal else "flash_encoder"
    B, W, HD = q.shape
    if HD % H:
        raise ValueError(f"HD={HD} is not a multiple of n_heads={H}")
    for what, t, shape in (("k", k, (B, W, HD)), ("v", v, (B, W, HD)),
                           ("wkr", wkr, (W, HD)), ("pad_mask", pad_mask, (B, W))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"{what}: on {t.device}, expected {q.device}")
    if u_bias.numel() != HD or v_bias.numel() != HD:
        raise ValueError(f"u_bias / v_bias must hold H*Dh = {HD} values")
    if q.device.type == "cpu":
        return flash_encoder_attention_plain(q, k, v, wkr, u_bias, v_bias, pad_mask, H,
                                             scale, causal), None
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    why = kernel_supports(H, HD, causal)
    if why:
        raise ValueError(f"the {name} kernel does not take these heads: {why}")
    if pad_mask.dtype != torch.bool:
        raise TypeError(f"pad_mask: dtype {pad_mask.dtype}, expected torch.bool")
    operands = {"q": q, "k": k, "v": v, "wkr": wkr,
                "u_bias": u_bias.reshape(HD), "v_bias": v_bias.reshape(HD)}
    for what, t in operands.items():
        if t.dtype != BF16:
            raise TypeError(f"{what}: dtype {t.dtype}, expected {BF16}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"{what}: on {t.device}, expected {q.device}")
    entry = prefill_entry(HD // H) if causal else "bidir"
    symbol = f"flash_prefill_{entry}_fwd" if causal else "flash_encoder_fwd"
    return _launch(name, symbol, *operands.values(), pad_mask.contiguous(), H,
                   1.0 / math.sqrt(HD // H) if scale else 1.0), entry


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
    W = q.shape[1]
    if block_rows and W % block_rows:
        raise ValueError(f"W={W} not divisible by block_rows={block_rows}")
    out, entry = _run(q, k, v, wkr, u_bias, v_bias, pad_mask, n_heads, scale, causal=True)
    if entry:
        flash_prefill_attention.launches += 1
        flash_prefill_attention.entries[entry] += 1
    return out


flash_prefill_attention.launches = 0  # kernel launches (CUDA tensors only)
# the same launches by the entry of csrc/flash_prefill.cu that ran
flash_prefill_attention.entries = {"wgmma": 0, "cuda_core": 0}


def flash_encoder_attention(
    q: torch.Tensor,          # (B, W, HD) bf16
    k: torch.Tensor,
    v: torch.Tensor,
    wkr: torch.Tensor,        # (W, HD) bf16
    u_bias: torch.Tensor,     # (H, Dh) or (H, 1, Dh)
    v_bias: torch.Tensor,
    pad_mask: torch.Tensor,   # (B, W) bool, True = pad (key blocked)
    n_heads: int,
    scale: bool = True,
    causal: bool = False,
) -> torch.Tensor:
    """The multitask stacks' self-attention over a window: AC + the exact
    ``rel_shift`` BD (spill included), key-pad masking, softmax, P.V;
    returns (B, W, HD). ``causal=True`` is the decoder prefill's attention,
    the same function as :func:`flash_prefill_attention` (its kernel, counted
    here). Every query row is computed, padded ones too."""
    out, entry = _run(q, k, v, wkr, u_bias, v_bias, pad_mask, n_heads, scale, causal)
    if entry:
        flash_encoder_attention.launches["causal" if causal else "bidir"] += 1
        if causal:
            flash_encoder_attention.entries[entry] += 1
    return out


# kernel launches by variant (CUDA tensors only)
flash_encoder_attention.launches = {"bidir": 0, "causal": 0}
# the causal launches by the entry of csrc/flash_prefill.cu that ran
flash_encoder_attention.entries = {"wgmma": 0, "cuda_core": 0}
