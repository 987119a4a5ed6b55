"""Relative-position multi-head attention primitives (Transformer-XL style).

Implements the math of fastai's MultiHeadRelativeAttention / the reference's
MemMultiHeadRelativeAttentionKV (deep_music_remix.py:2025-2104): attention
scores are ``AC + BD`` where ``AC = (q + u)·kᵀ`` is content addressing and
``BD = skew((q + v)·R)`` is relative-position addressing over a backwards
sinusoid table, scaled by ``1/sqrt(d_head)``.

Plain functions on tensors, with the JAX package's layouts. Contractions
take bf16 or f32 inputs and accumulate in float32 (the inputs are upcast, so
products of bf16 values are exact), like ``preferred_element_type=float32``.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e9  # mask fill; avoids NaNs from (-inf) - (-inf) in softmax


def sinusoid_pos_enc(positions, d_model: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """fastai PositionalEncoding: concat(sin(p·f), cos(p·f)), f = 10000^(-2i/d).

    Positions are a host array. The table is built in float64 (fp32 ``pow``
    discrepancies get amplified by large positions), then rounded to float32.
    """
    pos = np.asarray(positions, dtype=np.float64)
    freq = 1.0 / (10000 ** (np.arange(0, d_model, 2, dtype=np.float64) / d_model))
    inp = np.outer(pos, freq)
    table = np.concatenate([np.sin(inp), np.cos(inp)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device=device, dtype=dtype)


def backwards_pos_enc(seq_len: int, d_model: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Sinusoid table over positions [seq_len-1 .. 0] (the TXL convention)."""
    return sinusoid_pos_enc(np.arange(seq_len - 1, -1, -1), d_model, dtype, device)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """fastai `_line_shift`: align the (q, k) grid of relative scores.

    x: (..., Q, K). out[..., i, j] = x[..., i, j + (Q-1-i)], as the classic
    pad+view+drop skewing trick — exact, including the cross-row spill values
    that the bidirectional encoder reads (deep_music_remix.py:2095-2097).
    """
    *lead, q, k = x.shape
    x_pad = torch.nn.functional.pad(x, (1, 0))
    return x_pad.reshape(*lead, k + 1, q)[..., 1:, :].reshape(*lead, q, k)


def rel_attention(
    q: torch.Tensor,          # (B, H, Q, Dh)
    k: torch.Tensor,          # (B, H, K, Dh)
    v: torch.Tensor,          # (B, H, K, Dh)
    wkr: torch.Tensor,        # (H, K, Dh) — R projected through r_attn
    u_bias: torch.Tensor,     # (H, 1, Dh)
    v_bias: torch.Tensor,     # (H, 1, Dh)
    mask: torch.Tensor = None,  # (B|1, 1|H, Q, K) bool, True = BLOCKED
    scale: bool = True,
    shift: bool = True,
    r_mask: bool = False,
    attn_p: float = 0.0,
    generator: torch.Generator = None,
) -> torch.Tensor:
    """Core AC+BD attention; returns (B, H, Q, Dh).

    ``shift=False`` is the single-token decode path where the skew is the
    identity (Q == 1) and BD indexes the distance table directly.
    ``r_mask`` zeroes the strictly upper band of the shifted BD scores
    (``tril(K - Q)``), as the multitask model's cross-attention does.
    ``attn_p``/``generator``: training-time dropout on the softmax
    probabilities (fastai's ``drop_att``), applied only when a generator
    (on the tensors' device) is given.
    """
    dh = q.shape[-1]
    f32 = torch.float32
    ac = torch.einsum("bhqd,bhkd->bhqk", (q + u_bias).to(f32), k.to(f32))
    bd = torch.einsum("bhqd,hkd->bhqk", (q + v_bias).to(f32), wkr.to(f32))
    if shift:
        bd = rel_shift(bd)
    if r_mask:
        Q, K = bd.shape[-2:]
        bd = bd * torch.tril(torch.ones((Q, K), dtype=f32, device=bd.device), K - Q)
    score = ac + bd
    if scale:
        score = score * float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    if mask is not None:
        score = torch.where(mask, NEG_INF, score)
    prob = torch.softmax(score, dim=-1).to(v.dtype)
    if generator is not None and attn_p > 0.0:
        keep = torch.rand(prob.shape, generator=generator, device=prob.device) < 1.0 - attn_p
        prob = torch.where(keep, prob / (1.0 - attn_p), torch.zeros((), dtype=prob.dtype,
                                                                   device=prob.device))
    out = torch.einsum("bhqk,bhkd->bhqd", prob.to(f32), v.to(f32))
    return out.to(v.dtype)


def causal_window_mask(x_len: int, m_len: int, win_size: int = 1, k: int = 1,
                       mem_valid=None, device=None) -> torch.Tensor:
    """Reference `window_mask` (deep_music_genre.py:1577-1584): block-causal
    over windows of ``win_size`` with diagonal offset ``k``; memory columns
    always visible (up to ``mem_valid`` slots, right-aligned).

    Returns bool (1, 1, x_len, m_len + x_len), True = blocked.
    """
    rows = torch.arange(x_len, device=device)[:, None] // win_size
    cols = torch.arange(x_len, device=device)[None, :] // win_size
    win = cols >= rows + k  # triu(diagonal=k) on the window grid
    if x_len:
        win[:, 0] = False  # always allow attending the first token
    mem = torch.zeros((x_len, m_len), dtype=torch.bool, device=device)
    if mem_valid is not None and m_len:
        slot = torch.arange(m_len, device=device)[None, :]
        mem = (slot < (m_len - mem_valid)).expand(x_len, m_len)
    full = torch.cat([mem, win], dim=1)
    return full[None, None]
