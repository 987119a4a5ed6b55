"""MusicTransformerXL inference path: prompt prefill and the exact ring-cache
decode step, as plain functions of a parameter dict.

Architecture parity with the reference model (deep_music_genre.py:1603-1665
on top of fastai's TransformerXL): token embedding, N post-norm decoder
blocks with relative-position multi-head attention (shared ``u``/``v``
biases, fused qkv projection, per-layer ``r_w`` projection of a backwards
sinusoid table), erf GELU feed-forward, weight-tied output head.

``params`` is the JAX package's parameter tree carried over by
:func:`deepmusicgeneration_tpu_torch.train.checkpoint.params_from_numpy`:
``{"embed", "u", "v", "head_b", "layers": [{"qkv_w", "qkv_b", "r_w", "r_b",
"out_w", "out_b", "ln1_g", "ln1_b", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
"ln2_g", "ln2_b"}, ...]}``, with the same shapes.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..ops.flash_prefill import KERNEL_HEAD_DIMS, flash_prefill_attention
from ..ops.rel_attention import (
    NEG_INF,
    backwards_pos_enc,
    causal_window_mask,
    rel_attention,
)
from .config import TXLConfig

F32 = torch.float32


def _layer_norm(x, g, b, eps=1e-5):
    x32 = x.to(F32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps) * g + b
    return out.to(x.dtype)


def _act(x, kind: str):
    if kind == "gelu":
        return torch.nn.functional.gelu(x)  # exact erf form (models/txl.py:112)
    if kind == "relu":
        return torch.relu(x)
    raise ValueError(kind)


def _linear(x, w, b):
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def _qkv(lp, h, H, Dh):
    y = _linear(h, lp["qkv_w"], lp["qkv_b"])
    B, L, _ = y.shape
    q, k, v = torch.chunk(y, 3, dim=-1)
    reshape = lambda t: t.reshape(B, L, H, Dh).transpose(1, 2)
    return reshape(q), reshape(k), reshape(v)


def _wkr(lp, r, H, Dh):
    # r: (K, D) sinusoid table → (H, K, Dh)
    y = _linear(r, lp["r_w"], lp["r_b"])
    K = r.shape[0]
    return y.reshape(K, H, Dh).transpose(0, 1)


def _check_supported(cfg: TXLConfig):
    if cfg.encode_position:
        raise NotImplementedError(
            "beat-position embeddings (encode_position=True) are not ported "
            "yet; see ROADMAP.md")


def _block_tail(lp, cfg, h, attn):
    out = _linear(attn, lp["out_w"], lp["out_b"])
    h2 = _layer_norm(h + out, lp["ln1_g"], lp["ln1_b"])
    ff = _act(_linear(h2, lp["ff1_w"], lp["ff1_b"]), cfg.act)
    ff = _linear(ff, lp["ff2_w"], lp["ff2_b"])
    return _layer_norm(h2 + ff, lp["ln2_g"], lp["ln2_b"])


def _logits(params, h_last):
    logits = h_last.to(F32) @ params["embed"].to(F32).T
    if params.get("head_b") is not None:
        logits = logits + params["head_b"].to(F32)
    return logits


class KVCache(NamedTuple):
    """Right-aligned per-layer K/V cache: (n_layers, B, M, H, Dh)."""
    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor  # (B,) int32


def init_kv_cache(cfg: TXLConfig, batch: int, mem_len: Optional[int] = None,
                  device=None) -> KVCache:
    M = cfg.mem_len if mem_len is None else mem_len
    shape = (cfg.n_layers, batch, M, cfg.n_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                   valid=torch.zeros((batch,), dtype=torch.int32, device=device))


def _flash_auto(cfg: TXLConfig, x: torch.Tensor, device=None) -> bool:
    """The JAX package's rule for the flash prefill kernel, read on
    ``device`` (default: ``x``'s): a CUDA device, a bf16 config and
    W <= 2048 with B >= 8 (the per-row work amortizes the kernel's fixed
    cost) or 2048 < W <= 8192 (the materialized scores grow quadratically).
    A head width the kernel is not built for takes the materialized branch."""
    B, W = x.shape
    dev = torch.device(device) if device is not None else x.device
    return (dev.type == "cuda" and cfg.act_dtype == torch.bfloat16
            and cfg.d_head in KERNEL_HEAD_DIMS
            and ((W <= 2048 and B >= 8) or 2048 < W <= 8192))


def prefill(
    params: Dict,
    cfg: TXLConfig,
    x: torch.Tensor,            # (B, W) LEFT-padded prompt window
    pad_mask: torch.Tensor,     # (B, W) True where x is left-padding
    pos: Optional[torch.Tensor] = None,
    mem_len: Optional[int] = None,
    flash: Optional[bool] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Process a fixed-width prompt window, returning last-token logits and a
    KV cache holding the window's keys/values (right-aligned by construction).

    ``flash``: attention through ``ops.flash_prefill.flash_prefill_attention``
    (the hand-written kernel on the card, its plain version on the CPU)
    instead of the branch that materializes the (B, H, W, W) scores; None
    picks it by :func:`_flash_auto`, which never picks it on the CPU. Padded
    columns are masked out of attention either way, so the cache validity is
    the true prompt length.
    """
    _check_supported(cfg)
    B, W = x.shape
    dt = cfg.act_dtype
    dev = x.device
    M = cfg.mem_len if mem_len is None else mem_len
    if flash is None:
        flash = _flash_auto(cfg, x)
    h = params["embed"][x].to(dt)
    r = backwards_pos_enc(W, cfg.d_model, dtype=dt, device=dev)
    if not flash:
        mask = causal_window_mask(W, 0, 1, 1, device=dev)
        mask = mask | pad_mask[:, None, None, :]

    H, Dh = cfg.n_heads, cfg.d_head
    u_b, v_b = params["u"].to(dt), params["v"].to(dt)
    ks, vs = [], []
    for lp in params["layers"]:
        if flash:
            y = _linear(h, lp["qkv_w"], lp["qkv_b"])
            q_f, k_f, v_f = (t.contiguous() for t in torch.chunk(y, 3, dim=-1))
            ks.append(k_f.reshape(B, W, H, Dh)[:, -M:])
            vs.append(v_f.reshape(B, W, H, Dh)[:, -M:])
            wkr_flat = _linear(r, lp["r_w"], lp["r_b"])           # (W, HD)
            attn = flash_prefill_attention(q_f, k_f, v_f, wkr_flat, u_b, v_b,
                                           pad_mask, H, scale=cfg.scale)
        else:
            q, k, vv = _qkv(lp, h, H, Dh)
            ks.append(k.transpose(1, 2)[:, -M:])    # (B, min(W, M), H, Dh)
            vs.append(vv.transpose(1, 2)[:, -M:])
            wkr = _wkr(lp, r, H, Dh)
            attn = rel_attention(q, k, vv, wkr, u_b, v_b, mask=mask,
                                 scale=cfg.scale, shift=True)
            attn = attn.transpose(1, 2).reshape(B, W, H * Dh)
        h = _block_tail(lp, cfg, h, attn)

    logits = _logits(params, h[:, -1])
    n_valid = torch.clamp((~pad_mask).sum(dim=1).to(torch.int32), max=M)
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if W < M:
        padk = (0, 0, 0, 0, M - W, 0)  # left-pad the slot axis
        k_all = torch.nn.functional.pad(k_all, padk)
        v_all = torch.nn.functional.pad(v_all, padk)
    return logits, KVCache(k=k_all, v=v_all, valid=n_valid)


# ---------------------------------------------------------------------------
# Ring-buffer KV cache decode
#
# One slot is written per step; relative positions resolve through a per-slot
# global-index array:
#   * cache layout (n_layers, B, H, M, Dh) — head-major,
#   * slot j holds the token with global index g[b, j] (pads: PAD_G),
#   * distance(current → slot) = g_cur - g[b, j]; masked unless 1 ≤ d ≤ M,
#   * the BD term reads distance-space scores s_d = (q+v)·W_r·sinusoid(d),
#     d ∈ [0..M], rotated by the ring pointer, with wkr precomputed once.
# ---------------------------------------------------------------------------

class RingKVCache(NamedTuple):
    k: torch.Tensor        # (n_layers, B, H, M, Dh)
    v: torch.Tensor        # (n_layers, B, H, M, Dh)
    g: torch.Tensor        # (B, M) int32: global index per slot (pad → PAD_G)
    ptr: int               # next slot to overwrite
    g_cur: int             # global index of the token being decoded


PAD_G = -(1 << 30)


def precompute_wkr(params: Dict, cfg: TXLConfig, mem_len: int) -> torch.Tensor:
    """(n_layers, H, M+1, Dh): r_attn projection of distances M..0, hoisted
    out of the decode loop (it is loop-invariant)."""
    dt = cfg.act_dtype
    dev = params["embed"].device
    r = backwards_pos_enc(mem_len + 1, cfg.d_model, dtype=dt, device=dev)
    return torch.stack([_wkr(lp, r, cfg.n_heads, cfg.d_head)
                        for lp in params["layers"]])


def ring_from_prefill(cache: KVCache, cfg: TXLConfig) -> RingKVCache:
    """Convert the right-aligned prefill cache into ring form.

    Prefill slot j (of M, right-aligned) holds the prompt token with global
    index j - M (last prompt token → -1); per-row invalid slots get PAD_G.
    The ring pointer starts at 0, overwriting the oldest slot first.
    """
    L, B, M, H, Dh = cache.k.shape
    k = cache.k.permute(0, 1, 3, 2, 4).contiguous()  # → (L, B, H, M, Dh)
    v = cache.v.permute(0, 1, 3, 2, 4).contiguous()
    slot = torch.arange(M, device=cache.k.device)[None, :]
    valid = slot >= (M - cache.valid[:, None])       # (B, M)
    g = torch.where(valid, slot - M, PAD_G).to(torch.int32)
    return RingKVCache(k=k, v=v, g=g, ptr=0, g_cur=0)


def decode_step_ring(
    params: Dict,
    cfg: TXLConfig,
    tok: torch.Tensor,      # (B,)
    pos: torch.Tensor,      # (B,) beat positions (unused: no beat embedding)
    cache: RingKVCache,
    wkr_all: torch.Tensor,  # (L, H, M+1, Dh) from precompute_wkr
) -> Tuple[torch.Tensor, RingKVCache]:
    """One exact decode step against the ring cache (the ``xla`` path).

    Unlike the JAX function, this updates ``cache.k``, ``cache.v`` and
    ``cache.g`` in place (the new token's K/V go into slot ``ptr`` of each
    layer after that layer's attention has read the old slot) and returns a
    cache holding the same tensors with the pointer advanced."""
    _check_supported(cfg)
    B = tok.shape[0]
    dt = cfg.act_dtype
    H, Dh = cfg.n_heads, cfg.d_head
    M = cache.k.shape[3]
    h = params["embed"][tok].to(dt)[:, None, :]

    dist = cache.g_cur - cache.g                      # (B, M), ≥1 for valid slots
    blocked = (dist < 1) | (dist > M)
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0

    u_b, v_b = params["u"].to(dt), params["v"].to(dt)
    for i, lp in enumerate(params["layers"]):
        q, k1, v1 = _qkv(lp, h, H, Dh)                # (B, H, 1, Dh)
        ks, vs = cache.k[i], cache.v[i]               # (B, H, M, Dh)
        ac = torch.einsum("bhqd,bhkd->bhqk", (q + u_b).to(F32), ks.to(F32))[:, :, 0]
        # distance-space relative scores: wkr row m ↔ distance M-m. Ring slot
        # j holds distance ((ptr-1-j) mod M) + 1 — a pure rotation of s_d.
        s_d = torch.einsum("bhqd,hkd->bhqk", (q + v_b).to(F32),
                           wkr_all[i].to(F32))[:, :, 0]            # (B, H, M+1)
        bd = torch.roll(s_d[..., :M], cache.ptr, dims=-1)
        score = (ac + bd) * scale
        score = torch.where(blocked[:, None, :], NEG_INF, score)
        ac_self = torch.einsum("bhqd,bhqd->bhq", (q + u_b).to(F32), k1.to(F32))
        self_score = (ac_self[:, :, 0] + s_d[..., -1]) * scale     # distance 0
        full = torch.cat([score, self_score[:, :, None]], dim=-1)
        prob = torch.softmax(full, dim=-1).to(dt)
        attn = torch.einsum("bhk,bhkd->bhd", prob[..., :M].to(F32),
                            vs.to(F32)).to(dt)
        attn = attn + prob[..., M:M + 1] * v1[:, :, 0]
        h = _block_tail(lp, cfg, h, attn.reshape(B, 1, H * Dh))
        ks[:, :, cache.ptr] = k1[:, :, 0]
        vs[:, :, cache.ptr] = v1[:, :, 0]

    logits = _logits(params, h[:, 0])
    cache.g[:, cache.ptr] = cache.g_cur
    return logits, RingKVCache(k=cache.k, v=cache.v, g=cache.g,
                               ptr=(cache.ptr + 1) % M,
                               g_cur=cache.g_cur + 1)
