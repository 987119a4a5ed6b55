"""MusicTransformerXL as plain functions of a parameter dict: the parameter
initializer, the full-window training forward with XL memory, prompt
prefill, and the exact decode steps: the shift-append reference step and
the ring-cache step the engines run.

Architecture parity with the reference model (deep_music_genre.py:1603-1665
on top of fastai's TransformerXL): token embedding, N post-norm decoder
blocks with relative-position multi-head attention (shared ``u``/``v``
biases, fused qkv projection, per-layer ``r_w`` projection of a backwards
sinusoid table), erf GELU feed-forward, weight-tied output head.

``params`` is the JAX package's parameter tree, drawn by :func:`init_txl` or
carried over by
:func:`deepmusicgeneration_tpu_torch.train.checkpoint.params_from_numpy`:
``{"embed", "u", "v", "head_b", "layers": [{"qkv_w", "qkv_b", "r_w", "r_b",
"out_w", "out_b", "ln1_g", "ln1_b", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
"ln2_g", "ln2_b"}, ...]}``, with the same shapes.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

import numpy as np

from ..ops.flash_prefill import KERNEL_HEAD_DIMS, flash_prefill_attention
from ..ops.flash_train import flash_train_attention, kernel_supports
from ..ops.rel_attention import (
    NEG_INF,
    backwards_pos_enc,
    causal_window_mask,
    rel_attention,
)
from .config import TXLConfig, btp_phase1_config

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


def _dropout(x, rate: float, generator: Optional[torch.Generator], train: bool):
    """Inverted dropout: keep with probability 1 - rate, scale by 1 / (1 - rate)."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _block_tail(lp, cfg, h, attn, generator=None, train=False):
    """Output projection, residual + LayerNorm, feed-forward, residual +
    LayerNorm; with ``train`` and a generator, the residual and feed-forward
    dropouts (``models/txl.py:249-262`` of the JAX package)."""
    out = _linear(attn, lp["out_w"], lp["out_b"])
    out = _dropout(out, cfg.resid_p, generator, train)
    h2 = _layer_norm(h + out, lp["ln1_g"], lp["ln1_b"])
    ff = _act(_linear(h2, lp["ff1_w"], lp["ff1_b"]), cfg.act)
    ff = _dropout(ff, cfg.ff_p, generator, train)
    ff = _dropout(_linear(ff, lp["ff2_w"], lp["ff2_b"]), cfg.ff_p, generator, train)
    return _layer_norm(h2 + ff, lp["ln2_g"], lp["ln2_b"])


def _logits(params, h_last):
    logits = h_last.to(F32) @ params["embed"].to(F32).T
    if params.get("head_b") is not None:
        logits = logits + params["head_b"].to(F32)
    return logits


# ---------------------------------------------------------------------------
# Parameters and the full-window (training) forward
# ---------------------------------------------------------------------------

def _linear_init(generator: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=F32) * std


def init_txl(cfg: TXLConfig, generator: Optional[torch.Generator] = None,
             device=None) -> Dict:
    """Fresh float32 parameters, the JAX package's tree (``init_txl``,
    fastai's init_transformer): N(0, 0.02) weights, LayerNorm gains
    1 + N(0, 0.02), zero biases, None for absent biases. Drawn on the CPU
    from ``generator`` (seed 0 if None), then moved to ``device``."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    H, Dh, D = cfg.n_heads, cfg.d_head, cfg.d_model
    zeros = lambda n: torch.zeros((n,), dtype=F32)
    params = {
        "embed": _linear_init(g, (cfg.vocab_size, D)),
        "u": _linear_init(g, (H, 1, Dh)),
        "v": _linear_init(g, (H, 1, Dh)),
        "head_b": zeros(cfg.vocab_size) if cfg.out_bias else None,
    }
    if cfg.encode_position:
        params["beat_enc"] = _linear_init(g, (cfg.beat_len, D))
        params["bar_enc"] = _linear_init(g, (cfg.max_bar_len, D))
    params["layers"] = [{
        "qkv_w": _linear_init(g, (D, 3 * H * Dh)),
        "qkv_b": zeros(3 * H * Dh) if cfg.bias else None,
        "r_w": _linear_init(g, (D, H * Dh)),
        "r_b": zeros(H * Dh) if cfg.bias else None,
        "out_w": _linear_init(g, (H * Dh, D)),
        "out_b": zeros(D) if cfg.bias else None,
        "ln1_g": 1.0 + _linear_init(g, (D,)),
        "ln1_b": zeros(D),
        "ff1_w": _linear_init(g, (D, cfg.d_inner)),
        "ff1_b": zeros(cfg.d_inner),
        "ff2_w": _linear_init(g, (cfg.d_inner, D)),
        "ff2_b": zeros(D),
        "ln2_g": 1.0 + _linear_init(g, (D,)),
        "ln2_b": zeros(D),
    } for _ in range(cfg.n_layers)]
    return tree_map(lambda t: t.to(device), params) if device is not None else params


def tree_leaves(params):
    """The tensors of a parameter tree, None leaves skipped, in JAX's leaf
    order (each dict's keys sorted, lists in order)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in tree_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for x in params for t in tree_leaves(x)]
    return [] if params is None else [params]


def tree_map(fn, params):
    """``fn`` on every tensor of a parameter tree; None leaves stay None."""
    if isinstance(params, dict):
        return {k: tree_map(fn, v) for k, v in params.items()}
    if isinstance(params, list):
        return [tree_map(fn, v) for v in params]
    return None if params is None else fn(params)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


class TXLState(NamedTuple):
    """XL hidden-state memory: right-aligned (n_layers, B, M, D) and the
    number of filled slots (a host int)."""
    mem: torch.Tensor
    valid: int


def init_state(cfg: TXLConfig, batch: int, mem_len: Optional[int] = None,
               device=None) -> TXLState:
    M = cfg.mem_len if mem_len is None else mem_len
    return TXLState(mem=torch.zeros((cfg.n_layers, batch, M, cfg.d_model),
                                    dtype=cfg.act_dtype, device=device), valid=0)


def flash_train_auto(cfg: TXLConfig, B: int, L: int, seq: int, device) -> bool:
    """The JAX package's rule for the flash train kernel (``txl.py:337-340``)
    with "TPU" read as a CUDA device: a bf16 config, B >= 8, L and M + L
    multiples of 128, M + L <= 2048. Where the rule holds but the CUDA
    kernels do not take the shape (``ops.flash_train.kernel_supports``), it
    raises rather than let the card run the score path."""
    if not (torch.device(device).type == "cuda" and cfg.act_dtype == torch.bfloat16
            and B >= 8 and L % 128 == 0 and seq % 128 == 0 and seq <= 2048):
        return False
    why = kernel_supports(B, L, seq, cfg.n_heads, cfg.n_heads * cfg.d_head, cfg.act_dtype)
    if why is not None:
        raise NotImplementedError(
            f"the flash train kernel has no CUDA version for B={B}, L={L}, M+L={seq}, "
            f"{cfg.n_heads} x {cfg.d_head} heads: {why}")
    return True


def _train_attention(lp, cfg, h, h_ctx, r, u, v, mask, flash_args, generator,
                     attn_seeds, train):
    """One layer's attention over [memory, window]: the flash train kernel
    with ``flash_args = (win_size, win_k, mem_valid, pad_mask)``, else the
    materialized score path under ``mask``. Returns (B, L, H * Dh)."""
    H, Dh = cfg.n_heads, cfg.d_head
    HD = H * Dh
    attn_p = cfg.attn_p if (train and generator is not None) else 0.0
    if flash_args is not None:
        win_size, win_k, mem_valid, pad_mask = flash_args
        dt = h.dtype
        w = lp["qkv_w"].to(dt)
        q = h @ w[:, :HD]
        kv = h_ctx @ w[:, HD:]
        if lp["qkv_b"] is not None:
            bqkv = lp["qkv_b"].to(dt)
            q = q + bqkv[:HD]
            kv = kv + bqkv[HD:]
        wkr_flat = _linear(r, lp["r_w"], lp["r_b"])
        # drop_att rides inside the kernel (counter-hash mask, identical
        # forward and backward), seeded per layer from the host
        seed = int(attn_seeds.integers(0, 2 ** 31 - 1)) if attn_p > 0.0 else None
        return flash_train_attention(q, kv[..., :HD], kv[..., HD:], wkr_flat, u, v,
                                     win_size, win_k, mem_valid, H, pad_mask=pad_mask,
                                     scale=cfg.scale, attn_p=attn_p, attn_seed=seed)
    q, _, _ = _qkv(lp, h, H, Dh)
    _, k, vv = _qkv(lp, h_ctx, H, Dh)
    attn = rel_attention(q, k, vv, _wkr(lp, r, H, Dh), u, v, mask=mask, scale=cfg.scale,
                         shift=True, attn_p=attn_p, generator=generator)
    B, _, L, _ = attn.shape
    return attn.transpose(1, 2).reshape(B, L, HD)


def forward(
    params: Dict,
    cfg: TXLConfig,
    x: torch.Tensor,                       # (B, L) token ids
    pos: Optional[torch.Tensor] = None,    # (B, L) beat positions (unused: no beat embedding)
    state: Optional[TXLState] = None,
    train: bool = False,
    rng: Optional[int] = None,
    win_size: int = 1,
    win_k: int = 1,
    pad_mask: Optional[torch.Tensor] = None,   # (B, L) True where x is padding
    flash: Optional[bool] = None,
    mesh=None,
    ring_mesh=None,
) -> Tuple[torch.Tensor, Optional[TXLState]]:
    """Full-window forward (``models/txl.py::forward`` of the JAX package).
    Returns (logits (B, L, V) float32, new_state).

    ``rng``: an int seed for the dropouts when ``train`` (None: no dropout);
    the masks are drawn on ``x``'s device from a generator it seeds, the
    flash kernel's attention seeds from a host generator it seeds.
    ``flash``: every layer's attention through
    ``ops.flash_train.flash_train_attention`` (the CUDA kernels on the card,
    its plain version on the CPU) instead of the materialized score path;
    None picks it by :func:`flash_train_auto`, which never picks it on the
    CPU. On the card, shapes the kernels do not take raise, whether
    ``flash=True`` was explicit or picked. The new XL memory is each layer's input over the last
    M positions, detached; its fill count grows by L, capped at M.
    """
    _check_supported(cfg)
    if mesh is not None or ring_mesh is not None:
        raise NotImplementedError(
            "mesh and ring (sequence-parallel) training are not ported yet; see "
            "ROADMAP.md Queue 1 item 14")
    B, L = x.shape
    dt = cfg.act_dtype
    dev = x.device
    generator = (torch.Generator(device=dev).manual_seed(int(rng))
                 if (train and rng is not None) else None)
    attn_seeds = np.random.default_rng(int(rng)) if generator is not None else None
    h = _dropout(params["embed"][x].to(dt), cfg.embed_p, generator, train)

    M = state.mem.shape[2] if state is not None else 0
    seq = M + L
    r = backwards_pos_enc(seq, cfg.d_model, dtype=dt, device=dev)
    if flash is None:
        flash = flash_train_auto(cfg, B, L, seq, dev)
    mem_valid = state.valid if state is not None else 0
    mask, flash_args = None, None
    if flash:
        flash_args = (win_size, win_k, mem_valid, pad_mask)
    else:
        mask = causal_window_mask(L, M, win_size, win_k,
                                  mem_valid=mem_valid if state is not None else None,
                                  device=dev)
        if pad_mask is not None:
            # block attention *to* padded positions of the current window
            blocked_cols = torch.cat([torch.zeros((B, M), dtype=torch.bool, device=dev),
                                      pad_mask], dim=1)[:, None, None, :]
            mask = mask | blocked_cols

    u, v = params["u"].to(dt), params["v"].to(dt)
    new_mem = []
    for i, lp in enumerate(params["layers"]):
        if state is not None:
            h_ctx = torch.cat([state.mem[i].to(dt), h], dim=1)
            new_mem.append(h_ctx[:, -M:].detach() if M else state.mem[i])
        else:
            h_ctx = h
        attn = _train_attention(lp, cfg, h, h_ctx, r, u, v, mask, flash_args, generator,
                                attn_seeds, train)
        h = _block_tail(lp, cfg, h, attn, generator, train)

    logits = _logits(params, _dropout(h, cfg.output_p, generator, train))
    new_state = state
    if state is not None and M:
        new_state = TXLState(mem=torch.stack(new_mem), valid=min(state.valid + L, M))
    return logits, new_state


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


def decode_step(
    params: Dict,
    cfg: TXLConfig,
    tok: torch.Tensor,    # (B,) current token
    pos: torch.Tensor,    # (B,) beat positions (unused: no beat embedding)
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step against the right-aligned cache: the logits for the
    next token and a new cache whose slots have moved left by one, the
    token's K/V appended (``valid`` saturates at M). The current token
    attends over the M cached slots and itself (distances M..0); slots
    before the row's ``valid`` most recent ones are blocked. The JAX
    package's reference form of :func:`decode_step_ring`, which computes
    the same function with one slot write a step."""
    _check_supported(cfg)
    B = tok.shape[0]
    dt = cfg.act_dtype
    dev = tok.device
    H, Dh = cfg.n_heads, cfg.d_head
    M = cache.k.shape[2]
    h = params["embed"][tok].to(dt)[:, None, :]
    r = backwards_pos_enc(M + 1, cfg.d_model, dtype=dt, device=dev)
    slot = torch.arange(M + 1, device=dev)[None, None, None, :]
    mask = slot < (M - cache.valid.reshape(B, 1, 1, 1))   # self (slot M) always visible
    u_b, v_b = params["u"].to(dt), params["v"].to(dt)
    new_k, new_v = [], []
    for i, lp in enumerate(params["layers"]):
        q, k1, v1 = _qkv(lp, h, H, Dh)                       # (B, H, 1, Dh)
        k_full = torch.cat([cache.k[i].transpose(1, 2).to(dt), k1], dim=2)
        v_full = torch.cat([cache.v[i].transpose(1, 2).to(dt), v1], dim=2)
        attn = rel_attention(q, k_full, v_full, _wkr(lp, r, H, Dh), u_b, v_b, mask=mask,
                             scale=cfg.scale, shift=False)
        h = _block_tail(lp, cfg, h, attn.transpose(1, 2).reshape(B, 1, H * Dh))
        new_k.append(torch.cat([cache.k[i][:, 1:], k1.transpose(1, 2)], dim=1))
        new_v.append(torch.cat([cache.v[i][:, 1:], v1.transpose(1, 2)], dim=1))
    return _logits(params, h[:, 0]), KVCache(k=torch.stack(new_k), v=torch.stack(new_v),
                                             valid=torch.clamp(cache.valid + 1, max=M))


def txl_config_41m() -> TXLConfig:
    """The 41M genre flagship's config (``btp_phase1_config``)."""
    return btp_phase1_config()


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


# ---------------------------------------------------------------------------
# int8-quantized ring KV cache (``kv_int8`` on the exact path)
#
# Per-(slot, head) symmetric int8 over Dh, scale max(amax / 127, 1e-8): the
# JAX package's contract (``models/txl.py::_quantize_rows``); everything else
# is the exact ring step.
# ---------------------------------------------------------------------------

class RingKVCacheQ(NamedTuple):
    k_q: torch.Tensor      # (L, B, H, M, Dh) int8
    k_s: torch.Tensor      # (L, B, H, M, 1) fp32 scales
    v_q: torch.Tensor
    v_s: torch.Tensor
    g: torch.Tensor        # (B, M) int32
    ptr: int
    g_cur: int


def _quantize_rows(x: torch.Tensor):
    """Symmetric int8 over the last axis; returns (int8, scale[..., :1])."""
    x32 = x.to(F32)
    scale = torch.clamp_min(x32.abs().amax(-1, keepdim=True) / 127.0, 1e-8)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def quantize_ring(cache: RingKVCache) -> RingKVCacheQ:
    k_q, k_s = _quantize_rows(cache.k)
    v_q, v_s = _quantize_rows(cache.v)
    return RingKVCacheQ(k_q=k_q, k_s=k_s, v_q=v_q, v_s=v_s, g=cache.g,
                        ptr=cache.ptr, g_cur=cache.g_cur)


def decode_step_ring_q(
    params: Dict,
    cfg: TXLConfig,
    tok: torch.Tensor,      # (B,)
    pos: torch.Tensor,      # (B,) beat positions (unused: no beat embedding)
    cache: RingKVCacheQ,
    wkr_all: torch.Tensor,  # (L, H, M+1, Dh) from precompute_wkr
) -> Tuple[torch.Tensor, RingKVCacheQ]:
    """:func:`decode_step_ring` over int8 K/V dequantized in the act dtype
    (int8 x scale, both cast first); the fresh token's K/V are quantized
    into slot ``ptr`` of each layer, in place, after that layer's attention
    has read the old slot. Returns the cache with the pointer advanced."""
    _check_supported(cfg)
    B = tok.shape[0]
    dt = cfg.act_dtype
    H, Dh = cfg.n_heads, cfg.d_head
    M = cache.k_q.shape[3]
    h = params["embed"][tok].to(dt)[:, None, :]
    dist = cache.g_cur - cache.g
    blocked = (dist < 1) | (dist > M)
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0

    u_b, v_b = params["u"].to(dt), params["v"].to(dt)
    for i, lp in enumerate(params["layers"]):
        q, k1, v1 = _qkv(lp, h, H, Dh)                # (B, H, 1, Dh)
        ks = cache.k_q[i].to(dt) * cache.k_s[i].to(dt)
        vs = cache.v_q[i].to(dt) * cache.v_s[i].to(dt)
        ac = torch.einsum("bhqd,bhkd->bhqk", (q + u_b).to(F32), ks.to(F32))[:, :, 0]
        s_d = torch.einsum("bhqd,hkd->bhqk", (q + v_b).to(F32),
                           wkr_all[i].to(F32))[:, :, 0]            # (B, H, M+1)
        bd = torch.roll(s_d[..., :M], cache.ptr, dims=-1)
        score = torch.where(blocked[:, None, :], NEG_INF, (ac + bd) * scale)
        ac_self = torch.einsum("bhqd,bhqd->bhq", (q + u_b).to(F32), k1.to(F32))
        self_score = (ac_self[:, :, 0] + s_d[..., -1]) * scale
        full = torch.cat([score, self_score[:, :, None]], dim=-1)
        prob = torch.softmax(full, dim=-1).to(dt)
        attn = torch.einsum("bhk,bhkd->bhd", prob[..., :M].to(F32),
                            vs.to(F32)).to(dt)
        attn = attn + prob[..., M:M + 1] * v1[:, :, 0]
        h = _block_tail(lp, cfg, h, attn.reshape(B, 1, H * Dh))
        for q8, s8, x in ((cache.k_q, cache.k_s, k1), (cache.v_q, cache.v_s, v1)):
            xq, xs = _quantize_rows(x[:, :, 0])
            q8[i, :, :, cache.ptr] = xq
            s8[i, :, :, cache.ptr] = xs

    logits = _logits(params, h[:, 0])
    cache.g[:, cache.ptr] = cache.g_cur
    return logits, cache._replace(ptr=(cache.ptr + 1) % M, g_cur=cache.g_cur + 1)
