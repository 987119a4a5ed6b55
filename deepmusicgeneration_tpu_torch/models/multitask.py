"""MultiTransformer: the multitask encoder-decoder (mask infill, next-word
continuation, seq2seq harmonization) as plain functions of a parameter dict,
for training and inference.

The JAX package's ``models/multitask.py``, with its structural quirks of the
reference architecture:

* separate q/k/v projections with biases, **no output projection**
  (d_model == n_heads * d_head), post-norm ``ln(q + attn)``,
* ``u``/``v`` relative biases shared by a whole stack,
* a block runs self-attention, and only with an encoder output to attend to
  does it run cross-attention and the feed-forward: the mask and next-word
  paths are attention-only stacks,
* the relative sinusoid table spans ``max(L, Le) + mem_len`` positions and
  is sliced to the key length,
* cross-attention zeroes the strictly upper band of the shifted relative
  scores (``r_mask``), self-attention does not,
* token + beat + bar embeddings, each zero at its padding index,
* a tied output head with a bias.

``params`` is the JAX package's tree carried over by
:func:`..train.checkpoint.multitask_params_from_numpy`: ``{"embed",
"beat_enc", "bar_enc", "head_b", "encoder"/"decoder": {"u", "v", "layers":
[{"mha1", "mha2": {"q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "r_w", "r_b",
"ln_g", "ln_b"}, "ff1_w", "ff1_b", "ff2_w", "ff2_b", "ff_ln_g",
"ff_ln_b"}]}}``.

Training (:func:`forward` over a task dict with ``train=True``) applies the
reference's dropouts (embed_p, attn_p, resid_p, ff_p, output_p) and the
decoder's window-mask curriculum. Its random draws come from int seeds
folded per module (:func:`_fold`), each dropout from a ``torch.Generator``
seeded on the tensors' device, so a block recomputed under ``remat``
(``torch.utils.checkpoint``) draws the same masks again; the numbers differ
from JAX's ``jax.random``. On the card, a bf16 config at B >= 8 runs every
attention of the step through the flash train kernels
(:func:`_flash_train_ok`): the decoder's causal-window attention, the
encoder's bidirectional attention and the cross attention, with attn_p
inside the kernels. At inference (:func:`encode`, :func:`decoder_prefill`,
:func:`lm_prefill`) a bf16 config at B >= 8, W <= 512 runs the window's
self-attention through the flash prefill kernels (:func:`_flash_ok`).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops import flash_prefill as fp
from ..ops import flash_train as ft
from ..ops.rel_attention import (NEG_INF, backwards_pos_enc, causal_window_mask,
                                 rel_attention)
from .config import MultitaskConfig
from .txl import PAD_G, _dropout, _layer_norm, _logits, tree_leaves

F32 = torch.float32


def _attn_init(randn, cfg: MultitaskConfig) -> Dict:
    D, HD = cfg.d_model, cfg.n_heads * cfg.d_head
    zeros = lambda n: randn(n).zero_() if cfg.bias else None
    return {"q_w": randn(D, HD), "k_w": randn(D, HD), "v_w": randn(D, HD),
            "q_b": zeros(HD), "k_b": zeros(HD), "v_b": zeros(HD),
            "r_w": randn(D, HD), "r_b": zeros(HD),
            "ln_g": 1.0 + randn(D), "ln_b": randn(D).zero_()}


def init_multitask(cfg: MultitaskConfig, generator: Optional[torch.Generator] = None,
                   device=None) -> Dict:
    """Fresh float32 parameters with the JAX package's shapes and
    distribution (``init_multitask``): weights N(0, 0.02^2), LayerNorm gains
    1 + N(0, 0.02^2), zero biases and LayerNorm offsets, a zero padding row
    in the embedding. The draws come from ``generator`` (on ``device``, which
    defaults to the generator's), so they differ from JAX's threefry
    numbers."""
    if device is None:
        device = generator.device if generator is not None else "cpu"

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    def stack(n):
        return {"u": randn(cfg.n_heads, 1, cfg.d_head),
                "v": randn(cfg.n_heads, 1, cfg.d_head),
                "layers": [{"mha1": _attn_init(randn, cfg), "mha2": _attn_init(randn, cfg),
                            "ff1_w": randn(cfg.d_model, cfg.d_inner),
                            "ff1_b": randn(cfg.d_inner).zero_(),
                            "ff2_w": randn(cfg.d_inner, cfg.d_model),
                            "ff2_b": randn(cfg.d_model).zero_(),
                            "ff_ln_g": 1.0 + randn(cfg.d_model),
                            "ff_ln_b": randn(cfg.d_model).zero_()}
                           for _ in range(n)]}

    params = {"embed": randn(cfg.vocab_size, cfg.d_model),
              "beat_enc": randn(cfg.beat_len, cfg.d_model),
              "bar_enc": randn(cfg.max_bar_len, cfg.d_model),
              "encoder": stack(cfg.enc_layers),
              "decoder": stack(cfg.dec_layers),
              "head_b": randn(cfg.vocab_size).zero_() if cfg.out_bias else None}
    params["embed"][1] = 0.0            # padding-index row (pad_idx == 1)
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _fold(seed: Optional[int], i: int) -> Optional[int]:
    """A seed for sub-module ``i`` of the module seeded ``seed`` (JAX's
    ``fold_in``; None stays None): a non-negative int32."""
    if seed is None:
        return None
    return int(np.random.SeedSequence([int(seed), i]).generate_state(1)[0] & 0x7FFFFFFF)


def _gen(seed: Optional[int], device) -> Optional[torch.Generator]:
    return None if seed is None else torch.Generator(device=device).manual_seed(seed)


def _rnn_dropout(x, rate: float, generator: Optional[torch.Generator], train: bool):
    """fastai RNNDropout: one (B, 1, D) mask broadcast over the sequence."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = torch.rand((x.shape[0], 1, x.shape[-1]), generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def embed_tokens(params: Dict, cfg: MultitaskConfig, x: torch.Tensor,
                 pos: Optional[torch.Tensor], pad_idx: int = 1, rng: Optional[int] = None,
                 train: bool = False) -> torch.Tensor:
    """Token + beat + bar embeddings, each zero at its padding index (the
    pad token, beat 0, bar 0); embed_p dropout on the sum when ``train``
    with a seed ``rng``."""
    dt = cfg.act_dtype
    emb = params["embed"][x].to(dt)
    emb = torch.where((x == pad_idx)[..., None], 0.0, emb).to(dt)
    if pos is not None:
        pos = pos.long()
        beat = pos % cfg.beat_len
        bar = torch.clamp(torch.div(pos, cfg.beat_len, rounding_mode="floor")
                          % cfg.max_bar_len, max=cfg.max_bar_len - 1)
        be = torch.where((beat == 0)[..., None], 0.0, params["beat_enc"][beat].to(dt))
        ba = torch.where((bar == 0)[..., None], 0.0, params["bar_enc"][bar].to(dt))
        emb = emb + be.to(dt) + ba.to(dt)
    return _dropout(emb, cfg.embed_p, _gen(rng, x.device), train)


def _lin(x, w, b):
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def _proj(h, w, b, H: int, Dh: int):
    """(B, L, D) → (B, H, L, Dh)."""
    y = _lin(h, w, b)
    B, L, _ = y.shape
    return y.reshape(B, L, H, Dh).transpose(1, 2)


def _wkr_of(ap, r, H: int, Dh: int):
    """(K, D) sinusoid table → (H, K, Dh) relative keys."""
    return _lin(r, ap["r_w"], ap["r_b"]).reshape(r.shape[0], H, Dh).transpose(0, 1)


def _attn_apply(ap, cfg: MultitaskConfig, q_in, kv_in, r, u, v, mask, r_mask: bool,
                rng: Optional[int] = None, train: bool = False):
    """ln(q_in + drop_res(rel_attention(q_in, kv_in))) with no output
    projection; with ``train`` and a seed, attn_p dropout on the
    probabilities and resid_p on the attention output."""
    H, Dh = cfg.n_heads, cfg.d_head
    B, Lq, _ = q_in.shape
    K = kv_in.shape[1]
    q = _proj(q_in, ap["q_w"], ap["q_b"], H, Dh)
    k = _proj(kv_in, ap["k_w"], ap["k_b"], H, Dh)
    vv = _proj(kv_in, ap["v_w"], ap["v_b"], H, Dh)
    tr = train and rng is not None
    attn = rel_attention(q, k, vv, _wkr_of(ap, r[-K:], H, Dh), u, v,
                         mask=None if mask is None else mask[..., -K:],
                         scale=cfg.scale, shift=True, r_mask=r_mask,
                         attn_p=cfg.attn_p if tr else 0.0,
                         generator=_gen(_fold(rng, 0), q_in.device) if tr else None)
    attn = attn.to(q_in.dtype).transpose(1, 2).reshape(B, Lq, H * Dh)
    attn = _dropout(attn, cfg.resid_p, _gen(_fold(rng, 1), q_in.device), tr)
    return _layer_norm(q_in + attn, ap["ln_g"], ap["ln_b"])


def _act(x, kind: str):
    if kind == "gelu":
        return torch.nn.functional.gelu(x)       # the exact erf form
    if kind == "relu":
        return torch.relu(x)
    raise ValueError(kind)


def _ff(bp, cfg: MultitaskConfig, h, rng: Optional[int] = None, train: bool = False):
    """fastai feed_forward(double_drop=True): act, drop(ff_p), linear,
    drop(ff_p), residual, LayerNorm."""
    tr = train and rng is not None
    y = _act(_lin(h, bp["ff1_w"], bp["ff1_b"]), cfg.act)
    y = _dropout(y, cfg.ff_p, _gen(_fold(rng, 0), h.device), tr)
    y = _lin(y, bp["ff2_w"], bp["ff2_b"])
    y = _dropout(y, cfg.ff_p, _gen(_fold(rng, 1), h.device), tr)
    return _layer_norm(h + y, bp["ff_ln_g"], bp["ff_ln_b"])


def _causal_mask(L: int, win_size: int = 1, win_k: int = 1, device=None) -> torch.Tensor:
    """(1, 1, L, L) block-causal window mask (True = blocked; the
    ``rand_window_mask`` curriculum); column 0 always visible."""
    return causal_window_mask(L, 0, win_size, win_k, device=device)


def _stack_uv(stack: Dict, dt):
    return stack["u"].to(dt), stack["v"].to(dt)


def _flash_train_ok(cfg: MultitaskConfig, B: int, L: int, Le: Optional[int],
                    flag: Optional[bool], device) -> bool:
    """The JAX package's rule for the flash train kernels in the multitask
    step (``models/multitask.py:275-286``) with "TPU" read as a CUDA device:
    a bf16 config, B >= 8, L (and the encoder length Le) multiples of 128 and
    at most 512. ``flag`` overrides it. Where the rule holds but the CUDA
    kernels do not take the shapes, it raises rather than let the card run
    the score path."""
    if flag is not None:
        return flag
    if not (torch.device(device).type == "cuda" and cfg.act_dtype == torch.bfloat16
            and B >= 8 and L % 128 == 0 and L <= 512
            and (Le is None or (Le % 128 == 0 and Le <= 512))):
        return False
    HD = cfg.n_heads * cfg.d_head
    why = (ft.kernel_supports(B, L, L, cfg.n_heads, HD, cfg.act_dtype)
           or ft.mt_kernel_supports("bidir", B, L, L, cfg.n_heads, HD, cfg.act_dtype)
           or (Le is not None and ft.mt_kernel_supports("cross", B, L, Le, cfg.n_heads, HD,
                                                        cfg.act_dtype)))
    if why:
        raise NotImplementedError(
            f"the flash train kernels have no CUDA version for B={B}, L={L}, Le={Le}, "
            f"{cfg.n_heads} x {cfg.d_head} heads: {why}")
    return True


def _flash_ok(cfg: MultitaskConfig, B: int, W: int, flash: Optional[bool], device) -> bool:
    """The JAX package's rule for the inference self-attention through the
    flash kernels (``models/multitask.py:232-244``) with "TPU" read as a
    CUDA device: a bf16 config, B >= 8 and W <= 512, and heads both kernels
    of ``ops.flash_prefill.flash_encoder_attention`` take (the rule passes
    other shapes by). ``flash`` overrides it; an explicit True on the card
    raises where the kernels do not take the heads."""
    HD = cfg.n_heads * cfg.d_head
    why = fp.kernel_supports(cfg.n_heads, HD, False) or fp.kernel_supports(cfg.n_heads, HD,
                                                                            True)
    if flash is not None:
        if flash and torch.device(device).type == "cuda" and why:
            raise ValueError(f"flash=True: the flash prefill kernels have no CUDA version "
                             f"for {cfg.n_heads} x {cfg.d_head} heads: {why}")
        return flash
    return (torch.device(device).type == "cuda" and cfg.act_dtype == torch.bfloat16
            and B >= 8 and W <= 512 and not why)


def _flash_self_attn(ap, cfg: MultitaskConfig, h, pad_cols, u, v, causal: bool, kv=None):
    """One self-attention layer through ``flash_encoder_attention``:
    ln(h + attn(h)), the projections and the post-norm outside the kernel
    and no feed-forward (the encoder's blocks are attention only; the
    decoder prefill adds its cross-attention and feed-forward after it).
    ``kv`` passes already-projected (k, v), which the prefill computes for
    its cache anyway."""
    B, W, _ = h.shape
    q = _lin(h, ap["q_w"], ap["q_b"])
    k, vv = kv if kv is not None else (_lin(h, ap["k_w"], ap["k_b"]),
                                       _lin(h, ap["v_w"], ap["v_b"]))
    wkr = _lin(backwards_pos_enc(W, cfg.d_model, dtype=h.dtype, device=h.device),
               ap["r_w"], ap["r_b"])
    pad = pad_cols if pad_cols is not None else torch.zeros((B, W), dtype=torch.bool,
                                                             device=h.device)
    attn = fp.flash_encoder_attention(q, k, vv, wkr, u, v, pad, cfg.n_heads, scale=cfg.scale,
                                      causal=causal)
    return _layer_norm(h + attn, ap["ln_g"], ap["ln_b"])


def _wkr_flat(ap, r, K: int):
    """The last K rows of the sinusoid table through r_w: (K, H * Dh)."""
    return _lin(r[-K:], ap["r_w"], ap["r_b"])


def _flash_train_block(bp, cfg: MultitaskConfig, h, is_decoder: bool, enc_out, r, u, v,
                       win_size: int, win_k: int, pad_cols, rng: Optional[int] = None,
                       train: bool = False):
    """One block on the flash train kernels: the decoder's self-attention
    through ``flash_train_attention`` with no memory (M = 0) under the window
    curriculum, the encoder's through ``flash_bidir_attention``, the cross
    attention through ``flash_cross_attention``; projections, post-norms,
    resid_p / ff_p dropout and the feed-forward outside (the math of
    :func:`_attn_apply` / :func:`_ff`), attn_p inside the kernels, seeded
    from ``rng``."""
    L = h.shape[1]
    H, Dh = cfg.n_heads, cfg.d_head
    u2, v2 = u.reshape(H, Dh), v.reshape(H, Dh)
    tr = train and rng is not None
    attn_p = cfg.attn_p if tr else 0.0
    seed_of = lambda i: _fold(rng, i) if attn_p > 0.0 else None
    ap = bp["mha1"]
    q, k, vv = _lin(h, ap["q_w"], ap["q_b"]), _lin(h, ap["k_w"], ap["k_b"]), \
        _lin(h, ap["v_w"], ap["v_b"])
    wkr = _wkr_flat(ap, r, L)
    if is_decoder:
        attn = ft.flash_train_attention(q, k, vv, wkr, u2, v2, win_size, win_k, 0, H,
                                        pad_mask=pad_cols, scale=cfg.scale, attn_p=attn_p,
                                        attn_seed=seed_of(13))
    else:
        attn = ft.flash_bidir_attention(q, k, vv, wkr, u2, v2, H, pad_mask=pad_cols,
                                        scale=cfg.scale, attn_p=attn_p, attn_seed=seed_of(13))
    attn = _dropout(attn, cfg.resid_p, _gen(_fold(rng, 10), h.device), tr)
    h = _layer_norm(h + attn, ap["ln_g"], ap["ln_b"])
    if enc_out is not None:
        ap2 = bp["mha2"]
        q2 = _lin(h, ap2["q_w"], ap2["q_b"])
        k2, vv2 = _lin(enc_out, ap2["k_w"], ap2["k_b"]), _lin(enc_out, ap2["v_w"], ap2["v_b"])
        attn2 = ft.flash_cross_attention(q2, k2, vv2, _wkr_flat(ap2, r, enc_out.shape[1]), u2,
                                         v2, H, scale=cfg.scale, attn_p=attn_p,
                                         attn_seed=seed_of(14))
        attn2 = _dropout(attn2, cfg.resid_p, _gen(_fold(rng, 11), h.device), tr)
        h = _layer_norm(h + attn2, ap2["ln_g"], ap2["ln_b"])
        h = _ff(bp, cfg, h, rng=_fold(rng, 12), train=train)
    return h


def stack_forward(stack: Dict, cfg: MultitaskConfig, h: torch.Tensor, is_decoder: bool,
                  enc_out: Optional[torch.Tensor] = None,
                  self_mask: Optional[torch.Tensor] = None,
                  pad_cols: Optional[torch.Tensor] = None, win_size: int = 1, win_k: int = 1,
                  flash: Optional[bool] = None, remat: bool = False,
                  flash_train: Optional[bool] = None, mesh=None,
                  rng: Optional[int] = None, train: bool = False) -> torch.Tensor:
    """One stack over an embedded (B, L, D) input: causal self-attention for
    the decoder (under the ``win_size`` / ``win_k`` window curriculum),
    bidirectional for the encoder, with ``pad_cols`` (B, L) blocked as keys;
    cross-attention and the feed-forward only with ``enc_out`` (the
    reference's quirk: without it a block is attention only).

    ``flash`` routes an encoder stack's bidirectional self-attention
    through the flash prefill kernel (None: :func:`_flash_ok`'s rule; never
    on the CPU), with no dropout: an inference path. ``flash_train`` routes
    every attention through the flash train kernels (None:
    :func:`_flash_train_ok`'s rule; never on the CPU). ``remat``
    recomputes each block in the backward (``torch.utils.checkpoint``)
    instead of keeping its activations. ``rng``: the stack's int seed of the
    training dropouts, folded per layer."""
    if mesh is not None:
        raise NotImplementedError("mesh (sharded) multitask training is not ported yet; "
                                  "see ROADMAP.md Queue 1 item 14")
    B, L, D = h.shape
    dt = h.dtype
    Le = enc_out.shape[1] if enc_out is not None else None
    r = backwards_pos_enc(max(L, Le or 0) + cfg.mem_len, D, dtype=dt, device=h.device)
    u, v = _stack_uv(stack, dt)
    if (not is_decoder and enc_out is None and self_mask is None
            and _flash_ok(cfg, B, L, flash, h.device)):
        for bp in stack["layers"]:
            h = _flash_self_attn(bp["mha1"], cfg, h, pad_cols, u, v, causal=False)
        return h
    if self_mask is None and _flash_train_ok(cfg, B, L, Le, flash_train, h.device):
        def one_block(bp, h, lrng):
            return _flash_train_block(bp, cfg, h, is_decoder, enc_out, r, u, v, win_size,
                                      win_k, pad_cols, rng=lrng, train=train)
    else:
        if self_mask is None and is_decoder:
            self_mask = _causal_mask(L, win_size, win_k, h.device)
        if pad_cols is not None:
            pc = pad_cols[:, None, None, :]
            self_mask = pc if self_mask is None else (self_mask | pc)

        def one_block(bp, h, lrng):
            h = _attn_apply(bp["mha1"], cfg, h, h, r, u, v, self_mask, r_mask=False,
                            rng=_fold(lrng, 0), train=train)
            if enc_out is not None:
                h = _attn_apply(bp["mha2"], cfg, h, enc_out, r, u, v, None, r_mask=True,
                                rng=_fold(lrng, 1), train=train)
                h = _ff(bp, cfg, h, rng=_fold(lrng, 2), train=train)
            return h

    tr = train and rng is not None
    for i, bp in enumerate(stack["layers"]):
        lrng = _fold(rng, i) if tr else None
        if remat:
            h = torch.utils.checkpoint.checkpoint(one_block, bp, h, lrng, use_reentrant=False)
        else:
            h = one_block(bp, h, lrng)
    return h


def head(params: Dict, cfg: MultitaskConfig, h: torch.Tensor, rng: Optional[int] = None,
         train: bool = False) -> torch.Tensor:
    """RNNDropout(output_p) when ``train`` with a seed, then the tied linear
    head: float32 logits."""
    return _logits(params, _rnn_dropout(h, cfg.output_p, _gen(rng, h.device), train))


def forward(params: Dict, cfg: MultitaskConfig, inp: Dict[str, Dict[str, torch.Tensor]],
            pad_idx: int = 1, win_size: int = 1, win_k: int = 1, remat: bool = False,
            flash_train: Optional[bool] = None, mesh=None, rng: Optional[int] = None,
            train: bool = False) -> Dict[str, torch.Tensor]:
    """Task dict to logits dict (MultiTransformer.forward): 'msk' through the
    encoder, 'lm' through the decoder alone, 's2f' / 'f2s' / 'c2m' / 'm2c'
    through the encoder and the decoder with cross-attention. Each task's
    dict holds 'x' (and 'pos'), or 'enc', 'dec' (and 'enc_pos', 'dec_pos',
    'enc_pad', 'dec_pad'), as tensors on the parameters' device. ``rng``:
    the int seed of the training dropouts (None: none); ``flash_train``,
    ``remat``, ``win_size`` / ``win_k`` as :func:`stack_forward` takes
    them. No stack takes the inference flash route (``flash=False``), as in
    the JAX package."""
    out = {}
    tr = train and rng is not None
    sub = (lambda i: _fold(rng, i)) if tr else (lambda i: None)
    kw = dict(flash=False, remat=remat, flash_train=flash_train, mesh=mesh, train=train)
    if inp.get("msk") is not None:
        d = inp["msk"]
        h = embed_tokens(params, cfg, d["x"], d.get("pos"), pad_idx, rng=sub(0), train=train)
        h = stack_forward(params["encoder"], cfg, h, is_decoder=False, rng=sub(1), **kw)
        out["msk"] = head(params, cfg, h, rng=sub(2), train=train)
    if inp.get("lm") is not None:
        d = inp["lm"]
        h = embed_tokens(params, cfg, d["x"], d.get("pos"), pad_idx, rng=sub(3), train=train)
        h = stack_forward(params["decoder"], cfg, h, is_decoder=True, win_size=win_size,
                          win_k=win_k, rng=sub(4), **kw)
        out["lm"] = head(params, cfg, h, rng=sub(5), train=train)
    for j, key in enumerate(("s2f", "f2s", "c2m", "m2c")):
        if inp.get(key) is None:
            continue
        d = inp[key]
        eh = embed_tokens(params, cfg, d["enc"], d.get("enc_pos"), pad_idx,
                          rng=sub(10 + 10 * j), train=train)
        eh = stack_forward(params["encoder"], cfg, eh, is_decoder=False,
                           pad_cols=d.get("enc_pad"), rng=sub(11 + 10 * j), **kw)
        dh = embed_tokens(params, cfg, d["dec"], d.get("dec_pos"), pad_idx,
                          rng=sub(12 + 10 * j), train=train)
        dh = stack_forward(params["decoder"], cfg, dh, is_decoder=True, enc_out=eh,
                           pad_cols=d.get("dec_pad"), win_size=win_size, win_k=win_k,
                           rng=sub(13 + 10 * j), **kw)
        out[key] = head(params, cfg, dh, rng=sub(14 + 10 * j), train=train)
    return out


def encode(params: Dict, cfg: MultitaskConfig, x, pos, pad_cols=None,
           pad_idx: int = 1, flash: Optional[bool] = None) -> torch.Tensor:
    """The bidirectional encoder over (B, W) tokens; ``pad_cols`` blocks
    right-padding columns as keys. ``flash`` as :func:`stack_forward`."""
    h = embed_tokens(params, cfg, x, pos, pad_idx)
    return stack_forward(params["encoder"], cfg, h, is_decoder=False, pad_cols=pad_cols,
                         flash=flash)


class DecKVCache(NamedTuple):
    """Right-aligned decoder self-attention cache: (dec_layers, B, M, H, Dh)."""
    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor     # (B,) int32


def init_dec_cache(cfg: MultitaskConfig, batch: int, mem_len: Optional[int] = None,
                   device=None) -> DecKVCache:
    """An empty decoder cache (nothing valid) of M slots."""
    M = cfg.mem_len if mem_len is None else mem_len
    shape = (cfg.dec_layers, batch, M, cfg.n_heads, cfg.d_head)
    zeros = lambda: torch.zeros(shape, dtype=cfg.act_dtype, device=device)
    return DecKVCache(zeros(), zeros(), torch.zeros((batch,), dtype=torch.int32,
                                                    device=device))


def _prefill(params, cfg: MultitaskConfig, x, pos, pad_mask, enc_out, enc_pad,
             mem_len, pad_idx, flash):
    """The decoder over a LEFT-padded (B, W) prefix, with cross-attention
    and the feed-forward when ``enc_out`` is given; returns last-token logits
    and the cache of each layer's self-attention K/V. With :func:`_flash_ok`
    the self-attention runs through the causal flash kernel on the K/V the
    cache takes."""
    B, W = x.shape
    dt = cfg.act_dtype
    M = cfg.mem_len if mem_len is None else mem_len
    H, Dh = cfg.n_heads, cfg.d_head
    h = embed_tokens(params, cfg, x, pos, pad_idx)
    Le = enc_out.shape[1] if enc_out is not None else 0
    r = backwards_pos_enc(max(W, Le) + cfg.mem_len, cfg.d_model, dtype=dt, device=x.device)
    u, v = _stack_uv(params["decoder"], dt)
    use_flash = _flash_ok(cfg, B, W, flash, x.device)
    mask = None if use_flash else _causal_mask(W, device=x.device) | pad_mask[:, None, None, :]
    cross_mask = enc_pad[:, None, None, :] if enc_pad is not None else None
    ks, vs = [], []
    for bp in params["decoder"]["layers"]:
        ap = bp["mha1"]
        kf, vf = _lin(h, ap["k_w"], ap["k_b"]), _lin(h, ap["v_w"], ap["v_b"])
        ks.append(kf.reshape(B, W, H, Dh)[:, -M:])
        vs.append(vf.reshape(B, W, H, Dh)[:, -M:])
        if use_flash:
            h = _flash_self_attn(ap, cfg, h, pad_mask, u, v, causal=True, kv=(kf, vf))
        else:
            h = _attn_apply(ap, cfg, h, h, r, u, v, mask, r_mask=False)
        if enc_out is not None:
            h = _attn_apply(bp["mha2"], cfg, h, enc_out, r, u, v, cross_mask, r_mask=True)
            h = _ff(bp, cfg, h)
    logits = head(params, cfg, h[:, -1])
    n_valid = torch.clamp((~pad_mask).sum(dim=1).to(torch.int32), max=M)
    k_st, v_st = torch.stack(ks), torch.stack(vs)
    if W < M:
        padw = (0, 0, 0, 0, M - W, 0)           # left-pad the slot axis
        k_st = torch.nn.functional.pad(k_st, padw)
        v_st = torch.nn.functional.pad(v_st, padw)
    return logits, DecKVCache(k_st, v_st, n_valid)


def decoder_prefill(params, cfg: MultitaskConfig, x, pos, pad_mask, enc_out,
                    enc_pad=None, mem_len: Optional[int] = None, pad_idx: int = 1,
                    flash: Optional[bool] = None) -> Tuple[torch.Tensor, DecKVCache]:
    """The seq2seq decoder over a LEFT-padded target prefix (``pad_mask``
    True = pad), attending to ``enc_out`` (B, Le, D) with ``enc_pad``
    columns blocked; returns (last-token logits, the self-attention cache of
    each layer's input, right-aligned in M slots). ``flash``: the
    self-attention through the causal flash kernel (None:
    :func:`_flash_ok`'s rule)."""
    return _prefill(params, cfg, x, pos, pad_mask, enc_out, enc_pad, mem_len, pad_idx, flash)


def lm_prefill(params, cfg: MultitaskConfig, x, pos, pad_mask,
               mem_len: Optional[int] = None, pad_idx: int = 1,
               flash: Optional[bool] = None) -> Tuple[torch.Tensor, DecKVCache]:
    """The decoder as an attention-only language model over a LEFT-padded
    prompt (the next-word task); ``flash`` as :func:`decoder_prefill`."""
    return _prefill(params, cfg, x, pos, pad_mask, None, None, mem_len, pad_idx, flash)


# ---------------------------------------------------------------------------
# Shift-append decode (the JAX package's reference steps): every step
# re-projects the relative table (and, for seq2seq, the encoder output) and
# returns a new right-aligned cache, moved left by one slot with the
# token's K/V appended. The ring steps below compute the same function.
# ---------------------------------------------------------------------------

def _shift_self_attn(ap, cfg: MultitaskConfig, h, k_cache, v_cache, r, u, v, self_mask):
    """ln(h + self_attn) of one token over a layer's (B, M, H, Dh) cache plus
    itself, ``r`` the M + 1 distances M..0; returns (h_out, k1, v1) with
    k1 / v1 (B, 1, H, Dh) for the append."""
    B = h.shape[0]
    H, Dh = cfg.n_heads, cfg.d_head
    k1 = _proj(h, ap["k_w"], ap["k_b"], H, Dh).transpose(1, 2)
    v1 = _proj(h, ap["v_w"], ap["v_b"], H, Dh).transpose(1, 2)
    k_full = torch.cat([k_cache.to(h.dtype), k1], dim=1).transpose(1, 2)   # (B, H, M+1, Dh)
    v_full = torch.cat([v_cache.to(h.dtype), v1], dim=1).transpose(1, 2)
    q = _proj(h, ap["q_w"], ap["q_b"], H, Dh)
    attn = rel_attention(q, k_full, v_full, _wkr_of(ap, r, H, Dh), u, v, mask=self_mask,
                         scale=cfg.scale, shift=False)
    attn = attn.transpose(1, 2).reshape(B, 1, H * Dh)
    return _layer_norm(h + attn, ap["ln_g"], ap["ln_b"]), k1, v1


def _shift_cache(cache: DecKVCache, new_kv) -> DecKVCache:
    M = cache.k.shape[2]
    k = torch.stack([torch.cat([cache.k[i][:, 1:], k1], dim=1) for i, (k1, _) in
                     enumerate(new_kv)])
    v = torch.stack([torch.cat([cache.v[i][:, 1:], v1], dim=1) for i, (_, v1) in
                     enumerate(new_kv)])
    return DecKVCache(k, v, torch.clamp(cache.valid + 1, max=M))


def _self_mask(cache: DecKVCache):
    B, M = cache.k.shape[1], cache.k.shape[2]
    slot = torch.arange(M + 1, device=cache.k.device)[None, None, None, :]
    return slot < (M - cache.valid.reshape(B, 1, 1, 1))    # self (slot M) always visible


def decoder_step(params, cfg: MultitaskConfig, tok, pos, cache: DecKVCache, enc_out,
                 enc_pad=None, pad_idx: int = 1) -> Tuple[torch.Tensor, DecKVCache]:
    """One seq2seq decode step against the right-aligned cache, attending to
    ``enc_out`` (B, Le, D) with ``enc_pad`` columns blocked; returns (logits,
    the new cache, ``valid`` saturating at M)."""
    dt = cfg.act_dtype
    M = cache.k.shape[2]
    h = embed_tokens(params, cfg, tok[:, None], pos[:, None], pad_idx)
    r = backwards_pos_enc(max(M + 1, enc_out.shape[1]), cfg.d_model, dtype=dt,
                          device=h.device)
    u, v = _stack_uv(params["decoder"], dt)
    self_mask = _self_mask(cache)
    cross_mask = enc_pad[:, None, None, :] if enc_pad is not None else None
    new_kv = []
    for i, bp in enumerate(params["decoder"]["layers"]):
        h2, k1, v1 = _shift_self_attn(bp["mha1"], cfg, h, cache.k[i], cache.v[i],
                                      r[-(M + 1):], u, v, self_mask)
        h2 = _attn_apply(bp["mha2"], cfg, h2, enc_out, r, u, v, cross_mask, r_mask=True)
        h = _ff(bp, cfg, h2)
        new_kv.append((k1, v1))
    return head(params, cfg, h[:, 0]), _shift_cache(cache, new_kv)


def lm_step(params, cfg: MultitaskConfig, tok, pos, cache: DecKVCache,
            pad_idx: int = 1) -> Tuple[torch.Tensor, DecKVCache]:
    """One next-word decode step (attention-only blocks) against the
    right-aligned cache, as :func:`decoder_step`."""
    dt = cfg.act_dtype
    M = cache.k.shape[2]
    h = embed_tokens(params, cfg, tok[:, None], pos[:, None], pad_idx)
    r = backwards_pos_enc(M + 1, cfg.d_model, dtype=dt, device=h.device)
    u, v = _stack_uv(params["decoder"], dt)
    self_mask = _self_mask(cache)
    new_kv = []
    for i, bp in enumerate(params["decoder"]["layers"]):
        h, k1, v1 = _shift_self_attn(bp["mha1"], cfg, h, cache.k[i], cache.v[i], r, u, v,
                                     self_mask)
        new_kv.append((k1, v1))
    return head(params, cfg, h[:, 0]), _shift_cache(cache, new_kv)


# ---------------------------------------------------------------------------
# Ring-buffer decode: one slot write per layer per step, relative tables and
# the cross-attention K/V projected once per generation. At one query token
# rel_shift is the identity and the cross r_mask keeps every column, so the
# relative terms index the distance tables directly.
# ---------------------------------------------------------------------------

class DecRingCache(NamedTuple):
    k: torch.Tensor        # (dec_layers, B, H, M, Dh)
    v: torch.Tensor
    g: torch.Tensor        # (B, M) int32 global index per slot (pad → PAD_G)
    ptr: int               # next slot to overwrite
    g_cur: int             # global index of the token being decoded


class CrossCache(NamedTuple):
    k: torch.Tensor        # (dec_layers, B, H, Le, Dh)
    v: torch.Tensor
    wkr: torch.Tensor      # (dec_layers, H, Le, Dh)


def precompute_dec_wkr(params: Dict, cfg: MultitaskConfig, mem_len: int) -> torch.Tensor:
    """(dec_layers, H, M+1, Dh): each layer's self-attention relative keys
    over distances M..0."""
    r = backwards_pos_enc(mem_len + 1, cfg.d_model, dtype=cfg.act_dtype,
                          device=params["embed"].device)
    return torch.stack([_wkr_of(bp["mha1"], r, cfg.n_heads, cfg.d_head)
                        for bp in params["decoder"]["layers"]])


def precompute_cross(params: Dict, cfg: MultitaskConfig, enc_out: torch.Tensor) -> CrossCache:
    """Every decoder layer's cross-attention K/V of ``enc_out`` and its
    relative keys over the Le encoder positions, projected once."""
    H, Dh = cfg.n_heads, cfg.d_head
    r = backwards_pos_enc(enc_out.shape[1], cfg.d_model, dtype=enc_out.dtype,
                          device=enc_out.device)
    ks, vs, wk = [], [], []
    for bp in params["decoder"]["layers"]:
        ap = bp["mha2"]
        ks.append(_proj(enc_out, ap["k_w"], ap["k_b"], H, Dh))
        vs.append(_proj(enc_out, ap["v_w"], ap["v_b"], H, Dh))
        wk.append(_wkr_of(ap, r, H, Dh))
    return CrossCache(torch.stack(ks), torch.stack(vs), torch.stack(wk))


def dec_ring_from_prefill(cache: DecKVCache) -> DecRingCache:
    """Right-aligned prefill cache → ring form. Slot j holds the prompt token
    with global index j - M (last prompt token → -1), invalid slots PAD_G;
    the pointer starts at 0, overwriting the oldest slot first."""
    L, B, M, H, Dh = cache.k.shape
    k = cache.k.permute(0, 1, 3, 2, 4).contiguous()
    v = cache.v.permute(0, 1, 3, 2, 4).contiguous()
    slot = torch.arange(M, device=cache.k.device)[None, :]
    g = torch.where(slot >= (M - cache.valid[:, None]), slot - M, PAD_G).to(torch.int32)
    return DecRingCache(k=k, v=v, g=g, ptr=0, g_cur=0)


def _ring_self_attn(ap, cfg: MultitaskConfig, h, cache: DecRingCache, i: int,
                    wkr_all, u, v, blocked):
    """Layer ``i``'s ln(h + self_attn) over the ring plus the fresh token;
    returns (h_out, k1, v1) with k1/v1 (B, H, 1, Dh) for the slot write."""
    B = h.shape[0]
    H, Dh = cfg.n_heads, cfg.d_head
    M = cache.k.shape[3]
    q = _proj(h, ap["q_w"], ap["q_b"], H, Dh)
    k1 = _proj(h, ap["k_w"], ap["k_b"], H, Dh)
    v1 = _proj(h, ap["v_w"], ap["v_b"], H, Dh)
    ks, vs = cache.k[i], cache.v[i]                                   # (B, H, M, Dh)
    ac = torch.einsum("bhqd,bhkd->bhqk", (q + u).to(F32), ks.to(F32))[:, :, 0]
    # wkr row m ↔ distance M - m; ring slot j holds distance
    # ((ptr - 1 - j) mod M) + 1, a rotation of the first M scores by ptr
    s_d = torch.einsum("bhqd,hkd->bhqk", (q + v).to(F32),
                       wkr_all[i].to(F32))[:, :, 0]                   # (B, H, M+1)
    bd = torch.roll(s_d[..., :M], cache.ptr, dims=-1)
    scale = 1.0 / math.sqrt(Dh) if cfg.scale else 1.0
    score = torch.where(blocked[:, None, :], NEG_INF, (ac + bd) * scale)
    ac_self = torch.einsum("bhqd,bhqd->bhq", (q + u).to(F32), k1.to(F32))
    self_score = (ac_self[:, :, 0] + s_d[..., -1]) * scale
    full = torch.cat([score, self_score[:, :, None]], dim=-1)
    prob = torch.softmax(full, dim=-1).to(h.dtype)
    attn = torch.einsum("bhk,bhkd->bhd", prob[..., :M].to(F32), vs.to(F32)).to(h.dtype)
    attn = attn + prob[..., M:M + 1] * v1[:, :, 0]
    return _layer_norm(h + attn.reshape(B, 1, H * Dh), ap["ln_g"], ap["ln_b"]), k1, v1


def _cross_attn_step(ap, cfg: MultitaskConfig, h, kc, vc, wkr2, u, v, cross_mask):
    """One-token cross-attention over the cached K/V: ``_attn_apply`` at
    Lq = 1, where rel_shift is the identity and the tril keeps every column."""
    B = h.shape[0]
    H, Dh = cfg.n_heads, cfg.d_head
    q = _proj(h, ap["q_w"], ap["q_b"], H, Dh)
    attn = rel_attention(q, kc, vc, wkr2, u, v, mask=cross_mask, scale=cfg.scale,
                         shift=False)
    attn = attn.to(h.dtype).transpose(1, 2).reshape(B, 1, H * Dh)
    return _layer_norm(h + attn, ap["ln_g"], ap["ln_b"])


def _ring_write_advance(cache: DecRingCache, new_kv) -> DecRingCache:
    for i, (k1, v1) in enumerate(new_kv):
        cache.k[i][:, :, cache.ptr] = k1[:, :, 0]
        cache.v[i][:, :, cache.ptr] = v1[:, :, 0]
    cache.g[:, cache.ptr] = cache.g_cur
    M = cache.k.shape[3]
    return DecRingCache(k=cache.k, v=cache.v, g=cache.g, ptr=(cache.ptr + 1) % M,
                        g_cur=cache.g_cur + 1)


def decoder_step_ring(params, cfg: MultitaskConfig, tok, pos, cache: DecRingCache,
                      cross: CrossCache, wkr_all: torch.Tensor, enc_pad=None,
                      pad_idx: int = 1) -> Tuple[torch.Tensor, DecRingCache]:
    """One seq2seq decode step against the ring cache (the ``xla`` path).

    Unlike the JAX function, this writes the new token's K/V into slot
    ``ptr`` of ``cache.k``/``cache.v`` and its index into ``cache.g`` in place
    (each layer's attention has read the old slot first) and returns a cache
    holding the same tensors with the pointer advanced."""
    dt = cfg.act_dtype
    M = cache.k.shape[3]
    h = embed_tokens(params, cfg, tok[:, None], pos[:, None], pad_idx)
    u, v = _stack_uv(params["decoder"], dt)
    dist = cache.g_cur - cache.g
    blocked = (dist < 1) | (dist > M)
    cross_mask = enc_pad[:, None, None, :] if enc_pad is not None else None
    new_kv = []
    for i, bp in enumerate(params["decoder"]["layers"]):
        h2, k1, v1 = _ring_self_attn(bp["mha1"], cfg, h, cache, i, wkr_all, u, v, blocked)
        h2 = _cross_attn_step(bp["mha2"], cfg, h2, cross.k[i], cross.v[i],
                              cross.wkr[i], u, v, cross_mask)
        h = _ff(bp, cfg, h2)
        new_kv.append((k1, v1))
    return head(params, cfg, h[:, 0]), _ring_write_advance(cache, new_kv)


def lm_step_ring(params, cfg: MultitaskConfig, tok, pos, cache: DecRingCache,
                 wkr_all: torch.Tensor, pad_idx: int = 1) -> Tuple[torch.Tensor, DecRingCache]:
    """One next-word decode step (attention-only blocks), in place as
    :func:`decoder_step_ring`."""
    dt = cfg.act_dtype
    M = cache.k.shape[3]
    h = embed_tokens(params, cfg, tok[:, None], pos[:, None], pad_idx)
    u, v = _stack_uv(params["decoder"], dt)
    dist = cache.g_cur - cache.g
    blocked = (dist < 1) | (dist > M)
    new_kv = []
    for i, bp in enumerate(params["decoder"]["layers"]):
        h, k1, v1 = _ring_self_attn(bp["mha1"], cfg, h, cache, i, wkr_all, u, v, blocked)
        new_kv.append((k1, v1))
    return head(params, cfg, h[:, 0]), _ring_write_advance(cache, new_kv)
