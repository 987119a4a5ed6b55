"""Logit filtering and sampling on the device.

Batched equivalents of the reference's host-side samplers: ``top_k_top_p``
(deep_music_genre.py:1679-1706) and softmax + multinomial, fused into one
stable sort per step. Randomness comes from an explicit ``torch.Generator``
on the logits' device; nothing here synchronizes with the host.
"""

from __future__ import annotations

from typing import Optional

import torch

FILTER_VALUE = -1e9


def _filter_sorted(logits: torch.Tensor, top_k: int, top_p: float):
    """Single-sort filter core: returns (filtered sorted logits, vocab-index
    payload, keep mask), all in descending-logit order.

    Top-k keeps ties at the k-th value; the nucleus mass is measured on the
    top-k-filtered distribution, as the reference chains the two filters
    (deep_music_genre.py:1696-1700). ``top_p <= 0`` disables top-p.
    """
    V = logits.shape[-1]
    # stable ascending sort of -logits == descending logits with the lowest
    # vocab id first among ties (argmax-compatible)
    neg_sorted, order = torch.sort(-logits, dim=-1, stable=True)
    slog = -neg_sorted
    keep = slog > FILTER_VALUE / 2          # grammar-banned entries stay dead
    if 0 < top_k < V:
        keep = keep & (slog >= slog[..., top_k - 1:top_k])
    if top_p > 0.0:
        filt = torch.where(keep, slog, FILTER_VALUE)
        cum = torch.cumsum(torch.softmax(filt, dim=-1), dim=-1)
        remove = torch.cat([torch.zeros_like(keep[..., :1]),
                            cum[..., :-1] > top_p], dim=-1)
        keep = keep & ~remove
    filt = torch.where(keep, slog, FILTER_VALUE)
    return filt, order, keep


def filter_sample_sorted(generator: Optional[torch.Generator],
                         logits: torch.Tensor, top_k: int, top_p: float,
                         greedy: bool = False):
    """Fused top-k + top-p + categorical sample in ONE sort.

    The draw is Gumbel-max in sorted space (the winner maps back through the
    index payload); ``greedy`` takes sorted position 0, the filtered argmax.
    Returns ``(idx (B,) int64, n_kept (B,) int64)``.
    """
    filt, order, keep = _filter_sorted(logits, top_k, top_p)
    if greedy:
        spos = torch.zeros(logits.shape[:-1], dtype=torch.long, device=logits.device)
    else:
        u = torch.rand(filt.shape, generator=generator, device=filt.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        spos = torch.argmax(filt - torch.log(-torch.log(u)), dim=-1)
    idx = torch.gather(order, -1, spos[..., None])[..., 0]
    return idx, keep.sum(dim=-1)
