"""Logit filtering and sampling on the device.

Batched equivalents of the reference's host-side samplers: ``top_k_top_p``
(deep_music_genre.py:1679-1706) and softmax + multinomial, as separate
filters (:func:`top_k_top_p`, :func:`sample_categorical`; the multitask
engine's parallel mask fill) and fused into one stable sort per step. :func:`filter_sample_sorted` draws from an explicit
``torch.Generator`` shared by the batch (the static engine);
:func:`filter_sample_sorted_rows` gives every row its own stream, a
counter-based hash of (row seed, row step, sorted position), for the
continuous-batching engine. Nothing here synchronizes with the host.
"""

from __future__ import annotations

from typing import Optional

import torch

FILTER_VALUE = -1e9


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the k highest logits per row (ties at the threshold survive)."""
    if top_k <= 0:
        return logits
    kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(logits < kth, FILTER_VALUE, logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering over the last axis, as the reference: tokens whose
    cumulative softmax probability in descending order exceeds ``top_p`` are
    dropped, shifted one position so the first token above it is kept. Ties
    are ordered as the JAX package orders them (a reversed stable ascending
    argsort: the higher vocab id first)."""
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sorted_logits = torch.gather(logits, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = torch.cat([torch.zeros_like(cum[..., :1], dtype=torch.bool),
                               cum[..., :-1] > top_p], dim=-1)
    remove = torch.empty_like(remove_sorted).scatter_(-1, order, remove_sorted)
    return torch.where(remove, FILTER_VALUE, logits)


def top_k_top_p(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Top-k, then top-p on what survives (``top_p <= 0`` disables it)."""
    out = top_k_filter(logits, top_k)
    return top_p_filter(out, top_p) if top_p > 0.0 else out


def sample_categorical(generator: Optional[torch.Generator],
                       logits: torch.Tensor) -> torch.Tensor:
    """A softmax draw over the last axis by Gumbel-max, from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _filter_sorted(logits: torch.Tensor, top_k, top_p):
    """Single-sort filter core: returns (filtered sorted logits, vocab-index
    payload, keep mask), all in descending-logit order.

    Top-k keeps ties at the k-th value; the nucleus mass is measured on the
    top-k-filtered distribution, as the reference chains the two filters
    (deep_music_genre.py:1696-1700). ``top_k`` is an int or a per-row
    integer tensor (0 disables); ``top_p`` a float or a per-row tensor
    (``<= 0`` disables top-p). A scalar is broadcast to every row.
    """
    V = logits.shape[-1]
    # stable ascending sort of -logits == descending logits with the lowest
    # vocab id first among ties (argmax-compatible)
    neg_sorted, order = torch.sort(-logits, dim=-1, stable=True)
    slog = -neg_sorted
    keep = slog > FILTER_VALUE / 2          # grammar-banned entries stay dead
    rows = slog.shape[:-1]
    k = torch.as_tensor(top_k, device=slog.device).long().expand(rows)[..., None]
    kth = torch.gather(slog, -1, torch.clamp(k - 1, 0, V - 1))
    keep = keep & torch.where((k > 0) & (k < V), slog >= kth, True)
    p = torch.as_tensor(top_p, device=slog.device).to(slog.dtype).expand(rows)[..., None]
    filt = torch.where(keep, slog, FILTER_VALUE)
    cum = torch.cumsum(torch.softmax(filt, dim=-1), dim=-1)
    remove = torch.cat([torch.zeros_like(keep[..., :1]), cum[..., :-1] > p], dim=-1)
    keep = keep & ~(remove & (p > 0.0))
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


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply, both multipliers below
    2^31) on int64 tensors holding values in [0, 2^32): exact integer
    arithmetic, so it gives the same bits on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def row_keys(seeds) -> torch.Tensor:
    """Per-row stream keys of request seeds (a tensor of Python-int seeds,
    any 64-bit value): a hash of both 32-bit halves, computed once a
    request, so that each step hashes only (key, step, position)."""
    seeds = torch.as_tensor(seeds, dtype=torch.long)
    return _mix32(_mix32(seeds & _M32) ^ ((seeds >> 32) & _M32))


def row_uniforms(keys: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 uniforms in (0, 1): entry (b, j) is a function of
    ``keys[b]`` (:func:`row_keys`), ``steps[b]`` and ``j`` only, a
    counter-based hash computed with integer tensor ops. A row's draws
    therefore do not depend on which other rows share its batch, nor on the
    device."""
    key = _mix32(keys ^ (steps.long() & _M32))                        # (B,)
    pos = torch.arange(n, dtype=torch.long, device=keys.device)
    h = _mix32(key[:, None] ^ ((pos * 0x9E3779B1) & _M32))            # (B, n)
    # 24 random bits, centred in their cell: exact in float32, never 0 or 1
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def filter_sample_sorted_rows(keys: torch.Tensor, steps: torch.Tensor,
                              logits: torch.Tensor, top_k: torch.Tensor,
                              top_p: torch.Tensor, greedy: torch.Tensor):
    """:func:`filter_sample_sorted` with per-row parameters and per-row
    random streams, for the continuous-batching engine where each resident
    row carries its own request: ``keys`` and ``steps`` are (B,) integers
    (the row's stream key, :func:`row_keys` of its request seed, and its own
    step counter), ``top_k`` (B,) (0 disables), ``top_p`` (B,) and
    ``greedy`` (B,) bool (greedy rows take sorted position 0, the filtered
    argmax).

    The draw is Gumbel-max in sorted space over :func:`row_uniforms`, so a
    request's stream is a function of its own seed and step only, as the
    JAX package's per-row folded keys are. Returns
    ``(idx (B,) int64, n_kept (B,) int64)``.
    """
    filt, order, keep = _filter_sorted(logits, top_k, top_p)
    u = row_uniforms(keys, steps, logits.shape[-1])
    sampled = torch.argmax(filt - torch.log(-torch.log(u)), dim=-1)
    spos = torch.where(greedy, torch.zeros_like(sampled), sampled)
    idx = torch.gather(order, -1, spos[..., None])[..., 0]
    return idx, keep.sum(dim=-1)


def num_choices(logits: torch.Tensor) -> torch.Tensor:
    """The number of tokens the filters left (the reference counts the
    non-zero probabilities)."""
    return (logits > FILTER_VALUE / 2).sum(dim=-1)
