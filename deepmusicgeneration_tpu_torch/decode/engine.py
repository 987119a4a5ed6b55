"""Autoregressive generation engine: prefill, then a fixed-length token loop.

Every step of the loop runs on the device: model step, grammar-constraint
masking, per-token-type temperature, repeat penalty, top-k/top-p filtering,
sampling, beat tracking and bar-boundary stopping. The loop runs exactly
``n_words`` steps, like the JAX package's ``lax.scan``; no value goes back
to the host between tokens (finished rows emit pads).

Parity contract with the reference engine:
* grammar masks come from :mod:`..codec.grammar` (bit-identical tables),
* temperature slots: prev duration → temperatures[2] (instrument), prev
  ins/pad → temperatures[0] (note), otherwise → temperatures[1] (duration),
* repeat penalty ``max(0, log((c+1)/4)/5)·T`` grown when ≤ 2 choices survive,
* BOS banned until ``min_bars`` bars were generated,
* early stop when 80% of the budget is used and the absolute bar index is a
  multiple of 4, or when BOS is sampled,
* greedy mode is argmax over the same filtered logits.

The JAX package's ten decode paths: ``xla`` (the exact ring step,
``models.txl``; with ``kv_int8`` over an int8 ring), the slab steps of
``ops.fused_decode.fused_slab_core`` over a slot-major int8 (or, ``slab4*``,
int4) KV ring — ``slab_w8`` (int8 weights), ``slab`` (bf16 weights),
``slab_int8`` (int8 x int8 scores), ``slab4`` / ``slab4_w8`` — the all-rows
steps ``slab_ar_w8`` / ``slab_ar`` (``fused_slab_allrows_core``: each
layer's weights read once for all rows), and the multirow steps over
head-major panels, ``multirow`` (bf16, ``fused_multirow_core``) and
``multirow_int8`` (int8 with per-slot scales, ``fused_multirow_q_core``).
On the card the auto rule (:meth:`GenerationEngine.resolve_kernel`) takes
``slab_w8`` for B < 8, ``slab_ar_w8`` for B % 8 == 0 and ``xla``
otherwise; the others run on request. The prompt prefill takes the flash
attention kernel for bf16 configs at B >= 8 (W <= 2048) or
2048 < W <= 8192 (``models.txl.prefill``). Neither rule picks a kernel whose
widths the CUDA kernels do not take (:func:`slab_ok`).

``prepare_logits`` and ``advance_state`` also take per-row sampling
parameters ((B, 3) temperatures, (B,) min_bars, a (B, V) instrument mask,
a (B,) past-80% flag), as the continuous-batching engine passes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..codec import grammar as G
from ..codec.index import position_enc
from ..device import resolve_device
from ..models import txl
from ..models.config import TXLConfig
from ..models.precision import cast_params_for_inference
from ..ops.fused_decode import (fused_multirow_core, fused_multirow_q_core,
                                fused_slab_allrows_core, fused_slab_core,
                                kernel_accepts, quantize_kv_panels,
                                quantize_kv_slot_major, quantize_kv_slot_major_int4,
                                quantize_stacked_weights, stack_txl_layers)
from ..ops.sampling import FILTER_VALUE, filter_keeps, filter_sample_sorted
from ..vocab import SAMPLE_FREQ, MusicVocab

I32 = torch.int32

KERNELS = ("xla", "multirow", "multirow_int8", "slab", "slab_int8", "slab_w8",
           "slab4", "slab4_w8", "slab_ar", "slab_ar_w8")
ALLROWS_KERNELS = ("slab_ar_w8", "slab_ar")
MULTIROW_KERNELS = ("multirow", "multirow_int8")
INT8_WEIGHT_KERNELS = ("slab_w8", "slab4_w8", "slab_ar_w8")
# the JAX engine's int8-KV kernels tile the cache in 32-slot bands, so they
# need mem_len % 32 == 0; int4 packs slot pairs (m, m + M/2) in 32-row tiles
# (mem_len % 64 == 0); the bf16 'multirow' step takes any mem_len
ALIGNED_KERNELS = ("slab", "slab_int8", "slab_w8", "multirow_int8", "slab4",
                   "slab4_w8", "slab_ar", "slab_ar_w8")
INT4_KERNELS = ("slab4", "slab4_w8")


def slab_ok(cfg: TXLConfig, mem_len: int, kernel: Optional[str] = None) -> bool:
    """Whether the fused decode kernels apply: a bf16, bias-free config
    without beat embeddings (the genre flagship shape) and widths the CUDA
    kernels take (``fused_decode.kernel_accepts``), with the JAX engine's
    alignment of ``kernel``: mem_len % 64 == 0 for :data:`INT4_KERNELS`,
    mem_len % 32 == 0 for the other :data:`ALIGNED_KERNELS` and for
    ``kernel=None`` (would the auto rule pick a fused kernel), any mem_len
    for ``multirow``."""
    base = (cfg.dtype == "bfloat16" and not cfg.bias
            and not cfg.encode_position and kernel_accepts(cfg))
    if kernel in INT4_KERNELS:
        return base and mem_len % 64 == 0
    if kernel is None or kernel in ALIGNED_KERNELS:
        return base and mem_len % 32 == 0
    return base


def expand_temperatures(temperatures) -> tuple:
    """A (t_note, t_dur) pair expanded to the three genre slots
    (t_note, t_dur, t_dur), as the JAX package does; three pass through."""
    temperatures = tuple(temperatures)
    if len(temperatures) == 2:
        return (temperatures[0], temperatures[1], temperatures[1])
    return temperatures


@dataclass(frozen=True)
class SamplerSettings:
    """Static sampling configuration. The defaults are the genre engine's;
    the seq2seq engine turns off the min-bars BOS ban and the bar-boundary
    stop, and stops on a sampled EOS or past a maximum position
    (``decode.multitask_engine``). The temperature slots come with the
    tables (``build_tables``)."""

    n_words: int = 512
    top_k: int = 30
    greedy: bool = False
    use_min_bars_ban: bool = True
    bar_stop: bool = True      # 80%-budget bar-boundary early stop
    pos_stop: bool = False     # stop past max_pos (seq2seq)
    eos_stop: bool = False     # stop on a sampled EOS (seq2seq)


class DecodeTables(NamedTuple):
    """Device-resident constant tables derived from the vocabulary."""
    allowed: torch.Tensor      # (3, 2, V) bool
    prev_class: torch.Tensor   # (V,) int64
    temp_slot: torch.Tensor    # (V,) int64
    sep_idx: int
    bos_idx: int
    eos_idx: int
    ni_idx: int
    pad_idx: int
    dur_lo: int


def build_tables(vocab: MusicVocab, temp_mode: str = "genre", strict: bool = True,
                 device=None) -> DecodeTables:
    """The grammar and temperature-slot tables on ``device``: ``temp_mode``
    'genre' (three temperatures) or 'twotemp' (the multitask engines')."""
    return DecodeTables(
        allowed=torch.from_numpy(G.allowed_table(vocab, strict=strict)).to(device),
        prev_class=torch.from_numpy(G.prev_class_table(vocab)).long().to(device),
        temp_slot=torch.from_numpy(G.temp_slot_table(vocab, temp_mode)).long().to(device),
        sep_idx=vocab.sep_idx,
        bos_idx=vocab.bos_idx,
        eos_idx=vocab.eos_idx,
        ni_idx=vocab.ni_idx,
        pad_idx=vocab.pad_idx,
        dur_lo=vocab.dur_range[0],
    )


class SampleState(NamedTuple):
    prev_tok: torch.Tensor     # (B,) int32
    last_pos: torch.Tensor     # (B,) int32 beat-step position
    start_pos: torch.Tensor    # (B,) int32
    last_xxsep: torch.Tensor   # (B,) bool
    repeat_count: torch.Tensor # (B,) int32
    done: torch.Tensor         # (B,) bool
    n_emitted: torch.Tensor    # (B,) int32


def prepare_logits(
    logits: torch.Tensor,          # (B, V) fp32
    st: SampleState,
    tables: DecodeTables,
    temperatures: torch.Tensor,    # (B, 3) fp32 per row, or (3,) for all rows
    min_bars,                      # (B,) int32 per row, or an int for all rows
    allowed_ins: torch.Tensor,     # (B, V) bool overlay per row, or (V,)
    settings: Optional[SamplerSettings] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-sampling logit processing: temperature slot + repeat penalty,
    min-bars BOS ban (unless ``settings.use_min_bars_ban`` is off), grammar
    mask. Returns (masked logits, last_xxsep)."""
    prev = st.prev_tok.long()
    # last_xxsep flag update from prev (deep_music_genre.py:1901-1905)
    last_xxsep = torch.where(prev == tables.sep_idx, True,
                             torch.where(prev == tables.ni_idx, False, st.last_xxsep))
    cls = tables.prev_class[prev]                          # (B,)
    slot = tables.temp_slot[prev]
    temperature = torch.gather(temperatures.expand(len(slot), 3), 1,
                               slot[:, None])[:, 0]        # (B,)
    penalty = torch.clamp_min(
        torch.log((st.repeat_count + 1) / 4.0) / 5.0, 0.0) * temperature
    temperature = temperature + penalty
    logits = logits / temperature[:, None]

    # BOS banned while bars generated ≤ min_bars
    if settings is None or settings.use_min_bars_ban:
        bars = torch.div(st.last_pos - st.start_pos, SAMPLE_FREQ * 4,
                         rounding_mode="floor")
        bos = tables.bos_idx
        logits = logits.clone()
        logits[:, bos] = torch.where(bars <= min_bars, FILTER_VALUE, logits[:, bos])

    ok = tables.allowed[cls, last_xxsep.long()] & allowed_ins   # (B, V)
    return torch.where(ok, logits, FILTER_VALUE), last_xxsep


def advance_state(
    idx: torch.Tensor,             # (B,) sampled token
    nc: torch.Tensor,              # (B,) filter-survivor count
    st: SampleState,
    last_xxsep: torch.Tensor,      # (B,) bool from prepare_logits
    tables: DecodeTables,
    past_80pct,                    # step / n_words > 0.8 in float32: a bool,
                                   # or a (B,) bool tensor per row
    settings: Optional[SamplerSettings] = None,
    max_pos: Optional[torch.Tensor] = None,   # (B,) int32, with settings.pos_stop
) -> Tuple[torch.Tensor, SampleState]:
    """Post-sampling bookkeeping: repeat count, beat position, stopping,
    pad semantics. Returns (emitted idx or pad, new state). ``settings``
    None means the genre defaults."""
    idx = idx.to(I32)
    prev = st.prev_tok
    repeat_count = torch.where(nc <= 2, st.repeat_count + 1,
                               torch.div(st.repeat_count, 2, rounding_mode="floor"))
    # beat position: a duration following xxsep advances the song position
    was_sep = prev == tables.sep_idx
    duration = idx - tables.dur_lo
    last_pos = torch.where(was_sep & ~st.done, st.last_pos + duration, st.last_pos)

    # stopping: bar boundary after 80% of budget, a sampled BOS (or EOS), or
    # past the counterpart track's length (seq2seq)
    settings = settings or SamplerSettings()
    abs_bar = torch.div(last_pos, SAMPLE_FREQ * 4, rounding_mode="floor")
    done = st.done | (idx == tables.bos_idx)
    if settings.bar_stop:
        done = done | (was_sep & past_80pct & (abs_bar % 4 == 0))
    if settings.eos_stop:
        done = done | (idx == tables.eos_idx)
    if settings.pos_stop and max_pos is not None:
        done = done | (was_sep & (last_pos > max_pos))

    # the token that *triggers* a stop is dropped, exactly like the
    # reference's `break` before `new_idx.append(idx)`; afterwards pads flow
    emitted = ~done
    idx = torch.where(emitted, idx, tables.pad_idx)
    new_st = SampleState(
        prev_tok=torch.where(emitted, idx, st.prev_tok),
        last_pos=last_pos.to(I32),
        start_pos=st.start_pos,
        last_xxsep=torch.where(st.done, st.last_xxsep, last_xxsep),
        repeat_count=torch.where(st.done, st.repeat_count, repeat_count).to(I32),
        done=done,
        n_emitted=st.n_emitted + emitted.to(I32),
    )
    return idx, new_st


def sample_next_token(
    logits: torch.Tensor,
    st: SampleState,
    tables: DecodeTables,
    temperatures: torch.Tensor,
    top_k,                         # int, or (B,) int64 on the device
    top_p,                         # float, or (B,) fp32 on the device
    min_bars: int,
    allowed_ins: torch.Tensor,
    generator: Optional[torch.Generator],
    settings: SamplerSettings,
    past_80pct: bool,
    max_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, SampleState]:
    """One full sampling step given model logits."""
    logits, last_xxsep = prepare_logits(logits, st, tables, temperatures,
                                        min_bars, allowed_ins, settings)
    idx, nc = filter_sample_sorted(generator, logits, top_k, top_p,
                                   greedy=settings.greedy)
    return advance_state(idx, nc, st, last_xxsep, tables, past_80pct, settings, max_pos)


def replay_next_token(
    logits: torch.Tensor,
    st: SampleState,
    tables: DecodeTables,
    temperatures: torch.Tensor,
    top_k,
    top_p,
    min_bars: int,
    allowed_ins: torch.Tensor,
    settings: SamplerSettings,
    past_80pct: bool,
    forced: torch.Tensor,          # (B,) the token to take instead of a draw
) -> Tuple[torch.Tensor, SampleState, torch.Tensor]:
    """:func:`sample_next_token` with its draw replaced by ``forced``.
    Returns (idx, new state, kept): ``kept`` (B,) says whether the filter
    kept ``forced``, i.e. whether this step could have drawn it."""
    logits, last_xxsep = prepare_logits(logits, st, tables, temperatures,
                                        min_bars, allowed_ins, settings)
    kept, nc = filter_keeps(logits, top_k, top_p, forced, greedy=settings.greedy)
    idx, st = advance_state(forced, nc, st, last_xxsep, tables, past_80pct, settings)
    return idx, st, kept


def _past_80pct(i: int, n_words: int) -> bool:
    """``i / n_words > 0.80`` evaluated in float32, as on the device."""
    return bool(np.float32(i) / np.float32(n_words) > np.float32(0.80))


@torch.no_grad()
def generate_compiled(
    params: Dict,
    cfg: TXLConfig,
    window_toks: torch.Tensor,    # (B, W) left-padded prompt
    window_pad: torch.Tensor,     # (B, W) bool, True = pad
    window_pos: torch.Tensor,     # (B, W) int32 beat positions
    start_last_pos: torch.Tensor, # (B,) last beat position of the prompt
    tables: DecodeTables,
    temperatures: torch.Tensor,
    top_p: float,
    min_bars: int,
    allowed_ins: torch.Tensor,
    generator: Optional[torch.Generator],
    settings: SamplerSettings,
    mem_len: int,
    kernel: str = "xla",
    stacked_q=None,               # (StackedTXL, w_scales or None) for the fused kernels
    rows_per_cell: Optional[int] = None,
    kv_int8: bool = False,
    forced: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill + fixed-length sampling loop.

    ``forced`` (B, n_words): the tokens to feed instead of the draws (a
    replay). The loop then returns (kept (B, n_words) bool, lengths):
    whether the filter kept each forced token at its step.

    ``kernel`` is one of :data:`KERNELS`; ``kv_int8`` quantizes the ring to
    int8 on ``xla`` (``txl.decode_step_ring_q``) and on ``multirow`` (which
    then runs the ``multirow_int8`` step), and is ignored by the slab
    kernels, as in the JAX engine. ``rows_per_cell`` is the fused kernels'
    row tiling (it must divide B; None: the largest of 8, 4, 2, 1 that does,
    as the JAX engine picks it).

    Returns (tokens (B, n_words) int32, lengths (B,) int32), on the device.
    The name follows the JAX package; here the loop runs eagerly."""
    if kernel not in KERNELS:
        raise ValueError(f"decode_kernel {kernel!r}: one of {KERNELS}")
    B = window_toks.shape[0]
    dev = window_toks.device
    M = mem_len
    logits, cache0 = txl.prefill(params, cfg, window_toks, window_pad,
                                 pos=window_pos, mem_len=M)
    st = SampleState(
        prev_tok=window_toks[:, -1].to(I32),
        last_pos=start_last_pos.to(I32),
        start_pos=start_last_pos.to(I32),
        last_xxsep=torch.zeros((B,), dtype=torch.bool, device=dev),
        repeat_count=torch.zeros((B,), dtype=I32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        n_emitted=torch.zeros((B,), dtype=I32, device=dev),
    )
    ring = txl.ring_from_prefill(cache0, cfg)
    toks = torch.empty((settings.n_words, B), dtype=I32, device=dev)
    # the filter's per-row parameters, made on the device once
    top_k_rows = torch.full((B,), settings.top_k, dtype=torch.long, device=dev)
    top_p_rows = torch.full((B,), top_p, dtype=torch.float32, device=dev)
    if forced is not None:
        kept = torch.empty((settings.n_words, B), dtype=torch.bool, device=dev)

    def sample(i, logits, st):
        if forced is not None:
            idx, st, kept[i] = replay_next_token(
                logits, st, tables, temperatures, top_k_rows, top_p_rows, min_bars,
                allowed_ins, settings, _past_80pct(i, settings.n_words),
                forced[:, i].long())
            return idx, st
        return sample_next_token(logits, st, tables, temperatures, top_k_rows,
                                 top_p_rows, min_bars, allowed_ins, generator, settings,
                                 _past_80pct(i, settings.n_words))

    wkr = txl.precompute_wkr(params, cfg, M)            # (L, H, M+1, Dh)
    if kernel == "xla":
        cache, step_fn = ring, txl.decode_step_ring
        if kv_int8:
            cache, step_fn = txl.quantize_ring(ring), txl.decode_step_ring_q
        for i in range(settings.n_words):
            idx, st = sample(i, logits, st)
            toks[i] = idx
            logits, cache = step_fn(params, cfg, idx, st.last_pos, cache, wkr)
        return (toks if forced is None else kept).T, st.n_emitted

    rows_per_cell = rows_per_cell or next(r for r in (8, 4, 2, 1) if B % r == 0)
    run_stack = _fused_stack(cfg, kernel, stacked_q, ring, wkr, M, rows_per_cell,
                             kv_int8)
    embed32 = params["embed"].to(torch.float32)
    head_b = params.get("head_b")
    g, ptr, g_cur = ring.g, ring.ptr, ring.g_cur
    for i in range(settings.n_words):
        idx, st = sample(i, logits, st)
        toks[i] = idx
        dist = g_cur - g
        blocked = ((dist < 1) | (dist > M)).to(I32)
        logits = run_stack(embed32[idx.long()], blocked, ptr) @ embed32.T
        if head_b is not None:
            logits = logits + head_b
        g[:, ptr] = g_cur
        ptr, g_cur = (ptr + 1) % M, g_cur + 1
    return (toks if forced is None else kept).T, st.n_emitted


def _fused_stack(cfg, kernel, stacked_q, ring, wkr, M, rows_per_cell, kv_int8):
    """The caches of ``kernel``'s layout, built from the ring (quantized
    where the kernel keeps int8 or int4), and a function
    ``run(h_in, blocked, ptr) -> h_out`` that advances them one step in
    place through the kernel's wrapper."""
    L, B = cfg.n_layers, ring.k.shape[1]
    HD = cfg.n_heads * cfg.d_head
    stacked, w_scales = stacked_q
    bf16 = torch.bfloat16
    if kernel in MULTIROW_KERNELS:
        kt = ring.k.permute(0, 1, 2, 4, 3).reshape(L, B, HD, M)   # head-major K
        vc = ring.v.permute(0, 1, 3, 2, 4).reshape(L, B, M, HD)
        wkr_f = wkr.permute(0, 1, 3, 2).reshape(L, HD, M + 1).to(bf16).contiguous()
        if kv_int8 or kernel == "multirow_int8":
            kv = quantize_kv_panels(kt, vc)
            return lambda h_in, blocked, ptr: fused_multirow_q_core(
                stacked, cfg, h_in, wkr_f, *kv, blocked, ptr, M,
                rows_per_cell=rows_per_cell)[0]
        kv = (kt.contiguous(), vc.contiguous())
        return lambda h_in, blocked, ptr: fused_multirow_core(
            stacked, cfg, h_in, wkr_f, *kv, blocked, ptr, M,
            rows_per_cell=rows_per_cell)[0]
    kt_s = ring.k.permute(0, 1, 3, 2, 4).reshape(L, B, M, HD)      # slot-major
    vc_s = ring.v.permute(0, 1, 3, 2, 4).reshape(L, B, M, HD)
    kv_int4 = kernel in INT4_KERNELS
    kv = (quantize_kv_slot_major_int4 if kv_int4 else quantize_kv_slot_major)(kt_s, vc_s)
    wkr_mt = wkr.permute(0, 2, 1, 3).reshape(L, M + 1, HD).to(bf16).contiguous()
    if kernel in ALLROWS_KERNELS:
        return lambda h_in, blocked, ptr: fused_slab_allrows_core(
            stacked, cfg, h_in, wkr_mt, *kv, blocked, ptr, M,
            rows_per_cell=rows_per_cell, weights_int8=w_scales is not None,
            w_scales=w_scales)[0]
    return lambda h_in, blocked, ptr: fused_slab_core(
        stacked, cfg, h_in, wkr_mt, *kv, blocked, ptr, M, rows_per_cell=rows_per_cell,
        score_mode="int8" if kernel == "slab_int8" else "bf16",
        weights_int8=w_scales is not None, w_scales=w_scales, kv_int4=kv_int4)[0]


# ---------------------------------------------------------------------------
# Host-level wrapper
# ---------------------------------------------------------------------------

def _bucket(n: int, buckets=(128, 256, 512, 1024, 2048, 4096, 8192)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class GenerationEngine:
    """Host wrapper: prompt packing into a bucketed left-padded window, kernel
    choice, post-trim. One instance per (params, cfg, vocab, device)."""

    def __init__(self, params: Dict, cfg: TXLConfig, vocab: MusicVocab,
                 device=None):
        """``params``: the port's parameter dict (``params_from_numpy``),
        cast to bf16 for a bf16 config. ``device=None`` means the CUDA card;
        pass ``"cpu"`` explicitly."""
        self.device = resolve_device(device)
        if cfg.dtype == "bfloat16":
            params = cast_params_for_inference(params)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.vocab = vocab
        self.tables = build_tables(vocab, device=self.device)
        self._stacked = None
        self._stacked_q = None

    def resolve_kernel(self, batch: int, mem_len: Optional[int] = None,
                       decode_kernel: Optional[str] = None) -> str:
        """The kernel ``generate_batch(decode_kernel=None)`` picks: the JAX
        package's rule, read on the card.

        - B % 8 == 0 → 'slab_ar_w8': one pass over each layer's weights
          serves all B rows;
        - B < 8 → 'slab_w8': decode is weight-read-bound there, and int8
          weights nearly halve the bytes per step;
        - any other B → 'xla', the exact ring step.

        The slab kernels also need :func:`slab_ok`. On the CPU this returns
        'xla', as the JAX package does off the TPU."""
        if decode_kernel is not None:
            return decode_kernel
        mem_len = mem_len or self.cfg.mem_len
        if self.device.type == "cuda" and slab_ok(self.cfg, mem_len):
            if batch % 8 == 0:
                return "slab_ar_w8"
            if batch < 8:
                return "slab_w8"
        return "xla"

    def stacked(self):
        """(bf16-weight StackedTXL, None) for the bf16-weight kernel paths."""
        if self._stacked is None:
            self._stacked = (stack_txl_layers(self.params), None)
        return self._stacked

    def stacked_q(self):
        """(int8-weight StackedTXL, w_scales) for :data:`INT8_WEIGHT_KERNELS`."""
        if self._stacked_q is None:
            self._stacked_q = quantize_stacked_weights(stack_txl_layers(self.params))
        return self._stacked_q

    def generate(self, seed_idxenc: np.ndarray, seed_pos: Optional[np.ndarray] = None,
                 **kwargs) -> np.ndarray:
        """Generate continuation tokens for one prompt; returns the new ids.
        Keyword arguments are those of :meth:`generate_batch`."""
        toks, lengths = self.generate_batch(
            [np.asarray(seed_idxenc)],
            [seed_pos] if seed_pos is not None else None, **kwargs)
        return toks[0][: lengths[0]]

    def generate_batch(
        self,
        seeds,
        seed_positions=None,
        n_words: int = 512,
        temperatures=(1.0, 1.0, 1.0),
        min_bars: int = 4,
        top_k: int = 30,
        top_p: float = 0.6,
        allowed_ins=None,
        greedy: bool = False,
        seed: int = 0,
        mem_len: Optional[int] = None,
        kv_int8: bool = False,
        decode_kernel: Optional[str] = None,
        rows_per_cell: Optional[int] = None,
        forced=None,
    ):
        """Generate for a batch of prompts. Returns numpy
        (tokens (B, n_words) int32, lengths (B,) int32).

        ``forced`` (B, n_words) tokens, as this method returns them, turns
        the run into a replay: the loop feeds them instead of its draws and
        returns (kept (B, n_words) bool, lengths), whether this engine's
        filter kept each one at its step (could have drawn it).

        ``decode_kernel``: None = auto (:meth:`resolve_kernel`), or one of
        :data:`KERNELS`: 'xla' is the exact bf16/f32 ring step ('xla' with
        ``kv_int8`` over an int8 ring); 'slab_w8', 'slab4_w8' and
        'slab_ar_w8' quantize the KV cache and the weights, 'slab',
        'slab_int8', 'slab4', 'slab_ar' and 'multirow_int8' the KV cache
        only ('slab4*' to int4, mem_len % 64 == 0), 'multirow' keeps bf16
        panels ('multirow' with ``kv_int8`` runs 'multirow_int8'). The
        kernel paths run their hand-written kernels on the card and their
        plain versions on a CPU device. ``rows_per_cell``: the fused
        kernels' row tiling, which must divide B (default the largest of 8,
        4, 2, 1 that does); it changes the result only in 'slab_int8'. The
        prompt prefill follows ``models.txl.prefill``'s auto rule.
        ``temperatures``: three genre slots, or a (t_note, t_dur) pair that
        expands to (t_note, t_dur, t_dur). ``seed`` seeds the sampling
        generator on the engine's device."""
        B = len(seeds)
        mem_len = mem_len or self.cfg.mem_len
        W = _bucket(max(len(s) for s in seeds))
        W = min(W, max(self.cfg.ctx_len, mem_len))
        toks = np.full((B, W), self.vocab.pad_idx, dtype=np.int64)
        pad = np.ones((B, W), dtype=bool)
        pos = np.zeros((B, W), dtype=np.int32)
        last_pos = np.zeros((B,), dtype=np.int32)
        for i, s in enumerate(seeds):
            s = np.asarray(s)[-W:]
            p = (np.asarray(seed_positions[i])[-W:] if seed_positions is not None
                 else position_enc(s, self.vocab))
            toks[i, W - len(s):] = s
            pad[i, W - len(s):] = False
            pos[i, W - len(s):] = p[:len(s)]
            last_pos[i] = p[-1] if len(p) else 0

        kernel = self.resolve_kernel(B, mem_len, decode_kernel)
        if kernel != "xla" and not slab_ok(self.cfg, mem_len, kernel):
            need = (", mem_len % 64 == 0" if kernel in INT4_KERNELS
                    else ", mem_len % 32 == 0" if kernel in ALIGNED_KERNELS else "")
            raise ValueError(f"decode_kernel={kernel!r} needs a bf16 bias-free "
                             "config without beat embeddings and widths the "
                             f"kernels take{need}; got mem_len={mem_len}, "
                             f"d_head={self.cfg.d_head}")
        if rows_per_cell is not None and B % rows_per_cell:
            raise ValueError(f"rows_per_cell={rows_per_cell} must divide batch {B}")
        temperatures = expand_temperatures(temperatures)
        settings = SamplerSettings(n_words=n_words, top_k=top_k, greedy=greedy)
        dev = self.device
        ins_mask = torch.from_numpy(G.allowed_ins_mask(self.vocab, allowed_ins)).to(dev)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        out, lengths = generate_compiled(
            self.params, self.cfg,
            torch.from_numpy(toks).to(dev), torch.from_numpy(pad).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(last_pos).to(dev),
            self.tables,
            torch.tensor(temperatures, dtype=torch.float32, device=dev),
            float(top_p), int(min_bars), ins_mask, generator, settings,
            mem_len=mem_len, kernel=kernel,
            stacked_q=(None if kernel == "xla" else self.stacked_q()
                       if kernel in INT8_WEIGHT_KERNELS else self.stacked()),
            rows_per_cell=rows_per_cell, kv_int8=kv_int8,
            forced=None if forced is None else torch.as_tensor(np.asarray(forced)).to(dev))
        return out.cpu().numpy(), lengths.cpu().numpy()


def _to_device(node, device):
    return txl.tree_map(lambda t: t.to(device), node)
