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

Five decode paths: ``xla`` (the exact ring step, ``models.txl``),
``slab_w8`` (``ops.fused_decode.fused_slab_core``: int8 weights, int8 KV),
``slab_ar_w8`` (``ops.fused_decode.fused_slab_allrows_core``: the same step,
each layer's weights read once for all rows), and their bf16-weight modes
``slab`` and ``slab_ar`` (explicit only here; the continuous engine
auto-picks ``slab``). On the card the auto rule
(:meth:`GenerationEngine.resolve_kernel`) takes ``slab_w8`` for B < 8,
``slab_ar_w8`` for B % 8 == 0 and ``xla`` otherwise; the prompt prefill takes
the flash attention kernel for bf16 configs at B >= 8 (W <= 2048) or
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
from ..ops.fused_decode import (fused_slab_allrows_core, fused_slab_core,
                                kernel_accepts, quantize_kv_slot_major,
                                quantize_stacked_weights, stack_txl_layers)
from ..ops.sampling import FILTER_VALUE, filter_sample_sorted
from ..vocab import SAMPLE_FREQ, MusicVocab

I32 = torch.int32

KERNELS = ("xla", "slab_w8", "slab_ar_w8", "slab", "slab_ar")
ALLROWS_KERNELS = ("slab_ar_w8", "slab_ar")
INT8_WEIGHT_KERNELS = ("slab_w8", "slab_ar_w8")


def slab_ok(cfg: TXLConfig, mem_len: int) -> bool:
    """Whether the slab paths apply: a bf16, bias-free config without beat
    embeddings (the genre flagship shape) with mem_len % 32 == 0, the TPU
    kernel's slab tile, kept so both packages pick alike; and widths the
    CUDA kernels take (``fused_decode.kernel_accepts``)."""
    return (cfg.dtype == "bfloat16" and not cfg.bias
            and not cfg.encode_position and mem_len % 32 == 0
            and kernel_accepts(cfg))


def expand_temperatures(temperatures) -> tuple:
    """A (t_note, t_dur) pair expanded to the three genre slots
    (t_note, t_dur, t_dur), as the JAX package does; three pass through."""
    temperatures = tuple(temperatures)
    if len(temperatures) == 2:
        return (temperatures[0], temperatures[1], temperatures[1])
    return temperatures


@dataclass(frozen=True)
class SamplerSettings:
    """Static sampling configuration."""

    n_words: int = 512
    top_k: int = 30
    greedy: bool = False


class DecodeTables(NamedTuple):
    """Device-resident constant tables derived from the vocabulary."""
    allowed: torch.Tensor      # (3, 2, V) bool
    prev_class: torch.Tensor   # (V,) int64
    temp_slot: torch.Tensor    # (V,) int64
    sep_idx: int
    bos_idx: int
    ni_idx: int
    pad_idx: int
    dur_lo: int


def build_tables(vocab: MusicVocab, device=None) -> DecodeTables:
    """The grammar and genre temperature-slot tables on ``device``."""
    return DecodeTables(
        allowed=torch.from_numpy(G.allowed_table(vocab, strict=True)).to(device),
        prev_class=torch.from_numpy(G.prev_class_table(vocab)).long().to(device),
        temp_slot=torch.from_numpy(G.temp_slot_table(vocab, "genre")).long().to(device),
        sep_idx=vocab.sep_idx,
        bos_idx=vocab.bos_idx,
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-sampling logit processing: temperature slot + repeat penalty,
    min-bars BOS ban, grammar mask. Returns (masked logits, last_xxsep)."""
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
) -> Tuple[torch.Tensor, SampleState]:
    """Post-sampling bookkeeping: repeat count, beat position, stopping,
    pad semantics. Returns (emitted idx or pad, new state)."""
    idx = idx.to(I32)
    prev = st.prev_tok
    repeat_count = torch.where(nc <= 2, st.repeat_count + 1,
                               torch.div(st.repeat_count, 2, rounding_mode="floor"))
    # beat position: a duration following xxsep advances the song position
    was_sep = prev == tables.sep_idx
    duration = idx - tables.dur_lo
    last_pos = torch.where(was_sep & ~st.done, st.last_pos + duration, st.last_pos)

    # stopping: bar boundary after 80% of budget, or a sampled BOS
    abs_bar = torch.div(last_pos, SAMPLE_FREQ * 4, rounding_mode="floor")
    stop_bar = was_sep & past_80pct & (abs_bar % 4 == 0)
    done = st.done | stop_bar | (idx == tables.bos_idx)

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
) -> Tuple[torch.Tensor, SampleState]:
    """One full sampling step given model logits."""
    logits, last_xxsep = prepare_logits(logits, st, tables, temperatures,
                                        min_bars, allowed_ins)
    idx, nc = filter_sample_sorted(generator, logits, top_k, top_p,
                                   greedy=settings.greedy)
    return advance_state(idx, nc, st, last_xxsep, tables, past_80pct)


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
    stacked_q=None,               # (StackedTXL, w_scales or None) for the slab kernels
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill + fixed-length sampling loop.

    Returns (tokens (B, n_words) int32, lengths (B,) int32), on the device.
    The name follows the JAX package; here the loop runs eagerly."""
    if kernel not in KERNELS:
        raise ValueError(f"decode kernel {kernel!r} is not ported; one of "
                         f"{KERNELS} (ROADMAP.md)")
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

    def sample(i, logits, st):
        return sample_next_token(logits, st, tables, temperatures, top_k_rows,
                                 top_p_rows, min_bars, allowed_ins, generator, settings,
                                 _past_80pct(i, settings.n_words))

    if kernel == "xla":
        wkr_all = txl.precompute_wkr(params, cfg, M)
        cache = ring
        for i in range(settings.n_words):
            idx, st = sample(i, logits, st)
            toks[i] = idx
            logits, cache = txl.decode_step_ring(params, cfg, idx, st.last_pos,
                                                 cache, wkr_all)
        return toks.T, st.n_emitted

    L, HD = cfg.n_layers, cfg.n_heads * cfg.d_head
    kt_s = ring.k.permute(0, 1, 3, 2, 4).reshape(L, B, M, HD)
    vc_s = ring.v.permute(0, 1, 3, 2, 4).reshape(L, B, M, HD)
    kv = quantize_kv_slot_major(kt_s, vc_s)
    wkr_mt = txl.precompute_wkr(params, cfg, M).permute(0, 2, 1, 3) \
        .reshape(L, M + 1, HD).to(torch.bfloat16).contiguous()
    stacked, w_scales = stacked_q
    core = fused_slab_allrows_core if kernel in ALLROWS_KERNELS else fused_slab_core
    rows_per_cell = next(r for r in (8, 4, 2, 1) if B % r == 0)   # as the JAX engine
    embed32 = params["embed"].to(torch.float32)
    head_b = params.get("head_b")
    g, ptr, g_cur = ring.g, ring.ptr, ring.g_cur
    for i in range(settings.n_words):
        idx, st = sample(i, logits, st)
        toks[i] = idx
        dist = g_cur - g
        blocked = ((dist < 1) | (dist > M)).to(I32)
        h_out, *kv = core(
            stacked, cfg, embed32[idx.long()], wkr_mt, *kv, blocked, ptr, M,
            rows_per_cell=rows_per_cell, weights_int8=w_scales is not None,
            w_scales=w_scales)
        logits = h_out @ embed32.T
        if head_b is not None:
            logits = logits + head_b
        g[:, ptr] = g_cur
        ptr, g_cur = (ptr + 1) % M, g_cur + 1
    return toks.T, st.n_emitted


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
        """(bf16-weight StackedTXL, None) for the slab and slab_ar paths."""
        if self._stacked is None:
            self._stacked = (stack_txl_layers(self.params), None)
        return self._stacked

    def stacked_q(self):
        """(int8-weight StackedTXL, w_scales) for the slab_w8 and slab_ar_w8
        paths."""
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
        decode_kernel: Optional[str] = None,
    ):
        """Generate for a batch of prompts. Returns numpy
        (tokens (B, n_words) int32, lengths (B,) int32).

        ``decode_kernel``: None = auto (:meth:`resolve_kernel`); 'xla' is the
        exact bf16/f32 ring step; 'slab_w8' and 'slab_ar_w8' quantize the KV
        cache and the weights to int8, 'slab' and 'slab_ar' the KV cache
        only (the kernel paths; on a CPU device their plain version). The
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
        if kernel in KERNELS[1:] and not slab_ok(self.cfg, mem_len):
            raise ValueError(f"decode_kernel={kernel!r} needs a bf16 bias-free "
                             "config without beat embeddings, mem_len % 32 == 0 "
                             "and widths the slab kernels take; got "
                             f"mem_len={mem_len}, d_head={self.cfg.d_head}")
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
                       if kernel in INT8_WEIGHT_KERNELS else self.stacked()))
        return out.cpu().numpy(), lengths.cpu().numpy()


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    return None if node is None else node.to(device)
