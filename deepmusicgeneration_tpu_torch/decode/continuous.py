"""Continuous-batching generation engine.

:class:`~..tasks.serve.GenerationService` coalesces requests into *static*
batches: a batch decodes to completion before the next one starts, and rows
that stop early keep their lane as padding until the slowest row finishes.
This module keeps a RESIDENT device batch instead, as the JAX package's
``decode/continuous.py`` does:

* the KV ring cache, sampler state and per-row request parameters live on
  the device across calls; decoding proceeds in CHUNKS of ``chunk`` steps
  (a Python loop of device work with no host sync inside; one copy to the
  host at the chunk's end fetches tokens, ``done`` and ``n_emitted``);
* a new request joins between chunks by prefilling into any free row
  (:meth:`ContinuousEngine.insert`): its right-aligned prompt cache is
  rotated so its oldest entry lands at the shared ring pointer and its slot
  indices are rebased to the shared clock, so attention distances come out
  exactly as if the row were decoding alone;
* rows finish independently (budget, sampled BOS, bar-boundary stop) and
  free their lane for the next queued request at the next chunk boundary.

Every row carries its own sampling parameters (temperatures, top_k, top_p,
min_bars, greedy, instrument whitelist, seed). A row's random draws are a
function of its own seed and its own step counter only
(``ops.sampling.filter_sample_sorted_rows``), so a request's output does not
depend on which other requests share the batch.

Compute paths (``decode_kernel``):

* ``xla`` — the exact ring step (``models.txl.decode_step_ring``);
* ``slab`` (auto-picked on the card) / ``slab_w8`` — ``fused_slab_core``
  over the resident slot-major int8 cache, bf16 or int8 weight panels;
* ``slab_ar`` / ``slab_ar_w8`` — ``fused_slab_allrows_core``, the same step
  with each layer's weights read once for all rows.

Per-slot quantization is position-independent, so a mid-flight join stays
exact within each slab path. The clock (ring pointer and global index) is
shared by all rows and kept on the host as two integers.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..codec.grammar import allowed_ins_mask
from ..codec.index import position_enc
from ..device import resolve_device
from ..models import txl
from ..models.config import TXLConfig
from ..models.precision import cast_params_for_inference
from ..ops.fused_decode import (fused_slab_allrows_core, fused_slab_core,
                                quantize_kv_slot_major, quantize_stacked_weights,
                                stack_txl_layers)
from ..ops.sampling import filter_sample_sorted_rows, row_keys
from ..vocab import MusicVocab
from .engine import (ALLROWS_KERNELS, INT8_WEIGHT_KERNELS, KERNELS, DecodeTables,
                     SampleState, _bucket, _to_device, advance_state, build_tables,
                     expand_temperatures, prepare_logits, slab_ok)

I32 = torch.int32


class RowParams(NamedTuple):
    """Per-row request parameters, on the device."""
    temps: torch.Tensor        # (B, 3) fp32
    top_k: torch.Tensor        # (B,) int32 — 0 disables
    top_p: torch.Tensor        # (B,) fp32
    min_bars: torch.Tensor     # (B,) int32
    budget: torch.Tensor       # (B,) int32 — n_words for this row
    greedy: torch.Tensor       # (B,) bool
    allowed_ins: torch.Tensor  # (B, V) bool
    keys: torch.Tensor         # (B,) int64 — the row's stream key (row_keys of its seed)


class SlabKV(NamedTuple):
    """Slot-major int8 resident cache of the slab paths (the layout the
    static engine's slab branch carries through its loop)."""
    kq: torch.Tensor           # (L, B, M, HD) int8
    ksc: torch.Tensor          # (L, B, M, 1) fp32 per-slot scales
    vq: torch.Tensor           # (L, B, M, HD) int8
    vsc: torch.Tensor          # (L, B, M, 1) fp32
    g: torch.Tensor            # (B, M) int32 global index per slot


class BatchState(NamedTuple):
    """The resident decode state: everything carried across chunk calls."""
    cache: object              # RingKVCache (xla path) | SlabKV (slab paths)
    st: SampleState
    logits: torch.Tensor       # (B, V) fp32 — next-token logits per row
    steps: torch.Tensor        # (B,) int32 — sampling steps taken this request
    rows: RowParams
    ptr: int                   # shared ring pointer: the next slot written
    g_cur: int                 # shared clock: global index of the next token


def init_state(cfg: TXLConfig, n_slots: int, mem_len: int, vocab_size: int,
               kernel: str = "xla", device=None) -> BatchState:
    """All-free resident state: every row done, zeroed caches."""
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    B, M, V = n_slots, mem_len, vocab_size
    zeros = lambda shape=(B,), dtype=I32: torch.zeros(shape, dtype=dtype, device=device)
    g = torch.full((B, M), txl.PAD_G, dtype=I32, device=device)
    if kernel == "xla":
        cache = txl.RingKVCache(k=zeros((L, B, H, M, Dh), cfg.act_dtype),
                                v=zeros((L, B, H, M, Dh), cfg.act_dtype),
                                g=g, ptr=0, g_cur=0)
    else:
        floor = lambda: torch.full((L, B, M, 1), 1e-6 / 127.0, dtype=torch.float32,
                                   device=device)
        HD = H * Dh
        cache = SlabKV(kq=zeros((L, B, M, HD), torch.int8), ksc=floor(),
                       vq=zeros((L, B, M, HD), torch.int8), vsc=floor(), g=g)
    st = SampleState(
        prev_tok=zeros(), last_pos=zeros(), start_pos=zeros(),
        last_xxsep=zeros(dtype=torch.bool), repeat_count=zeros(),
        done=torch.ones((B,), dtype=torch.bool, device=device), n_emitted=zeros())
    rows = RowParams(
        temps=torch.ones((B, 3), dtype=torch.float32, device=device),
        top_k=zeros(), top_p=zeros(dtype=torch.float32), min_bars=zeros(),
        budget=zeros(), greedy=zeros(dtype=torch.bool),
        allowed_ins=torch.ones((B, V), dtype=torch.bool, device=device),
        keys=zeros(dtype=torch.int64))
    return BatchState(cache=cache, st=st, logits=zeros((B, V), torch.float32),
                      steps=zeros(), rows=rows, ptr=0, g_cur=0)


@torch.no_grad()
def insert_compiled(
    params: Dict,
    cfg: TXLConfig,
    state: BatchState,
    row: int,                    # free slot to fill
    window_toks: torch.Tensor,   # (1, W) left-padded prompt
    window_pad: torch.Tensor,    # (1, W) bool
    window_pos: torch.Tensor,    # (1, W) int32
    last_pos: int,
    temps: torch.Tensor,         # (3,) fp32
    top_k: int,
    top_p: float,
    min_bars: int,
    budget: int,
    greedy: bool,
    allowed_ins: torch.Tensor,   # (V,) bool
    seed: int,
    mem_len: int,
) -> None:
    """Prefill one prompt and graft it into resident row ``row`` in place.

    The single-prompt prefill produces a right-aligned ring cache whose own
    clock starts at (ptr=0, g_cur=0). The resident batch's clock is at
    (ptr=p, g_cur=t), shared by all rows, so the new row's slots are rolled
    by ``p`` (its oldest entry lands at ``p``, the next slot every row
    overwrites) and its slot indices are rebased by ``+t`` (attention reads
    distances ``g_cur - g``, so the last prompt token sits at distance 1 from
    the first decoded token, exactly as in a solo decode). On the slab paths
    the rolled panels are quantized per slot (position-independent) and
    scattered into the int8 / scale caches. The name follows the JAX
    package; the prefill is the materialized one, as there (``flash=False``).
    """
    logits1, cache0 = txl.prefill(params, cfg, window_toks, window_pad,
                                  pos=window_pos, mem_len=mem_len, flash=False)
    ring1 = txl.ring_from_prefill(cache0, cfg)      # B = 1, ptr = 0, g_cur = 0
    p, t = state.ptr, state.g_cur
    g1 = torch.where(ring1.g == txl.PAD_G, txl.PAD_G, ring1.g + t)
    cache = state.cache
    cache.g[row] = torch.roll(g1, p, dims=1)[0].to(I32)
    if isinstance(cache, txl.RingKVCache):
        cache.k[:, row] = torch.roll(ring1.k, p, dims=3)[:, 0]
        cache.v[:, row] = torch.roll(ring1.v, p, dims=3)[:, 0]
    else:
        L, HD, M = cfg.n_layers, cfg.n_heads * cfg.d_head, mem_len
        kt_s = ring1.k.permute(0, 1, 3, 2, 4).reshape(L, 1, M, HD)
        vc_s = ring1.v.permute(0, 1, 3, 2, 4).reshape(L, 1, M, HD)
        kq1, ks1, vq1, vs1 = quantize_kv_slot_major(torch.roll(kt_s, p, dims=2),
                                                    torch.roll(vc_s, p, dims=2))
        for dst, src in ((cache.kq, kq1), (cache.ksc, ks1), (cache.vq, vq1),
                         (cache.vsc, vs1)):
            dst[:, row] = src[:, 0]

    st, rows = state.st, state.rows
    st.prev_tok[row] = window_toks[0, -1].to(I32)
    st.last_pos[row] = last_pos
    st.start_pos[row] = last_pos
    st.last_xxsep[row] = False
    st.repeat_count[row] = 0
    st.done[row] = False
    st.n_emitted[row] = 0
    rows.temps[row] = temps
    rows.top_k[row] = top_k
    rows.top_p[row] = top_p
    rows.min_bars[row] = min_bars
    rows.budget[row] = budget
    rows.greedy[row] = greedy
    rows.allowed_ins[row] = allowed_ins
    rows.keys[row] = row_keys([seed])[0]
    state.logits[row] = logits1[0].to(torch.float32)
    state.steps[row] = 0


def _sample_rows(logits, st: SampleState, steps, rows: RowParams,
                 tables: DecodeTables):
    """One per-row sampling step (shared by the xla and slab chunk loops):
    each row's own draw stream and settings, then the per-row budget stop: a
    row takes exactly ``budget`` sampling steps unless it stopped earlier
    (the count of ``generate_batch``'s ``n_words`` loop)."""
    step_frac = steps.to(torch.float32) / torch.clamp_min(rows.budget, 1).to(torch.float32)
    lg, last_xxsep = prepare_logits(logits, st, tables, rows.temps,
                                    rows.min_bars, rows.allowed_ins)
    idx, nc = filter_sample_sorted_rows(rows.keys, steps, lg, rows.top_k,
                                        rows.top_p, rows.greedy)
    idx, st = advance_state(idx, nc, st, last_xxsep, tables, step_frac > 0.80)
    return idx, st._replace(done=st.done | (steps + 1 >= rows.budget))


@torch.no_grad()
def decode_chunk_compiled(params: Dict, cfg: TXLConfig, state: BatchState,
                          tables: DecodeTables, wkr_all: torch.Tensor,
                          chunk: int):
    """Advance every resident row by ``chunk`` sampling steps on the exact
    ring step. Finished and free rows ride along emitting pads (their
    ``done`` flag freezes their sampler state); the shared clock advances
    for everyone. Returns ``(state, tokens (chunk, B) int32)``."""
    st, logits, steps, cache = state.st, state.logits, state.steps, state.cache
    toks = []
    for _ in range(chunk):
        idx, st = _sample_rows(logits, st, steps, state.rows, tables)
        toks.append(idx)
        logits, cache = txl.decode_step_ring(params, cfg, idx, st.last_pos,
                                             cache, wkr_all)
        steps = steps + 1
    return state._replace(cache=cache, st=st, logits=logits, steps=steps,
                          ptr=cache.ptr, g_cur=cache.g_cur), torch.stack(toks)


@torch.no_grad()
def decode_chunk_slab(stacked, w_scales, embed32: torch.Tensor, head_b,
                      cfg: TXLConfig, state: BatchState, tables: DecodeTables,
                      wkr_mt: torch.Tensor, chunk: int, mem_len: int,
                      allrows: bool, rows_per_cell: int):
    """:func:`decode_chunk_compiled` on the slab path: one
    ``fused_slab_core`` (or, ``allrows``, ``fused_slab_allrows_core``) call
    per step over the resident slot-major int8 caches, which it updates in
    slot ``ptr``; ``w_scales`` None means bf16 weight panels."""
    core = fused_slab_allrows_core if allrows else fused_slab_core
    st, logits, steps, cache = state.st, state.logits, state.steps, state.cache
    ptr, g_cur = state.ptr, state.g_cur
    kv = [cache.kq, cache.ksc, cache.vq, cache.vsc]
    toks = []
    for _ in range(chunk):
        idx, st = _sample_rows(logits, st, steps, state.rows, tables)
        toks.append(idx)
        dist = g_cur - cache.g
        blocked = ((dist < 1) | (dist > mem_len)).to(I32)
        h_out, *kv = core(stacked, cfg, embed32[idx.long()], wkr_mt, *kv, blocked,
                          ptr, mem_len, rows_per_cell=rows_per_cell,
                          weights_int8=w_scales is not None, w_scales=w_scales)
        logits = h_out @ embed32.T
        if head_b is not None:
            logits = logits + head_b
        cache.g[:, ptr] = g_cur
        ptr, g_cur = (ptr + 1) % mem_len, g_cur + 1
        steps = steps + 1
    return state._replace(st=st, logits=logits, steps=steps, ptr=ptr,
                          g_cur=g_cur), torch.stack(toks)


class _Slot(NamedTuple):
    """Host-side record for one resident row."""
    future: Future
    chunks: list              # accumulated (chunk,) int32 arrays


class ContinuousEngine:
    """Host wrapper around the resident state: slot bookkeeping, prompt
    packing, kernel choice. Not thread-safe by itself: the
    :class:`ContinuousGenerationService` serializes access on one worker
    thread."""

    def __init__(self, params: Dict, cfg: TXLConfig, vocab: MusicVocab,
                 n_slots: int = 8, mem_len: Optional[int] = None,
                 chunk: int = 32, temp_mode: str = "genre",
                 cast_bf16: Optional[bool] = None,
                 strict_grammar: bool = True,
                 decode_kernel: Optional[str] = None,
                 device=None):
        """``params``: the port's parameter dict (``params_from_numpy``).
        ``decode_kernel``: 'xla' (exact ring step), 'slab' (bf16 weights,
        int8 resident KV), 'slab_w8' (slab + int8 weights), 'slab_ar' /
        'slab_ar_w8' (the all-rows step). ``None`` = auto: 'slab' on the card
        when the slab path applies (``engine.slab_ok``: bf16 bias-free
        config, mem_len % 32 == 0, widths the kernels take), else 'xla'; on
        the CPU an explicit slab kernel walks its plain version.
        ``device=None`` means the CUDA card; pass ``"cpu"`` explicitly.
        ``temp_mode`` and ``strict_grammar`` keep the JAX signature; only
        'genre' and True are ported."""
        if temp_mode != "genre" or not strict_grammar:
            raise NotImplementedError(
                "only temp_mode='genre' with strict_grammar=True is ported; the "
                "other tables are still to port (ROADMAP.md Queue 1 item 9)")
        self.device = resolve_device(device)
        if cast_bf16 is None:
            cast_bf16 = cfg.dtype == "bfloat16"
        if cast_bf16:
            params = cast_params_for_inference(params)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.vocab = vocab
        self.n_slots = n_slots
        self.mem_len = mem_len or cfg.mem_len
        self.chunk = chunk
        fused_ok = slab_ok(cfg, self.mem_len)
        if decode_kernel is None:
            decode_kernel = "slab" if fused_ok and self.device.type == "cuda" else "xla"
        if decode_kernel not in KERNELS:
            raise ValueError(f"decode kernel {decode_kernel!r} is not ported; one "
                             f"of {KERNELS} (ROADMAP.md)")
        if decode_kernel != "xla" and not fused_ok:
            raise ValueError(f"decode_kernel={decode_kernel!r} needs the slab path "
                             "(bf16 bias-free config, mem_len % 32 == 0, widths "
                             "the slab kernels take)")
        self.kernel = decode_kernel
        self.tables = build_tables(vocab, device=self.device)
        self.rows_per_cell = next(r for r in (8, 4, 2, 1) if n_slots % r == 0)
        wkr = txl.precompute_wkr(self.params, cfg, self.mem_len)
        if decode_kernel == "xla":
            self.wkr = wkr
        else:
            stacked = stack_txl_layers(self.params)
            self._w_scales = None
            if decode_kernel in INT8_WEIGHT_KERNELS:
                stacked, self._w_scales = quantize_stacked_weights(stacked)
            self._stacked = stacked
            self._embed32 = self.params["embed"].to(torch.float32)
            self._head_b = self.params.get("head_b")
            self.wkr = wkr.permute(0, 2, 1, 3).reshape(
                cfg.n_layers, self.mem_len + 1, -1).to(torch.bfloat16).contiguous()
        self.reset()

    def reset(self) -> None:
        """Rebuild the resident batch (fresh buffers, all slots free), as
        after a failed step, which may have left the in-place caches half
        written."""
        self.state = init_state(self.cfg, self.n_slots, self.mem_len,
                                len(self.vocab.itos),
                                kernel="xla" if self.kernel == "xla" else "slab",
                                device=self.device)
        self.slots: list = [None] * self.n_slots   # Optional[_Slot]

    # -- admission -----------------------------------------------------------
    def free_slots(self) -> list:
        return [i for i, s in enumerate(self.slots) if s is None]

    def insert(self, slot: int, seed_idxenc: np.ndarray,
               seed_pos: Optional[np.ndarray] = None, n_words: int = 512,
               temperatures=(1.0, 1.0, 1.0), top_k: int = 30,
               top_p: float = 0.6, min_bars: int = 4, greedy: bool = False,
               allowed_ins=None, seed: int = 0,
               future: Optional[Future] = None) -> None:
        """Prefill one prompt into free row ``slot`` (it joins at the next
        chunk). Prompt packing mirrors ``GenerationEngine.generate_batch``;
        a (t_note, t_dur) pair of temperatures expands to three slots."""
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} is busy")
        s = np.asarray(seed_idxenc)
        W = _bucket(len(s))
        W = min(W, max(self.cfg.ctx_len, self.mem_len))
        s = s[-W:]
        p = (np.asarray(seed_pos)[-W:] if seed_pos is not None
             else position_enc(s, self.vocab))
        toks = np.full((1, W), self.vocab.pad_idx, dtype=np.int64)
        pad = np.ones((1, W), dtype=bool)
        pos = np.zeros((1, W), dtype=np.int32)
        toks[0, W - len(s):] = s
        pad[0, W - len(s):] = False
        pos[0, W - len(s):] = p[:len(s)]
        temps = np.asarray(expand_temperatures(temperatures), np.float32)
        if temps.shape != (3,):
            raise ValueError(f"temperatures: 2 or 3 values, got {temperatures!r}")
        dev = self.device
        insert_compiled(
            self.params, self.cfg, self.state, slot,
            torch.from_numpy(toks).to(dev), torch.from_numpy(pad).to(dev),
            torch.from_numpy(pos).to(dev), int(p[-1]) if len(p) else 0,
            torch.from_numpy(temps).to(dev), int(top_k), float(top_p),
            int(min_bars), int(n_words), bool(greedy),
            torch.from_numpy(allowed_ins_mask(self.vocab, allowed_ins)).to(dev),
            int(seed), mem_len=self.mem_len)
        self.slots[slot] = _Slot(future or Future(), [])

    # -- stepping ------------------------------------------------------------
    def active(self) -> bool:
        return any(s is not None for s in self.slots)

    def step_chunk(self) -> list:
        """Run one chunk; returns the slots it completed.

        A slot completes when its row is ``done`` (budget exhausted, sampled
        BOS, or bar-boundary stop). Its future resolves to the emitted token
        array (pads trimmed through the device-tracked ``n_emitted``)."""
        if self.kernel == "xla":
            self.state, toks = decode_chunk_compiled(
                self.params, self.cfg, self.state, self.tables, self.wkr, self.chunk)
        else:
            self.state, toks = decode_chunk_slab(
                self._stacked, self._w_scales, self._embed32, self._head_b,
                self.cfg, self.state, self.tables, self.wkr, self.chunk,
                self.mem_len, allrows=self.kernel in ALLROWS_KERNELS,
                rows_per_cell=self.rows_per_cell)
        # one copy to the host for tokens, done and n_emitted together
        st = self.state.st
        fetched = torch.cat([toks.to(I32), st.done[None].to(I32),
                             st.n_emitted[None]]).cpu().numpy()
        toks, done, n_emitted = fetched[:-2].T, fetched[-2], fetched[-1]
        finished = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.chunks.append(toks[i])
            if done[i]:
                out = np.concatenate(slot.chunks)
                # pads only ever FOLLOW the emitted stream (done is sticky and
                # advance_state emits pad_idx once done): the first n_emitted
                # tokens are exactly the request's output
                slot.future.set_result(out[: n_emitted[i]])
                self.slots[i] = None
                finished.append(i)
        return finished

    # -- one-shot convenience (tests / offline) -------------------------------
    def generate(self, seed_idxenc: np.ndarray, **kw) -> np.ndarray:
        """Decode one prompt to completion on this engine (blocking)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        fut: Future = Future()
        self.insert(free[0], seed_idxenc, future=fut, **kw)
        while not fut.done():
            self.step_chunk()
        return fut.result()


class ContinuousGenerationService:
    """Futures front-end: concurrent :meth:`submit` calls stream through the
    resident batch. Unlike :class:`~..tasks.serve.GenerationService`,
    requests with different sampling settings share one device batch, a
    request joins within ``chunk`` steps of arriving instead of waiting for
    the previous batch to finish, and early-stopping rows free their lane at
    once."""

    def __init__(self, learner=None, engine: Optional[ContinuousEngine] = None,
                 n_slots: int = 8, chunk: int = 32, **engine_kw):
        """``learner``: a ``MusicLearner`` whose params, config, vocab and
        device build the engine (``engine_kw`` go to
        :class:`ContinuousEngine`); or a ready ``engine``."""
        if engine is None:
            engine_kw.setdefault("device", learner.device)
            engine = ContinuousEngine(learner.params, learner.cfg, learner.vocab,
                                      n_slots=n_slots, chunk=chunk, **engine_kw)
        self.engine = engine
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # torch runs eagerly on this thread and needs no larger stack than
        # the default (the JAX package's 256 MB was for XLA:CPU compiles)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, seed_idxenc: np.ndarray, **kw) -> Future:
        """Keyword args: n_words, temperatures, top_k, top_p, min_bars,
        greedy, allowed_ins, seed, seed_pos, all per request (see
        :meth:`ContinuousEngine.insert`)."""
        if self._closed:
            raise RuntimeError("service closed")
        fut: Future = Future()
        self._q.put((np.asarray(seed_idxenc), kw, fut))
        return fut

    def _admit(self, block: bool) -> bool:
        """Move queued requests into free slots. Returns False on shutdown."""
        eng = self.engine
        while True:
            free = eng.free_slots()
            if not free:
                return True
            try:
                item = self._q.get(block=block and not eng.active())
            except queue.Empty:
                return True
            if item is None:
                return False
            seed, kw, fut = item
            try:
                eng.insert(free[0], seed, future=fut, **kw)
            except Exception as e:       # a bad request fails its own future
                fut.set_exception(e)
            block = False  # only the first get may block (idle engine)

    def _loop(self):
        stopping = False   # close() was called: finish the residents, admit no more
        while True:
            if not stopping and not self._admit(block=True):
                stopping = True
            if stopping and not self.engine.active():
                return
            if self.engine.active():
                try:
                    self.engine.step_chunk()
                except Exception as e:   # a failed step fails every resident
                    for s in self.engine.slots:
                        if s is not None and not s.future.done():
                            s.future.set_exception(e)
                    # the in-place caches may be half written: rebuild the
                    # resident batch so later requests start clean
                    try:
                        self.engine.reset()
                    except Exception as re:
                        self._closed = True
                        self._fail_pending(RuntimeError(
                            f"service closed: device reset failed ({re})"))
                        return

    def _fail_pending(self, exc: Exception) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item[2].done():
                item[2].set_exception(exc)

    def close(self, timeout: float = 60.0):
        """Stop taking requests, finish the ones submitted before (queued
        requests reach a slot first, since the queue is first in first out),
        and join the worker; raises, failing every open future, if it is
        still busy after ``timeout`` seconds."""
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # a resident decode outlived the join: callers must not be left
            # waiting on futures the daemon thread still owns
            exc = RuntimeError("service close timed out; worker still busy")
            for s in self.engine.slots:
                if s is not None and not s.future.done():
                    s.future.set_exception(exc)
            self._fail_pending(exc)
            raise exc
