"""Inference engines of the multitask model: mask infill, seq2seq
harmonization and next-word continuation.

The port's counterparts of the JAX package's ``decode/multitask_engine.py``
(the reference's MultitaskLearner.predict_mask / predict_s2s / predict_nw):

* :class:`MaskEngine` fills ``xxmask`` holes with the bidirectional encoder:
  sequentially, left to right, one full encode per mask (later masks see
  earlier fills), or in parallel from one encoder pass; special tokens are
  banned and the grammar mask applies.
* :class:`S2SEngine` encodes the source track once, prefills the decoder on
  the target's prefix and decodes one token a step with a self-attention
  ring and cached cross-attention, stopping one bar past the source or at
  EOS.
* :class:`NWEngine` continues a prompt through the decoder's attention-only
  path.

Every engine builds a batch-1 window. The decode step is picked by
:func:`_pick_dec_kernel`: on the card, with a bf16 config and mem_len a
multiple of 32 (and widths the CUDA kernel takes), ``slab_w8``
(``ops.fused_s2s``: int8 weights, an int8 self ring and cross context);
elsewhere ``xla``, the exact ring step of ``models.multitask``. ``fused``
(the exact bf16 sweep of ``ops.fused_s2s``: bf16 weights, ring and cross
context) runs on request. The loops run eagerly, ``n_words`` steps, with no
value read back to the host between tokens.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..codec.grammar import allowed_ins_mask
from ..codec.index import position_enc
from ..device import resolve_device
from ..models import multitask as mt
from ..models.config import MultitaskConfig
from ..models.precision import cast_params_for_inference
from ..ops.fused_decode import quantize_kv_slot_major
from ..ops.fused_s2s import (SLAB, fused_nw_slab_core, fused_nw_step_core,
                             fused_s2s_slab_core, fused_s2s_step_core, kernel_accepts,
                             quantize_cross_slot_major, quantize_mt_weights,
                             stack_mt_dec_layers)
from ..ops.sampling import (FILTER_VALUE, filter_sample_sorted, sample_categorical,
                            top_k_top_p)
from ..vocab import SAMPLE_FREQ, MusicVocab
from .engine import (SampleState, SamplerSettings, _past_80pct, _to_device, build_tables,
                     sample_next_token)

I32 = torch.int32
KERNELS = ("xla", "slab_w8", "slab", "fused")


def _bucket(n: int, buckets=(64, 128, 256, 512, 1024)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def slab_ok(cfg: MultitaskConfig) -> bool:
    """Whether the slab steps apply: a bf16 config with mem_len % 32 == 0
    (the JAX package's rule) and widths the CUDA kernel takes."""
    return cfg.dtype == "bfloat16" and cfg.mem_len % SLAB == 0 and kernel_accepts(cfg)


def _pick_dec_kernel(cfg: MultitaskConfig, decode_kernel: str, device: torch.device) -> str:
    """The decode step: 'auto' gives 'slab_w8' on the card where
    :func:`slab_ok` holds (int8 weights, int8 self ring and cross context),
    'xla' elsewhere (the exact ring step, any device). An explicit 'slab'
    (int8 ring and cross context, bf16 weights), 'slab_w8', 'fused' (the
    exact bf16 sweep: a bf16 config whose widths the kernel takes) or 'xla'
    is honoured; an explicit kernel step on a config it does not take
    raises."""
    if decode_kernel == "auto":
        return "slab_w8" if device.type == "cuda" and slab_ok(cfg) else "xla"
    if decode_kernel not in KERNELS:
        raise ValueError(f"decode_kernel {decode_kernel!r}: one of 'auto', {KERNELS}")
    if decode_kernel == "fused":
        if not (cfg.dtype == "bfloat16" and kernel_accepts(cfg)):
            raise ValueError(f"decode_kernel='fused' needs a bf16 config with widths the "
                             f"kernel takes; got dtype={cfg.dtype}, d_head={cfg.d_head}")
        return decode_kernel
    if decode_kernel != "xla" and not slab_ok(cfg):
        raise ValueError(f"decode_kernel={decode_kernel!r} needs a bf16 config with "
                         f"mem_len % {SLAB} == 0 and widths the kernel takes; got "
                         f"dtype={cfg.dtype}, mem_len={cfg.mem_len}, d_head={cfg.d_head}")
    return decode_kernel


def _build_stacked(params: Dict, kernel: str):
    """(stacked weights, w_scales or None) of a kernel step: int8 panels for
    'slab_w8', bf16 for 'slab' and 'fused'; None for 'xla'."""
    if kernel == "xla":
        return None
    stacked = stack_mt_dec_layers(params)
    return quantize_mt_weights(stacked) if kernel == "slab_w8" else (stacked, None)


def inference_params(params: Dict, cfg: MultitaskConfig, device: torch.device) -> Dict:
    """``params`` cast for inference (bf16 matmul weights for a bf16 config)
    and moved to ``device``; tensors already so are not copied."""
    if cfg.dtype == "bfloat16":
        params = cast_params_for_inference(params)
    return _to_device(params, device)


class _Engine:
    def __init__(self, params: Dict, cfg: MultitaskConfig, vocab: MusicVocab, device=None):
        """``device=None`` means the CUDA card; pass ``"cpu"`` explicitly."""
        self.device = resolve_device(device)
        self.params = inference_params(params, cfg, self.device)
        self.cfg, self.vocab = cfg, vocab
        self.tables = build_tables(vocab, "twotemp", device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)


def _temps(temperatures) -> tuple:
    """(t_note, t_dur) → the three slots (t_note, t_dur, t_dur), as the JAX
    engines expand them."""
    return (temperatures[0], temperatures[1], temperatures[1])


class MaskEngine(_Engine):
    """Mask infill (the reference's predict_mask contract)."""

    def __init__(self, params: Dict, cfg: MultitaskConfig, vocab: MusicVocab, device=None):
        super().__init__(params, cfg, vocab, device=device)
        # special tokens an infill never produces: bos, sep, ni, eos, genres,
        # and the pad and mask tokens themselves
        banned = np.zeros(len(vocab), bool)
        banned[[*vocab.special_idxs, vocab.pad_idx, vocab.mask_idx]] = True
        self.banned = self._tensor(banned)

    @torch.no_grad()
    def predict_mask(self, masked_idxenc: np.ndarray, position: Optional[np.ndarray] = None,
                     temperatures=(1.0, 1.0), top_k: int = 20, top_p: float = 0.8,
                     greedy: bool = False, seed: int = 0, parallel: bool = False) -> np.ndarray:
        """Fill the xxmask holes of ``masked_idxenc``; returns the filled ids.
        ``parallel`` fills every mask from one encoder pass; otherwise masks
        are filled left to right, each from a full encode of the sequence so
        far. The encoder window is capped at 1024 tokens; the tail beyond it
        passes through unchanged."""
        v = self.vocab
        x_all = np.asarray(masked_idxenc, np.int64)
        pos_all = (np.asarray(position, np.int64) if position is not None
                   else position_enc(x_all, v).astype(np.int64))
        x, pos = x_all[:1024], pos_all[:1024]
        W = _bucket(len(x))
        xb = np.full((1, W), v.pad_idx, np.int64)
        pb = np.zeros((1, W), np.int64)
        padc = np.ones((1, W), bool)
        xb[0, :len(x)], pb[0, :len(x)], padc[0, :len(x)] = x, pos, False
        temps = self._tensor(np.asarray(temperatures if len(temperatures) == 3
                                        else _temps(temperatures), np.float32))
        xt, pt, pc = self._tensor(xb), self._tensor(pb), self._tensor(padc)
        gen = self._generator(seed)
        if parallel:
            out = self._fill_parallel(xt, pt, pc, temps, top_k, top_p, greedy, gen)
        else:
            out = self._fill_sequential(xt, pt, pc, temps, top_k, top_p, greedy, gen,
                                        np.nonzero(x == v.mask_idx)[0])
        filled = out[0, :len(x)].cpu().numpy().astype(np.int32)
        return np.concatenate([filled, x_all[len(x):].astype(np.int32)])

    def _masked_logits(self, logits, prev, temperature):
        """Temperature, the special-token ban and the grammar mask (the
        infill always reads the no-xxsep-yet row of the table)."""
        t = self.tables
        logits = logits / temperature[..., None]
        logits = torch.where(self.banned, FILTER_VALUE, logits)
        ok = t.allowed[t.prev_class[prev], 0]
        return torch.where(ok, logits, FILTER_VALUE)

    def _fill_parallel(self, x, pos, pad, temps, top_k, top_p, greedy, gen):
        logits = mt.head(self.params, self.cfg, mt.encode(self.params, self.cfg, x, pos,
                                                          pad_cols=pad))
        prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        logits = self._masked_logits(logits, prev, temps[self.tables.temp_slot[prev]])
        logits = top_k_top_p(logits, top_k, top_p)
        idx = logits.argmax(-1) if greedy else sample_categorical(gen, logits)
        return torch.where(x == self.vocab.mask_idx, idx, x)

    def _fill_sequential(self, x, pos, pad, temps, top_k, top_p, greedy, gen, mask_pos):
        x = x.clone()
        repeat_count = torch.zeros((1,), dtype=torch.long, device=self.device)
        for m in mask_pos:
            h = mt.encode(self.params, self.cfg, x, pos, pad_cols=pad)
            logits = mt.head(self.params, self.cfg, h[:, m])               # (1, V)
            prev = x[:, max(m - 1, 0)]
            temperature = temps[self.tables.temp_slot[prev]]
            penalty = torch.clamp_min(torch.log((repeat_count + 1) / 4.0) / 5.0, 0.0) \
                * temperature
            logits = self._masked_logits(logits, prev, temperature + penalty)
            idx, nc = filter_sample_sorted(gen, logits, top_k, top_p, greedy=greedy)
            repeat_count = torch.where(nc <= 2, repeat_count + 1,
                                       torch.div(repeat_count, 2, rounding_mode="floor"))
            x[:, m] = idx
        return x


class _DecodeEngine(_Engine):
    def __init__(self, params: Dict, cfg: MultitaskConfig, vocab: MusicVocab,
                 decode_kernel: str = "auto", device=None):
        super().__init__(params, cfg, vocab, device=device)
        self.kernel = _pick_dec_kernel(cfg, decode_kernel, self.device)
        self._stacked = None

    def stacked(self):
        """The kernel step's (stacked weights, w_scales or None), built once."""
        if self._stacked is None:
            self._stacked = _build_stacked(self.params, self.kernel)
            logging.getLogger(__name__).info("multitask decode kernel: %s", self.kernel)
        return self._stacked

    def _loop(self, logits, st, ring, settings, temps, top_p, min_bars, overlay, gen,
              max_pos, step_xla, step_kernel):
        """The token loop shared by the seq2seq and next-word engines: sample,
        then one decoder step through ``step_xla(idx, pos, ring)`` or the
        kernel step ``step_kernel(stacked, h_in, kv, blocked, ptr)``, whose
        ``kv`` is the ring's K/V: the bf16 head-major tensors for 'fused'
        (updated in place), quantized slot-major for the slab steps."""
        B = st.prev_tok.shape[0]
        toks = torch.empty((settings.n_words, B), dtype=I32, device=self.device)
        top_k = torch.full((B,), settings.top_k, dtype=torch.long, device=self.device)
        top_p = torch.full((B,), top_p, dtype=torch.float32, device=self.device)

        def sample(i, logits, st):
            return sample_next_token(logits, st, self.tables, temps, top_k, top_p, min_bars,
                                     overlay, gen, settings, _past_80pct(i, settings.n_words),
                                     max_pos=max_pos)

        if self.kernel == "xla":
            for i in range(settings.n_words):
                idx, st = sample(i, logits, st)
                toks[i] = idx
                logits, ring = step_xla(idx, st.last_pos, ring)
            return toks.T, st.n_emitted

        cfg, M = self.cfg, self.cfg.mem_len
        L, HD = cfg.dec_layers, cfg.n_heads * cfg.d_head
        if self.kernel == "fused":
            kv = [ring.k, ring.v]
        else:
            kv = quantize_kv_slot_major(ring.k.permute(0, 1, 3, 2, 4).reshape(L, B, M, HD),
                                        ring.v.permute(0, 1, 3, 2, 4).reshape(L, B, M, HD))
        stacked = self.stacked()
        embed32 = self.params["embed"].to(torch.float32)
        head_b = self.params.get("head_b")
        g, ptr, g_cur = ring.g, ring.ptr, ring.g_cur
        for i in range(settings.n_words):
            idx, st = sample(i, logits, st)
            toks[i] = idx
            h_in = mt.embed_tokens(self.params, cfg, idx[:, None],
                                   st.last_pos[:, None])[:, 0].to(torch.float32)
            dist = g_cur - g
            blocked = ((dist < 1) | (dist > M)).to(I32)
            h_out, *kv = step_kernel(stacked, h_in, kv, blocked, ptr)
            logits = h_out @ embed32.T
            if head_b is not None:
                logits = logits + head_b
            g[:, ptr] = g_cur
            ptr, g_cur = (ptr + 1) % M, g_cur + 1
        return toks.T, st.n_emitted

    def _state0(self, prev_tok: torch.Tensor, last_pos: torch.Tensor) -> SampleState:
        B = prev_tok.shape[0]
        zeros = lambda dt: torch.zeros((B,), dtype=dt, device=self.device)
        return SampleState(prev_tok=prev_tok.to(I32), last_pos=last_pos.to(I32),
                           start_pos=last_pos.to(I32), last_xxsep=zeros(torch.bool),
                           repeat_count=zeros(I32), done=zeros(torch.bool),
                           n_emitted=zeros(I32))

    def _wkr_mt(self, wkr_all: torch.Tensor) -> torch.Tensor:
        L, H, M1, Dh = wkr_all.shape
        return wkr_all.permute(0, 2, 1, 3).reshape(L, M1, H * Dh).to(torch.bfloat16) \
            .contiguous()

    def _left_window(self, toks: np.ndarray, pos: np.ndarray):
        """The last W tokens of ``toks`` left-padded into a (1, W) window,
        W the bucket of its length capped at max(ctx_len, mem_len)."""
        W = min(_bucket(len(toks)), max(self.cfg.ctx_len, self.cfg.mem_len))
        t, p = toks[-W:], pos[-W:]
        xb = np.full((1, W), self.vocab.pad_idx, np.int64)
        pb = np.zeros((1, W), np.int64)
        pad = np.ones((1, W), bool)
        xb[0, W - len(t):], pb[0, W - len(t):], pad[0, W - len(t):] = t, p, False
        return self._tensor(xb), self._tensor(pb), self._tensor(pad)


class S2SEngine(_DecodeEngine):
    """Seq2seq harmonization (the reference's predict_s2s contract).

    ``decode_kernel``: 'auto' (the int8 ``slab_w8`` step on the card, see
    :func:`_pick_dec_kernel`; it quantizes the self ring, the cross context
    and the weights, as the JAX package's auto rule does on the TPU),
    'slab', 'slab_w8', 'fused' (exact bf16), or 'xla' (exact, any
    device)."""

    @torch.no_grad()
    def predict_s2s(self, input_idxenc: np.ndarray, target_idxenc: np.ndarray,
                    target_ins: Optional[str] = None, n_words: int = 256,
                    temperatures=(1.0, 1.0), top_k: int = 30, top_p: float = 0.8,
                    greedy: bool = False, seed: int = 0) -> np.ndarray:
        """The target continued against the source; returns the target ids
        followed by the new ones. The source window is capped at its first
        1024 tokens."""
        v, cfg = self.vocab, self.cfg
        inp = np.asarray(input_idxenc, np.int64)
        targ = np.asarray(target_idxenc, np.int64)
        inp_pos = position_enc(inp, v).astype(np.int64)[:1024]
        targ_pos = position_enc(targ, v).astype(np.int64)
        inp = inp[:1024]
        We = _bucket(len(inp))
        ib = np.full((1, We), v.pad_idx, np.int64)
        ipb = np.zeros((1, We), np.int64)
        ipad = np.ones((1, We), bool)
        ib[0, :len(inp)], ipb[0, :len(inp)], ipad[0, :len(inp)] = inp, inp_pos, False
        x, pos, pad = self._left_window(targ, targ_pos)
        last = int(targ_pos[-1]) if len(targ_pos) else 0
        # only predict until both tracks cover the same span + 1 bar
        max_pos = self._tensor([int(inp_pos[-1]) + SAMPLE_FREQ * 4], I32)
        settings = SamplerSettings(n_words=n_words, top_k=top_k, greedy=greedy,
                                   use_min_bars_ban=False, bar_stop=False, pos_stop=True,
                                   eos_stop=True)
        overlay = self._tensor(allowed_ins_mask(v, [target_ins] if target_ins else None))
        ib_t, ipb_t, ipad_t = self._tensor(ib), self._tensor(ipb), self._tensor(ipad)

        p = self.params
        enc_out = mt.encode(p, cfg, ib_t, ipb_t, pad_cols=ipad_t)
        logits, cache = mt.decoder_prefill(p, cfg, x, pos, pad, enc_out, enc_pad=ipad_t)
        ring = mt.dec_ring_from_prefill(cache)
        cross = mt.precompute_cross(p, cfg, enc_out)
        wkr_all = mt.precompute_dec_wkr(p, cfg, cfg.mem_len)
        st = self._state0(x[:, -1], self._tensor([last], I32))
        temps = self._tensor(np.asarray(_temps(temperatures), np.float32))

        def step_xla(idx, last_pos, ring):
            return mt.decoder_step_ring(p, cfg, idx, last_pos, ring, cross, wkr_all,
                                        enc_pad=ipad_t)

        step_kernel = None
        if self.kernel == "fused":
            fctx = (cross.k[:, 0], cross.v[:, 0], cross.wkr, ipad_t.to(I32))

            def step_kernel(stacked, h_in, kv, blocked, ptr):
                return fused_s2s_step_core(stacked[0], cfg, h_in, wkr_all, *kv, *fctx, blocked,
                                           ptr, cfg.mem_len)
        elif self.kernel != "xla":
            wkr_mt = self._wkr_mt(wkr_all)
            cctx = (*quantize_cross_slot_major(cross), ipad_t.to(I32))

            def step_kernel(stacked, h_in, kv, blocked, ptr):
                stk, w_scales = stacked
                return fused_s2s_slab_core(stk, cfg, h_in, wkr_mt, *kv, *cctx, blocked, ptr,
                                           cfg.mem_len, weights_int8=w_scales is not None,
                                           w_scales=w_scales)

        toks, lengths = self._loop(logits, st, ring, settings, temps, top_p, 0, overlay,
                                   self._generator(seed), max_pos, step_xla, step_kernel)
        new = toks[0, :int(lengths[0])].cpu().numpy()
        return np.concatenate([targ, new]).astype(np.int64)


class NWEngine(_DecodeEngine):
    """Next-word continuation through the decoder's attention-only path (the
    reference's predict_nw contract); ``decode_kernel`` as :class:`S2SEngine`."""

    @torch.no_grad()
    def predict_nw(self, idxenc: np.ndarray, n_words: int = 128, temperatures=(1.0, 1.0),
                   min_bars: int = 4, top_k: int = 30, top_p: float = 0.6,
                   greedy: bool = False, seed: int = 0) -> np.ndarray:
        """Returns the new token ids."""
        v, cfg = self.vocab, self.cfg
        toks = np.asarray(idxenc, np.int64)
        pos = position_enc(toks, v).astype(np.int64)
        x, pos_t, pad = self._left_window(toks, pos)
        settings = SamplerSettings(n_words=n_words, top_k=top_k, greedy=greedy)
        p = self.params
        logits, cache = mt.lm_prefill(p, cfg, x, pos_t, pad)
        ring = mt.dec_ring_from_prefill(cache)
        wkr_all = mt.precompute_dec_wkr(p, cfg, cfg.mem_len)
        st = self._state0(x[:, -1], self._tensor([int(pos[-1]) if len(pos) else 0], I32))
        temps = self._tensor(np.asarray(_temps(temperatures), np.float32))
        overlay = torch.ones((logits.shape[-1],), dtype=torch.bool, device=self.device)

        def step_xla(idx, last_pos, ring):
            return mt.lm_step_ring(p, cfg, idx, last_pos, ring, wkr_all)

        step_kernel = None
        if self.kernel == "fused":
            def step_kernel(stacked, h_in, kv, blocked, ptr):
                return fused_nw_step_core(stacked[0], cfg, h_in, wkr_all, *kv, blocked, ptr,
                                          cfg.mem_len)
        elif self.kernel != "xla":
            wkr_mt = self._wkr_mt(wkr_all)

            def step_kernel(stacked, h_in, kv, blocked, ptr):
                stk, w_scales = stacked
                return fused_nw_slab_core(stk, cfg, h_in, wkr_mt, *kv, blocked, ptr,
                                          cfg.mem_len, weights_int8=w_scales is not None,
                                          w_scales=w_scales)

        out, lengths = self._loop(logits, st, ring, settings, temps, top_p, int(min_bars),
                                  overlay, self._generator(seed), None, step_xla, step_kernel)
        return out[0, :int(lengths[0])].cpu().numpy()
