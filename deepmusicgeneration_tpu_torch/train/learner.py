"""Learners: checkpoint load and prediction through the decode engines.

The inference halves of the JAX package's ``MusicLearner`` (genre LM,
``train/learner.py:59-130``) and ``MultitaskLearner`` (mask infill,
seq2seq, next-word; ``:266-340``); training is still to port (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..codec.item import MusicItem
from ..decode.engine import GenerationEngine
from ..device import resolve_device
from ..models.config import MultitaskConfig, TXLConfig, multitask_config
from ..models.multitask import init_multitask
from ..vocab import MusicVocab
from .checkpoint import load_checkpoint, multitask_params_from_numpy, params_from_numpy


class MusicLearner:
    """Holds (params, cfg, vocab) and the generation engine on one device."""

    def __init__(self, cfg: TXLConfig, vocab: MusicVocab, params: Dict,
                 device=None):
        """``device=None`` means the CUDA card; pass ``"cpu"`` explicitly."""
        self.cfg = cfg
        self.vocab = vocab
        self.params = params
        self.device = device
        self._engine = None

    @classmethod
    def load(cls, path: str, device=None) -> "MusicLearner":
        """Load a checkpoint directory written by the JAX package."""
        tree, cfg, vocab, manifest = load_checkpoint(path)
        if not isinstance(cfg, TXLConfig):
            raise ValueError(f"{path} holds a {manifest['kind']!r} checkpoint; load it "
                             "with MultitaskLearner")
        return cls(cfg, vocab, params=params_from_numpy(tree, cfg), device=device)

    @property
    def engine(self):
        if self._engine is None:
            self._engine = GenerationEngine(self.params, self.cfg, self.vocab,
                                            device=self.device)
        return self._engine

    def predict(self, item: MusicItem, n_words: int = 128,
                temperatures=(1.0, 1.0, 1.0), min_bars: int = 4,
                top_k: int = 30, top_p: float = 0.6, allowed_ins=None,
                greedy: bool = False, seed: int = 0,
                mem_len: Optional[int] = None):
        """Reference MusicLearner.predict contract: returns (pred, full)."""
        new = self.engine.generate(
            item.data, seed_pos=item.position, n_words=n_words,
            temperatures=temperatures, min_bars=min_bars, top_k=top_k,
            top_p=top_p, allowed_ins=allowed_ins, greedy=greedy, seed=seed,
            mem_len=mem_len)
        pred = MusicItem(new, self.vocab, ins=item.ins)
        return pred, item.append(pred)


class MultitaskLearner:
    """The multitask model's (params, cfg, vocab) and its three engines on
    one device: the inference half of the JAX package's MultitaskLearner."""

    def __init__(self, cfg: MultitaskConfig, vocab: MusicVocab, params: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 decode_kernel: str = "auto"):
        """``params`` None draws fresh weights with ``init_multitask`` from
        ``generator``. ``device=None`` means the CUDA card; pass ``"cpu"``
        explicitly. ``decode_kernel`` goes to the seq2seq and next-word
        engines (``decode.multitask_engine._pick_dec_kernel``)."""
        self.cfg = cfg
        self.vocab = vocab
        self.params = params if params is not None else init_multitask(cfg, generator)
        self.device = device
        self.decode_kernel = decode_kernel
        self._device_params = None
        self._engines = {}

    @classmethod
    def load(cls, path: str, device=None, decode_kernel: str = "auto") -> "MultitaskLearner":
        """Load a multitask checkpoint directory written by the JAX package."""
        tree, cfg, vocab, manifest = load_checkpoint(path)
        if not isinstance(cfg, MultitaskConfig):
            raise ValueError(f"{path} holds a {manifest['kind']!r} checkpoint; load it "
                             "with MusicLearner")
        return cls(cfg, vocab, params=multitask_params_from_numpy(tree, cfg),
                   device=device, decode_kernel=decode_kernel)

    def engine(self, kind: str):
        """The 'mask', 's2s' or 'nw' engine, built on first use; the three
        share one device copy of the inference parameters."""
        if kind not in self._engines:
            from ..decode import multitask_engine as me
            dev = resolve_device(self.device)
            if self._device_params is None:
                self._device_params = me.inference_params(self.params, self.cfg, dev)
            p = self._device_params
            self._engines[kind] = (
                me.MaskEngine(p, self.cfg, self.vocab, device=dev) if kind == "mask" else
                {"s2s": me.S2SEngine, "nw": me.NWEngine}[kind](
                    p, self.cfg, self.vocab, decode_kernel=self.decode_kernel, device=dev))
        return self._engines[kind]

    def predict_mask(self, masked_item: MusicItem, temperatures=(1.0, 1.0),
                     top_k: int = 20, top_p: float = 0.8, seed: int = 0,
                     greedy: bool = False, parallel: bool = True) -> MusicItem:
        """Fill the item's xxmask holes. ``parallel=True`` (the default, as in
        the JAX package) fills every mask from one bidirectional pass;
        ``False`` is the reference's sequential left-to-right loop."""
        out = self.engine("mask").predict_mask(
            masked_item.data, position=masked_item.position, temperatures=temperatures,
            top_k=top_k, top_p=top_p, seed=seed, greedy=greedy, parallel=parallel)
        return MusicItem(out.astype(np.int64), self.vocab)

    def predict_s2s(self, input_item: MusicItem, target_item: MusicItem,
                    n_words: int = 256, temperatures=(1.0, 1.0), top_k: int = 30,
                    top_p: float = 0.8, seed: int = 0, greedy: bool = False) -> MusicItem:
        """The target track continued against the input track."""
        target_ins = target_item.ins if isinstance(target_item.ins, str) else None
        out = self.engine("s2s").predict_s2s(
            input_item.data, target_item.data, target_ins=target_ins, n_words=n_words,
            temperatures=temperatures, top_k=top_k, top_p=top_p, greedy=greedy, seed=seed)
        return MusicItem(out.astype(np.int64), self.vocab, ins=target_item.ins)

    def predict_nw(self, item: MusicItem, n_words: int = 128, temperatures=(1.0, 1.0),
                   min_bars: int = 4, top_k: int = 30, top_p: float = 0.6,
                   seed: int = 0, greedy: bool = False):
        """Next-word continuation; returns (pred, full)."""
        new = self.engine("nw").predict_nw(item.data, n_words=n_words,
                                           temperatures=temperatures, min_bars=min_bars,
                                           top_k=top_k, top_p=top_p, greedy=greedy, seed=seed)
        pred = MusicItem(new.astype(np.int64), self.vocab)
        return pred, item.append(pred)


def multitask_model_learner(cfg: Optional[MultitaskConfig] = None,
                            vocab: Optional[MusicVocab] = None,
                            pretrained_path: Optional[str] = None, seed: int = 0,
                            device=None) -> MultitaskLearner:
    """A learner from a checkpoint, or with fresh ``init_multitask`` weights
    drawn from ``seed`` (the flagship config by default)."""
    if pretrained_path:
        return MultitaskLearner.load(pretrained_path, device=device)
    vocab = vocab or MusicVocab.create()
    cfg = cfg or multitask_config(len(vocab))
    return MultitaskLearner(cfg, vocab, generator=torch.Generator().manual_seed(seed),
                            device=device)
