"""Learners: training, checkpoints, and prediction through the decode engines.

``MusicLearner`` is the JAX package's genre-LM learner
(``train/learner.py:44-246``): fresh weights or a checkpoint, ``save``,
``fit_one_cycle`` with the window-mask curriculum, early stopping, best
checkpoint saving and per-epoch samples, ``evaluate``, and prediction.
``MultitaskLearner`` is the JAX package's multitask learner
(``:266-434``): mask infill, seq2seq and next-word prediction through the
engines, ``save``, and ``fit`` over the mask / next-word / seq2seq task
batches with the window-mask curriculum and loader rotation, without its
mesh.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codec.item import MusicItem
from ..decode.engine import GenerationEngine
from ..device import resolve_device
from ..models import multitask as mt
from ..models import txl
from ..models.config import MultitaskConfig, TXLConfig, btp_phase1_config, multitask_config
from ..models.precision import master_params
from ..vocab import MusicVocab
from .checkpoint import (load_checkpoint, multitask_params_from_numpy, params_from_numpy,
                         save_checkpoint)
from .data import LMStreamLoader
from .loop import (TrainState, _batch_to_device, cross_entropy, make_optimizer,
                   make_train_step, multi_loss)


@dataclass
class FitResult:
    history: List[Dict[str, float]] = field(default_factory=list)
    best_loss: float = float("inf")
    stopped_early: bool = False
    losses: List[float] = field(default_factory=list)   # every train step's loss
    windows: List[Tuple[int, int]] = field(default_factory=list)  # (win_size, win_k) a step


class MusicLearner:
    """Holds (params, cfg, vocab), trains them, and predicts through the
    generation engine on one device."""

    def __init__(self, cfg: TXLConfig, vocab: MusicVocab, params: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        """``params`` None draws fresh weights with ``txl.init_txl`` from
        ``generator`` (seed 0 if None). ``device=None`` means the CUDA card;
        pass ``"cpu"`` explicitly."""
        self.cfg = cfg
        self.vocab = vocab
        self.params = params if params is not None else txl.init_txl(cfg, generator)
        self.device = device
        self.step = 0              # optimizer steps the parameters have taken here
        self._engine = None

    def save(self, path: str, step: Optional[int] = None) -> str:
        """Write a checkpoint in the JAX package's format; the manifest
        records ``step`` (default: the steps trained by :meth:`fit_one_cycle`)."""
        return save_checkpoint(path, self.params, self.cfg, self.vocab,
                               step=self.step if step is None else step)

    @classmethod
    def load(cls, path: str, device=None) -> "MusicLearner":
        """Load a checkpoint directory written by either package."""
        tree, cfg, vocab, manifest = load_checkpoint(path)
        if not isinstance(cfg, TXLConfig):
            raise ValueError(f"{path} holds a {manifest['kind']!r} checkpoint; load it "
                             "with MultitaskLearner")
        learner = cls(cfg, vocab, params=params_from_numpy(tree, cfg), device=device)
        learner.step = int(manifest.get("step", 0))
        return learner

    @property
    def engine(self):
        if self._engine is None:
            self._engine = GenerationEngine(txl.tree_map(torch.Tensor.detach, self.params),
                                            self.cfg, self.vocab, device=self.device)
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

    # -- training -----------------------------------------------------------
    def fit_one_cycle(
        self,
        loader: LMStreamLoader,
        epochs: int = 1,
        lr: float = 5e-4,
        clip: float = 0.5,
        valid_loader: Optional[LMStreamLoader] = None,
        early_stop_patience: Optional[int] = 5,
        min_delta: float = 0.01,
        save_best_to: Optional[str] = None,
        sample_every_epoch: bool = False,
        sample_seed_item: Optional[MusicItem] = None,
        sample_dir: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        seed: int = 0,
    ) -> FitResult:
        """One-cycle training (``train/learner.py:104-226`` of the JAX
        package, without its mesh). The curriculum draws each step's window
        on the host from ``numpy.random.default_rng(seed)`` exactly as there
        (with probability 0.2 a random window in 1..mask_steps, else plain
        causal), so a seed gives JAX's window sequence; each step's dropout
        seed comes from a CPU ``torch.Generator`` seeded with ``seed``.
        Attention runs through the flash train kernels where
        ``txl.flash_train_auto`` picks them (on the card, a bf16 config at
        B >= 8). The learner's parameters
        become float32 masters on the device and are updated in place."""
        dev = resolve_device(self.device)
        total_steps = len(loader) * epochs
        optimizer = make_optimizer(total_steps, peak_lr=lr, clip=clip)
        params = master_params(self.params, dev)
        state = TrainState(params=params, opt_state=optimizer.init(params),
                           mem=txl.init_state(self.cfg, loader.bs, device=dev), step=0)
        step_fn = make_train_step(self.cfg, optimizer, self.vocab.pad_idx)
        step_seeds = torch.Generator().manual_seed(seed)
        host_rng = np.random.default_rng(seed)
        result = FitResult()
        patience_left = early_stop_patience
        mask_steps = self.cfg.mask_steps

        for epoch in range(epochs):
            t0 = time.time()
            train_loss, train_acc, n = 0.0, 0.0, 0
            state = state._replace(mem=txl.init_state(self.cfg, loader.bs, device=dev))
            for batch in loader:
                sub = int(torch.randint(0, 2 ** 31 - 1, (), generator=step_seeds))
                # rand_window_mask curriculum (genre:1586-1590): with p=0.2
                # use a random window size <= mask_steps, else plain causal
                win = (int(host_rng.integers(1, max(mask_steps, 1) + 1))
                       if mask_steps and host_rng.random() < 0.2 else 1)
                state, metrics = step_fn(state, batch, sub, win_size=win)
                result.losses.append(float(metrics["loss"]))
                train_loss += result.losses[-1]
                train_acc += float(metrics["acc"])
                n += 1
            train_loss /= max(n, 1)
            train_acc /= max(n, 1)
            entry = {"epoch": epoch, "train_loss": train_loss, "train_acc": train_acc,
                     "time_s": time.time() - t0}
            if valid_loader is not None:
                entry.update(self.evaluate(state.params, valid_loader))
            val_loss = entry.get("valid_loss", train_loss)
            result.history.append(entry)
            log_fn(f"epoch {epoch}: loss {train_loss:.4f} acc {train_acc:.3f} "
                   + (f"val {val_loss:.4f} " if valid_loader else "")
                   + f"({entry['time_s']:.1f}s)")

            if val_loss < result.best_loss - min_delta:
                result.best_loss = val_loss
                patience_left = early_stop_patience
                if save_best_to:
                    self.params, self._engine = state.params, None
                    self.save(save_best_to, step=self.step + state.step)
            elif early_stop_patience is not None:
                patience_left -= 1
                if patience_left <= 0:
                    result.stopped_early = True
                    log_fn(f"early stop at epoch {epoch}")
                    break

            if sample_every_epoch and sample_seed_item is not None:
                self.params, self._engine = state.params, None
                try:
                    _, full = self.predict(sample_seed_item, n_words=256, seed=epoch)
                    if sample_dir:
                        os.makedirs(sample_dir, exist_ok=True)
                        full.write_midi(os.path.join(sample_dir, f"pred_epoch_{epoch}.mid"))
                except Exception as e:  # GenSamples catches too (notebook cell 65)
                    log_fn(f"Invalid prediction generated at epoch {epoch}: {e}")

        self.params, self._engine = state.params, None
        self.step += state.step
        return result

    @torch.no_grad()
    def evaluate(self, params, loader: LMStreamLoader) -> Dict[str, float]:
        """Mean loss and accuracy over ``loader``, the XL memory threaded
        through its batches (``train/learner.py:228-246``)."""
        dev = resolve_device(self.device)
        params = txl.tree_map(lambda t: t.detach().to(dev), params)
        mem = txl.init_state(self.cfg, loader.bs, device=dev)
        tot_l, tot_a, n = 0.0, 0.0, 0
        for batch in loader:
            x = torch.from_numpy(batch["x"]).to(dev)
            logits, mem = txl.forward(params, self.cfg, x, state=mem)
            loss, acc = cross_entropy(logits, torch.from_numpy(batch["y"]).to(dev),
                                      self.vocab.pad_idx)
            tot_l += float(loss)
            tot_a += float(acc)
            n += 1
        return {"valid_loss": tot_l / max(n, 1), "valid_acc": tot_a / max(n, 1)}


def music_model_learner(cfg: Optional[TXLConfig] = None, vocab: Optional[MusicVocab] = None,
                        pretrained_path: Optional[str] = None, seed: int = 0,
                        device=None) -> MusicLearner:
    """Factory matching music_model_learner (genre:1784-1807): a checkpoint,
    or fresh ``init_txl`` weights drawn from ``seed`` (the flagship config by
    default)."""
    if pretrained_path:
        return MusicLearner.load(pretrained_path, device=device)
    vocab = vocab or MusicVocab.create()
    cfg = cfg or btp_phase1_config(len(vocab))
    return MusicLearner(cfg, vocab, generator=torch.Generator().manual_seed(seed),
                        device=device)


class MultitaskLearner:
    """The multitask model's (params, cfg, vocab), its training, and its
    three engines on one device."""

    def __init__(self, cfg: MultitaskConfig, vocab: MusicVocab, params: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 decode_kernel: str = "auto"):
        """``params`` None draws fresh weights with ``init_multitask`` from
        ``generator``. ``device=None`` means the CUDA card; pass ``"cpu"``
        explicitly. ``decode_kernel`` goes to the seq2seq and next-word
        engines (``decode.multitask_engine._pick_dec_kernel``)."""
        self.cfg = cfg
        self.vocab = vocab
        self.params = params if params is not None else mt.init_multitask(cfg, generator)
        self.device = device
        self.decode_kernel = decode_kernel
        self.step = 0              # optimizer steps the parameters have taken here
        self._device_params = None
        self._engines = {}

    def save(self, path: str, step: Optional[int] = None) -> str:
        """Write a checkpoint in the JAX package's format (kind
        ``multitask``); the manifest records ``step`` (default: the steps
        trained by :meth:`fit`)."""
        return save_checkpoint(path, self.params, self.cfg, self.vocab,
                               step=self.step if step is None else step)

    @classmethod
    def load(cls, path: str, device=None, decode_kernel: str = "auto") -> "MultitaskLearner":
        """Load a multitask checkpoint directory written by the JAX package."""
        tree, cfg, vocab, manifest = load_checkpoint(path)
        if not isinstance(cfg, MultitaskConfig):
            raise ValueError(f"{path} holds a {manifest['kind']!r} checkpoint; load it "
                             "with MusicLearner")
        learner = cls(cfg, vocab, params=multitask_params_from_numpy(tree, cfg),
                      device=device, decode_kernel=decode_kernel)
        learner.step = int(manifest.get("step", 0))
        return learner

    def engine(self, kind: str):
        """The 'mask', 's2s' or 'nw' engine, built on first use; the three
        share one device copy of the inference parameters."""
        if kind not in self._engines:
            from ..decode import multitask_engine as me
            dev = resolve_device(self.device)
            if self._device_params is None:
                self._device_params = me.inference_params(
                    txl.tree_map(torch.Tensor.detach, self.params), self.cfg, dev)
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

    # -- training -----------------------------------------------------------
    def fit(self, batches, epochs: int = 1, lr: float = 5e-4, clip: float = 0.5,
            log_fn: Callable[[str], None] = print, seed: int = 0, dataloaders=None,
            starting_mask_window: int = 1, mesh=None, remat: bool = False) -> FitResult:
        """Train on (x_dict, y_dict) multitask batches (``train/learner.py:
        341-434`` of the JAX package, without its mesh).

        MTTrainer semantics: each epoch the decoder's window curriculum
        grows (``mask_steps = max(epoch + starting_mask_window, 1)``) and,
        with ``dataloaders``, training rotates between them (epoch e runs
        ``dataloaders[e % len(dataloaders)]``); ``batches`` may be a list or
        a loader. The host draws exactly as JAX's: per step
        ``numpy.random.default_rng(seed).random() < cfg.mask_p`` (with
        mask_steps > 1) for a window ``integers(1, mask_steps + 1)`` at
        diagonal 0, else plain causal, then the step's dropout seed
        ``integers(2**31)``; so a seed gives JAX's window sequence. One-cycle
        AdamW (``loop.make_optimizer``) over float32 masters on the device,
        updated in place. On the card, a bf16 config at B >= 8 runs every
        attention through the flash train kernels (``multitask.
        _flash_train_ok``). ``remat``: per-block recomputation in the
        backward. Afterwards the engines and their device copy of the
        weights are dropped, so prediction uses the trained weights."""
        if mesh is not None:
            raise NotImplementedError("mesh (sharded) multitask training is not ported yet; "
                                      "see ROADMAP.md Queue 1 item 14")
        loaders = dataloaders if dataloaders is not None else [
            batches if isinstance(batches, list) else list(batches)]
        total_steps = sum(len(l) for l in loaders) // max(len(loaders), 1) * epochs
        optimizer = make_optimizer(max(total_steps, 1), peak_lr=lr, clip=clip)
        dev = resolve_device(self.device)
        cfg, pad_idx = self.cfg, self.vocab.pad_idx
        params = master_params(self.params, dev)
        opt = optimizer.init(params)
        leaves = txl.tree_leaves(params)
        host_rng = np.random.default_rng(seed)
        result = FitResult()
        for epoch in range(epochs):
            t0 = time.time()
            tot, n = 0.0, 0
            mask_steps = max(epoch + starting_mask_window, 1)
            for xd, yd in loaders[epoch % len(loaders)]:
                # rand_window_mask: active with p = mask_p, window <= mask_steps
                if host_rng.random() < cfg.mask_p and mask_steps > 1:
                    win, wk = int(host_rng.integers(1, mask_steps + 1)), 0
                else:
                    win, wk = 1, 1
                step_seed = int(host_rng.integers(2 ** 31))
                xs = {task: _batch_to_device(d, dev) for task, d in xd.items() if d is not None}
                out = mt.forward(params, cfg, xs, pad_idx=pad_idx, win_size=win, win_k=wk,
                                 remat=remat, rng=step_seed, train=True)
                loss, _ = multi_loss(out, _batch_to_device(yd, dev), pad_idx)
                # a task reaches only its stacks: the others' gradients are zero,
                # and AdamW still decays them, as in JAX
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
                # the schedule reads the updates taken in this fit, as optax's count
                optimizer.step(opt, grads, len(result.losses))
                result.losses.append(float(loss.detach()))
                result.windows.append((win, wk))
                tot += result.losses[-1]
                n += 1
            self.step += n
            entry = {"epoch": epoch, "train_loss": tot / max(n, 1), "steps": n,
                     "time_s": time.time() - t0}
            result.history.append(entry)
            result.best_loss = min(result.best_loss, entry["train_loss"])
            log_fn(f"epoch {epoch}: loss {entry['train_loss']:.4f} ({entry['time_s']:.1f}s)")
        self.params = params
        self._engines, self._device_params = {}, None
        return result


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
