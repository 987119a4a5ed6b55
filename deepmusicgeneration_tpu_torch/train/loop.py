"""Training step, losses, metrics, optimizer.

The JAX package's recipe (``train/loop.py``; the reference's notebook cells
62, 70-73): cross-entropy next-token loss with pad ignored, gradient clipping
by global norm 0.5, AdamW with fastai's defaults (betas 0.9/0.99, eps 1e-5,
weight decay 0.01) decoupled as optax applies it, a one-cycle cosine
learning-rate schedule, bf16 activations over float32 master parameters and
optimizer state. The train step differentiates ``models/txl.py::forward``,
whose attention runs through the flash train kernels on the card.

The multitask learner sums its tasks' losses with :func:`multi_loss`. The
sharded steps are still to port (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import txl
from ..models.config import TXLConfig
from ..models.precision import master_params


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_index: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored targets; returns (loss, accuracy) as 0-dim
    float32 tensors."""
    targets = targets.long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    correct = (logits.argmax(-1) == targets).float()
    if ignore_index is None:
        return nll.mean(), correct.mean()
    mask = (targets != ignore_index).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom, (correct * mask).sum() / denom


def multi_loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
               pad_idx: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MultiLoss (``train/loop.py:60-70``): the sum of each task's
    cross-entropy with pad ignored; metrics ``<task>_loss`` and
    ``<task>_acc``."""
    total, metrics = 0.0, {}
    for key, y in targets.items():
        loss, acc = cross_entropy(outputs[key], y, ignore_index=pad_idx)
        total = total + loss
        metrics[f"{key}_loss"] = loss
        metrics[f"{key}_acc"] = acc
    return total, metrics


def one_cycle_schedule(total_steps: int, peak_lr: float = 5e-4,
                       pct_start: float = 0.3) -> Callable[[int], float]:
    """fastai's fit_one_cycle shape, as ``optax.cosine_onecycle_schedule``
    computes it (``transition_steps=max(total_steps, 1)``, div_factor 25,
    final_div_factor 1e4): a cosine rise from peak / 25 to the peak over the
    first ``int(pct_start * total)`` steps, a cosine fall to peak / 2.5e5 by
    ``total``, constant after. The arithmetic is optax's piecewise cosine
    interpolation, in float32 as optax computes it for the optimizer's int32
    step count (its float64 boundary values rounded where they meet the
    float32 count). When ``int(pct_start * total)`` is 0 (fewer than 4 steps
    at 0.3) optax's first interval is empty and every value is NaN; so is
    this schedule's."""
    steps = max(total_steps, 1)
    div, final_div = 25.0, 1e4
    bounds = np.array([0, int(pct_start * steps), int(steps)])
    values = np.cumprod(np.array([peak_lr / div, div, 1.0 / (div * final_div)]))
    f32 = np.float32
    ends = values[1:].astype(f32)
    halves = ((values[:-1] - values[1:]) / 2.0).astype(f32)
    starts = bounds[:-1].astype(f32)
    sizes = (bounds[1:] - bounds[:-1]).astype(f32)

    def schedule(count: int) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (f32(count) - starts) / sizes
            interp = ends + halves * (np.cos(f32(math.pi) * pct) + f32(1.0))
            inside = ((bounds[:-1] <= count) & (count < bounds[1:])).astype(f32)
            return float(np.sum(inside * interp, dtype=f32)
                         + f32(bounds[-1] <= count) * f32(values[-1]))

    return schedule


class OneCycleAdamW(NamedTuple):
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, 0.9, 0.99,
    1e-5, weight_decay))`` through ``torch.nn.utils.clip_grad_norm_`` and
    ``torch.optim.AdamW`` (fused on the card) over every parameter leaf.
    Both apply the decay decoupled, as optax does: ``p - lr * (wd * p +
    m_hat / (sqrt(v_hat) + eps))``. ``clip_grad_norm_`` divides by the norm
    + 1e-6 where optax divides by the norm; Adam's update barely moves with
    the gradients' scale."""
    schedule: Callable[[int], float]
    clip: float = 0.5
    weight_decay: float = 0.01

    def init(self, params) -> torch.optim.AdamW:
        leaves = txl.tree_leaves(params)
        # lr is set before every update: the schedule is NaN at step 0 when
        # total_steps < 4 (as optax's is), which the constructor refuses
        return torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.99), eps=1e-5,
                                 weight_decay=self.weight_decay, fused=leaves[0].is_cuda)

    def step(self, opt: torch.optim.AdamW, grads: List[torch.Tensor],
             count: int) -> torch.Tensor:
        """Updates the float32 master parameters in place with ``grads`` at
        the learning rate of step ``count`` (optax evaluates the schedule at
        the count before the update). Returns the gradients' global norm
        before clipping (a device tensor: nothing synchronizes)."""
        leaves = [p for group in opt.param_groups for p in group["params"]]
        for p, g in zip(leaves, grads):
            p.grad = g
        gnorm = torch.nn.utils.clip_grad_norm_(leaves, self.clip)
        for group in opt.param_groups:
            group["lr"] = self.schedule(count)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return gnorm


def make_optimizer(total_steps: int, peak_lr: float = 5e-4, clip: float = 0.5,
                   weight_decay: float = 0.01) -> OneCycleAdamW:
    return OneCycleAdamW(one_cycle_schedule(total_steps, peak_lr), clip=clip,
                         weight_decay=weight_decay)


class TrainState(NamedTuple):
    params: Dict                 # float32 masters with requires_grad, updated in place
    opt_state: torch.optim.AdamW
    mem: txl.TXLState
    step: int                    # optimizer updates taken; the schedule reads it


def init_train_state(cfg: TXLConfig, optimizer: OneCycleAdamW, batch: int,
                     generator: Optional[torch.Generator] = None, device=None) -> TrainState:
    params = master_params(txl.init_txl(cfg, generator), device)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      mem=txl.init_state(cfg, batch, device=device), step=0)


def _batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items() if v is not None}


def make_train_step(cfg: TXLConfig, optimizer: OneCycleAdamW, pad_idx: int,
                    flash: Optional[bool] = None) -> Callable:
    """Returns ``train_step(state, batch, rng, win_size=1) -> (state,
    metrics)``.

    ``batch``: 'x' and 'y' (B, L) int32 (numpy or tensors), optional 'pos'.
    The XL memory is threaded through the steps (the loader streams
    contiguous windows, so consecutive steps continue the same songs).
    ``rng``: an int seed of the step's dropouts (None: none). The curriculum
    window ``win_size`` > 1 uses diagonal 0 (only completed windows visible),
    plain causal diagonal 1. ``flash``: forwarded to ``txl.forward`` (None:
    its auto rule, the flash train kernels on the card at bf16, B >= 8).
    Unlike the JAX step the parameters and Adam moments are updated in
    place; the returned state holds them, the new memory and step + 1.
    Metrics are device tensors: loss, acc, grad_norm (before clipping).
    """

    def train_step(state: TrainState, batch, rng: Optional[int] = None,
                   win_size: int = 1):
        leaves = txl.tree_leaves(state.params)
        dev = leaves[0].device
        b = _batch_to_device(batch, dev)
        logits, new_mem = txl.forward(
            state.params, cfg, b["x"], pos=b.get("pos"), state=state.mem, train=True,
            rng=rng, win_size=win_size, win_k=0 if win_size > 1 else 1, flash=flash)
        loss, acc = cross_entropy(logits, b["y"], ignore_index=pad_idx)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = optimizer.step(state.opt_state, grads, state.step)
        metrics = {"loss": loss.detach(), "acc": acc, "grad_norm": gnorm}
        return TrainState(state.params, state.opt_state, new_mem, state.step + 1), metrics

    return train_step
