#!/usr/bin/env python3
"""Where a train step's time goes on the card.

    python3 profile_train.py [--model genre|multitask] [--steps 5] [--bs 16]

``--model genre`` (the default) builds the 41M flagship
(``btp_phase1_config``, fresh ``init_txl`` weights) with the port, and runs
its train step (``train/loop.py::make_train_step``, the flash train kernels,
dropout on, XL memory threaded) on batches of synthetic songs at bs ``--bs``
x bptt 512. ``--model multitask`` builds the 85M flagship
(``multitask_config``, fresh ``init_multitask`` weights) and runs the step
``MultitaskLearner.fit`` takes (``mt.forward`` through the flash train
kernels, ``multi_loss``, the gradients, one-cycle AdamW), dropout on, on
chip_smoke.py's synthetic corpus at bs ``--bs`` x bptt 512: a mask step
(the encoder's bidirectional attention) and an s2s step (bidirectional,
cross and causal attention), each separately. For each: three warm-up
steps, then ``--steps`` steps timed on the host clock (each ends in a device
sync) and the same steps again under ``torch.profiler``. Prints the step
time, the CUDA kernels by total device time (with their launch counts), the
device-busy share, the host operations by their own host time, and the
card's name and power limit. Imports only the port; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import torch
from torch.profiler import ProfilerActivity, profile

from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.models import multitask as mt
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import btp_phase1_config, multitask_config
from deepmusicgeneration_tpu_torch.models.precision import master_params
from deepmusicgeneration_tpu_torch.train import loop, synthcorpus
from deepmusicgeneration_tpu_torch.train.data import (LMStreamLoader, S2SLoader,
                                                      mask_lm_tfm_pitchdur)
from deepmusicgeneration_tpu_torch.vocab import MusicVocab
from profile_decode import report


def timed_steps(label, run, batches, steps):
    """Three warm-up steps, ``steps`` timed, ``steps`` under the profiler."""
    run(batches[:3])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(batches[3:3 + steps])
    secs = time.perf_counter() - t0
    print(f"{label}: {steps} steps in {secs:.3f} s: {secs / steps * 1e3:.2f} ms a step, "
          f"{steps / secs:.3f} steps/s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batches[3 + steps:3 + 2 * steps])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"{label}: {steps} steps under the profiler", prof, wall, top=30)


def profile_genre(args, dev) -> None:
    vocab = MusicVocab.create()
    cfg = btp_phase1_config(len(vocab))
    songs = [MusicItem.from_npenc(synthcorpus.generate_song(g, s), vocab).data
             for s in range(4) for g in synthcorpus.GENRE_STYLES]
    loader = LMStreamLoader(songs, vocab, bs=args.bs, bptt=cfg.ctx_len,
                            encode_position=False)
    # the loader's epochs back to back: --steps may exceed one epoch's batches
    epochs = itertools.chain.from_iterable(itertools.repeat(loader))
    batches = list(itertools.islice(epochs, 3 + 2 * args.steps))
    opt = loop.make_optimizer(100)
    params = master_params(txl.init_txl(cfg), dev)
    state = loop.TrainState(params, opt.init(params), txl.init_state(cfg, args.bs, device=dev), 0)
    step = loop.make_train_step(cfg, opt, vocab.pad_idx)

    def run(chunk):
        nonlocal state
        for i, batch in enumerate(chunk):
            state, m = step(state, batch, rng=i, win_size=1)
            float(m["loss"])          # the fit loop reads each loss: a sync

    timed_steps(f"train step: bs {args.bs} x bptt {cfg.ctx_len}", run, batches, args.steps)


def profile_multitask(args, dev) -> None:
    import chip_smoke          # its synthetic multitask corpus
    vocab = MusicVocab.create()
    cfg = multitask_config(len(vocab))
    B, L = args.bs, cfg.ctx_len
    with tempfile.TemporaryDirectory() as tmp:
        corpus, items = chip_smoke.mt_train_corpus(Path(tmp) / "corpus", 0, vocab)
    rng = np.random.default_rng(0)
    mask = [mask_lm_tfm_pitchdur(b, vocab, rng)
            for b in LMStreamLoader(corpus, vocab, bs=B, bptt=L, seed=0)]
    s2s = list(S2SLoader(items, vocab, bs=min(B, len(items)), bptt=L, seed=0))
    n = 3 + 2 * args.steps
    params = master_params(mt.init_multitask(cfg, torch.Generator(device=dev).manual_seed(0),
                                             device=dev), dev)
    optimizer = loop.make_optimizer(100)
    opt = optimizer.init(params)
    leaves = txl.tree_leaves(params)
    count = itertools.count()

    def run(chunk):            # MultitaskLearner.fit's step, plain causal window
        for xd, yd in chunk:
            i = next(count)
            xs = {task: loop._batch_to_device(d, dev) for task, d in xd.items()
                  if d is not None}
            out = mt.forward(params, cfg, xs, pad_idx=vocab.pad_idx, win_size=1, win_k=1,
                             rng=i, train=True)
            loss, _ = loop.multi_loss(out, loop._batch_to_device(yd, dev), vocab.pad_idx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            optimizer.step(opt, grads, i)
            float(loss.detach())      # the fit loop reads each loss: a sync

    print(f"multitask: {cfg.enc_layers}+{cfg.dec_layers} layers d{cfg.d_model} "
          f"{cfg.n_heads}x{cfg.d_head}, attn_p {cfg.attn_p}, {len(mask)} mask and "
          f"{len(s2s)} s2s batches, cycled", flush=True)
    for task, batches in (("mask", mask), ("s2s", s2s)):
        cycled = list(itertools.islice(itertools.cycle(batches), n))
        timed_steps(f"multitask {task} step: bs {B} x bptt {L}", run, cycled, args.steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("genre", "multitask"), default="genre")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--bs", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    (profile_multitask if args.model == "multitask" else profile_genre)(args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
