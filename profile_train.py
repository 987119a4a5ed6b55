#!/usr/bin/env python3
"""Where a genre train step's time goes on the card.

    python3 profile_train.py [--steps 5] [--bs 16]

Builds the 41M flagship (``btp_phase1_config``, fresh ``init_txl`` weights)
with the port, and runs its train step (``train/loop.py::make_train_step``,
the flash train kernels, dropout on, XL memory threaded) on batches of
synthetic songs at bs ``--bs`` x bptt 512: three warm-up steps, then
``--steps`` steps timed on the host clock (each ends in a device sync) and
the same steps again under ``torch.profiler``. Prints the step time, the
CUDA kernels by total device time, the device-busy share, the host
operations by their own host time, and the card's name and power limit.
Imports only the port; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import btp_phase1_config
from deepmusicgeneration_tpu_torch.models.precision import master_params
from deepmusicgeneration_tpu_torch.train import loop, synthcorpus
from deepmusicgeneration_tpu_torch.train.data import LMStreamLoader
from deepmusicgeneration_tpu_torch.vocab import MusicVocab
from profile_decode import report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    run(batches[:3])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(batches[3:3 + args.steps])
    secs = time.perf_counter() - t0
    print(f"train step: bs {args.bs} x bptt {cfg.ctx_len}, {args.steps} steps in "
          f"{secs:.3f} s: {secs / args.steps * 1e3:.2f} ms a step, "
          f"{args.steps / secs:.3f} steps/s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batches[3 + args.steps:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"{args.steps} train steps under the profiler", prof, wall, top=20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
