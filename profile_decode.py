#!/usr/bin/env python3
"""Where the decode's time goes on the card: single stream, batched and
continuous.

    python3 profile_decode.py [--steps 20] [--batches 16 64]

Loads the 41M flagship checkpoint with the port and, each under
``torch.profiler``: runs ``--steps`` slab_w8 decode steps (``fused_slab_core``
at B = 1, mem_len 512, full ring) and one ``predict_nw_genre`` call of
``--steps`` tokens; then, for each B of ``--batches``, ``--steps``
slab_ar_w8 steps (``fused_slab_allrows_core``) and one ``generate_batch``
of B prompts (W = 512, flash prefill) of ``--steps`` tokens; then the
continuous engine (16 slots, the auto kernel slab): 16 inserts timed one by
one (each a B = 1 prefill of a 300-512 token prompt), and two chunks of 32
steps with every slot busy. Prints for each the CUDA kernels by total device
time, the device-busy share of the window, the host operations by their own
host time, and the card's name and power limit. Imports only the port;
needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from deepmusicgeneration_tpu_torch.decode.continuous import ContinuousEngine
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd
from deepmusicgeneration_tpu_torch.tasks.generate import predict_nw_genre
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner


def report(title: str, prof, wall_s: float, top: int = 12) -> None:
    """Print device kernels by their own device time, and the busy share."""
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"{title}: window {wall_s * 1e3:.3f} ms host, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall_s:.1f}%)", flush=True)
    for e in events[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}", flush=True)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"  host: {sum(e.count for e in host if e.key.startswith('aten::'))} aten "
          f"calls; by own host time:", flush=True)
    for e in host[:6]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}",
              flush=True)


def profile_continuous(learner, n_slots: int = 16, chunk: int = 32) -> None:
    """Inserts, then two chunks with every slot busy, on the continuous engine."""
    eng = ContinuousEngine(learner.params, learner.cfg, learner.vocab,
                           n_slots=n_slots, chunk=chunk)
    items = chip_smoke.batch_prompts(learner.vocab, 0, n_slots)
    times = []
    for i, it in enumerate(items):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.insert(i, it.data, n_words=4096, seed=i, **chip_smoke.GEN_KW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"continuous insert ({eng.kernel}): median {1e3 * np.median(times):.3f} ms, "
          f"min {1e3 * min(times):.3f}, max {1e3 * max(times):.3f} over {len(times)}",
          flush=True)
    eng.step_chunk()                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            eng.step_chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"continuous {eng.kernel} {n_slots} slots, 2 chunks of {chunk} steps", prof, wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="*", default=[16, 64])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    learner = MusicLearner.load(str(chip_smoke.CKPT))
    engine = learner.engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, w_scales = engine.stacked_q()
    wkr_mt = chip_smoke.wkr_table(engine)
    rng = np.random.default_rng(0)

    def profile_steps(core, name, B):
        kv, blocked = chip_smoke.ring_inputs(cfg, B, M, 100, True, rng, dev,
                                             on_device=True)
        h_in = engine.params["embed"].float()[
            torch.from_numpy(rng.integers(12, 140, B)).to(dev)]

        def step():
            core(stacked, cfg, h_in, wkr_mt, *kv, blocked, 100, M,
                 rows_per_cell=min(B, 8), weights_int8=True, w_scales=w_scales)

        for _ in range(5):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{name} step B={B} x{args.steps}", prof, wall)

    def profile_call(title, fn):
        fn(8)   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(args.steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(title, prof, wall)

    profile_steps(fd.fused_slab_core, "slab_w8", 1)
    midi = chip_smoke.prompt_midi(0, learner.vocab)
    profile_call(f"predict_nw_genre {args.steps} steps",
                 lambda n: predict_nw_genre(learner, midi, genre="jazz", max_len=n))
    for B in args.batches:
        profile_steps(fd.fused_slab_allrows_core, "slab_ar_w8", B)
        prompts = [it.data for it in chip_smoke.batch_prompts(learner.vocab, 0, B)]
        profile_call(f"generate_batch B={B} {args.steps} steps",
                     lambda n: engine.generate_batch(prompts, n_words=n,
                                                     **chip_smoke.GEN_KW))
    profile_continuous(learner)
    return 0


if __name__ == "__main__":
    sys.exit(main())
