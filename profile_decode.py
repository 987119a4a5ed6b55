#!/usr/bin/env python3
"""Where the decode's time goes on the card: single stream, batched and
continuous; or the multitask model's harmonize and next-word steps.

    python3 profile_decode.py [--steps 20] [--batches 16 64]
    python3 profile_decode.py --modes slab4 slab_int8 --batches 64 8 [--steps 20]
    python3 profile_decode.py --model multitask [--steps 64]
    python3 profile_decode.py --timing slab_ar_w8 slab_ar --batches 4 8 16 64 [--e2e]
    python3 profile_decode.py --timing slab_w8 fused_batched fused_stack --batches 1 2 4 16
    python3 profile_decode.py --data-gate auto xla --seeds 0 1 2
    python3 profile_decode.py --stack --seeds 0 1 2 [--steps 256] [--repeats 2]
    python3 profile_decode.py --edge fused_batched:3,5 fused_batched:1,5,64:520 --seeds 7 [--detail]
    python3 profile_decode.py --flash

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

``--modes`` profiles decode modes instead (any of
``chip_smoke.EXPLICIT_MODES`` and of ``fd.TC_MODES``, so also slab, the
continuous service's step, and the all-rows steps slab_ar_w8 and slab_ar,
which run the chain at B >= 8): for each B of ``--batches``, ``--steps``
steps of the mode's wrapper on a full ring (ptr 100) of the flagship, the
CUDA kernels by device time a step; then, beside it, the yardstick of its
weight products: ``torch.matmul`` of the same bf16 operands (the int8
panels dequantized by their column scales and rounded to bf16, as the
kernels use them) by the same (B, K) rows, 4 a layer x 8 layers, its
device time a step (never called by the port). For slab4, slab4_w8,
slab_int8, slab, slab_ar and slab_ar_w8 on the tensor-core chain it also prints each attention
kernel's blocks, the blocks the card holds at once and so its waves (the
kernel library's ``slab_decode_attention_occupancy``, where the tree has it
for the mode). It
uses only functions that every tree of the port has otherwise, so the
same script profiles a parent checkout (copy it there).

``--timing`` runs ``chip_smoke.slab_timing`` for each given decode mode (a
slab mode, or row 10's fused_stack, at B = 1 only, and fused_batched) at
each B of ``--batches`` (inputs from one rng of seed 0): the CUDA-event
medians of the step and of its plain version beside the bound, its CUDA
kernels a step by the wrapper's count, and on the tensor-core chain the
kernels ``torch.profiler`` records. With ``--e2e`` it then runs
``chip_smoke.batched_phase`` once: 16 requests through
``GenerationService`` and a ``generate_batch`` of 64 prompts, 256 steps
each, with their checks and rates. Both use functions a parent tree's
``chip_smoke.py`` has too, so the script times the two trees in turns.

``--data-gate`` runs the batch phase's ``generate_batch`` (the 64 prompts of
``chip_smoke.batch_prompts`` for each seed of ``--seeds``, 256 steps, the
sampling settings of ``chip_smoke.GEN_KW``, that seed for the sampler) with
each given decode kernel (``auto``: the engine's rule), and prints the
rows that fail the batch phase's checks (``chip_smoke.check_continuation``:
re-parse, grammar, and the codec's data gate, a pitch outside the piano
range or a duration past the cap), with its message.

``--stack`` runs the smoke stack phase's gate (``chip_smoke.stack_fixed_path``:
``--steps`` steps, 256 by default) on the prompts of
``chip_smoke.batch_prompts`` for each seed of ``--seeds``, one prompt at
B = 1 and 16 at B = 16, ``--repeats`` times: the row-10 path driven by the
float64 plain step (``fd.stack_plain``, the TPU kernel's function with
float64 between its bf16 cast points), whose logits choose the tokens and
whose slot writes make the caches; at every step the wrapper
(fused_stack_decode at B = 1, fused_batched_decode otherwise) and the
float32 plain step run on copies of the same caches. It prints the gate's
figures (each one's logit distance from float64, the share of the gate's
bounds, the failing steps) and the exact ring step's largest share of the
JAX test's bound (atol 0.08, rtol 0.02) against each step.

``--edge`` runs ``chip_smoke.edge_phase`` (the kernel phase's float64 check
at every ptr and kind of ring) for each case ``mode:B,B,...[:M]`` in turn
(M: the slots, the checkpoint's mem_len if left out), all drawn from one
rng of each seed of ``--seeds``, on the chain ``fd.tc_path`` gives; a case
that fails is reported and the next one runs. The smoke's edge phases draw
their cases from an rng of seed 0 plus an offset, so the same cases in the
same order redraw its inputs, in this tree or a parent's. With
``--detail`` each case is compared with float64 layer by layer and slot by
slot instead, and run again over the panel's last M % 16 slots alone
(``case_detail``).

``--flash`` runs ``chip_smoke.flash_timing`` (the causal flash prefill's
CUDA-event median of 100 launches, twice, its plain version's and the
bound, no padding) at each shape of FLASH_TIMING: the genre flagship's
heads (12 x 64) at B 16 and 64, W 512, and at B 2, W 4096 (the TPU
kernel's blocked regime), the multitask flagship's (8 x 64) and the demo
checkpoints' (8 x 32) at B 16, W 512; then the device time a launch by
``torch.profiler`` over 20 launches. It loads no checkpoint and uses only
functions every tree of the port has, so the script copied into a parent
checkout times the two trees in turns.

``--model multitask`` takes the 85M multitask flagship's shapes
(``init_multitask`` weights from seed 0, as ``chip_smoke.py``): first
``chip_smoke.py``'s mt timing and mt fused timing phases (each s2s / nw
step at B = 1, M = 512, Le = 512: CUDA-event medians beside the bound),
then for the auto kernel (slab_w8) and the exact ``fused`` one a
harmonize (``s2s_predict_from_midi``) and a next-word
(``nw_predict_from_midi``) call of 8 and of 8 + ``--steps`` words on a
two-track prompt, each under ``torch.profiler``. The difference of the two
calls gives a decode step's host-clock time, its device time (by kernel)
and the host's share of the step.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from deepmusicgeneration_tpu_torch.decode.continuous import ContinuousEngine
from deepmusicgeneration_tpu_torch.ops import flash_prefill as fp
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


def device_ms(prof) -> dict:
    """Device ms by kernel name over a profiled window."""
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0}


# the modes --modes takes
PROFILED_MODES = tuple(m for m in dict.fromkeys(chip_smoke.EXPLICIT_MODES + fd.TC_MODES)
                       if m not in fd.STACK_MODES)


def attention_waves(mode, cfg, B: int, M: int):
    """[(kernel, blocks of its launch, blocks the card holds at once)] of
    the chain's attention kernels of ``mode`` at B, or None where the mode
    does not run the chain's slab attention or the library has no such
    query."""
    kind = fd.TC_POLICY[mode].occupancy if mode in fd.TC_POLICY else None
    if kind is None or not fd.tc_path(mode, cfg, B, M):
        return None
    fn = getattr(fd._lib("slab_decode"), "slab_decode_attention_occupancy", None)
    if fn is None:
        return None
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = (ctypes.c_int * 6)()
    n = fn(B, cfg.n_heads, cfg.d_head, M, kind, out)
    if n < 0:
        raise RuntimeError(f"slab_decode_attention_occupancy: CUDA error {-n}")
    names = ("qkv_sum_i8", "group_scores_i8", "pv_i8") if n == 3 else ("group_attention",)
    return [(name, out[2 * k], out[2 * k + 1]) for k, name in enumerate(names)]


def profile_modes(engine, modes, batches, steps: int, dev) -> None:
    """Device time by kernel of ``steps`` steps of each explicit mode at each
    B, then the torch.matmul yardstick of its weight products."""
    cfg, M = engine.cfg, engine.cfg.mem_len
    L, D, Dff, HD = cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_heads * cfg.d_head
    wkr_mt = chip_smoke.wkr_table(engine)
    rng = np.random.default_rng(0)
    for mode in modes:
        stacked, w_scales = chip_smoke.weights(engine, mode)
        wkr = chip_smoke.mode_wkr(mode, wkr_mt)
        # the products' bf16 operands as the kernels use them: (K, N) a product
        panels = []
        for l in range(L):
            for row, w in enumerate((stacked.qkv_w, stacked.out_w, stacked.ff1_w, stacked.ff2_w)):
                w = w[l].float()
                if w_scales is not None:
                    w = w * w_scales[l, row, :w.shape[1]]
                panels.append(w.to(torch.bfloat16))
        for B in batches:
            kv, blocked = chip_smoke.ring_inputs(cfg, B, M, 100, "full", rng, dev, mode)
            h_in = engine.params["embed"].float()[
                torch.from_numpy(rng.integers(12, 140, B)).to(dev)]
            kw = {} if mode in chip_smoke.MULTIROW_MODES else dict(
                weights_int8=w_scales is not None, w_scales=w_scales,
                **chip_smoke.SLAB_ARGS.get(mode, {}))

            def step():
                chip_smoke.CORES[mode](stacked, cfg, h_in, wkr, *kv, blocked, 100, M,
                                       rows_per_cell=min(B, 8), **kw)

            for _ in range(5):
                step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(f"{mode} step B={B} x{steps}", prof, wall)
            by_kernel = device_ms(prof)
            print(f"{mode} B={B}: device {sum(by_kernel.values()) / steps:.4f} ms a step; by "
                  "kernel a step: " + "; ".join(
                      f"{v / steps:.4f} ms {k[:70]}"
                      for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])), flush=True)
            waves = attention_waves(mode, cfg, B, M)
            if waves:
                print(f"{mode} B={B} attention waves: " + "; ".join(
                    f"{name} {blocks} blocks, {held} held at once: {-(-blocks // held)} "
                    f"wave(s) ({blocks / held:.2f})" for name, blocks, held in waves), flush=True)
            xs = {K: torch.randn(B, K, device=dev).to(torch.bfloat16) for K in {D, HD, Dff}}

            def products():
                for w in panels:
                    torch.matmul(xs[w.shape[0]], w)

            for _ in range(3):
                products()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    products()
                torch.cuda.synchronize()
            yard = sum(device_ms(prof).values()) / steps
            print(f"{mode} B={B} yardstick: torch.matmul of the {len(panels)} bf16 weight "
                  f"products ({4} a layer x {L} layers) {yard:.4f} ms of device time a step "
                  f"({chip_smoke.time_ms(products, 20):.4f} ms CUDA-event median)", flush=True)


def time_modes(learner, modes, batches, e2e: bool, dev) -> None:
    """chip_smoke.slab_timing of each of ``modes`` at each B of ``batches``
    (fused_stack at B = 1 alone, its only size), then, with ``e2e``,
    chip_smoke.batched_phase once."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain versions' f32 products
    engine = learner.engine
    wkr_mt = chip_smoke.wkr_table(engine)
    rng = np.random.default_rng(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    for mode in modes:
        for B in (1,) if mode == "fused_stack" else batches:
            chip_smoke.slab_timing(engine, wkr_mt, rng, dev, mode, B, flush)
    if e2e:
        items = chip_smoke.batch_prompts(learner.vocab, 0, 64)
        chip_smoke.batched_phase(learner, items, 0, 256)


# --flash: (n_heads, d_head, B, W)
FLASH_TIMING = ((12, 64, 16, 512), (12, 64, 64, 512), (12, 64, 2, 4096), (8, 64, 16, 512),
                (8, 32, 16, 512))


def time_flash(dev, launches: int = 20) -> None:
    """chip_smoke.flash_timing at each shape of FLASH_TIMING, then the
    kernels' device time a launch over ``launches`` launches under
    ``torch.profiler`` (the event medians also hold the wrapper's host
    time)."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain version's f32 products
    for H, Dh, B, W in FLASH_TIMING:
        print(f"flash: {H}x{Dh} heads", flush=True)
        chip_smoke.flash_timing(types.SimpleNamespace(n_heads=H, d_head=Dh), dev, B, W, 0)
        args = chip_smoke.flash_inputs(B, W, (0,), H, Dh, dev, 0)
        for _ in range(3):
            fp.flash_prefill_attention(*args, H)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fp.flash_prefill_attention(*args, H)
            torch.cuda.synchronize()
        by_kernel = device_ms(prof)
        print(f"flash: B={B} W={W} {H}x{Dh} device {sum(by_kernel.values()) / launches:.4f} ms "
              f"a launch over {launches} launches: " + ", ".join(
                  f"{k.replace('(anonymous namespace)::', '').split('(')[0]} {ms:.3f} ms in all"
                  for k, ms in by_kernel.items()), flush=True)


def data_gate(learner, kernels, seeds) -> None:
    """The batch phase's generate_batch rows that fail chip_smoke's
    check_continuation, for each kernel and seed."""
    engine, vocab = learner.engine, learner.vocab
    for kernel in kernels:
        for seed in seeds:
            items = chip_smoke.batch_prompts(vocab, seed, 64)
            toks, lengths = engine.generate_batch(
                [it.data for it in items], n_words=256, seed=seed,
                decode_kernel=None if kernel == "auto" else kernel, **chip_smoke.GEN_KW)
            bad = []
            for i, it in enumerate(items):
                try:
                    chip_smoke.check_continuation(it, toks[i][: lengths[i]], vocab)
                except AssertionError as e:
                    bad.append(f"row {i}: {e}")
            print(f"data gate: generate_batch B=64 kernel {kernel} "
                  f"({engine.resolve_kernel(64) if kernel == 'auto' else kernel}) seed {seed}: "
                  f"{len(bad)} of 64 rows fail: {bad}", flush=True)


def stack_paths(learner, seeds, steps: int, repeats: int) -> None:
    """chip_smoke.stack_fixed_path (the stack phase's gate, driven by the
    float64 plain step) at B = 1 and 16 on each seed's prompts, ``repeats``
    times each."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain versions' f32 products
    cfg = learner.engine.cfg
    for seed in seeds:
        items = chip_smoke.batch_prompts(learner.vocab, seed, 16)
        for batch in (items[:1], items[:16]):
            B = len(batch)
            mode = chip_smoke.stack_mode(B)
            chain = "tensor-core" if fd.tc_path(mode, cfg, B, cfg.mem_len) else "old"
            for r in range(repeats):
                got = chip_smoke.stack_fixed_path(learner, batch, steps)
                ex = got["exact"]
                print(f"stack path: seed {seed} B={B} ({mode}, the {chain} chain) repeat {r}, "
                      f"{steps} steps driven by the float64 plain step: max |dlogit| from it "
                      f"kernel {got['kernel_d']:.4e}, plain32 {got['plain32_d']:.4e}, "
                      f"{got['logit_ratio']:.4f} of the gate's bound; written slot "
                      f"{got['slot_ratio']:.4f} of its bound, two-step share "
                      f"{got['two_steps']:.2e}; argmax flips {got['flips']}; failing steps "
                      f"{len(got['failures'])} {got['failures'][:4]}; of the exact step's "
                      f"bound: plain64 {ex['plain64']:.4f}, kernel {ex['kernel']:.4f}, "
                      f"plain32 {ex['plain32']:.4f}", flush=True)


def slot_detail(mode, got, ref, kv, ptr) -> str:
    """Layer by layer, the written slot of ``got`` against ``ref`` (step_diff's
    units: int8 or int4 steps, bf16 panels 2^-7 of the row's largest entry):
    K and V entries two or more steps off and the largest step; then whether
    every other slot kept the bytes of ``kv``."""
    parts = []
    for name, (g, _), (r, _) in zip("KV", chip_smoke.written_slots(mode, got[1:], ptr),
                                    chip_smoke.written_slots(mode, ref[1:], ptr)):
        d = (g - r).abs()
        if d.dtype == torch.float32:
            d = d / (2.0 ** -7 * r.abs().amax(-1, keepdim=True).clamp_min(1e-30))
        per = [(int((d[l] > 1).sum()), d[l].max().item()) for l in range(d.shape[0])]
        parts.append(f"{name} " + " ".join(f"l{l}:{n}/{m:.2f}" for l, (n, m) in enumerate(per)))
    untouched = chip_smoke.others_untouched(mode, got[1:], kv, ptr)
    return "; ".join(parts) + f"; other slots identical {untouched}"


def edge_cases(engine, cases, seeds, detail: bool = False) -> None:
    """chip_smoke.edge_phase for each of ``cases`` ("mode:B,B,...[:M]") in
    turn, drawn from one rng of each seed; a case that fails is reported
    and the next one runs. With ``detail`` the same draws go to
    case_detail instead."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain versions' f32 products
    for seed in seeds:
        rng = np.random.default_rng(seed)
        for case in cases:
            mode, batches, *mem_len = case.split(":")
            batches = tuple(int(b) for b in batches.split(","))
            M = int(mem_len[0]) if mem_len else None
            chain = mode in fd.TC_MODES and fd.tc_path(mode, engine.cfg, batches[0],
                                                       M or engine.cfg.mem_len)
            if detail:
                case_detail(engine, rng, mode, batches, M, f"seed {seed} {case}")
                continue
            try:
                dh, ratio = chip_smoke.edge_phase(engine, rng, engine.device, mode, batches, M,
                                                  chain)
                print(f"edge: seed {seed} {case}: max |dh_out| {dh:.3e}, {ratio:.3f} of its "
                      f"bound", flush=True)
            except AssertionError as e:
                print(f"edge: seed {seed} {case}: FAILED: {e}", flush=True)


def case_detail(engine, rng, mode, batches, mem_len, label) -> None:
    """chip_smoke.edge_phase's cases of ``mode`` at ``batches`` and
    ``mem_len``, drawn from ``rng`` as it draws them, each compared with a
    float64 run of the plain version: the float64 check's verdict, |dh_out|
    and the two-step share of the kernel and of the float32 plain version;
    where either has an entry two or more steps off, or the case fails,
    both layer by layer and slot by slot (slot_detail). Each case runs
    again with every slot blocked but the last M % 16 (the tail of a panel
    whose M is no multiple of 16; the last 16 where it is): |dh_out| of the
    kernel and of the float32 plain version from float64 there, the
    attention over those slots alone."""
    cs = chip_smoke
    eng = cs.at_mem_len(engine, mem_len)
    M, wkr_mt = eng.cfg.mem_len, cs.wkr_table(eng)
    tail = M % 16 or 16
    for B, ptr, kind, kv, blocked, h_in in cs.kernel_cases(eng, rng, engine.device, batches,
                                                           mode):
        tag = f"edge detail: {label} B={B} M={M} ptr={ptr} ring={kind}"
        runs = {}
        for name, blk in (("case", blocked), ("tail", torch.ones_like(blocked))):
            if name == "tail":
                blk[:, M - tail:] = 0
            args = (mode, eng, wkr_mt, kv, blk, h_in, ptr)
            runs[name] = (cs.run_step(*args), cs.plain_step(*args, acc=torch.float32),
                          cs.plain_step(*args))
        got, f32, ref = runs["case"]
        torch.cuda.synchronize()
        diff, pdiff = cs.step_diff(got, ref, kv, ptr, mode), cs.step_diff(f32, ref, kv, ptr, mode)
        ok = cs.within_bounds(mode, diff, pdiff)
        tg, tf, tr = runs["tail"]
        tail_dh = [(x[0].double() - tr[0].double()).abs().max().item() for x in (tg, tf)]
        print(f"{tag}: {'pass' if ok else 'FAILED'}; |dh_out| kernel {diff[0]:.3e} plain32 "
              f"{pdiff[0]:.3e}; two-step share kernel {diff[3]:.3e} plain32 {pdiff[3]:.3e} "
              f"(bound {cs.bounds(mode, pdiff)['two_steps']:.3e}); the last {tail} slots "
              f"alone: |dh_out| kernel {tail_dh[0]:.3e} plain32 {tail_dh[1]:.3e}", flush=True)
        if not ok or diff[3] > 0 or pdiff[3] > 0:
            print(f"{tag}: kernel {slot_detail(mode, got, ref, kv, ptr)}", flush=True)
            print(f"{tag}: plain32 {slot_detail(mode, f32, ref, kv, ptr)}", flush=True)


def profile_multitask(steps: int, dev) -> None:
    """The multitask timing phases, then a harmonize and a next-word decode
    step's host-clock and device time with the auto and the fused kernel."""
    from deepmusicgeneration_tpu_torch.tasks.harmonize import (nw_predict_from_midi,
                                                               s2s_predict_from_midi)
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain versions' f32 products
    flagship, _ = chip_smoke.mt_load_phase(dev, 0)
    rng = np.random.default_rng(0)
    chip_smoke.mt_timing_phase(flagship, rng, dev)
    chip_smoke.mt_fused_timing_phase(flagship, rng, dev)
    midi = chip_smoke.two_track_midi(0, flagship.vocab)
    n0, n1 = 8, 8 + steps
    for kernel in ("slab_w8", "fused"):
        lr = MultitaskLearner(flagship.cfg, flagship.vocab, flagship.params, device=dev,
                              decode_kernel=kernel)
        for task, fn in (("harmonize", s2s_predict_from_midi),
                         ("next-word", nw_predict_from_midi)):
            fn(lr, midi, n_words=n0, seed=0)                  # warm-up
            walls, busy = {}, {}
            for n in (n0, n1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(lr, midi, n_words=n, seed=0)
                torch.cuda.synchronize()
                walls[n] = time.perf_counter() - t0
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fn(lr, midi, n_words=n, seed=0)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                busy[n] = device_ms(prof)
            report(f"{task} {kernel} flagship {n1} words", prof, wall)
            step_wall = (walls[n1] - walls[n0]) / steps * 1e3
            per_kernel = {k: (v - busy[n0].get(k, 0.0)) / steps for k, v in busy[n1].items()}
            step_dev = sum(per_kernel.values())
            top = sorted(per_kernel.items(), key=lambda kv: kv[1], reverse=True)[:4]
            print(f"{task} {kernel}: a decode step {step_wall:.4f} ms host clock (unprofiled), "
                  f"{step_dev:.4f} ms device, host share {100 * (1 - step_dev / step_wall):.1f}%; "
                  "by kernel: " + "; ".join(f"{v:.4f} ms {k[:60]}" for k, v in top), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("genre", "multitask"), default="genre")
    ap.add_argument("--steps", type=int, default=None,
                    help="decode steps a window (default 20; 64 with --model multitask)")
    ap.add_argument("--batches", type=int, nargs="*", default=[16, 64])
    ap.add_argument("--modes", nargs="*", default=None, choices=PROFILED_MODES,
                    help="decode modes to profile (chip_smoke.EXPLICIT_MODES, fd.TC_MODES)")
    ap.add_argument("--timing", nargs="*", default=None, choices=fd.SLAB_MODES + fd.STACK_MODES,
                    help="slab or row-10 modes to time with chip_smoke.slab_timing at each B")
    ap.add_argument("--e2e", action="store_true",
                    help="with --timing: then chip_smoke.batched_phase once")
    ap.add_argument("--data-gate", nargs="*", default=None,
                    help="decode kernels (or auto) whose generate_batch rows to hold "
                         "to the codec's data gate")
    ap.add_argument("--stack", action="store_true",
                    help="the row-10 path driven by the float64 plain step, the kernel and "
                         "the float32 plain step on its inputs")
    ap.add_argument("--repeats", type=int, default=1, help="with --stack: runs of each path")
    ap.add_argument("--edge", nargs="*", default=None,
                    help="cases mode:B,B,...[:M] for chip_smoke.edge_phase, one rng a seed")
    ap.add_argument("--detail", action="store_true",
                    help="with --edge: each case layer by layer and slot by slot against "
                         "float64, and over the panel's tail slots alone")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--flash", action="store_true",
                    help="time the causal flash prefill at the FLASH_TIMING shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.flash:
        time_flash(dev)
        return 0
    if args.model == "multitask":
        profile_multitask(args.steps or 64, dev)
        return 0
    if args.stack:
        stack_paths(MusicLearner.load(str(chip_smoke.CKPT)), args.seeds, args.steps or 256,
                    args.repeats)
        return 0
    args.steps = args.steps or 20
    learner = MusicLearner.load(str(chip_smoke.CKPT))
    engine = learner.engine
    if args.edge is not None:
        edge_cases(engine, args.edge, args.seeds, args.detail)
        return 0
    if args.modes:
        torch.backends.cuda.matmul.allow_tf32 = False
        profile_modes(engine, args.modes, args.batches, args.steps, dev)
        return 0
    if args.timing is not None:
        time_modes(learner, args.timing, args.batches, args.e2e, dev)
        return 0
    if args.data_gate is not None:
        data_gate(learner, args.data_gate, args.seeds)
        return 0
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, w_scales = engine.stacked_q()
    wkr_mt = chip_smoke.wkr_table(engine)
    rng = np.random.default_rng(0)

    def profile_steps(core, name, B):
        kv, blocked = chip_smoke.ring_inputs(cfg, B, M, 100, "full", rng, dev)
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
