#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n-words 256]

Phases, one line each (a failing phase raises and the script exits non-zero
without printing a result):

1. device — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build  — nvcc builds every kernel source of the slice, in parallel.
3. load   — the 41M flagship checkpoint through the port's msgpack reader.
4. kernel — ``fused_slab_core`` (slab_w8) on the card against its plain
   PyTorch version on the same inputs, at flagship widths, B in {1, 4},
   ptr in {0, 31, 32, M - 1 = 511}, a partly full and a full ring.
5. timing — CUDA-event medians of the kernel and of the plain version at the
   main path's shapes (B = 1), beside the bound from the bytes it must move.
6. main   — ``predict_nw_genre`` at B = 1 with the auto kernel on a seeded
   prompt MIDI built with the port's codec; the kernel's launch count must
   equal the number of token steps; the output MIDI is re-parsed and checked.

Then one JSON line per kernel, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deepmusicgeneration_tpu_torch.codec.encode import chordarr2npenc, notes2chordarr
from deepmusicgeneration_tpu_torch.codec.grammar import grammar_violations
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.codec.validate import is_valid_npenc, roundtrip_ok
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.ops import _build
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd
from deepmusicgeneration_tpu_torch.tasks.generate import predict_nw_genre
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import SAMPLE_FREQ

CKPT = Path(__file__).resolve().parent / "checkpoints" / "synth_genre_model"
KERNEL_SOURCES = ("slab_decode",)   # every csrc/*.cu the slice runs
HBM_BYTES_PER_S = 3.35e12           # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12                 # dense bf16 peak, same source

# Tolerances of the kernel against its plain version (same arithmetic, other
# summation order): float32 sums differ in the last bits, which can flip a
# value across a bf16 rounding point (2^-8 relative) at the kernel's cast
# points, and that difference propagates through 8 layers. h_out is
# post-LayerNorm (entries of order 1). A fresh K/V entry is round(x / scale):
# a float difference smaller than one quantization step moves it by at most
# one step; how many entries move follows the drift of h between the two
# versions, so that share is printed, not bounded.
H_ATOL = 5e-2
SLOT_MAX_STEP = 1          # a written int8 entry may differ by one step
SCALE_RTOL = 1e-2          # fresh-slot scales: max|x| / 127 of the drifted x


def say(line: str) -> None:
    print(line, flush=True)


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(smi.splitlines()[0])
    say(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi.splitlines()[0]


def build_phase() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        paths = list(pool.map(_build.build, KERNEL_SOURCES))
    secs = time.perf_counter() - t0
    for p in paths:
        log = p.with_suffix(".log").read_text() if p.with_suffix(".log").exists() else ""
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        say(f"build: {p.name} {len(regs)} ptxas lines: " + " | ".join(regs))
    say(f"build: {len(paths)} kernel source(s) in {secs:.2f} s")


def ring_inputs(cfg, B, M, ptr, full, rng, dev):
    """Random int8 slot-major caches and the blocked mask of a ring whose
    pointer is ``ptr``: full (every slot valid) or partly full (a prompt of
    M // 3 tokens plus ptr decoded ones)."""
    L, HD = cfg.n_layers, cfg.n_heads * cfg.d_head
    k = torch.from_numpy(rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32))
    v = torch.from_numpy(rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32))
    kq, ks, vq, vs = fd.quantize_kv_slot_major(k.to(dev, torch.bfloat16),
                                               v.to(dev, torch.bfloat16))
    slot = np.arange(M)
    if full:
        g = np.where(slot < ptr, slot, slot - M)          # g_cur = ptr
    else:
        g = np.where(slot < ptr, slot, txl.PAD_G)
        g[M - M // 3:] = np.arange(-(M // 3), 0)
    dist = ptr - np.broadcast_to(g, (B, M))
    blocked = ((dist < 1) | (dist > M)).astype(np.int32).copy()
    blocked[1:, : 7] = 1                                   # rows differ
    return [kq, ks, vq, vs], torch.from_numpy(blocked).to(dev)


def kernel_phase(engine, rng, dev):
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, w_scales = engine.stacked_q()
    wkr_mt = txl.precompute_wkr(engine.params, cfg, M).permute(0, 2, 1, 3) \
        .reshape(cfg.n_layers, M + 1, -1).to(torch.bfloat16).contiguous()
    embed32 = engine.params["embed"].float()
    worst = 0.0
    for B in (1, 4):
        for ptr in (0, 31, 32, M - 1):
            for full in (False, True):
                kv, blocked = ring_inputs(cfg, B, M, ptr, full, rng, dev)
                h_in = embed32[torch.from_numpy(rng.integers(12, 140, B)).to(dev)]
                ref = fd.slab_w8_plain(stacked, w_scales, cfg, h_in, wkr_mt,
                                       *[t.clone() for t in kv], blocked, ptr)
                got = fd.fused_slab_core(stacked, cfg, h_in, wkr_mt,
                                         *[t.clone() for t in kv], blocked, ptr, M,
                                         rows_per_cell=1, weights_int8=True,
                                         w_scales=w_scales)
                torch.cuda.synchronize()
                dh = (got[0] - ref[0]).abs().max().item()
                other = torch.ones(M, dtype=torch.bool, device=dev)
                other[ptr] = False
                untouched = all(torch.equal(g[:, :, other], t[:, :, other])
                                for g, t in zip(got[1:], kv))
                slot_diff, slot_share, scale_rel = 0, 0.0, 0.0
                for i in (0, 2):   # int8 K and V slots
                    d = (got[1 + i][:, :, ptr].int() - ref[1 + i][:, :, ptr].int()).abs()
                    slot_diff = max(slot_diff, d.max().item())
                    slot_share = max(slot_share, (d > 0).float().mean().item())
                for i in (1, 3):   # their scales
                    r = ((got[1 + i][:, :, ptr] - ref[1 + i][:, :, ptr]).abs()
                         / ref[1 + i][:, :, ptr]).max().item()
                    scale_rel = max(scale_rel, r)
                say(f"kernel: B={B} ptr={ptr:3d} ring={'full' if full else 'part'} "
                    f"max|dh_out|={dh:.3e} slot_int8_max_step={slot_diff} "
                    f"slot_int8_differ={slot_share:.4f} scale_rel={scale_rel:.2e} "
                    f"other_slots_identical={untouched}")
                if not (dh <= H_ATOL and slot_diff <= SLOT_MAX_STEP
                        and scale_rel <= SCALE_RTOL and untouched):
                    raise AssertionError("slab_w8 kernel disagrees with its plain version")
                worst = max(worst, dh)
    return worst, wkr_mt


def step_bytes_and_flops(cfg, stacked, w_scales, wkr_mt, kv, blocked, B):
    """Bytes the step must move (inputs read once, outputs written once) and
    its multiply-adds counted as 2 operations."""
    L, D, Dff, H, Dh = cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head
    M, HD = blocked.shape[1], H * Dh
    nbytes = lambda t: t.numel() * t.element_size()
    read = (sum(nbytes(t) for t in stacked) + nbytes(w_scales) + nbytes(wkr_mt)
            + sum(nbytes(t) for t in kv) + nbytes(blocked) + B * D * 4)
    written = B * D * 4 + L * B * 2 * (HD + 4)
    flops = 2 * L * B * (D * 3 * HD + HD * D + D * Dff + Dff * D
                         + H * ((M + 1) * Dh + 2 * M * Dh))
    return read + written, flops


def time_ms(fn, n: int, flush=None) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` calls (after 5 warm-ups)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def timing_phase(engine, wkr_mt, rng, dev):
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, w_scales = engine.stacked_q()
    kv, blocked = ring_inputs(cfg, 1, M, 100, True, rng, dev)
    h_in = engine.params["embed"].float()[torch.tensor([60], device=dev)]
    args = (stacked, cfg, h_in, wkr_mt, *kv, blocked, 100, M)
    kernel = lambda: fd.fused_slab_core(*args, rows_per_cell=1, weights_int8=True,
                                        w_scales=w_scales)
    plain = lambda: fd.slab_w8_plain(stacked, w_scales, cfg, h_in, wkr_mt, *kv,
                                     blocked, 100)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    launches0 = fd.fused_slab_core.launches
    ms = time_ms(kernel, 100)
    ms_cold = time_ms(kernel, 50, flush)
    plain_ms = time_ms(plain, 50)
    ms_again = time_ms(kernel, 100)
    fd.fused_slab_core.launches = launches0   # timing launches are not the main path's
    nbytes, flops = step_bytes_and_flops(cfg, stacked, w_scales, wkr_mt, kv, blocked, 1)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations"
    say(f"timing: slab_w8 B=1 M={M} kernel median {ms:.4f} ms (again {ms_again:.4f}, "
        f"L2 flushed {ms_cold:.4f}) plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP, by {bound_by}); "
        f"1 wrapper launch = {fd.kernels_per_step(cfg.n_layers)} CUDA kernels per step")
    return dict(ms=min(ms, ms_again), plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def prompt_midi(seed: int, vocab) -> bytes:
    """A few bars of melody over block chords in a random major key."""
    rng = np.random.default_rng(seed)
    root = 60 + int(rng.integers(-5, 6))
    scale = np.array([0, 2, 4, 5, 7, 9, 11])
    melody, chords = [], []
    bar = 4 * SAMPLE_FREQ
    for b in range(8):
        deg = int(rng.choice([0, 3, 4, 5]))
        for off in (0, 2, 3):   # triad in the octave below
            chords.append([root - 12 + scale[(deg + 2 * (off // 2) + off % 2) % 7], b * bar, bar])
        t = 0
        while t < bar:
            dur = int(rng.choice([2, 4]))
            pitch = root + scale[int(rng.integers(0, 7))] + 12 * int(rng.integers(0, 2))
            melody.append([pitch, b * bar + t, dur])
            t += dur
    npenc = chordarr2npenc(notes2chordarr([np.array(melody), np.array(chords)]))
    return MusicItem.from_npenc(npenc, vocab).to_midi_bytes()


def main_path_phase(learner, seed: int, n_words: int):
    vocab = learner.vocab
    midi = prompt_midi(seed, vocab)
    kernel = learner.engine.resolve_kernel(1)
    if kernel != "slab_w8":
        raise AssertionError(f"auto kernel at B=1 is {kernel!r}, expected 'slab_w8'")
    predict_nw_genre(learner, midi, genre="jazz", max_len=8, seed=seed)  # warm-up
    torch.cuda.synchronize()
    fd.fused_slab_core.launches = 0
    t0 = time.perf_counter()
    full = predict_nw_genre(learner, midi, genre="jazz", max_len=n_words, seed=seed)
    secs = time.perf_counter() - t0
    launches = fd.fused_slab_core.launches
    if launches != n_words:
        raise AssertionError(f"slab_w8 launched {launches} times for {n_words} steps")
    seed_item = MusicItem.from_file(midi, vocab).trim_to_beat(32)
    seed_item = seed_item.set_genre("jazz").remove_eos()
    pred = full.data[len(seed_item.data):]
    back = MusicItem.from_file(full.to_midi_bytes(), vocab)
    npenc = back.to_npenc()
    viol = grammar_violations(pred, vocab, prev_idx=int(seed_item.data[-1]))
    checks = dict(tokens=len(pred), reparsed_tokens=len(back.data),
                  grammar_violations=viol, roundtrip=roundtrip_ok(back.data, vocab),
                  valid_npenc=is_valid_npenc(npenc, min_notes=1))
    say(f"main: predict_nw_genre B=1 kernel={kernel} n_words={n_words} "
        f"slab_w8 launches={launches} {checks} {len(pred) / secs:.1f} emitted "
        f"tok/s, {n_words / secs:.1f} steps/s ({secs:.3f} s incl. prefill)")
    if not (len(pred) > 0 and back.data[0] == vocab.bos_idx and viol == 0
            and checks["roundtrip"] and checks["valid_npenc"]):
        raise AssertionError(f"generated MIDI failed its checks: {checks}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-words", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    device_phase()
    build_phase()
    t0 = time.perf_counter()
    learner = MusicLearner.load(str(CKPT))     # device=None → the card
    engine = learner.engine
    say(f"load: {CKPT} {engine.cfg.n_layers}L d{engine.cfg.d_model} "
        f"ff{engine.cfg.d_inner} {engine.cfg.n_heads}x{engine.cfg.d_head} "
        f"mem {engine.cfg.mem_len} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(args.seed)
    max_err, wkr_mt = kernel_phase(engine, rng, dev)
    timing = timing_phase(engine, wkr_mt, rng, dev)
    launches = main_path_phase(learner, args.seed, args.n_words)
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [{
        "name": "fused_slab_core[slab_w8]", "route": "cuda",
        "source": "deepmusicgeneration_tpu_torch/ops/csrc/slab_decode.cu",
        "replaces": "deepmusicgeneration_tpu/ops/fused_decode.py:1163",
        "launches": launches, "max_abs_err": max_err, **timing,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
