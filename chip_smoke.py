#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n-words 256]

Phases, one or more lines each (a failing phase raises and the script exits
non-zero without printing a result):

1. device — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build  — nvcc builds every kernel source of the slice, in parallel.
3. load   — the 41M flagship checkpoint through the port's msgpack reader.
4. kernel — each kernel on the card against its plain PyTorch version on
   the same inputs, all random inputs drawn on the card. The slab steps are
   held to the float64 check (each drift distance from a float64 run of the
   plain version within a fixed bound plus PLAIN_K times the float32 plain
   version's; see PLAIN_K), at ptr in
   {0, 31, 32, M - 1} on a partly full, a full and a short ring (RINGS):
   ``fused_slab_core`` in its modes slab_w8 (B in {1, 4}; the tensor-core
   chain at every B) and slab (bf16
   weights, B in {1, 16}), ``fused_slab_allrows_core`` in its modes
   slab_ar_w8 and slab_ar (B in {8, 64}, then 16; the tensor-core chain of
   csrc/tc_decode.cuh, as slab's at B >= 8), so every B a main path
   gives a kernel is among them, at the genre flagship's widths. Then the
   explicit modes, drawn from an rng of their own (MODE_CASE_BATCHES): the
   slab step's slab_int8 (B in {1, 24, 64}, B = 64 at 32 rows a cell and
   B = 24 at 24), slab4 (ptr also M/2 - 1 and M/2, the two nibble sides of
   one packed row; B in {1, 24, 64}, and 64 at 16 and 32 rows a cell) and
   slab4_w8 (B in {1, 24, 64}): the old chain at B = 1, the tensor-core
   chain of csrc/tc_decode.cuh at B >= 8; and ``fused_multirow_core`` /
   ``fused_multirow_q_core`` (multirow and multirow_int8 as slab4_w8, B in
   {1, 24, 64}; multirow's chain serves B = 1 too) on head-major panels, by
   the same float64
   check (written slots in int8 or int4 steps, or for bf16 panels in units
   of 2^-7 of the row's largest entry); then slab on its tensor-core chain
   at B in {8, 24, 64} (B = 16 is among the slab cases above). Then
   multirow's edge cases (MULTIROW_EDGE_CASES, an rng of their own): its
   chain at B in {3, 5}, clusters of 4 rows with padded ones, and its old
   chain (multirow_step, the sizes the chain refuses) at M = 520, B in
   {1, 5, 64}, by the same check. Then the all-rows steps' cases
   (ALLROWS_CHAIN_CASES, ALLROWS_EDGE_CASES, an rng of their own): slab_ar_w8
   and slab_ar on the chain at B in {24, 72} and slab_ar_w8 at 128 (two row
   groups of the products), and their old chain at B in {1, 4} and at
   M = 520, B in {8, 64}, by the same check. Then slab_w8's cases
   (SLAB_W8_EDGE_CASES, an rng of their own): its tensor-core chain (at
   every B; B = 1 and 4 are among the slab_w8 cases above) at B in
   {2, 8}, the rest of the B its chain was timed at, and its old chain
   (slab_w8_step) at M = 520, B in {1, 4}, by the same check. Then
   ``flash_prefill_attention`` on five left-padded windows (B = 16 and 64,
   W = 512, the batched paths' shapes; B = 2, W = 4096; B = 1, W = 128;
   B = 8, W = 96, a tail tile; and d_head 128, B = 8, W = 200, through the
   source's CUDA-core entry) against the float32 plain version; then at
   each d_head of ``fp.KERNEL_HEAD_DIMS`` the causal wrappers' kernel by
   their entry record and by ``torch.profiler`` (the wgmma kernel at 32
   and 64). Then the
   multitask slice. mt load: the trained demo_multitask_model through the
   port's reader, and the 85M multitask flagship's shapes (10 + 10 layers,
   d 512, 8 x 64 heads, d_inner 2048, M 512, ReLU) with ``init_multitask``
   weights drawn on the card. mt kernel: ``fused_s2s_slab_core`` and
   ``fused_nw_slab_core`` in modes slab_w8 and slab against
   ``s2s_slab_plain(acc=float64)`` by the same check, at the flagship's
   widths with non-zero biases drawn on the card and Le in {64, 512, 1024}
   with padded encoder columns, and at the demo's widths. Then
   ``txl.prefill`` through the flash kernel against its materialized branch
   on the 16 service prompts (logits and cache).
5. timing — CUDA-event medians of each kernel and of its plain version at
   the main paths' shapes, beside the bound from the bytes it must move and
   the operations it must do; slab_w8 and slab_ar_w8 at B in
   {1, 4, 8, 16, 64} (slab_ar_w8 also at 128), slab at B in {8, 16, 64},
   slab_ar at B in {8, 16, 64},
   the five explicit modes at B in {1, 64} (slab4 also at 16 and 32 rows a
   cell; slab4_w8, slab4, slab_int8, multirow_int8 and multirow also at 8
   and 16), each step also under ``torch.profiler``: its kernels a step by
   the wrapper's count and by the profiler, on the tensor-core chain every
   one a chain kernel, off it none); the four
   s2s / nw variants at B = 1, M = 512, Le = 512, each also under
   ``torch.profiler`` over 20 wrapper calls: one CUDA kernel a call (the
   persistent step, on its co-resident grid) and its device time a launch;
   the flash prefill at B in {16, 64}, W 512, and B 2, W 4096.
6. main   — ``predict_nw_genre`` at B = 1 with the auto kernel (slab_w8, on
   the tensor-core chain) on a seeded
   prompt MIDI built with the port's codec; the slab_w8 launch count must
   equal the number of token steps; the output MIDI is re-parsed and checked.
7. batch  — 16 requests through ``GenerationService(max_batch=16)``: one
   batch of 16 rows, W = 512, prefilled through the flash kernel (one launch
   per layer) and decoded through slab_ar_w8 (one launch per step, on the
   tensor-core chain); then one ``generate_batch`` of 64 prompts. Every
   result is re-parsed and checked. A ``generate_batch`` row that fails the
   checks is replayed on the plain step (``forced=``): each note it drew
   outside the piano range must be one the plain sampler's filter keeps at
   that step, and the rest of the row must pass the data gate
   (``check_drawn_row``); a row that fails that fails the run after the
   last phase and the ``kernels`` line.
8. continuous — 32 requests in four waves through
   ``ContinuousGenerationService`` (16 slots, chunks of 32 steps, the auto
   kernel, which must be slab), with mixed budgets and sampling settings;
   one greedy and one sampled request that joined mid-flight are decoded
   again alone and must equal their in-batch tokens; then a short run with
   the explicit slab_ar kernel. Each engine is warmed up before its
   service's worker thread starts. Every output must pass the codec's data
   gate (piano range, duration cap), except that of a request sampled from
   the whole distribution (top_k 0 and top_p 0), which is counted.
8b. modes — the genre engine's explicit modes on the 64 prompts:
   ``generate_batch(decode_kernel=k, rows_per_cell=r, kv_int8=q)`` at W =
   512 for slab_int8, slab4 at r 8, 16 and 32, slab4_w8, multirow,
   multirow_int8 and xla with kv_int8 (PATH_RUNS): one launch of the kernel
   a step and the flash prefill once a layer; then ``generate`` at B = 1
   with each of the five modes, one launch a step. Every output re-parses
   and passes the codec's checks; each run's rate in steps/s and emitted
   tok/s.
9. mt tasks — on the flagship's shapes and on the demo checkpoint, with the
   auto kernel (which must be slab_w8): ``s2s_predict_from_midi`` (200
   words) on a two-track Piano + Bass prompt, ``nw_predict_from_midi`` (256
   words) and ``predict_mask_remix`` (notes at 0.6); each decode path
   launches its kernel once a token step, remix none; every output
   re-parses with no grammar violation; then harmonize and next-word (64
   words) on the demo with the explicit bf16-weight slab step.
10. http — the HTTP server (``--continuous``) on 127.0.0.1 in a thread:
   /health, /tokenize, four concurrent /generate, then /remix and
   /harmonize on the demo multitask learner (200, MIDI that re-parses).
11. train kernel — ``flash_train_attention``'s CUDA forward and backward
   against its plain version at the flagship's train shape (B 16, L 512,
   K 1024, 12 x 64 heads, bf16), inputs drawn on the card, in five cases
   (causal with full memory, 40 valid memory slots, a curriculum window of
   3, key padding, attention dropout 0.1): the output and the six gradients
   each held to the float64 check (TRAIN_REL, PLAIN_K).
12. train timing — CUDA-event medians of 100 forward and 100 backward
   launches and of the plain version, beside the bound; the tile pairs the
   kernels compute of all (``tile_map``) and the bytes of the backward's
   dWkr partial slots.
13. train — the main path of training: a synthetic corpus
   (``synthcorpus.make_corpus``) sized to one epoch of 16-32 steps,
   ``MusicLearner(btp_phase1_config)`` with fresh weights on the card,
   ``fit_one_cycle`` at bs 16, bptt 512 with a validation loader; 8 forward
   and 8 backward kernel launches a step (and 8 forward a validation
   batch), the plain version never called; the loss of the last 4 steps
   below that of the first 4 and finite; then ``save``, ``MusicLearner.load``
   on the card and 32 tokens through ``slab_w8``, whose MIDI re-parses.
14. mt train kernel — the multitask train step's kernels against their plain
   versions at the 85M flagship's train shape (B 16, 8 x 64 heads, bf16),
   inputs drawn on the card: ``flash_bidir_attention`` (W 512: plain, key
   padding, dropout 0.1, and a fully padded batch row beside one whose last
   two key tiles are padded), ``flash_cross_attention`` (L = K = 512; L 256
   with K 512; dropout 0.1) and ``flash_train_attention`` with no memory
   (L = K = 512: causal, and a window of 3 at diagonal 0), the output and
   the six gradients each held to the float64 check (TRAIN_REL, PLAIN_K).
15. mt train timing — CUDA-event medians of 100 forward and 100 backward
   launches of the bidirectional and cross kernels and of
   ``flash_train_attention`` at M = 0, and of their plain versions, beside
   the bound; for each the tile pairs computed and the partials' bytes, and
   the bidirectional kernels' medians again under the leading key padding,
   beside the tile pairs they skip.
16. mt train — the main path of multitask training, as
   ``examples/train_multitask.py`` builds it: mask batches
   (``mask_lm_tfm_pitchdur`` over ``LMStreamLoader``, 8-16 of them) and
   Piano / Bass seq2seq batches (``S2SLoader`` over 18 two-track synthetic
   songs, repeated to as many), ``multitask_model_learner(multitask_config)``
   with fresh weights on the card, ``fit(epochs=2, dataloaders=[mask,
   s2s])`` at bs 16 x bptt 512: a mask step launches 10 bidirectional
   forward and backward kernels and nothing else, an s2s step 20 of each of
   the bidirectional, cross and train kernels' forward and backward, the
   plain versions never; at least one step runs a curriculum window; the
   loss is finite and the last 4 steps of each epoch below its first 4;
   on a mask batch and on an s2s batch with key padding, the trained
   model's ``multi_loss`` and its gradients through the kernels equal the
   score path's (``flash_train=False``) within MT_ROUTE_LOSS_ATOL and
   MT_ROUTE_GRAD_REL; then ``save``, ``MultitaskLearner.load`` on the card, and harmonize,
   next-word (64 words, ``slab_w8``) and remix, whose MIDI re-parses.
17. mt prefill kernel — ``flash_encoder_attention`` against its float32
   plain version by flash_check's exact-float32 check (MT_PREFILL_CASES):
   bidirectional at B 16, W 512 with right-padded keys, with a fully padded
   row, at W 64, at W 96 (a tail tile) and at W 40 (less than a tile), every
   query row held; causal at B 16, W 512, left-padded, its real rows held.
18. mt prefill — on the flagship's shapes at B 16, W 512, under the auto
   rule: ``encode`` (10 bidirectional launches), ``decoder_prefill`` and
   ``lm_prefill`` (10 causal launches each) against their ``flash=False``
   branch; at B = 1 none of them launches a kernel.
19. mt prefill timing — CUDA-event medians of both variants and of their
   plain version at B 16, W 512, beside the bound.
20. mt fused kernel — ``fused_s2s_step_core`` / ``fused_nw_step_core`` (the
   exact bf16 sweep) against ``s2s_fused_plain(acc=float64)`` by the float64
   check on h_out and the written K/V slot (within_fused_bounds), at the
   flagship's widths with non-zero biases (Le in {64, 512, 1024}, padded
   encoder columns) and at the demo's, ptr in {0, 31, M - 1} on each kind of
   RINGS.
21. mt fused timing — CUDA-event medians of both fused steps and of their
   plain version at B = 1, M = 512, Le = 512, beside the bound; one CUDA
   kernel a wrapper call and its device time, as the mt timing phase.
22. mt fused tasks — harmonize (200 words), next-word (256) and remix with
   ``decode_kernel='fused'`` on the flagship's shapes and on the demo: one
   fused launch a token step; every output re-parses with no grammar
   violation; 64 greedy steps of each task on the demo equal those of the
   exact ring step, or diverge first at a near-tie (FUSED_LOGITS_ATOL / RTOL).
23. row 10 kernel — from an rng of their own (ROW10_CASE_BATCHES):
   ``fused_stack_decode`` (B = 1, the token in row 0 of an 8-row h block,
   rows 1-7 of h_out bit for bit those of h_in), ``fused_batched_decode``
   (B in {1, 16, 64}) at ptr in {0, 31, M/2, M - 1}, both on the
   tensor-core chain (head_major_tc_step), and the int8-score slab step over
   int8 panels (``slab_int8_w8``, B in {1, 64}, slab_int8's two-step cap),
   each on every kind of RINGS against a float64 run of its plain version
   by the float64 check; then from a second rng (ROW10_EDGE_CASES)
   ``fused_batched_decode``'s chain at B in {3, 5} and its old chain at
   M = 520, B in {1, 5, 64}. Every case runs; the phase fails at its end,
   naming each case that failed.
24. row 10 timing — CUDA-event medians of both row-10 steps at B = 1, 16
   and 64 and of ``slab_int8_w8`` at B = 1 and 64, and of their plain
   versions, beside the bound; the row-10 steps' kernels a step under
   ``torch.profiler``.
25. stack — the path of the JAX package's row-10 tests at full width, one
   prompt at B = 1 (materialized prefill) and the batch cell's 16 at B = 16
   (flash prefill): ``txl.prefill``, ``ring_from_prefill``,
   ``precompute_wkr``, ``stack_txl_layers``, the transposed caches, then
   256 free-running greedy steps (``sample_next_token``, the grammar mask)
   of one launch each, every continuation re-parsed; its steps/s from that
   run alone. Then the gate (``stack_fixed_path``): the path driven by the
   float64 plain step (the TPU kernel's function, tanh GELU and its bf16
   cast points, float64 between them), the wrapper and the float32 plain
   step on copies of its caches at every step; the wrapper's largest
   |dlogit| from float64 within STACK_F64_ATOL + PLAIN_K x the float32 plain
   step's, its argmax equal to float64's where float64's top two are more
   than twice that bound apart, the slot it wrote within SLOT_MAX_STEP +
   PLAIN_K x the float32 plain step's steps of float64's and every other
   slot byte-identical, rows 1-7 of its h block bit for bit. This gate
   replaced one that held the wrapper's logits within the JAX test's
   one-step bound (STACK_LOGITS_ATOL / RTOL) of the exact
   ``txl.decode_step_ring`` over the free-running path: the float64 run of
   the TPU kernel's own function left that bound on 3 of 6 256-step paths
   (erf against tanh GELU and other bf16 cast points), so it passed or
   failed a faithful step by its rounding draw. The exact step still runs on
   its own ring, fed the same tokens; its largest share of that bound
   against the float64 step, the wrapper and the float32 plain step is
   printed and gates nothing. No engine mode reaches row 10, and no path
   runs ``slab_int8_w8`` (its launches are 0 in the JSON line).

A ``time:`` line after each phase says how long it took. Then one JSON line
with every kernel, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from deepmusicgeneration_tpu_torch.app.server import MusicServer, make_handler
from deepmusicgeneration_tpu_torch.codec.encode import chordarr2npenc, notes2chordarr
from deepmusicgeneration_tpu_torch.codec.grammar import grammar_violations
from deepmusicgeneration_tpu_torch.codec.item import MultitrackItem, MusicItem
from deepmusicgeneration_tpu_torch.codec.validate import is_valid_npenc, roundtrip_ok
from deepmusicgeneration_tpu_torch.decode.continuous import (ContinuousEngine,
                                                            ContinuousGenerationService)
from deepmusicgeneration_tpu_torch.codec import grammar
from deepmusicgeneration_tpu_torch.codec.index import position_enc
from deepmusicgeneration_tpu_torch.decode.engine import (INT8_WEIGHT_KERNELS, SampleState,
                                                         SamplerSettings, _bucket,
                                                         _past_80pct, sample_next_token)
from deepmusicgeneration_tpu_torch.models import multitask as mt
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import btp_phase1_config, multitask_config
from deepmusicgeneration_tpu_torch.models.precision import master_params
from deepmusicgeneration_tpu_torch.ops import _build
from deepmusicgeneration_tpu_torch.ops import flash_prefill as fp
from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd
from deepmusicgeneration_tpu_torch.ops import fused_s2s as fs
from deepmusicgeneration_tpu_torch.tasks.generate import predict_nw_genre
from deepmusicgeneration_tpu_torch.tasks.harmonize import (nw_predict_from_midi,
                                                           s2s_predict_from_midi)
from deepmusicgeneration_tpu_torch.tasks.remix import predict_mask_remix
from deepmusicgeneration_tpu_torch.tasks.serve import GenerationService
from deepmusicgeneration_tpu_torch.train import synthcorpus
from deepmusicgeneration_tpu_torch.train.data import (LMStreamLoader, S2SLoader,
                                                      mask_lm_tfm_pitchdur)
from deepmusicgeneration_tpu_torch.train.learner import (MultitaskLearner, MusicLearner,
                                                         multitask_model_learner)
from deepmusicgeneration_tpu_torch.train.loop import _batch_to_device, multi_loss
from deepmusicgeneration_tpu_torch.train.preprocess import load_corpus
from deepmusicgeneration_tpu_torch.vocab import PIANO_RANGE, SAMPLE_FREQ, VALTSEP, MusicVocab

CKPT = Path(__file__).resolve().parent / "checkpoints" / "synth_genre_model"
MT_DEMO = Path(__file__).resolve().parent / "checkpoints" / "demo_multitask_model"
HBM_BYTES_PER_S = 3.35e12           # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12                 # dense bf16 peak, same source
INT8_OPS = 1979e12                  # dense int8 peak, same source

# The float64 check of a slab step: the kernel's result and its float32
# plain version's (``slab_plain(acc=float32)``) are each compared with a
# float64 run of the plain version on the same inputs (the same bf16 cast
# points, everything between them in float64). The kernel's float32 sums
# differ from exact ones in the last bits, which can flip a value across a
# bf16 rounding point (2^-8 relative) at a cast point, and that difference
# propagates through the layers: h_out (post-LayerNorm, entries of order 1)
# drifts, written int8 K/V entries move by a step or two, and their scales
# (max |x| / 127 of the drifted x) move too. How far depends on the draw as
# much as on the kernel, so each distance of step_diff that measures the
# drift (|dh_out|, the largest int8 step, the share of entries two steps
# off, the written scales' relative difference) must be at most
#     its fixed bound + PLAIN_K x the float32 plain version's distance,
# and every other slot must keep its bytes. The fixed bounds were first set
# on numpy draws (H_ATOL; SLOT_MAX_STEP: slab_w8 stayed within one
# step in all its cases of
# tests/test_torch_cuda.py::test_slab_kernels_against_float64, the other
# modes reached two; TWO_STEP_SHARE_CAP: the largest two-step share there,
# 5.3e-5, doubled and rounded up; SCALE_RTOL). Alone they judged the draw
# too: on K/V drawn on the card the float32 plain version exceeded them as
# far as the kernel did. The added term lets a case drift as far again as
# the float32 plain version's own summation order took it, twice over; it
# stays small wherever that version is near float64, so a fault anywhere in
# the stack (the last layer's feed-forward shows only in h_out) still fails.
# Over the 1928 card-draw cases that the correct kernels were run on
# (PERF.md), no distance needed more than 1 x the float32 plain version's on
# top of its fixed bound.
H_ATOL = 5e-2
# the explicit modes take the bf16-weight modes' 2; a step of an
# int4 slot is a nibble (1/7 of the row's largest), of a bf16 slot 2^-7 of
# the row's largest (one ulp of it at most)
SLOT_MAX_STEP = {"slab_w8": 1, "slab_ar_w8": 2, "slab": 2, "slab_ar": 2, "slab_int8": 2,
                 "slab4": 2, "slab4_w8": 2, "multirow": 2, "multirow_int8": 2,
                 "slab_int8_w8": 2, "fused_stack": 2, "fused_batched": 2}
TWO_STEP_SHARE_CAP = 1.1e-4
# slab_int8 rounds each row's probabilities (times the V scales) to 7 bits.
# The kernel's and the plain version's float32 scores differ in their last
# bits, so where a large probability lies within that noise of a half-point
# the two round it to neighbouring steps: one such flip moves h_out by
# ~1e-3 in its layer (measured on the card: the kernel against its float32
# plain version over the first layer alone) and the next layers carry it on
# (5.6e-2 after eight). Such flips are independent draws in the kernel and
# in the float32 plain version, so one may take several where the other
# takes none, and at B = 1 one row's slots are every written entry: the
# two-step share reached 1.2e-2 there over 96 card draws (PERF.md). Its
# cap is 5e-2; the faults of tests/test_torch_slab_modes.py move
# about half the written entries two steps or more.
TWO_STEP_SHARE_CAP_BY_MODE = {"slab_int8": 5e-2, "slab_int8_w8": 5e-2}
SCALE_RTOL = 1e-2
PLAIN_K = 2.0
# Flash prefill against its plain version (the materialized rel_attention)
# run in float32 on the same bf16 values. flash_inputs makes q and the u, v
# biases multiples of 1/8 below 32 in magnitude, so bf16(q + u) and
# bf16(q + v) are exact: the float32 plain version then computes the
# kernel's function with no rounding at all, and the kernel differs from it
# only in its float32 summation order (scores, online-softmax rescaling,
# P.V: ~1e-5 here) and its bf16 output, which is within half an ulp,
# 2^-8 |out|. So every entry of a real query row must satisfy
# |d| <= FLASH_RTOL |ref| + FLASH_ATOL. Padded query rows (all their keys
# masked) are only required to be finite (see csrc/flash_prefill.cu).
FLASH_RTOL = 2.0 ** -8
FLASH_ATOL = 1e-4
# txl.prefill through the flash kernel against its materialized branch on
# the card, at the model's full depth. Logits: the bounds JAX's tests hold
# its own flash prefill to against the materialized one
# (tests/test_fused_decode.py), atol 0.15 rtol 0.05, and the same argmax.
# Cache: the branches differ by bf16 roundings (the materialized one rounds
# the probabilities, each rounds its attention output), each at most 2^-8 of
# the value, so layer l's input and the K/V it projects differ by about
# l * 2^-8 in relative (Frobenius) norm over the valid slots; layer 0's are
# identical. An elementwise bound does not hold at 8 layers: one flip of a
# large bf16 value (its ulp is 2^-5 at |x| >= 4), carried through 6 layers,
# moved single entries by up to 0.09 between the kernel's route and one whose
# attention is exact (PERF.md, Findings; tests/test_torch_cuda.py).
PREFILL_LOGITS_ATOL, PREFILL_LOGITS_RTOL = 0.15, 0.05
PREFILL_LAYER_RTOL = 2.0 ** -8
# The flash train kernels against their plain version, the float64 check in
# relative form: the kernel's output and each of its six gradients, and the
# float32 plain version's, are compared with a float64 run of the plain
# version on the same bf16 inputs (the same bf16 cast points: q + u, q + v,
# the dropped-out probabilities, the output; everything between them in
# float64). Each distance is relative, |x - ref| / |ref| over the whole
# tensor (Frobenius), and the kernel's must be at most
#     TRAIN_REL + PLAIN_K x the float32 plain version's.
# How TRAIN_REL was set, before the first card run judged by it: the kernel
# rounds where the plain version does not (bf16 dS and P·keep before the
# backward's products, each gradient to bf16 at the end, and the forward's
# row sum is accumulated online), each a relative error of at most 2^-9 per
# term; summed over many terms of random sign these stay near 2^-9 in
# relative norm, and a value rounded to bf16 on one side and not the other
# differs by about 2^-8 / sqrt(12) in relative norm. So a correct kernel sits
# near 3e-3; TRAIN_REL = 2^-6 (1.6e-2) leaves five times that. A wrong
# dropout mask (another seed), a dropped BD term or a wrong unskew (one
# query row off) moves the output or a gradient by 0.4 or more in this norm
# (tests/test_torch_flash_train.py runs each such fault through this check).
TRAIN_REL = 2.0 ** -6
TRAIN_OUTPUTS = ("out", "dq", "dk", "dv", "dwkr", "du", "dv_bias")
TRAIN_B, TRAIN_L, TRAIN_M = 16, 512, 512    # the flagship's cli train batch
TRAIN_SEED = 977
TRAIN_CASES = (
    ("causal", dict(win_size=1, win_k=1, mem_valid=TRAIN_M), False),
    ("mem40", dict(win_size=1, win_k=1, mem_valid=40), False),
    ("win3", dict(win_size=3, win_k=0, mem_valid=TRAIN_M), False),
    ("pad", dict(win_size=1, win_k=1, mem_valid=TRAIN_M), True),
    ("dropout", dict(win_size=1, win_k=1, mem_valid=TRAIN_M, attn_p=0.1), False),
)
# The multitask train step's shapes: B 16, W = L = Le = 512 (the flagship's
# ctx), its 8 x 64 heads. (name, kind, L, K, pad, case): kind "bidir" and
# "cross" are the multitask kernels, "train" flash_train_attention with no
# memory, as the decoder calls it.
MT_TRAIN_B, MT_TRAIN_W = 16, 512
MT_TRAIN_CASES = (
    ("bidir", "bidir", 512, 512, False, {}),
    ("bidir pad", "bidir", 512, 512, True, {}),
    ("bidir dropout", "bidir", 512, 512, False, dict(attn_p=0.1)),
    ("cross", "cross", 512, 512, False, {}),
    ("cross L256", "cross", 256, 512, False, {}),
    ("cross dropout", "cross", 512, 512, False, dict(attn_p=0.1)),
    ("train M=0 causal", "train", 512, 512, True, dict(win_size=1, win_k=1, mem_valid=0)),
    ("train M=0 win3", "train", 512, 512, False, dict(win_size=3, win_k=0, mem_valid=0)),
    # last, so that the cases above keep their seeds: batch row 0 fully
    # padded (it skips nothing), row 1's last two key tiles padded
    # (skipped), the others' leading padding
    ("bidir pad rows", "bidir", 512, 512, "rows", dict(attn_p=0.1)),
)
MT_TRAIN_FNS = {"bidir": (ftr.flash_bidir_attention, ftr.flash_bidir_attention_plain),
                "cross": (ftr.flash_cross_attention, ftr.flash_cross_attention_plain),
                "train": (ftr.flash_train_attention, ftr.flash_train_attention_plain)}


def say(line: str) -> None:
    print(line, flush=True)


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with a line that says how long the phase took."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    say(f"time: {name} phase {time.perf_counter() - t0:.1f} s")
    return out


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
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        paths = list(pool.map(_build.build, _build.SOURCES))
    secs = time.perf_counter() - t0
    for p in paths:
        log = p.with_suffix(".log").read_text() if p.with_suffix(".log").exists() else ""
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        say(f"build: {p.name} {len(regs)} ptxas lines: " + " | ".join(regs))
    say(f"build: {len(paths)} kernel source(s) in {secs:.2f} s")


def normal(shape, std, rng, dev):
    """float32 N(0, std^2) values drawn on ``dev`` from a generator that
    ``rng`` seeds."""
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 63)))
    return torch.randn(shape, generator=g, device=dev).mul_(std)


# the kernel phases' rings: full (every slot valid), part (a prompt of M // 3
# tokens plus ptr decoded ones) and short (a prompt of SHORT_PROMPT tokens plus
# ptr decoded ones, its K/V slot rows of varying magnitude): on short rings
# the fresh token's self term and each slot's own value scale carry weight, so
# a kernel that drops one or mixes them up fails the float64 check (on the
# other two kinds such a fault moves h_out by about 2e-2, within H_ATOL)
RINGS = ("part", "full", "short")
SHORT_PROMPT = 8


def ring_blocked(B, M, ptr, kind):
    """The (B, M) blocked mask of a ring of ``kind`` (RINGS) whose pointer
    is ``ptr``; rows after the first block their first 7 slots too."""
    slot = np.arange(M)
    n_prompt = {"part": M // 3, "short": SHORT_PROMPT}.get(kind, 0)
    if kind == "full":
        g = np.where(slot < ptr, slot, slot - M)          # g_cur = ptr
    else:
        g = np.where(slot < ptr, slot, txl.PAD_G)
        g[M - n_prompt:] = np.arange(-n_prompt, 0)
    dist = ptr - np.broadcast_to(g, (B, M))
    blocked = ((dist < 1) | (dist > M)).astype(np.int32).copy()
    blocked[1:, : 7] = 1                                   # rows differ
    return blocked


INT4_MODES = ("slab4", "slab4_w8")
MULTIROW_MODES = ("multirow", "multirow_int8")
# fused_stack_decode / fused_batched_decode: bf16 K (L, B, H, Dh, M), V (L, B, H, M, Dh)
STACK_MODES = fd.STACK_MODES


def ring_kv(L, B, M, HD, kind, rng, dev, mode="slab_w8", H=None):
    """Random K/V caches of ``mode``'s layout drawn on the card from slot
    rows of std 0.5, each slot row scaled by exp(N(0, 0.7^2)) on a short
    ring: int8 slot-major (L, B, M, HD) with (L, B, M, 1) scales; int4
    nibble pairs (L, B, M/2, HD) for the slab4 modes; head-major K panels
    (L, B, HD, M) with slot-major V for the multirow modes, bf16, or int8
    with (L, B, 1, M) scales; bf16 K (L, B, H, Dh, M) and V (L, B, H, M, Dh)
    for STACK_MODES (``H`` heads)."""
    def rows():
        x = normal((L, B, M, HD), 0.5, rng, dev)
        if kind == "short":
            x.mul_(torch.exp(normal((L, B, M, 1), 0.7, rng, dev)))
        return x.to(torch.bfloat16)
    k, v = rows(), rows()
    if mode in INT4_MODES:
        return list(fd.quantize_kv_slot_major_int4(k, v))
    if mode in MULTIROW_MODES:
        kt = k.transpose(2, 3).contiguous()
        return list(fd.quantize_kv_panels(kt, v)) if mode == "multirow_int8" else [kt, v]
    if mode in STACK_MODES:
        heads = lambda x: x.reshape(L, B, M, H, HD // H)
        return [heads(k).permute(0, 1, 3, 4, 2).contiguous(),
                heads(v).transpose(2, 3).contiguous()]
    return list(fd.quantize_kv_slot_major(k, v))


def ring_inputs(cfg, B, M, ptr, kind, rng, dev, mode="slab_w8"):
    """A ring of ``kind`` whose pointer is ``ptr``: its caches (of
    ``mode``'s layout) and blocked mask."""
    L, HD = cfg.n_layers, cfg.n_heads * cfg.d_head
    return (ring_kv(L, B, M, HD, kind, rng, dev, mode, cfg.n_heads),
            torch.from_numpy(ring_blocked(B, M, ptr, kind)).to(dev))


def wkr_table(engine):
    cfg, M = engine.cfg, engine.cfg.mem_len
    return txl.precompute_wkr(engine.params, cfg, M).permute(0, 2, 1, 3) \
        .reshape(cfg.n_layers, M + 1, -1).to(torch.bfloat16).contiguous()


def kernel_ptrs(mode, M):
    """The ring pointers of the kernel phase: {0, 31, 32, M - 1}, for the
    int4 modes also the last high-nibble and the first low-nibble slot, for
    STACK_MODES {0, 31, M/2, M - 1}."""
    if mode in STACK_MODES:
        return (0, 31, M // 2, M - 1)
    return (0, 31, 32, M // 2 - 1, M // 2, M - 1) if mode in INT4_MODES else (0, 31, 32, M - 1)


def kernel_cases(engine, rng, dev, batches, mode="slab_w8"):
    """The kernel phase's cases at each B of ``batches``: ptr in
    kernel_ptrs on each kind of RINGS. Yields
    (B, ptr, kind, caches of ``mode``'s layout, blocked, h_in); h_in of
    fused_stack is its 8-row block, rows 1-7 N(0, 1) draws."""
    cfg, M = engine.cfg, engine.cfg.mem_len
    embed32 = engine.params["embed"].float()
    for B in batches:
        for ptr in kernel_ptrs(mode, M):
            for kind in RINGS:
                kv, blocked = ring_inputs(cfg, B, M, ptr, kind, rng, dev, mode)
                h_in = embed32[torch.from_numpy(rng.integers(12, 140, B)).to(dev)]
                if mode == "fused_stack":
                    h_in = torch.cat([h_in, normal((7, cfg.d_model), 1.0, rng, dev)])
                yield B, ptr, kind, kv, blocked, h_in


def written_slots(mode, caches, ptr):
    """The slot ``ptr`` of a step's K and V caches: [(values (L, B, HD) as
    int32 entries or, bf16 panels, float32, scales (L, B) or None)] for K,
    then V; int4 entries are the slot's nibbles."""
    if mode in STACK_MODES:
        kt, vc = caches
        rows = lambda t: t.reshape(t.shape[0], t.shape[1], -1).float()
        return [(rows(kt[..., ptr]), None), (rows(vc[:, :, :, ptr]), None)]
    if mode in MULTIROW_MODES:
        kt, *rest = caches
        ks, vc, vs = rest if mode == "multirow_int8" else (None, rest[0], None)
        val = (lambda t: t.int()) if mode == "multirow_int8" else (lambda t: t.float())
        pick = lambda s: None if s is None else s[:, :, 0, ptr]
        return [(val(kt[:, :, :, ptr]), pick(ks)), (val(vc[:, :, ptr]), pick(vs))]
    kt, ks, vc, vs = caches
    if mode in INT4_MODES:
        M2 = kt.shape[2]
        pm, side = ptr % M2, ptr // M2
        nib = lambda t: ((t[:, :, pm].int() & 255) >> (4 if side == 0 else 0) & 15) - 8
        return [(nib(kt), ks[:, :, ptr, 0]), (nib(vc), vs[:, :, ptr, 0])]
    return [(kt[:, :, ptr].int(), ks[:, :, ptr, 0]), (vc[:, :, ptr].int(), vs[:, :, ptr, 0])]


def others_untouched(mode, got, kv, ptr):
    """Whether every cache entry of ``got`` outside slot ``ptr`` keeps the
    bytes of ``kv`` (int4: the other packed rows, and the partner slot's
    nibble in the shared row)."""
    M = (kv[0].shape[4] if mode in STACK_MODES else kv[0].shape[3] if mode in MULTIROW_MODES
         else kv[1].shape[2])
    other = torch.arange(M, device=kv[0].device) != ptr
    axes = {"multirow": (3, 2), "multirow_int8": (3, 3, 2, 3), "fused_stack": (4, 3),
            "fused_batched": (4, 3)}.get(mode, (2, 2, 2, 2))
    if mode not in INT4_MODES:
        return all(torch.equal(g.index_select(a, other.nonzero()[:, 0]),
                               t.index_select(a, other.nonzero()[:, 0]))
                   for g, t, a in zip(got, kv, axes))
    M2 = M // 2
    pm, keep = ptr % M2, (15 if ptr < M2 else 240)
    rows = torch.arange(M2, device=kv[0].device) != pm
    same = all(torch.equal(g[:, :, rows], t[:, :, rows]) and
               torch.equal(g[:, :, pm].int() & keep, t[:, :, pm].int() & keep)
               for g, t in ((got[0], kv[0]), (got[2], kv[2])))
    return same and all(torch.equal(g[:, :, other], t[:, :, other])
                        for g, t in ((got[1], kv[1]), (got[3], kv[3])))


def step_diff(got, ref, kv, ptr, mode="slab_w8"):
    """One decode step's result ``got`` against ``ref`` (both (h_out,
    caches...) of ``mode``'s layout, from the caches ``kv``): max |dh_out|,
    the largest step between written entries (int8 or int4 steps; for bf16
    panels |d| in units of 2^-7 of the row's largest entry, one ulp of it at
    most), the share of those entries that differ and the share that differ
    by more than one step, the largest relative difference of the written
    scales, and whether every other slot of ``got`` is byte-identical to
    ``kv``."""
    untouched = others_untouched(mode, got[1:], kv, ptr)
    dh = (got[0].double() - ref[0].double()).abs().max().item()
    step, share, share2, scale_rel = 0, 0.0, 0.0, 0.0
    for (g, s_got), (r, s_ref) in zip(written_slots(mode, got[1:], ptr),
                                      written_slots(mode, ref[1:], ptr)):
        d = (g - r).abs()
        if d.dtype == torch.float32:                     # bf16 panels
            d = d / (2.0 ** -7 * r.abs().amax(-1, keepdim=True).clamp_min(1e-30))
        step = max(step, d.max().item())
        share = max(share, (d > 0).float().mean().item())
        share2 = max(share2, (d > 1).float().mean().item())
        if s_ref is not None:
            scale_rel = max(scale_rel, ((s_got - s_ref).abs() / s_ref).max().item())
    return dh, step, share, share2, scale_rel, untouched


# the steps over int8 weight panels: the engine's, and slab_int8_w8 (no engine mode)
W8_MODES = INT8_WEIGHT_KERNELS + ("slab_int8_w8",)


def weights(engine, mode):
    """(StackedTXL, w_scales or None) of a decode mode: int8 panels for the
    _w8 modes, bf16 for the others."""
    return engine.stacked_q() if mode in W8_MODES else engine.stacked()


# the kernel phase's modes and batch sizes, in the order they draw from the rng
KERNEL_CASE_BATCHES = (("slab_w8", (1, 4)), ("slab_ar_w8", (8, 64)), ("slab", (1, 16)),
                       ("slab_ar", (8, 64)), ("slab_ar_w8", (16,)), ("slab_ar", (16,)))
CORES = {"slab_w8": fd.fused_slab_core, "slab": fd.fused_slab_core,
         "slab_ar_w8": fd.fused_slab_allrows_core, "slab_ar": fd.fused_slab_allrows_core,
         "slab_int8": fd.fused_slab_core, "slab4": fd.fused_slab_core,
         "slab4_w8": fd.fused_slab_core, "multirow": fd.fused_multirow_core,
         "multirow_int8": fd.fused_multirow_q_core, "slab_int8_w8": fd.fused_slab_core,
         "fused_stack": fd.fused_stack_decode, "fused_batched": fd.fused_batched_decode}
# fused_slab_core's arguments that select a mode beyond its weight panels
SLAB_ARGS = {"slab_int8": dict(score_mode="int8"), "slab4": dict(kv_int4=True),
             "slab4_w8": dict(kv_int4=True), "slab_int8_w8": dict(score_mode="int8")}


def mode_wkr(mode, wkr_mt, H=None):
    """The relative table in ``mode``'s layout: (L, M+1, HD), the multirow
    modes' (L, HD, M+1) panels, or STACK_MODES' (L, H, Dh, M+1)."""
    if mode in STACK_MODES:
        L, M1, HD = wkr_mt.shape
        return wkr_mt.transpose(1, 2).reshape(L, H, HD // H, M1).contiguous()
    return wkr_mt.transpose(1, 2).contiguous() if mode in MULTIROW_MODES else wkr_mt


def run_step(mode, engine, wkr_mt, kv, blocked, h_in, ptr, rows=None):
    """One launch of ``mode``'s kernel on copies of the caches ``kv``, at
    ``rows`` rows a cell (default min(B, 8)); fused_stack must return rows
    1-7 of its h block bit for bit."""
    stacked, w_scales = weights(engine, mode)
    R, cfg, M = rows or min(len(h_in), 8), engine.cfg, engine.cfg.mem_len
    caches = [t.clone() for t in kv]
    if mode in STACK_MODES:
        out = CORES[mode](stacked, cfg, h_in, mode_wkr(mode, wkr_mt, cfg.n_heads), *caches,
                          blocked, ptr, M)
        if mode == "fused_stack" and not torch.equal(out[0][1:], h_in[1:]):
            raise AssertionError("fused_stack changed rows 1-7 of its h block")
        return out
    if mode in MULTIROW_MODES:
        return CORES[mode](stacked, cfg, h_in, mode_wkr(mode, wkr_mt), *caches, blocked, ptr,
                           M, rows_per_cell=R)
    return CORES[mode](stacked, cfg, h_in, wkr_mt, *caches, blocked, ptr, M,
                       rows_per_cell=R, weights_int8=w_scales is not None,
                       w_scales=w_scales, **SLAB_ARGS.get(mode, {}))


def plain_step(mode, engine, wkr_mt, kv, blocked, h_in, ptr, acc=torch.float64, rows=None,
               copy=True):
    """``mode``'s plain version on copies of the caches ``kv`` (``copy``
    False: on ``kv`` itself, as the timing runs it)."""
    stacked, w_scales = weights(engine, mode)
    cfg, caches = engine.cfg, [t.clone() for t in kv] if copy else kv
    if mode in STACK_MODES:
        return fd.stack_plain(stacked, cfg, h_in, mode_wkr(mode, wkr_mt, cfg.n_heads),
                              *caches, blocked, ptr, acc=acc)
    if mode in MULTIROW_MODES:
        plain = fd.multirow_plain if mode == "multirow" else fd.multirow_q_plain
        return plain(stacked, cfg, h_in, mode_wkr(mode, wkr_mt), *caches, blocked, ptr,
                     acc=acc)
    return fd.slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, *caches, blocked, ptr,
                         acc=acc, rows_per_cell=rows or min(len(h_in), 8),
                         **SLAB_ARGS.get(mode, {}))


# the distances of step_diff that the check widens by the float32 plain
# version's: |dh_out|, the largest int8 step, the two-step share, the
# relative difference of the written scales
DRIFT_METRICS = (("dh", 0), ("step", 1), ("two_steps", 3), ("scale_rel", 4))


def bounds(mode, plain_diff) -> dict:
    """The float64 check's bound on each drift distance of ``mode``'s kernel,
    given the float32 plain version's step_diff from float64 on the same
    case."""
    fixed = {"dh": H_ATOL, "step": SLOT_MAX_STEP[mode],
             "two_steps": TWO_STEP_SHARE_CAP_BY_MODE.get(mode, TWO_STEP_SHARE_CAP),
             "scale_rel": SCALE_RTOL}
    return {m: fixed[m] + PLAIN_K * plain_diff[i] for m, i in DRIFT_METRICS}


def within_bounds(mode, diff, plain_diff) -> bool:
    """The float64 check of one kernel step_diff, against the float32 plain
    version's ``plain_diff`` on the same case (see PLAIN_K); the other
    slots must be byte-identical."""
    limit = bounds(mode, plain_diff)
    return all(diff[i] <= limit[m] for m, i in DRIFT_METRICS) and diff[5]


def check_case(name, mode, kv, ptr, kernel, plain, tag):
    """Run ``kernel()`` and ``plain(acc)`` (each on fresh copies of the
    caches ``kv``) and hold the kernel to the float64 check; says one line
    and returns |dh_out| and |dh_out| over the bound the check applied to
    it, or raises."""
    ref, f32 = plain(torch.float64), plain(torch.float32)
    got = kernel()
    torch.cuda.synchronize()
    diff, plain_diff = step_diff(got, ref, kv, ptr, mode), step_diff(f32, ref, kv, ptr, mode)
    dh, step, share, share2, scale_rel, untouched = diff
    limit = bounds(mode, plain_diff)
    say(f"kernel: {name} vs float64 {tag} max|dh_out|={dh:.3e} "
        f"(plain_f32 {plain_diff[0]:.3e}, bound {limit['dh']:.3e}) "
        f"slot_max_step={step:g} (plain_f32 {plain_diff[1]:g}, bound {limit['step']:g}) "
        f"differ={share:.5f} two_steps={share2:.6f} (plain_f32 {plain_diff[3]:.6f}, "
        f"bound {limit['two_steps']:.2e}) scale_rel={scale_rel:.2e} (plain_f32 "
        f"{plain_diff[4]:.2e}, bound {limit['scale_rel']:.2e}) "
        f"other_slots_identical={untouched}")
    if not within_bounds(mode, diff, plain_diff):
        raise AssertionError(f"{name} kernel disagrees with its plain version")
    return dh, dh / limit["dh"]


def float64_cases(engine, wkr_mt, rng, dev):
    """Every genre slab mode's kernel-phase cases (``kernel_cases``), each
    kernel and its float32 plain version run against a float64 run of the
    plain version. Yields (mode, case tag, the kernel's step_diff, the
    float32 plain version's step_diff)."""
    for mode, batches in KERNEL_CASE_BATCHES:
        for B, ptr, kind, kv, blocked, h_in in kernel_cases(engine, rng, dev, batches):
            args = (mode, engine, wkr_mt, kv, blocked, h_in, ptr)
            ref, f32 = plain_step(*args), plain_step(*args, acc=torch.float32)
            got = run_step(*args)
            torch.cuda.synchronize()
            yield (mode, f"B={B} ptr={ptr} ring={kind}", step_diff(got, ref, kv, ptr),
                   step_diff(f32, ref, kv, ptr))


def worse(worst, key, result):
    """Fold check_case's (|dh_out|, |dh_out| / bound) into ``worst[key]``,
    each the largest so far."""
    old = worst.get(key, (0.0, 0.0))
    worst[key] = (max(old[0], result[0]), max(old[1], result[1]))


def kernel_phase(engine, wkr_mt, rng, dev, mode, batches, rows=None, failed=None):
    """``mode``'s kernel on the card against a float64 run of its plain
    version in every case of ``kernel_cases`` (at ``rows`` rows a cell,
    default min(B, 8)); returns the largest |dh_out| and the largest
    |dh_out| over its bound of the cases that passed. A failing case raises,
    or, given a list ``failed``, is said and appended to it, and the next
    case runs."""
    worst = {mode: (0.0, 0.0)}
    for B, ptr, kind, kv, blocked, h_in in kernel_cases(engine, rng, dev, batches, mode):
        args = (mode, engine, wkr_mt, kv, blocked, h_in, ptr)
        tag = f"B={B} R={rows or min(B, 8)} ptr={ptr:3d} ring={kind}"
        try:
            worse(worst, mode, check_case(
                mode, mode, kv, ptr, lambda: run_step(*args, rows=rows),
                lambda acc: plain_step(*args, acc=acc, rows=rows), tag))
        except AssertionError as e:
            if failed is None:
                raise
            say(f"kernel: FAILED {mode} M={engine.cfg.mem_len} {tag}: {e}")
            failed.append(f"{mode} M={engine.cfg.mem_len} {tag}")
    return worst[mode]


def at_mem_len(engine, M):
    """``engine``'s weights under a config whose mem_len is ``M`` (None:
    ``engine`` itself): what kernel_cases, run_step and plain_step read."""
    if M is None:
        return engine
    return SimpleNamespace(cfg=dataclasses.replace(engine.cfg, mem_len=M),
                           params=engine.params, stacked=engine.stacked,
                           stacked_q=engine.stacked_q)


def edge_phase(engine, rng, dev, mode, batches, mem_len, chain, failed=None):
    """kernel_phase of ``mode`` at ``mem_len`` slots (None: the engine's),
    after checking that every B of ``batches`` takes the chain ``chain``
    says (the tensor-core chain, else the old one); ``failed`` as there."""
    eng = at_mem_len(engine, mem_len)
    M = eng.cfg.mem_len
    for B in batches:
        if fd.tc_path(mode, eng.cfg, B, M) != chain:
            raise AssertionError(f"{mode} at B={B} M={M} does not take the chain asked for")
    say(f"kernel: {mode} at M={M}, B in {batches}: the "
        f"{'tensor-core chain' if chain else 'old chain'}")
    return kernel_phase(eng, wkr_table(eng), rng, dev, mode, batches, failed=failed)


def flash_inputs(B, W, pads, H, Dh, dev, seed, right=False):
    """bf16 q, k, v (B, W, H * Dh), wkr (W, H * Dh), u and v biases (H, Dh),
    and a pad mask whose row b is left-padded (``right``: right-padded) by
    pads[b % len(pads)].

    q, k and wkr have std 1.3, so the scores have std ~2.5 and a query's
    softmax peaks on a few keys: a wrong skew, mask, skipped tile or rescale
    moves its output by about |v| (std 1). q and the biases are multiples of
    1/8 with |8 q| <= 200 and |8 u| <= 50, so q + u is exact in bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    HD = H * Dh
    randn = lambda std, *s: torch.randn(*s, generator=g, device=dev) * std
    eighths = lambda std, lim, *s: (torch.round(randn(8 * std, *s)).clamp(-lim, lim)
                                    / 8).to(torch.bfloat16)
    bf = lambda std, *s: randn(std, *s).to(torch.bfloat16)
    pad = torch.zeros((B, W), dtype=torch.bool, device=dev)
    for b in range(B):
        n = pads[b % len(pads)]
        pad[b, W - n if right else 0:W if right else n] = True
    return (eighths(1.3, 200, B, W, HD), bf(1.3, B, W, HD), bf(1.0, B, W, HD),
            bf(1.3, W, HD), eighths(0.5, 50, H, Dh), eighths(0.5, 50, H, Dh), pad)


def flash_check(args, H):
    """The kernel on ``args`` (from flash_inputs) against the float32 plain
    version on the same values. Returns (max |d| on real query rows, the
    largest |d| / (FLASH_RTOL |ref| + FLASH_ATOL) there, every row finite)."""
    pad = args[-1]
    ref = fp.flash_prefill_attention_plain(*[t.float() for t in args[:-1]], pad, H)
    got = fp.flash_prefill_attention(*args, H)
    torch.cuda.synchronize()
    d = (got.float() - ref).abs()[~pad]
    ratio = (d / (FLASH_RTOL * ref.abs()[~pad] + FLASH_ATOL)).max().item()
    return d.max().item(), ratio, bool(torch.isfinite(got.float()).all())


# flash_phase's windows (B, W, pads, d_head; None: the flagship's): the
# batched paths' shapes, the blocked regime, one tile, a tail tile; then
# d_head 128 at the flagship's H * Dh, which runs csrc/flash_prefill.cu's
# kept CUDA-core entry, on a window with a tail tile
FLASH_CASES = ((16, 512, (0, 17, 300), None), (64, 512, (0, 17, 300), None),
               (2, 4096, (0, 1000), None), (1, 128, (0,), None), (8, 96, (0, 17, 50), None),
               (8, 200, (0, 17, 50), 128))


def flash_phase(cfg, dev, seed):
    """The flash prefill kernel against its plain version in FLASH_CASES,
    each through the entry ``fp.prefill_entry`` names for its head width;
    returns the largest error on a real query row and the largest error
    over its bound."""
    worst, worst_ratio = 0.0, 0.0
    HD = cfg.n_heads * cfg.d_head
    for B, W, pads, Dh in FLASH_CASES:
        Dh = Dh or cfg.d_head
        H, entry = HD // Dh, fp.prefill_entry(Dh)
        ran = fp.flash_prefill_attention.entries[entry] + 1
        args = flash_inputs(B, W, pads, H, Dh, dev, seed + B)
        err, ratio, finite = flash_check(args, H)
        say(f"kernel: flash_prefill B={B} W={W} pads={pads} {H}x{Dh} ({entry} entry) real "
            f"rows: max|d| {err:.3e}, max |d| / ({FLASH_RTOL:.3e} |ref| + {FLASH_ATOL}) = "
            f"{ratio:.3f} (must be <= 1); all rows finite={finite}")
        if fp.flash_prefill_attention.entries[entry] != ran:
            raise AssertionError(f"flash prefill at d_head {Dh} did not run its {entry} entry")
        if not (ratio <= 1.0 and finite):
            raise AssertionError("flash prefill kernel disagrees with its plain version")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    return worst, worst_ratio


def cuda_kernel_names(fn, tries: int = 3) -> list:
    """The names of the CUDA kernels ``torch.profiler`` records over two
    calls of ``fn`` (after one warm-up); a window whose records the profiler
    dropped is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages() if e.self_device_time_total > 0})
        if names:
            return names
    return []


def flash_entry_phase(dev, seed):
    """Which kernel of csrc/flash_prefill.cu each causal wrapper launches at
    each head width of ``fp.KERNEL_HEAD_DIMS`` (H x Dh = 512, B 8, W 200):
    the entry the wrapper records and the only CUDA kernel
    ``torch.profiler`` records must both be ``fp.prefill_entry``'s, the
    wgmma kernel at d_head 32 and 64 and the CUDA-core one at 16 and 128.
    These launches do not count as the main path's."""
    before = launches()
    for Dh in fp.KERNEL_HEAD_DIMS:
        H, entry = 512 // Dh, fp.prefill_entry(Dh)
        args = flash_inputs(8, 200, (0, 17, 50), H, Dh, dev, seed + Dh)
        for label, wrapper, call in (
                ("flash_prefill_attention", fp.flash_prefill_attention,
                 lambda: fp.flash_prefill_attention(*args, H)),
                ("flash_encoder_attention[causal]", fp.flash_encoder_attention,
                 lambda: fp.flash_encoder_attention(*args, H, causal=True))):
            ran = dict(wrapper.entries)
            names = cuda_kernel_names(call)
            ran = {k: n - ran[k] for k, n in wrapper.entries.items() if n > ran[k]}
            say(f"kernel: {label} at {H}x{Dh}: entry {ran}, profiler: {names}")
            if set(ran) != {entry} or not names or not all(
                    f"flash_prefill_{entry}_kernel" in k for k in names):
                raise AssertionError(f"{label} at d_head {Dh} did not run only its {entry} "
                                     f"kernel: entries {ran}, profiler {names}")
    set_launches(before)


def window(items, pad_idx, W, dev):
    """The prompts of ``items`` left-padded into a (B, W) window, as the
    engine packs them: (tokens, pad mask)."""
    toks = np.full((len(items), W), pad_idx, dtype=np.int64)
    pad = np.ones((len(items), W), dtype=bool)
    for i, it in enumerate(items):
        data = it.data[-W:]
        toks[i, W - len(data):] = data
        pad[i, W - len(data):] = False
    return torch.from_numpy(toks).to(dev), torch.from_numpy(pad).to(dev)


def cache_diff_by_layer(cache, ref_cache, valid):
    """|d| / |ref| (Frobenius, K and V together) of each layer's cache over
    the valid slots, and the largest |d|."""
    rel, worst = [], 0.0
    for l in range(ref_cache.k.shape[0]):
        got = torch.stack([cache.k[l], cache.v[l]]).float()[:, valid]
        ref = torch.stack([ref_cache.k[l], ref_cache.v[l]]).float()[:, valid]
        rel.append(((got - ref).norm() / ref.norm()).item())
        worst = max(worst, (got - ref).abs().max().item())
    return rel, worst


def prefill_phase(learner, items, dev, W=None):
    """``txl.prefill`` with the flash kernel against its materialized branch
    on the service's prompts at the flagship's full depth (window ``W``,
    default the engine's bucket)."""
    engine = learner.engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    W = W or _bucket(max(len(it.data) for it in items))
    x, pad = window(items, learner.vocab.pad_idx, W, dev)
    ref_logits, ref_cache = txl.prefill(engine.params, cfg, x, pad, flash=False)
    logits, cache = txl.prefill(engine.params, cfg, x, pad, flash=True)
    torch.cuda.synchronize()
    ref_logits, logits = ref_logits.float(), logits.float()
    logit_ok = bool((logits - ref_logits).abs().le(
        PREFILL_LOGITS_ATOL + PREFILL_LOGITS_RTOL * ref_logits.abs()).all())
    same_argmax = bool(torch.equal(logits.argmax(-1), ref_logits.argmax(-1)))
    rel, cache_err = cache_diff_by_layer(cache, ref_cache, ~pad[:, -M:])
    cache_ok = all(r <= l * PREFILL_LAYER_RTOL for l, r in enumerate(rel))
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (logits, cache.k, cache.v))
    same_valid = torch.equal(cache.valid, ref_cache.valid)
    say(f"prefill: txl.prefill flash vs materialized, {len(items)} prompts, W={W}, "
        f"{cfg.n_layers} layers: max|d logits| {(logits - ref_logits).abs().max().item():.3e} "
        f"within atol {PREFILL_LOGITS_ATOL} rtol {PREFILL_LOGITS_RTOL}={logit_ok}, same "
        f"argmax={same_argmax}; cache K/V on valid slots, |d| / |ref| by layer "
        f"{' '.join(f'{r:.2e}' for r in rel)} within l * {PREFILL_LAYER_RTOL:.3e}="
        f"{cache_ok} (max|d| {cache_err:.3e}); finite={finite}; valid equal={same_valid}")
    if not (logit_ok and same_argmax and cache_ok and finite and same_valid):
        raise AssertionError("txl.prefill through the flash kernel disagrees with "
                             "its materialized branch")


def step_bytes_and_flops(cfg, stacked, w_scales, wkr_mt, kv, blocked, B, mode="slab_w8"):
    """Bytes the step must move (inputs read once, outputs written once:
    h_out and the written slot's K / V rows and scales) and its
    multiply-adds counted as 2 operations, split into (bf16 operations,
    int8 operations): the int8-score modes take q.K and P.V in int8."""
    L, D, Dff, H, Dh = cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head
    M, HD = blocked.shape[1], H * Dh
    nbytes = lambda t: 0 if t is None else t.numel() * t.element_size()
    read = (sum(nbytes(t) for t in stacked) + nbytes(w_scales) + nbytes(wkr_mt)
            + sum(nbytes(t) for t in kv) + nbytes(blocked) + B * D * 4)
    slot_bytes = 2 * HD if mode in ("multirow",) + STACK_MODES else HD + 4
    written = B * D * 4 + L * B * 2 * slot_bytes
    weight_ops = 2 * L * B * (D * 3 * HD + HD * D + D * Dff + Dff * D)
    rel_ops = 2 * L * B * H * (M + 1) * Dh
    attn_ops = 2 * L * B * H * 2 * M * Dh                  # q.K and P.V
    if mode in fd.INT8_SCORE_MODES:
        return read + written, (weight_ops + rel_ops, attn_ops)
    return read + written, (weight_ops + rel_ops + attn_ops, 0)


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


def step_kernels(label, fn, n: int = 20):
    """(device ms, kernels recorded) of ``n`` calls of ``fn`` (one wrapper
    call of a persistent multitask step) after 3 warm-ups. The wrapper's
    own launch count must rise by exactly ``n`` (it counts a launch where
    its cooperative launch returned no error, and raises otherwise), and
    ``torch.profiler`` over the synchronized window must record only the
    step kernel, at least once and at most ``n`` times: so each call ran one
    kernel and nothing else. The profiler can drop a window's records, so
    it is not the count; the device ms are those of the kernels it
    recorded."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    before = sum(launches().values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    counted = sum(launches().values()) - before
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    names = sorted({e.key for e in events})
    recorded = sum(e.count for e in events)
    if counted != n:
        raise AssertionError(f"{label}: {n} wrapper calls counted {counted} launches")
    if not 0 < recorded <= n or not all("s2s_step_kernel" in k for k in names):
        raise AssertionError(f"{label}: {n} wrapper calls ran {recorded} CUDA kernels {names}")
    return sum(e.self_device_time_total for e in events) / 1e3, recorded


def one_kernel_line(label, fn, grid: int, n: int = 20) -> float:
    """Checks that each of ``n`` calls of ``fn`` ran one kernel
    (:func:`step_kernels`), says so with the grid, and returns the device
    ms a launch."""
    ms, recorded = step_kernels(label, fn, n)
    say(f"timing: {label} 1 wrapper launch = 1 CUDA kernel ({n} launches counted by the "
        f"wrapper; the profiler recorded {recorded} step kernels and no other kernel), grid "
        f"{grid} blocks, device {ms / recorded:.4f} ms a launch")
    return ms / recorded


def bound(nbytes: float, flops, int8_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak of their type (bf16 ``flops``, ``int8_ops``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS + int8_ops / INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def slab_timing(engine, wkr_mt, rng, dev, name, B, flush, rows=None):
    """CUDA-event medians of ``name``'s kernel (at ``rows`` rows a cell,
    default min(B, 8)) and of its plain version on a full ring at ptr 100,
    beside the bound."""
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, w_scales = weights(engine, name)
    kv, blocked = ring_inputs(cfg, B, M, 100, "full", rng, dev, name)
    h_in = engine.params["embed"].float()[
        torch.from_numpy(rng.integers(12, 140, B)).to(dev)]
    if name == "fused_stack":
        h_in = torch.cat([h_in, torch.zeros((7, cfg.d_model), device=dev)])
    wkr = mode_wkr(name, wkr_mt, cfg.n_heads)
    R = rows or min(B, 8)
    if name in STACK_MODES:
        kernel = lambda: CORES[name](stacked, cfg, h_in, wkr, *kv, blocked, 100, M)
    elif name in MULTIROW_MODES:
        kernel = lambda: CORES[name](stacked, cfg, h_in, wkr, *kv, blocked, 100, M,
                                     rows_per_cell=R)
    else:
        kernel = lambda: CORES[name](stacked, cfg, h_in, wkr, *kv, blocked, 100, M,
                                     rows_per_cell=R, weights_int8=w_scales is not None,
                                     w_scales=w_scales, **SLAB_ARGS.get(name, {}))
    plain = lambda: plain_step(name, engine, wkr_mt, kv, blocked, h_in, 100,
                               acc=torch.float32, rows=R, copy=False)
    ms = time_ms(kernel, 100)
    ms_cold = time_ms(kernel, 50, flush)
    plain_ms = time_ms(plain, 20)
    ms_again = time_ms(kernel, 100)
    nbytes, (flops, int8_ops) = step_bytes_and_flops(cfg, stacked, w_scales, wkr, kv,
                                                     blocked, B, name)
    bound_ms, bound_by = bound(nbytes, flops, int8_ops)
    tc = name in fd.TC_MODES and fd.tc_path(name, cfg, B, M)
    per_step = fd.kernels_per_step(cfg.n_layers, name, tc)
    if per_step != fd.planned_kernels_per_step(cfg.n_layers, name, tc):
        raise AssertionError(f"{name}: the library's kernels a step differ from the plan")
    say(f"timing: {name} B={B} R={R} M={M} kernel median {ms:.4f} ms (again "
        f"{ms_again:.4f}, L2 flushed {ms_cold:.4f}) plain {plain_ms:.4f} ms bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP bf16, "
        f"{int8_ops / 1e6:.1f} MOP int8, by {bound_by}); 1 wrapper launch = "
        f"{per_step} CUDA kernels per step" + (" (tensor-core chain)" if tc else ""))
    recorded, chain = chain_kernels(f"{name} B={B}", kernel, per_step, tc)
    return dict(ms=min(ms, ms_again), plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, chain=chain, kernels_a_step=recorded)


# the kernels of the tensor-core chain (csrc/tc_decode.cuh) of fd.TC_MODES,
# slab_int8's attention three of them
TC_CHAIN_KERNELS = ("tc_product", "group_attention", "tc_layer_norm", "qkv_sum_i8",
                    "group_scores_i8", "pv_i8")


def chain_kernels(label, fn, per_step: int, tc: bool, n: int = 10):
    """The CUDA kernels of ``n`` wrapper calls of a decode step under
    ``torch.profiler``, by name: at most ``per_step`` (the wrapper's count)
    a call; on the tensor-core chain all of them the chain's
    (TC_CHAIN_KERNELS), off it none of them. Says them and returns (the
    kernels recorded a step, the chain their names show: "tensor-core" or
    "old"). The profiler can drop records, so the wrapper's count is the
    count and the profiler shows what ran; a window in which it recorded no
    kernel at all is taken again, up to three windows."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0 and not e.key.startswith(("Memcpy", "Memset")):
                short = next((k for k in TC_CHAIN_KERNELS if re.search(rf"\b{k}\b", e.key)),
                             e.key[:60])
                kernels[short] = kernels.get(short, 0) + e.count
        if kernels:
            break
    recorded = sum(kernels.values())
    chain = "tensor-core" if kernels and set(kernels) <= set(TC_CHAIN_KERNELS) else "old"
    if (not 0 < recorded <= n * per_step or (chain == "tensor-core") != tc
            or (not tc and set(kernels) & set(TC_CHAIN_KERNELS))):
        raise AssertionError(f"{label}: {n} wrapper calls ran {kernels}")
    say(f"timing: {label} {per_step} CUDA kernels a step by the wrapper's count; the "
        f"profiler recorded {recorded} over {n} steps ({recorded / n:g} a step, the "
        f"{chain} chain): " + ", ".join(f"{k} {c / n:g}" for k, c in sorted(kernels.items())))
    return recorded / n, chain


def flash_timing(cfg, dev, B, W, seed):
    """The flash prefill at (B, W) without padding: every causal pair is
    work the data needs."""
    q, k, v, wkr, u, vb, pad = flash_inputs(B, W, (0,), cfg.n_heads, cfg.d_head,
                                            dev, seed)
    H, HD = cfg.n_heads, cfg.n_heads * cfg.d_head
    kernel = lambda: fp.flash_prefill_attention(q, k, v, wkr, u, vb, pad, H)
    plain = lambda: fp.flash_prefill_attention_plain(q, k, v, wkr, u, vb, pad, H)
    ms = time_ms(kernel, 100)
    plain_ms = time_ms(plain, 20)
    ms_again = time_ms(kernel, 100)
    nbytes = 2 * (4 * B * W * HD + W * HD + 2 * HD) + B * W   # q k v out, wkr, u v, pad
    pairs = B * H * W * (W + 1) // 2                              # causal pairs j <= i
    flops = 3 * 2 * pairs * cfg.d_head                            # AC, BD and P.V products
    bound_ms, bound_by = bound(nbytes, flops)
    say(f"timing: flash_prefill B={B} W={W} kernel median {ms:.4f} ms (again "
        f"{ms_again:.4f}) plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP, by {bound_by})")
    return dict(ms=min(ms, ms_again), plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# the explicit modes' kernel checks: (mode, batch sizes, rows a
# cell or None for min(B, 8)), in the order they draw from the rng
MODE_CASE_BATCHES = (("slab_int8", (1, 64), None), ("slab_int8", (64,), 32),
                     ("slab4", (1, 64), None), ("slab4", (64,), 16), ("slab4", (64,), 32),
                     ("slab4_w8", (1, 64), None), ("multirow", (1, 64), None),
                     ("multirow_int8", (1, 64), None), ("slab4_w8", (24,), None),
                     ("multirow_int8", (24,), None), ("slab4", (24,), None),
                     ("slab_int8", (24,), None), ("slab_int8", (24,), 24),
                     ("multirow", (24,), None), ("slab", (8, 24, 64), None))
EXPLICIT_MODES = ("slab_int8", "slab4", "slab4_w8", "multirow", "multirow_int8")
# multirow's edge cases, drawn after MODE_CASE_BATCHES from an rng of their
# own: (mode, batch sizes, mem_len or None for the engine's, whether the
# tensor-core chain serves them). Its chain below 8 rows with 3 live rows in a
# cluster of 4, and 1 beside a whole cluster; and multirow_step, which serves
# the sizes tc_accepts refuses, at M = 520 (not a multiple of 16).
MULTIROW_EDGE_CASES = (("multirow", (3, 5), None, True),
                       ("multirow", (1, 5, 64), 520, False))
# the all-rows steps' cases beyond KERNEL_CASE_BATCHES, drawn after
# MULTIROW_EDGE_CASES from an rng of their own, as edge_phase takes them: the
# tensor-core chain at B = 24 and 72 (a second row group of 8 live rows) and
# slab_ar_w8 at B = 128 (two whole row groups); then the old all-rows chain
# (slab_ar_w8_step / slab_ar_step, gemm_partial), which serves the sizes the
# chain refuses: B = 1 and 4, and B = 8 and 64 at M = 520 (not a multiple of
# 16)
ALLROWS_CHAIN_CASES = (("slab_ar_w8", (24, 72), None, True), ("slab_ar", (24, 72), None, True),
                       ("slab_ar_w8", (128,), None, True))
ALLROWS_EDGE_CASES = (("slab_ar_w8", (1, 4), None, False), ("slab_ar", (1, 4), None, False),
                      ("slab_ar_w8", (8, 64), 520, False), ("slab_ar", (8, 64), 520, False))
# slab_w8's cases beyond KERNEL_CASE_BATCHES (its chain at B = 1 and 4 there),
# drawn after ALLROWS_EDGE_CASES from an rng of their own: its tensor-core
# chain, which serves every B (fd.TC_POLICY), at B = 2 and 8, so that every
# B it was timed at against the old chain is checked; and the old chain
# (slab_w8_step), which serves the sizes the chain refuses, at M = 520 (not a
# multiple of 16)
SLAB_W8_EDGE_CASES = (("slab_w8", (2, 8), None, True), ("slab_w8", (1, 4), 520, False))
# the explicit modes' timed batch sizes: the tensor-core chain's modes
# (fd.TC_MODES) also at 8 and 16, on both sides of its B >= 8 rule (multirow:
# the chain at every B)
MODE_TIMING_BATCHES = {mode: (1, 8, 16, 64) if mode in fd.TC_MODES else (1, 64)
                       for mode in EXPLICIT_MODES}


def timing_phase(engine, wkr_mt, rng, dev, seed, modes_rng):
    """Kernel timings at the main paths' shapes, the int8-weight slab steps
    at every B of the crossover between their weight products (the
    row-tiled GEMV of slab_w8; slab_ar_w8's all-rows GEMM at B < 8, its
    tensor-core chain at B >= 8), and the bf16-weight steps at B = 16 and 64
    (slab and slab_ar also at 8, where the tensor-core chain starts, and
    slab_ar_w8 at 128, its two row groups, drawn last); the explicit modes at B = 1 and
    64 (slab4 also at 16 and 32 rows a cell; the modes of fd.TC_MODES also
    at 8 and 16); the launches made here do not
    count as the main paths'. Returns the timings of the JSON line: slab_w8
    at B = 1; slab_ar_w8 and the flash prefill at B = 16, W = 512 (the
    service's batch); slab and slab_ar at B = 16 (the continuous engine's
    slots); the explicit modes at B = 64 (generate_batch's sweep), their
    inputs drawn from ``modes_rng``."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    before = launches()
    times = {name: {B: slab_timing(engine, wkr_mt, rng, dev, name, B, flush)
                    for B in batches}
             for name, batches in (("slab_w8", (1, 4, 8, 16, 64)),
                                   ("slab_ar_w8", (1, 4, 8, 16, 64)),
                                   ("slab", (16, 64)), ("slab_ar", (16, 64)))}
    times.update({mode: {B: slab_timing(engine, wkr_mt, modes_rng, dev, mode, B, flush)
                         for B in MODE_TIMING_BATCHES[mode]} for mode in EXPLICIT_MODES})
    for R in (16, 32):
        slab_timing(engine, wkr_mt, modes_rng, dev, "slab4", 64, flush, rows=R)
    times["slab"][8] = slab_timing(engine, wkr_mt, modes_rng, dev, "slab", 8, flush)
    times["slab_ar"][8] = slab_timing(engine, wkr_mt, modes_rng, dev, "slab_ar", 8, flush)
    times["slab_ar_w8"][128] = slab_timing(engine, wkr_mt, modes_rng, dev, "slab_ar_w8", 128,
                                           flush)
    flash = {B: flash_timing(engine.cfg, dev, B, 512, seed) for B in (16, 64)}
    flash_timing(engine.cfg, dev, 2, 4096, seed)    # the blocked regime of the TPU kernel
    set_launches(before)
    return {"slab_w8": times["slab_w8"][1], "slab_ar_w8": times["slab_ar_w8"][16],
            "slab": times["slab"][16], "slab_ar": times["slab_ar"][16],
            "flash": flash[16], **{mode: times[mode][64] for mode in EXPLICIT_MODES}}


def prompt_midi(seed: int, vocab, bars: int = 8) -> bytes:
    """``bars`` bars of melody over block chords in a random major key."""
    rng = np.random.default_rng(seed)
    root = 60 + int(rng.integers(-5, 6))
    scale = np.array([0, 2, 4, 5, 7, 9, 11])
    melody, chords = [], []
    bar = 4 * SAMPLE_FREQ
    for b in range(bars):
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


# the multitask wrappers' launch counts, keyed "<prefix><mode>"
MT_WRAPPERS = (("s2s_", fs.fused_s2s_slab_core), ("nw_", fs.fused_nw_slab_core),
               ("s2s_", fs.fused_s2s_step_core), ("nw_", fs.fused_nw_step_core))


# the train attention wrappers' launch counts, keyed "<prefix><fwd|bwd>"
TRAIN_WRAPPERS = {"flash_train_": ftr.flash_train_attention,
                  "flash_bidir_": ftr.flash_bidir_attention,
                  "flash_cross_": ftr.flash_cross_attention}


def launches() -> dict:
    """Every kernel's launch count: the genre slab, multirow and head-major
    (fused_stack, fused_batched) steps, the flash
    prefill, the multitask flash prefill (flash_encoder_bidir,
    flash_encoder_causal), the s2s / nw steps in the slab modes and the fused
    one (s2s_slab_w8, s2s_slab, s2s_fused, nw_slab_w8, nw_slab, nw_fused), and
    the forward and backward of the flash train, bidirectional and cross
    attention (flash_train_fwd, ..., flash_cross_bwd)."""
    return {**fd.fused_slab_core.launches, **fd.fused_slab_allrows_core.launches,
            **fd.fused_multirow_core.launches, **fd.fused_multirow_q_core.launches,
            **fd.fused_stack_decode.launches, **fd.fused_batched_decode.launches,
            "flash_prefill": fp.flash_prefill_attention.launches,
            **{"flash_encoder_" + k: n for k, n in fp.flash_encoder_attention.launches.items()},
            **{prefix + mode: n for prefix, w in MT_WRAPPERS
               for mode, n in w.launches.items()},
            **{prefix + k: n for prefix, w in TRAIN_WRAPPERS.items()
               for k, n in w.launches.items()}}


GENRE_WRAPPERS = (fd.fused_slab_core, fd.fused_slab_allrows_core, fd.fused_multirow_core,
                  fd.fused_multirow_q_core, fd.fused_stack_decode, fd.fused_batched_decode)


def set_launches(counts: dict) -> None:
    for wrapper in GENRE_WRAPPERS:
        for mode in wrapper.launches:
            wrapper.launches[mode] = counts[mode]
    fp.flash_prefill_attention.launches = counts["flash_prefill"]
    for k in fp.flash_encoder_attention.launches:
        fp.flash_encoder_attention.launches[k] = counts["flash_encoder_" + k]
    for prefix, wrapper in MT_WRAPPERS:
        for mode in wrapper.launches:
            wrapper.launches[mode] = counts[prefix + mode]
    for prefix, wrapper in TRAIN_WRAPPERS.items():
        for k in wrapper.launches:
            wrapper.launches[k] = counts[prefix + k]


def reset_launches() -> None:
    set_launches(dict.fromkeys(launches(), 0))


def entries_ran(wrapper, before: dict) -> str:
    """The entries of csrc/flash_prefill.cu that ``wrapper`` launched since
    its record read ``before``, joined by "+"."""
    return "+".join(k for k, n in wrapper.entries.items() if n > before[k])


def only(**nonzero) -> dict:
    """The launch counts of a path that runs only the given kernels."""
    return {**dict.fromkeys(launches(), 0), **nonzero}


def check_continuation(seed_item, pred, vocab, piano_range: bool = True) -> dict:
    """The continuation ``pred`` of ``seed_item`` decodes to a MIDI that
    re-parses, with no grammar violation and, with ``piano_range``, whose
    notes pass the codec's data gate (piano pitch range, duration cap);
    raises otherwise."""
    full = seed_item.append(MusicItem(np.asarray(pred), vocab))
    back = MusicItem.from_file(full.to_midi_bytes(), vocab)
    viol = grammar_violations(pred, vocab, prev_idx=int(seed_item.data[-1]))
    checks = dict(tokens=len(pred), reparsed_tokens=len(back.data),
                  grammar_violations=viol, roundtrip=roundtrip_ok(back.data, vocab),
                  valid_npenc=is_valid_npenc(back.to_npenc(), min_notes=1))
    if not (len(pred) > 0 and back.data[0] == vocab.bos_idx and viol == 0
            and checks["roundtrip"] and (checks["valid_npenc"] or not piano_range)):
        npenc = back.to_npenc()
        pitch = npenc[npenc[:, 0] > VALTSEP, 0]
        outside = pitch[(pitch < PIANO_RANGE[0]) | (pitch >= PIANO_RANGE[1])]
        raise AssertionError(
            f"generated MIDI failed its checks: {checks}, pitches outside the piano range "
            f"{PIANO_RANGE}: {sorted({int(x) for x in outside})}, largest duration "
            f"{int(npenc[:, 1].max(initial=0))}")
    return checks


def check_drawn_row(seed_item, pred, kept, vocab) -> dict:
    """The data gate of a sampled row that drew notes outside the piano
    range. ``kept`` (n_words,) is the plain step's replay of ``pred``
    (``generate_batch(decode_kernel="xla", forced=...)``): whether its filter
    kept each token at its step. Each note outside the piano range must be
    kept there, so the plain sampler could have drawn it at that step. The
    whole row passes ``check_continuation`` without the data gate, and the
    row without those notes (each with the duration and instrument tokens
    that follow it) passes it with the gate on. Raises otherwise; returns
    the checks and the notes held so."""
    lo, hi = vocab.note_range
    pitch = pred - lo
    outside = np.nonzero((pred >= lo) & (pred < hi) & ((pitch < PIANO_RANGE[0])
                                                       | (pitch >= PIANO_RANGE[1])))[0]
    not_kept = [f"step {t} n{pitch[t]}" for t in outside if not kept[t]]
    if not_kept:
        raise AssertionError("notes outside the piano range that the plain step's "
                             f"filter does not keep at their step: {not_kept}")
    checks = check_continuation(seed_item, pred, vocab, piano_range=False)
    drop = []
    for t in outside:
        drop.append(t)
        for after, follows in ((1, vocab.is_duration), (2, vocab.is_ins)):
            if t + after >= len(pred) or not follows(pred[t + after]):
                break
            drop.append(t + after)
    check_continuation(seed_item, np.delete(pred, drop), vocab)
    return dict(checks, outside_kept=[f"step {t} n{pitch[t]}" for t in outside])


def main_path_phase(learner, seed: int, n_words: int):
    vocab = learner.vocab
    midi = prompt_midi(seed, vocab)
    kernel = learner.engine.resolve_kernel(1)
    if kernel != "slab_w8":
        raise AssertionError(f"auto kernel at B=1 is {kernel!r}, expected 'slab_w8'")
    predict_nw_genre(learner, midi, genre="jazz", max_len=8, seed=seed)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    full = predict_nw_genre(learner, midi, genre="jazz", max_len=n_words, seed=seed)
    secs = time.perf_counter() - t0
    counts = launches()
    if counts != only(slab_w8=n_words):
        raise AssertionError(f"B=1 path launched {counts} for {n_words} steps")
    seed_item = MusicItem.from_file(midi, vocab).trim_to_beat(32)
    seed_item = seed_item.set_genre("jazz").remove_eos()
    pred = full.data[len(seed_item.data):]
    checks = check_continuation(seed_item, pred, vocab)
    say(f"main: predict_nw_genre B=1 kernel={kernel} n_words={n_words} "
        f"launches={counts} {checks} {len(pred) / secs:.1f} emitted "
        f"tok/s, {n_words / secs:.1f} steps/s ({secs:.3f} s incl. prefill)")
    return counts["slab_w8"]


GENRES = ("jazz", "pop", "rock", "folk", "funk", "electronic")
# the sampling settings predict_nw_genre hands the engine
GEN_KW = dict(temperatures=(1.8, 1.8, 1.0), top_k=30, top_p=0.65, min_bars=12)


def batch_prompts(vocab, seed: int, n: int):
    """n genre-prefixed prompts of 300-512 tokens (so W = 512): nine bars."""
    items = []
    for i in range(n):
        item = MusicItem.from_file(prompt_midi(seed + 1 + i, vocab, bars=9), vocab)
        item = item.set_genre(GENRES[i % len(GENRES)]).remove_eos()
        if not 300 <= len(item.data) <= 512:
            raise AssertionError(f"prompt {i} has {len(item.data)} tokens")
        items.append(item)
    return items


def batched_phase(learner, items, seed: int, n_words: int):
    """The first 16 of ``items`` as requests to the service, then one
    generate_batch of all 64. Returns the service's launch counts and the
    generate_batch rows that failed their checks."""
    vocab, engine = learner.vocab, learner.engine
    M = engine.cfg.mem_len
    if (engine.resolve_kernel(16), engine.resolve_kernel(64)) != ("slab_ar_w8",) * 2:
        raise AssertionError("the auto kernel at B = 16 / 64 is not slab_ar_w8")
    W = min(_bucket(max(len(it.data) for it in items)), max(engine.cfg.ctx_len, M))
    engine.generate_batch([it.data for it in items[:16]], n_words=8, seed=seed,
                          **GEN_KW)                                # warm-up
    torch.cuda.synchronize()

    service = GenerationService(learner, max_batch=16, max_wait_s=1.0)
    try:
        reset_launches()
        t0 = time.perf_counter()
        futs = [service.submit(it.data, n_words=n_words, seed=seed, **GEN_KW)
                for it in items[:16]]
        preds = [f.result(timeout=600) for f in futs]
        secs = time.perf_counter() - t0
        counts = launches()
    finally:
        service.close()
    if service.batch_sizes != [(16, 16)]:
        raise AssertionError(f"service batches {service.batch_sizes}, expected one of 16")
    want = only(slab_ar_w8=n_words, flash_prefill=engine.cfg.n_layers)
    if counts != want:
        raise AssertionError(f"service batch launched {counts}, expected {want}")
    checks = [check_continuation(it, p, vocab) for it, p in zip(items, preds)]
    emitted = sum(len(p) for p in preds)
    say(f"batch: GenerationService 16 requests -> batches {service.batch_sizes} W={W} "
        f"M={M} n_words={n_words} launches={counts}; all 16 re-parse, grammar "
        f"violations {sum(c['grammar_violations'] for c in checks)}, emitted "
        f"{emitted} tokens: {emitted / secs:.1f} emitted tok/s, "
        f"{n_words / secs:.1f} steps/s ({secs:.3f} s incl. prefill)")
    service_counts = counts

    reset_launches()
    t0 = time.perf_counter()
    toks, lengths = engine.generate_batch([it.data for it in items], n_words=n_words,
                                          seed=seed, **GEN_KW)
    secs = time.perf_counter() - t0
    counts = launches()
    if counts != want:
        raise AssertionError(f"generate_batch B=64 launched {counts}, expected {want}")
    # No engine masks pitch, so a sampled row may draw a note outside the
    # piano range. A row that fails check_continuation is replayed through
    # the plain step (xla, no kernel) and held to check_drawn_row: each such
    # note must be one the plain sampler could have drawn at its step. A row
    # that fails that does not stop the phases after this one, which hold
    # other kernels and paths; main fails the run at its end.
    checks, drawn, held, failed = [], {}, [], []
    for i, it in enumerate(items):
        try:
            checks.append(check_continuation(it, toks[i][: lengths[i]], vocab))
        except AssertionError as e:
            drawn[i] = str(e)
    if drawn:
        rows = sorted(drawn)
        kept, _ = engine.generate_batch([items[i].data for i in rows], n_words=n_words,
                                        seed=seed, decode_kernel="xla", forced=toks[rows],
                                        **GEN_KW)
        for j, i in enumerate(rows):
            try:
                checks.append(check_drawn_row(items[i], toks[i][: lengths[i]], kept[j], vocab))
                held.append(f"row {i}: {checks[-1]['outside_kept']}")
            except AssertionError as e:
                failed.append(f"row {i}: {drawn[i]}; replayed on the plain step: {e}")
    emitted = int(lengths.sum())
    say(f"batch: generate_batch B=64 W={W} n_words={n_words} launches={counts}; "
        + (f"{len(failed)} of 64 rows FAILED their checks: {failed}; " if failed else
           f"all 64 re-parse, grammar violations "
           f"{sum(c['grammar_violations'] for c in checks)}, ")
        + (f"notes outside the piano range, each kept by the plain step's filter at "
           f"its step (replayed): {held}; " if held else "")
        + f"emitted {emitted} tokens: "
        f"{emitted / secs:.1f} emitted tok/s, {n_words / secs:.1f} steps/s "
        f"({secs:.3f} s incl. prefill)")
    return service_counts, failed


def continuous_requests(items, seed: int):
    """32 requests over ``items`` with mixed budgets (64-256 tokens) and
    sampling settings: greedy and sampled, top_k 30 / 10 / 0 / 50, top_p
    0.65 / 0.9 / 0.3 / 0 (off), three temperatures or a (note, duration)
    pair, min_bars 12 or 4."""
    temps = ((1.8, 1.8, 1.0), (1.2, 1.5), (1.0, 1.0, 1.0), (2.0, 1.4))
    return [(items[i % len(items)], dict(
        n_words=(64, 128, 192, 256)[i % 4], greedy=i % 3 == 0,
        top_k=(30, 10, 0, 50)[i % 4], top_p=(0.65, 0.9, 0.3, 0.0)[i // 4 % 4],
        temperatures=temps[i // 2 % 4], min_bars=(12, 4)[i % 2], seed=seed + i))
        for i in range(32)]


def continuous_phase(learner, items, seed: int):
    """The continuous service with the auto kernel (slab) on 16 slots: 32
    requests in four waves of 8, 0.2 s apart, so later waves join a busy
    resident batch and queue for slots. Then one greedy and one sampled
    request of the second wave are decoded alone on a fresh engine and must
    equal their in-batch tokens. Returns the slab launch count."""
    vocab = learner.vocab
    reqs = continuous_requests(items, seed)
    engine = ContinuousEngine(learner.params, learner.cfg, vocab, n_slots=16, chunk=32)
    if engine.kernel != "slab":
        raise AssertionError(f"the continuous auto kernel is {engine.kernel!r}, "
                             "expected 'slab'")
    engine.generate(items[0].data, n_words=32, seed=seed)        # warm-up
    torch.cuda.synchronize()
    service = ContinuousGenerationService(engine=engine)
    try:
        reset_launches()
        t0 = time.perf_counter()
        futs = []
        for wave in range(4):
            futs += [service.submit(it.data, **kw) for it, kw in reqs[8 * wave:8 * wave + 8]]
            time.sleep(0.2)
        preds = [f.result(timeout=600) for f in futs]
        secs = time.perf_counter() - t0
        counts = launches()
    finally:
        service.close()
    steps = counts["slab"]
    if counts != only(slab=steps) or steps == 0:
        raise AssertionError(f"continuous service launched {counts}")
    # a draw from the whole distribution (no top-k, no top-p) may leave the
    # piano range; those requests' notes are counted, all others must pass
    checks = [check_continuation(it, p, vocab, piano_range=kw["greedy"] or
                                 kw["top_k"] > 0 or kw["top_p"] > 0)
              for (it, kw), p in zip(reqs, preds)]
    emitted = sum(len(p) for p in preds)
    say(f"continuous: ContinuousGenerationService 16 slots, chunk 32, kernel "
        f"{engine.kernel}: {len(reqs)} requests in 4 waves (n_words 64-256, "
        f"{sum(kw['greedy'] for _, kw in reqs)} greedy, mixed top_k/top_p/temperatures) "
        f"launches={counts}; all re-parse, grammar violations "
        f"{sum(c['grammar_violations'] for c in checks)}, outside the piano range or "
        f"duration cap {sum(not c['valid_npenc'] for c in checks)}; {steps} steps in "
        f"{secs:.3f} s: {steps / secs:.1f} steps/s, {emitted} emitted tokens, "
        f"{emitted / secs:.1f} emitted tok/s")
    solo_engine = ContinuousEngine(learner.params, learner.cfg, vocab, n_slots=16, chunk=32)
    for i in (9, 10):                     # greedy and sampled, second wave
        it, kw = reqs[i]
        alone = solo_engine.generate(it.data, **kw)
        same = np.array_equal(alone, preds[i])
        say(f"continuous: request {i} ({'greedy' if kw['greedy'] else 'sampled'}, "
            f"{len(preds[i])} tokens) decoded alone equals its in-batch tokens: {same}")
        if not same:
            raise AssertionError(f"request {i} differs when decoded alone")
    return steps


def slab_ar_phase(learner, items, seed: int):
    """A short continuous run with the explicit all-rows bf16 kernel."""
    reqs = [(it, dict(kw, n_words=64)) for it, kw in continuous_requests(items, seed)[:8]]
    engine = ContinuousEngine(learner.params, learner.cfg, learner.vocab, n_slots=16,
                              chunk=32, decode_kernel="slab_ar")
    engine.generate(items[0].data, n_words=32, seed=seed)        # warm-up
    torch.cuda.synchronize()
    service = ContinuousGenerationService(engine=engine)
    try:
        reset_launches()
        t0 = time.perf_counter()
        preds = [f.result(timeout=600) for f in
                 [service.submit(it.data, **kw) for it, kw in reqs]]
        secs = time.perf_counter() - t0
        counts = launches()
    finally:
        service.close()
    steps = counts["slab_ar"]
    if counts != only(slab_ar=steps) or steps == 0:
        raise AssertionError(f"explicit slab_ar run launched {counts}")
    checks = [check_continuation(it, p, learner.vocab) for (it, _), p in zip(reqs, preds)]
    say(f"continuous: explicit slab_ar, 8 requests of 64 tokens, launches={counts}; all "
        f"re-parse, grammar violations {sum(c['grammar_violations'] for c in checks)}; "
        f"{steps / secs:.1f} steps/s")
    return steps


# the explicit modes' path runs of 64 prompts: (decode_kernel, rows_per_cell
# or None for the default 8, kv_int8), as bench.py sweeps generate_batch
PATH_RUNS = (("slab_int8", None, False), ("slab4", 8, False), ("slab4", 16, False),
             ("slab4", 32, False), ("slab4_w8", None, False), ("multirow", None, False),
             ("multirow_int8", None, False), ("xla", None, True))


def explicit_modes_phase(learner, items, seed: int, n_words: int) -> dict:
    """``generate_batch`` of the 64 prompts (W = 512, ``n_words`` steps) with
    each run of PATH_RUNS: one launch of its kernel a step and the flash
    prefill once a layer (xla with kv_int8: the prefill only); then
    ``generate`` of one prompt at B = 1 with each explicit mode, one launch
    a step. Every output re-parses and passes the codec's checks. Returns
    the launch counts summed over the runs."""
    vocab, engine = learner.vocab, learner.engine
    L, M = engine.cfg.n_layers, engine.cfg.mem_len
    seqs = [it.data for it in items]
    W = min(_bucket(max(len(s) for s in seqs)), max(engine.cfg.ctx_len, M))
    total = dict.fromkeys(launches(), 0)

    def run(label, fn, want):
        fn(8)                                                    # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn(n_words)
        secs = time.perf_counter() - t0
        counts = launches()
        if counts != want:
            raise AssertionError(f"{label} launched {counts}, expected {want}")
        for key, n in counts.items():
            total[key] += n
        return out, secs, counts

    for kernel, rows, kv_int8 in PATH_RUNS:
        kw = dict(decode_kernel=kernel, rows_per_cell=rows, kv_int8=kv_int8, seed=seed,
                  **GEN_KW)
        label = f"generate_batch B=64 {kernel} r={rows or 8} kv_int8={kv_int8}"
        want = only(flash_prefill=L, **({} if kernel == "xla" else {kernel: n_words}))
        (toks, lengths), secs, counts = run(
            label, lambda n: engine.generate_batch(seqs, n_words=n, **kw), want)
        checks = [check_continuation(it, toks[i][: lengths[i]], vocab)
                  for i, it in enumerate(items)]
        emitted = int(lengths.sum())
        say(f"modes: {label} W={W} n_words={n_words} launches={counts[kernel] if kernel != 'xla' else 0} "
            f"{kernel if kernel != 'xla' else 'kernel'} + {counts['flash_prefill']} "
            f"flash_prefill; all 64 re-parse, grammar violations "
            f"{sum(c['grammar_violations'] for c in checks)}, emitted {emitted} tokens: "
            f"{emitted / secs:.1f} emitted tok/s, {n_words / secs:.1f} steps/s "
            f"({secs:.3f} s incl. prefill)")
    for kernel in EXPLICIT_MODES:
        item = items[0]
        pred, secs, _ = run(f"generate B=1 {kernel}", lambda n: engine.generate(
            item.data, n_words=n, decode_kernel=kernel, seed=seed, **GEN_KW),
            only(**{kernel: n_words}))
        checks = check_continuation(item, pred, vocab)
        say(f"modes: generate B=1 {kernel} n_words={n_words} launches={n_words} {checks} "
            f"{len(pred) / secs:.1f} emitted tok/s, {n_words / secs:.1f} steps/s "
            f"({secs:.3f} s incl. prefill)")
    return total


# ---------------------------------------------------------------------------
# Row 10: fused_stack_decode / fused_batched_decode (csrc/multirow_decode.cu),
# which no engine mode reaches, on the path of the JAX package's tests, and
# the int8-score slab step over int8 weight panels (slab_int8_w8), which no
# path runs
# ---------------------------------------------------------------------------

# (mode, batch sizes) of the row-10 kernel checks, in the order they draw from
# their rng; slab_int8_w8 with its own two-step cap (TWO_STEP_SHARE_CAP_BY_MODE)
ROW10_CASE_BATCHES = (("fused_stack", (1,)), ("fused_batched", (1, 16, 64)),
                      ("slab_int8_w8", (1, 64)))
# row 10's edge cases, drawn after ROW10_CASE_BATCHES from an rng of their own,
# as edge_phase takes them: the tensor-core chain (which serves every B,
# fd.TC_POLICY) at B = 3 and 5, clusters of 4 rows with padded ones; and the
# old chain (fused_batched_step), which serves the sizes the chain refuses, at
# M = 520 (not a multiple of 16), B in {1, 5, 64}
ROW10_EDGE_CASES = (("fused_batched", (3, 5), None, True),
                    ("fused_batched", (1, 5, 64), 520, False))
# The stack phase's gate. Row 10's path is driven by the float64 plain step,
# ``fd.stack_plain(acc=float64)``: the TPU kernel's own function (tanh GELU,
# its bf16 cast points) with float64 between the cast points. It chooses the
# tokens and its slot writes make the caches; at every step the wrapper and
# the float32 plain step run on copies of those caches, and the wrapper is
# held in the float64 check's form (``bounds``): its largest |dlogit| from the
# float64 step at most STACK_F64_ATOL + PLAIN_K x the float32 plain step's on
# the same step. STACK_F64_ATOL is H_ATOL's logit image at the flagship's
# widths: h_out drifting by H_ATOL in each of its d_model = 512 entries with
# independent signs moves a logit h . E[v] by about H_ATOL ||E[v]||_2, and
# ||E[v]||_2 ~ sqrt(512) x 0.0452 (the rms of the 41M checkpoint's embedding)
# = 1.02: 5e-2 x 1.02 = 0.051, taken as 0.05, below the 0.08 of the JAX
# test's bound.
STACK_F64_ATOL = 0.05
# The exact ring step (``txl.decode_step_ring``: erf GELU, bf16 activations,
# another function) is reported, not gated: its logits against the float64
# step's, the wrapper's and the float32 plain step's, as a share of the JAX
# test's one-step bound (tests/test_fused_decode.py), elementwise
# |d| <= atol + rtol |exact|. The float64 run of the TPU kernel's own
# function leaves that bound on 3 of 6 256-step paths (PERF.md), so as a gate
# it passed or failed a faithful step by its rounding draw.
STACK_LOGITS_ATOL, STACK_LOGITS_RTOL = 0.08, 0.02


def row10_kernel_phase(engine, wkr_mt, rng, dev, seed) -> dict:
    """ROW10_CASE_BATCHES through kernel_phase (the float64 check at ptr in
    kernel_ptrs on each kind of RINGS), then ROW10_EDGE_CASES through
    edge_phase from an rng of ``seed``. Every case runs: a failing one is
    said and recorded, and the phase raises at its end, naming them all.
    Returns each mode's largest |dh_out| and |dh_out| over its bound."""
    worst, failed = {}, []
    for mode, batches in ROW10_CASE_BATCHES:
        worse(worst, mode, timed(f"kernel {mode} B in {batches}", kernel_phase, engine,
                                 wkr_mt, rng, dev, mode, batches, failed=failed))
    edge_rng = np.random.default_rng(seed)
    for mode, batches, M, chain in ROW10_EDGE_CASES:
        worse(worst, mode, timed(f"kernel {mode} B in {batches} M {M or 'mem_len'}",
                                 edge_phase, engine, edge_rng, dev, mode, batches, M, chain,
                                 failed=failed))
    if failed:
        raise AssertionError(f"row 10: {len(failed)} case(s) failed: {failed}")
    say("kernel: fused_stack returned rows 1-7 of its h block bit for bit in every case")
    return worst


def row10_timing_phase(engine, wkr_mt, rng, dev) -> dict:
    """CUDA-event medians of fused_stack_decode at B = 1, fused_batched_decode
    at B = 1, 16 and 64 and slab_int8_w8 at B = 1 and 64 (M = 512), and of
    their plain versions, beside the bound; these launches do not count as
    the path's. Returns the timings of the JSON line: fused_stack at B = 1,
    fused_batched at B = 16 (the path's batch), slab_int8_w8 at B = 64."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    before = launches()
    times = {(name, B): slab_timing(engine, wkr_mt, rng, dev, name, B, flush)
             for name, batches in (("fused_stack", (1,)), ("fused_batched", (1, 16, 64)),
                                   ("slab_int8_w8", (1, 64)))
             for B in batches}
    set_launches(before)
    return {"fused_stack": times["fused_stack", 1],
            "fused_batched": times["fused_batched", 16],
            "slab_int8_w8": times["slab_int8_w8", 64]}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def stack_start(learner, items, n_words: int) -> SimpleNamespace:
    """The path of the JAX package's tests of row 10 (tests/test_fused_decode.py)
    up to its first of ``n_words`` steps, for the prompts ``items``: ``txl.prefill`` (its auto
    rule: the flash kernel at B >= 8 on the card), ``ring_from_prefill``,
    ``precompute_wkr``, ``stack_txl_layers`` and the transposed bf16 caches,
    and the greedy sampler's state (``sample_next_token`` with the grammar
    mask). Rows 1-7 of the single-stream step's 8-row h block are N(0, 1)
    draws, so that a step that changes them shows."""
    engine, vocab = learner.engine, learner.vocab
    params, cfg, dev = engine.params, engine.cfg, engine.device
    M, B = cfg.mem_len, len(items)
    W = min(_bucket(max(len(it.data) for it in items)), max(cfg.ctx_len, M))
    toks = np.full((B, W), vocab.pad_idx, dtype=np.int64)
    pad = np.ones((B, W), dtype=bool)
    pos = np.zeros((B, W), dtype=np.int32)
    for i, it in enumerate(items):
        s = np.asarray(it.data)[-W:]
        toks[i, W - len(s):], pad[i, W - len(s):] = s, False
        pos[i, W - len(s):] = position_enc(s, vocab)[:len(s)]
    last_pos = torch.from_numpy(pos[:, -1].copy()).to(dev).int()
    window = torch.from_numpy(toks).to(dev)
    logits, cache0 = txl.prefill(params, cfg, window, torch.from_numpy(pad).to(dev),
                                 pos=torch.from_numpy(pos).to(dev), mem_len=M)
    ring = txl.ring_from_prefill(cache0, cfg)
    wkr = txl.precompute_wkr(params, cfg, M)
    zeros = lambda dt: torch.zeros((B,), dtype=dt, device=dev)
    head_b = params.get("head_b")
    return SimpleNamespace(
        engine=engine, cfg=cfg, dev=dev, B=B, M=M, logits=logits, g=ring.g, ptr=ring.ptr,
        g_cur=ring.g_cur, exact=ring._replace(k=ring.k.clone(), v=ring.v.clone(),
                                              g=ring.g.clone()),
        wkr=wkr, stacked=engine.stacked()[0],                    # stack_txl_layers
        kt=ring.k.transpose(3, 4).to(torch.bfloat16).contiguous(),  # (L, B, H, Dh, M)
        vc=ring.v.to(torch.bfloat16).contiguous(),                  # (L, B, H, M, Dh)
        wkr_t=wkr.transpose(2, 3).to(torch.bfloat16).contiguous(),  # (L, H, Dh, M+1)
        n_words=n_words,
        settings=SamplerSettings(n_words=n_words, top_k=GEN_KW["top_k"], greedy=True),
        temps=torch.tensor(GEN_KW["temperatures"], dtype=torch.float32, device=dev),
        allowed=torch.from_numpy(grammar.allowed_ins_mask(vocab, None)).to(dev),
        top_k=torch.full((B,), GEN_KW["top_k"], dtype=torch.long, device=dev),
        top_p=torch.full((B,), GEN_KW["top_p"], dtype=torch.float32, device=dev),
        st=SampleState(prev_tok=window[:, -1].int(), last_pos=last_pos, start_pos=last_pos,
                       last_xxsep=zeros(torch.bool), repeat_count=zeros(torch.int32),
                       done=zeros(torch.bool), n_emitted=zeros(torch.int32)),
        embed32=params["embed"].float(),
        head_b=0.0 if head_b is None else head_b.float(),
        rows17=normal((7, cfg.d_model), 1.0, np.random.default_rng(0), dev))


def stack_next(s, logits, i: int):
    """Step ``i`` on the path ``s``: the greedy token from ``logits`` (the
    sampler's state advances), the blocked mask of the ring and the step's
    h_in (at B = 1 the 8-row block, the token in row 0)."""
    idx, s.st = sample_next_token(logits, s.st, s.engine.tables, s.temps, s.top_k, s.top_p,
                                  GEN_KW["min_bars"], s.allowed, None, s.settings,
                                  _past_80pct(i, s.n_words))
    blocked = ((s.g_cur - s.g < 1) | (s.g_cur - s.g > s.M)).int()
    h_in = s.embed32[idx.long()]
    return idx, blocked, torch.cat([h_in, s.rows17]) if s.B == 1 else h_in


def stack_advance(s) -> None:
    """The ring's pointer after a step: slot ptr now holds position g_cur."""
    s.g[:, s.ptr] = s.g_cur
    s.ptr, s.g_cur = (s.ptr + 1) % s.M, s.g_cur + 1


def stack_mode(B: int) -> str:
    return "fused_stack" if B == 1 else "fused_batched"


def stack_path(learner, items, n_words: int):
    """Row 10's path as a user would run it, for the prompts ``items``:
    stack_start, then ``n_words`` free-running greedy steps of one launch
    each (fused_stack_decode at B = 1, fused_batched_decode otherwise), each
    token chosen from h_out @ embed.T + head_b. No reference step runs.
    Returns (tokens (n_words, B), emitted (B,), seconds of the step loop,
    seconds with the prefill)."""
    t0 = time.perf_counter()
    s = stack_start(learner, items, n_words)
    core = CORES[stack_mode(s.B)]
    out = torch.empty((n_words, s.B), dtype=torch.int32, device=s.dev)
    logits = s.logits
    sync(s.dev)
    t1 = time.perf_counter()
    for i in range(n_words):
        idx, blocked, h_in = stack_next(s, logits, i)
        out[i] = idx
        h_out = core(s.stacked, s.cfg, h_in, s.wkr_t, s.kt, s.vc, blocked, s.ptr, s.M)[0]
        logits = h_out[:s.B] @ s.embed32.T + s.head_b
        stack_advance(s)
    sync(s.dev)
    t2 = time.perf_counter()
    return out.cpu().numpy(), s.st.n_emitted.cpu().numpy(), t2 - t1, t2 - t0


def stack_fixed_path(learner, items, n_words: int, step=None) -> dict:
    """Row 10's path for the prompts ``items`` driven by the float64 plain
    step, the stack phase's gate at every step (see STACK_F64_ATOL):
    ``step`` (default the wrapper, fused_stack_decode at B = 1 and
    fused_batched_decode otherwise; any function of their arguments) and the
    float32 plain step each run once on copies of the float64 step's caches.
    The step is held to the float64 step:
    - logits: its largest |dlogit| at most STACK_F64_ATOL + PLAIN_K x the
      float32 plain step's;
    - argmax: equal to float64's on every row whose float64 top two are more
      than twice that logit bound apart;
    - slot writes: step_diff's largest step of the slot it wrote, every
      layer, within SLOT_MAX_STEP + PLAIN_K x the float32 plain step's, and
      every other slot byte-identical (its copies are thrown away after the
      step, so its logits cannot show a wrong write);
    - at B = 1, rows 1-7 of its h block returned bit for bit.
    The exact ring step keeps its own ring, fed the same tokens: its logits
    against each step's are reported as a share of STACK_LOGITS_ATOL / RTOL
    and gate nothing. Returns the worst figures of each kind over the path
    and ``failures``, one line a failing step."""
    s = stack_start(learner, items, n_words)
    B, M, mode = s.B, s.M, stack_mode(s.B)
    step = step or CORES[mode]
    E64 = s.embed32.double()
    hb64 = s.head_b.double() if torch.is_tensor(s.head_b) else s.head_b
    plain = lambda h_in, blocked, acc: fd.stack_plain(
        s.stacked, s.cfg, h_in, s.wkr_t, s.kt.clone(), s.vc.clone(), blocked, s.ptr, acc=acc)
    res = dict(logit_ratio=0.0, kernel_d=0.0, plain32_d=0.0, slot_ratio=0.0, slot_step=0.0,
               two_steps=0.0, flip_gap=None, flips=0, failures=[],
               exact={k: 0.0 for k in ("plain64", "kernel", "plain32")})
    out = torch.empty((n_words, B), dtype=torch.int32, device=s.dev)
    logits = s.logits
    for i in range(n_words):
        idx, blocked, h_in = stack_next(s, logits, i)
        out[i] = idx
        kv = [s.kt, s.vc]
        got = step(s.stacked, s.cfg, h_in, s.wkr_t, s.kt.clone(), s.vc.clone(), blocked,
                   s.ptr, M)
        f32, ref = plain(h_in, blocked, torch.float32), plain(h_in, blocked, torch.float64)
        sync(s.dev)
        lg = {"plain64": ref[0][:B].double() @ E64.T + hb64,
              "kernel": (got[0][:B] @ s.embed32.T + s.head_b).double(),
              "plain32": (f32[0][:B] @ s.embed32.T + s.head_b).double()}
        l64 = lg["plain64"]
        dk = (lg["kernel"] - l64).abs().max().item()
        d32 = (lg["plain32"] - l64).abs().max().item()
        limit = STACK_F64_ATOL + PLAIN_K * d32
        res["kernel_d"], res["plain32_d"] = max(res["kernel_d"], dk), max(res["plain32_d"], d32)
        res["logit_ratio"] = max(res["logit_ratio"], dk / limit)
        fails = [f"|dlogit| {dk:.4e} > {limit:.4e}"] if dk > limit else []
        top2 = l64.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        differ = lg["kernel"].argmax(-1) != l64.argmax(-1)
        if differ.any():
            g_min = gap[differ].min().item()
            res["flips"] += int(differ.sum())
            res["flip_gap"] = g_min if res["flip_gap"] is None else min(res["flip_gap"], g_min)
            g_max = gap[differ].max().item()        # every differing row is held
            if g_max > 2 * limit:
                fails.append(f"argmax differs at top-two gap {g_max:.4e} > {2 * limit:.4e}")
        diff, pdiff = step_diff(got, ref, kv, s.ptr, mode), step_diff(f32, ref, kv, s.ptr, mode)
        slot_limit = SLOT_MAX_STEP[mode] + PLAIN_K * pdiff[1]
        res["slot_step"] = max(res["slot_step"], diff[1])
        res["slot_ratio"] = max(res["slot_ratio"], diff[1] / slot_limit)
        res["two_steps"] = max(res["two_steps"], diff[3])
        if diff[1] > slot_limit:
            fails.append(f"written slot {diff[1]:.3g} steps off > {slot_limit:g}")
        if not diff[5]:
            fails.append("another slot's bytes changed")
        if B == 1 and not torch.equal(got[0][1:], h_in[1:]):
            fails.append("rows 1-7 of the h block changed")
        if fails:
            res["failures"].append(f"step {i} ptr {s.ptr}: " + "; ".join(fails))
        e, s.exact = txl.decode_step_ring(s.engine.params, s.cfg, idx, s.st.last_pos, s.exact,
                                          s.wkr)
        e = e.double()
        for k, lgk in lg.items():
            share = ((lgk - e).abs() / (STACK_LOGITS_ATOL + STACK_LOGITS_RTOL * e.abs())).max()
            res["exact"][k] = max(res["exact"][k], share.item())
        s.kt, s.vc = ref[1], ref[2]
        logits = l64.float()
        stack_advance(s)
    sync(s.dev)
    res["tokens"] = out.cpu().numpy()
    return res


def stack_path_phase(learner, items, n_words: int) -> dict:
    """Row 10's path for one prompt at B = 1 (materialized prefill) and for
    the batch cell's 16 prompts at B = 16 (flash prefill, one launch a
    layer): ``stack_path``, the main path, ``n_words`` steps of one launch
    each, every continuation re-parsed with no grammar violation, its
    steps/s from that run alone; then ``stack_fixed_path``'s gate at every
    step, the exact ring step's shares beside it. Returns the main path's
    launch counts {"fused_stack": ..., "fused_batched": ...}."""
    L = learner.cfg.n_layers
    counts = {}
    for mode, batch in (("fused_stack", items[:1]), ("fused_batched", items[:16])):
        stack_path(learner, batch, 8)                             # warm-up
        sync(learner.engine.device)
        want = only(**{mode: n_words}, **({} if len(batch) == 1 else {"flash_prefill": L}))
        reset_launches()
        toks, emitted, loop_secs, secs = stack_path(learner, batch, n_words)
        got = launches()
        if got != want:
            raise AssertionError(f"{mode} path launched {got}, expected {want}")
        checks = [check_continuation(it, toks[: emitted[b], b], learner.vocab)
                  for b, it in enumerate(batch)]
        say(f"stack: {mode} B={len(batch)} n_words={n_words} launches={got[mode]} "
            f"(+ {got['flash_prefill']} flash_prefill); all {len(batch)} re-parse, grammar "
            f"violations {sum(c['grammar_violations'] for c in checks)}, emitted "
            f"{int(emitted.sum())} tokens; {n_words / loop_secs:.1f} steps/s (the kernel "
            f"alone, {loop_secs:.3f} s; {secs:.3f} s with the prefill)")
        reset_launches()
        t0 = time.perf_counter()
        res = stack_fixed_path(learner, batch, n_words)
        gate_secs = time.perf_counter() - t0
        if launches() != want:
            raise AssertionError(f"{mode} gate launched {launches()}, expected {want}")
        flip = "never" if res["flip_gap"] is None else \
            f"{res['flips']} row-steps, smallest top-two gap {res['flip_gap']:.4f}"
        say(f"stack: {mode} B={len(batch)} gate vs the float64 plain step, {n_words} steps "
            f"driven by it ({gate_secs:.3f} s with the float64 and float32 plain steps and "
            f"the exact step): max |dlogit| {res['kernel_d']:.4e} (plain_f32 "
            f"{res['plain32_d']:.4e}), {res['logit_ratio']:.3f} of its bound (atol "
            f"{STACK_F64_ATOL} + {PLAIN_K:g} x plain_f32's, each step); argmax differs: "
            f"{flip} (bound: agree above twice the step's logit bound); written slot "
            f"{res['slot_step']:.3g} steps off, {res['slot_ratio']:.3f} of its bound, "
            f"two-step share {res['two_steps']:.2e}; failing steps {len(res['failures'])}")
        ex = res["exact"]
        say(f"stack: {mode} B={len(batch)} the exact ring step's distance (reported, gates "
            f"nothing): largest share of (atol {STACK_LOGITS_ATOL}, rtol {STACK_LOGITS_RTOL}) "
            f"against the float64 step {ex['plain64']:.3f}, the kernel {ex['kernel']:.3f}, "
            f"plain_f32 {ex['plain32']:.3f}")
        if res["failures"]:
            raise AssertionError(f"{mode} path failed its gate at {len(res['failures'])} "
                                 f"step(s): {res['failures'][:8]}")
        counts[mode] = got[mode]
    return counts


# ---------------------------------------------------------------------------
# The multitask slice: the s2s / nw slab step (csrc/s2s_slab.cu) and the
# harmonize, next-word and remix paths on the 85M flagship's widths
# ---------------------------------------------------------------------------

MT_TASKS = ("s2s", "nw")
MT_MODES = ("slab_w8", "slab")
MT_LE = (64, 512, 1024)          # flagship cross-context lengths of the kernel phase


def mt_load_phase(dev, seed: int):
    """The trained demo multitask checkpoint through the port's reader, and
    the 85M flagship's shapes with weights from ``init_multitask`` drawn on
    the card from ``seed``."""
    t0 = time.perf_counter()
    demo = MultitaskLearner.load(str(MT_DEMO))          # device=None → the card
    cfg = multitask_config()
    params = mt.init_multitask(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    flagship = MultitaskLearner(cfg, MusicVocab.create(), params=params, device=dev)
    n = sum(t.numel() for t in leaves(params))
    for name, lr in (("demo_multitask_model", demo), ("flagship init_multitask", flagship)):
        c = lr.cfg
        say(f"mt load: {name} {c.enc_layers}+{c.dec_layers}L d{c.d_model} ff{c.d_inner} "
            f"{c.n_heads}x{c.d_head} mem {c.mem_len} act {c.act} {c.dtype}")
    say(f"mt load: flagship {n / 1e6:.1f}M parameters; both in "
        f"{time.perf_counter() - t0:.2f} s")
    return flagship, demo


def leaves(tree):
    """The tensors of a nested dict / list parameter tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [] if tree is None else [tree]


def mt_weights(learner, mode, rng, dev, bias_std: float):
    """(stacked weights, w_scales or None) of ``mode`` for the learner's
    decoder; with ``bias_std`` the q/k/v, q2 and feed-forward biases are
    replaced by N(0, bias_std^2) draws on the card (init_multitask gives
    zeros, which would hide a bias the kernel drops)."""
    eng = learner.engine("s2s")
    st = fs.stack_mt_dec_layers(eng.params)
    if bias_std:
        draw = lambda t: normal(t.shape, bias_std, rng, dev).to(torch.bfloat16)
        st = st._replace(qkv_b=draw(st.qkv_b), q2_b=draw(st.q2_b), ff1_b=draw(st.ff1_b),
                         ff2_b=draw(st.ff2_b))
    return fs.quantize_mt_weights(st) if mode == "slab_w8" else (st, None)


def mt_cross(cfg, Le, rng, dev):
    """A random encode-time context of Le slots (K, V and relative keys of
    std 0.5, drawn on the card), quantized slot-major, with its last Le / 4
    columns padded: (ckq, cksc, cvq, cvsc, cwkr_mt, cblocked)."""
    L, H, Dh = cfg.dec_layers, cfg.n_heads, cfg.d_head
    k, v = (normal((L, 1, H, Le, Dh), 0.5, rng, dev).to(torch.bfloat16) for _ in range(2))
    wkr = normal((L, H, Le, Dh), 0.5, rng, dev).to(torch.bfloat16)
    cblocked = (torch.arange(Le, device=dev)[None] >= Le - Le // 4).to(torch.int32)
    return (*fs.quantize_cross_slot_major(mt.CrossCache(k, v, wkr)), cblocked)


def mt_wkr(learner):
    eng = learner.engine("s2s")
    return eng._wkr_mt(mt.precompute_dec_wkr(eng.params, eng.cfg, eng.cfg.mem_len))


def mt_step(task, cfg, weights, wkr_mt, kv, cross, blocked, h_in, ptr, acc=None, clone=True):
    """One launch of the task's kernel (``acc`` None) or of its plain
    version in ``acc``, on copies of the self ring ``kv`` (on ``kv`` itself
    with ``clone`` False)."""
    stacked, w_scales = weights
    if clone:
        kv = [t.clone() for t in kv]
    M = cfg.mem_len
    if acc is not None:
        return fs.s2s_slab_plain(stacked, w_scales, cfg, h_in, wkr_mt, *kv,
                                 *(cross or (None,) * 6), blocked, ptr, M, acc=acc)
    kw = dict(weights_int8=w_scales is not None, w_scales=w_scales)
    if task == "s2s":
        return fs.fused_s2s_slab_core(stacked, cfg, h_in, wkr_mt, *kv, *cross, blocked, ptr,
                                      M, **kw)
    return fs.fused_nw_slab_core(stacked, cfg, h_in, wkr_mt, *kv, blocked, ptr, M, **kw)


def mt_kernel_phase(learner, label, rng, dev, le_values, bias_std):
    """Every s2s / nw variant on the card against a float64 run of its plain
    version (the float64 check of ``check_case``), ptr in {0, 31, 32, M - 1}
    on each kind of RINGS, each s2s case at every Le of ``le_values`` with
    padded encoder columns. Returns the largest |dh_out| and the largest
    |dh_out| over its bound, by variant."""
    cfg = learner.cfg
    M, L, HD = cfg.mem_len, cfg.dec_layers, cfg.n_heads * cfg.d_head
    wkr_mt = mt_wkr(learner)
    embed32 = learner.engine("s2s").params["embed"].float()
    worst = {}
    for mode in MT_MODES:
        weights = mt_weights(learner, mode, rng, dev, bias_std)
        for task in MT_TASKS:
            for Le in (le_values if task == "s2s" else (0,)):
                cross = mt_cross(cfg, Le, rng, dev) if task == "s2s" else None
                for ptr in (0, 31, 32, M - 1):
                    for kind in RINGS:
                        kv = ring_kv(L, 1, M, HD, kind, rng, dev)
                        blocked = torch.from_numpy(ring_blocked(1, M, ptr, kind)).to(dev)
                        h_in = embed32[torch.from_numpy(rng.integers(12, 140, 1)).to(dev)]
                        args = (task, cfg, weights, wkr_mt, kv, cross, blocked, h_in, ptr)
                        worse(worst, f"{task}_{mode}", check_case(
                            f"{task}[{mode}]", mode, kv, ptr, lambda: mt_step(*args),
                            lambda acc: mt_step(*args, acc=acc),
                            f"{label} Le={Le} ptr={ptr:3d} ring={kind}"))
    return worst


def mt_bytes_and_flops(task, cfg, weights, wkr_mt, kv, cross, slot_bytes=None):
    """Bytes one step must move (each input it reads once, each output
    written once) and its multiply-adds counted as 2 operations; the layouts
    of the slab steps, or of the fused ones when ``slot_bytes`` (the bytes
    of a layer's written K/V slot) is given. The last entry of ``cross`` is
    the (1, Le) encoder padding in both."""
    stacked, w_scales = weights
    L, D, Dff, H, Dh = cfg.dec_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head
    M, HD = cfg.mem_len, H * Dh
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    read = (nbytes(stacked.qkv_w, stacked.qkv_b, stacked.ln1_g, stacked.ln1_b, stacked.u,
                   stacked.v, wkr_mt, *kv) + 4 * M + 4 * D)       # + blocked, h_in
    cols = 3 * HD                                                 # column scales read
    flops = D * 3 * HD + H * ((M + 1) * Dh + 2 * M * Dh)
    if task == "s2s":
        Le = cross[-1].shape[1]
        read += nbytes(stacked.q2_w, stacked.q2_b, stacked.ln2_g, stacked.ln2_b,
                       stacked.ff1_w, stacked.ff1_b, stacked.ff2_w, stacked.ff2_b,
                       stacked.ff3_g, stacked.ff3_b, *cross)
        cols += HD + Dff + D
        flops += D * HD + D * Dff + Dff * D + H * 3 * Le * Dh
    if w_scales is not None:
        read += 4 * L * cols
    written = 4 * D + L * (2 * (HD + 4) if slot_bytes is None else slot_bytes)
    return read + written, 2 * L * flops


def mt_timing_phase(learner, rng, dev):
    """Each s2s / nw variant at B = 1, M = 512, Le = 512 on the flagship's
    widths: CUDA-event medians of the kernel (100 launches) and of its plain
    version, beside the bound from the bytes it must move. No single PyTorch
    call computes this step (library_ms null). These launches do not count
    as the main paths'."""
    cfg = learner.cfg
    M, L, HD = cfg.mem_len, cfg.dec_layers, cfg.n_heads * cfg.d_head
    wkr_mt = mt_wkr(learner)
    h_in = learner.engine("s2s").params["embed"].float()[:1]
    before = launches()
    times = {}
    for mode in MT_MODES:
        weights = mt_weights(learner, mode, rng, dev, 0.1)
        for task in MT_TASKS:
            kv = ring_kv(L, 1, M, HD, "full", rng, dev)
            cross = mt_cross(cfg, 512, rng, dev) if task == "s2s" else None
            blocked = torch.from_numpy(ring_blocked(1, M, 100, "full")).to(dev)
            args = (task, cfg, weights, wkr_mt, kv, cross, blocked, h_in, 100)
            ms = time_ms(lambda: mt_step(*args), 100)
            plain_ms = time_ms(lambda: mt_step(*args, acc=torch.float32), 20)
            ms_again = time_ms(lambda: mt_step(*args), 100)
            nbytes, flops = mt_bytes_and_flops(task, cfg, weights, wkr_mt, kv, cross)
            bound_ms, bound_by = bound(nbytes, flops)
            say(f"timing: {task}[{mode}] B=1 M={M} Le={512 if cross else 0} kernel median "
                f"{ms:.4f} ms (again {ms_again:.4f}) plain {plain_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP, by "
                f"{bound_by}); library: none; 1 wrapper launch = "
                f"{fs.kernels_per_step(L, task == 's2s')} CUDA kernel")
            grid = fs.step_grid(mode, cfg, M, 512 if cross else 0, cross is not None, dev)
            # the wrapper alone on one ring (each call rewrites slot 100)
            dev_ms = one_kernel_line(f"{task}[{mode}]", lambda: mt_step(*args, clone=False),
                                     grid)
            times[f"{task}_{mode}"] = dict(ms=min(ms, ms_again), plain_ms=plain_ms,
                                           bound_ms=bound_ms, bound_by=bound_by,
                                           device_ms=dev_ms)
    set_launches(before)
    return times


def two_track_midi(seed: int, vocab, bars: int = 8) -> bytes:
    """``bars`` bars of a Piano melody over a Bass line (root, fifth) in a
    random major key: the two tracks harmonize splits."""
    rng = np.random.default_rng(seed)
    root = 60 + int(rng.integers(-5, 6))
    scale = np.array([0, 2, 4, 5, 7, 9, 11])
    melody, bass = [], []
    bar = 4 * SAMPLE_FREQ
    for b in range(bars):
        deg = int(rng.choice([0, 3, 4, 5]))
        for q, step in enumerate((0, 4, 0, 4)):           # quarter notes: root, fifth
            bass.append([root - 24 + scale[(deg + step) % 7], b * bar + q * SAMPLE_FREQ,
                         SAMPLE_FREQ])
        t = 0
        while t < bar:
            dur = int(rng.choice([2, 4]))
            pitch = root + scale[int(rng.integers(0, 7))] + 12 * int(rng.integers(0, 2))
            melody.append([pitch, b * bar + t, dur])
            t += dur
    parts = [np.array(melody), np.zeros((0, 3), np.int64), np.array(bass)]  # i0, i1, i2
    npenc = chordarr2npenc(notes2chordarr(parts))
    return MusicItem.from_npenc(npenc, vocab).to_midi_bytes()


def check_tokens(tokens, vocab, prev_idx, midi: bytes) -> dict:
    """The task output ``tokens`` (new ids after ``prev_idx``) have no
    grammar violation and the output MIDI re-parses; raises otherwise."""
    back = MusicItem.from_file(midi, vocab)
    viol = grammar_violations(np.asarray(tokens), vocab, prev_idx=int(prev_idx))
    checks = dict(tokens=len(tokens), reparsed_tokens=len(back.data), grammar_violations=viol)
    if not (len(back.data) > 2 and back.data[0] == vocab.bos_idx and viol == 0):
        raise AssertionError(f"multitask output failed its checks: {checks}")
    return checks


def mt_tasks(learner, label, seed: int, want_kernel: str, n_s2s: int = 200,
             n_nw: int = 256) -> dict:
    """harmonize (s2s_predict_from_midi, n_words ``n_s2s``), next-word
    (nw_predict_from_midi, ``n_nw``) and remix (predict_mask_remix, notes at
    0.6) on a two-track Piano + Bass prompt. Each decode path must resolve
    to ``want_kernel`` and launch it once a token step, remix none; each
    output re-parses with no grammar violation. Returns the launch counts."""
    vocab = learner.vocab
    midi = two_track_midi(seed, vocab)
    for kind in ("s2s", "nw"):
        if learner.engine(kind).kernel != want_kernel:
            raise AssertionError(f"{label}: the {kind} kernel is "
                                 f"{learner.engine(kind).kernel!r}, expected {want_kernel!r}")
    key = lambda task: f"{task}_{want_kernel}"
    s2s_predict_from_midi(learner, midi, n_words=8, seed=seed)        # warm-up
    torch.cuda.synchronize()
    total = dict.fromkeys(launches(), 0)
    # harmonize: the Bass track against the Piano one
    reset_launches()
    t0 = time.perf_counter()
    multi = s2s_predict_from_midi(learner, midi, n_words=n_s2s, seed=seed)
    secs = time.perf_counter() - t0
    counts = launches()
    if counts != only(**{key("s2s"): n_s2s}):
        raise AssertionError(f"{label} harmonize launched {counts} for {n_s2s} steps")
    targ = MultitrackItem.from_file(midi, vocab).second_instrument.remove_eos()
    pred = multi.first_instrument.data[len(targ.data):]
    checks = check_tokens(pred, vocab, targ.data[-1], multi.to_midi_bytes())
    say(f"mt {label}: harmonize kernel={want_kernel} n_words={n_s2s} launches "
        f"{counts[key('s2s')]} {checks} {n_s2s / secs:.1f} steps/s ({secs:.3f} s incl. "
        f"encode and prefill)")
    total[key("s2s")] += counts[key("s2s")]
    # next-word continuation
    reset_launches()
    t0 = time.perf_counter()
    full = nw_predict_from_midi(learner, midi, n_words=n_nw, seed=seed)
    secs = time.perf_counter() - t0
    counts = launches()
    if counts != only(**{key("nw"): n_nw}):
        raise AssertionError(f"{label} next-word launched {counts} for {n_nw} steps")
    seed_item = MusicItem.from_file(midi, vocab)
    checks = check_tokens(full.data[len(seed_item.data):], vocab, seed_item.data[-1],
                          full.to_midi_bytes())
    say(f"mt {label}: next-word kernel={want_kernel} n_words={n_nw} launches "
        f"{counts[key('nw')]} {checks} {n_nw / secs:.1f} steps/s ({secs:.3f} s incl. prefill)")
    total[key("nw")] += counts[key("nw")]
    # remix: the encoder and the head only, no decode step
    reset_launches()
    t0 = time.perf_counter()
    remix = predict_mask_remix(learner, midi, mask_proportion=0.6, seed=seed)
    secs = time.perf_counter() - t0
    if launches() != only():
        raise AssertionError(f"{label} remix launched {launches()}")
    # the body after the (genre, pad) prefix
    checks = check_tokens(remix.data[2:], vocab, remix.data[1], remix.to_midi_bytes())
    if (remix.data == vocab.mask_idx).any():
        raise AssertionError(f"{label} remix left masks unfilled")
    say(f"mt {label}: remix (notes at 0.6, parallel fill) {checks} in {secs:.3f} s")
    return total


def mt_main_phase(flagship, demo, seed: int) -> dict:
    """The three tasks on the flagship's shapes and on the trained demo
    checkpoint with the auto kernel (slab_w8), then harmonize and next-word
    on the demo with the explicit bf16-weight slab step. Returns the launch
    counts of all these runs."""
    total = mt_tasks(flagship, "flagship", seed, "slab_w8")
    for key, n in mt_tasks(demo, "demo", seed + 1, "slab_w8").items():
        total[key] += n
    explicit = MultitaskLearner(demo.cfg, demo.vocab, demo.params, device=demo.device,
                                decode_kernel="slab")
    for key, n in mt_tasks(explicit, "demo explicit slab", seed + 2, "slab",
                           n_s2s=64, n_nw=64).items():
        total[key] += n
    return total


def http_phase(learner, mt_learner, seed: int):
    """The HTTP server with the continuous service on the genre learner and
    the multitask learner behind /remix and /harmonize."""
    vocab = learner.vocab
    server = MusicServer(genre_learner=learner, multitask_learner=mt_learner, max_batch=16,
                         continuous=True)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        midis = [base64.b64encode(prompt_midi(seed + 100 + i, vocab)).decode()
                 for i in range(4)]
        tok_code, tok = post("/tokenize", {"midi_b64": midis[0]})
        reset_launches()
        outs = [None] * 4

        def generate(i):
            outs[i] = post("/generate", {"midi_b64": midis[i], "genre": GENRES[i],
                                         "n_words": 64, "seed": seed + i,
                                         "temperatures": [1.8, 1.8, 1.0][: 2 + i % 2]})

        workers = [threading.Thread(target=generate, args=(i,)) for i in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(600)
        counts = launches()
        two_track = base64.b64encode(two_track_midi(seed + 200, vocab)).decode()
        reset_launches()
        remix = post("/remix", {"midi_b64": two_track, "seed": seed})
        harmonize = post("/harmonize", {"midi_b64": two_track, "n_words": 64, "seed": seed})
        mt_counts = launches()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    ok = health == {"ok": True} and tok_code == 200 and tok["n_tokens"] > 0
    ok = ok and counts["slab"] > 0 and mt_counts == only(s2s_slab_w8=64)
    mt_tokens = []
    for out in (remix, harmonize):
        ok = ok and out[0] == 200
        if ok:
            back = MusicItem.from_file(base64.b64decode(out[1]["midi_b64"]), vocab)
            ok = back.data[0] == vocab.bos_idx and len(back.data) > 2
            mt_tokens.append(len(back.data))
    lengths = []
    for out in outs:
        ok = ok and out is not None and out[0] == 200
        if ok:
            back = MusicItem.from_file(base64.b64decode(out[1]["midi_b64"]), vocab)
            ok = back.data[0] == vocab.bos_idx and out[1]["n_tokens"] > 0
            lengths.append(out[1]["n_tokens"])
    say(f"http: /health {health}, /tokenize {tok_code} ({tok.get('n_tokens')} tokens), "
        f"4 concurrent /generate -> {[o[0] if o else None for o in outs]} with "
        f"{lengths} tokens, each MIDI re-parsed; launches={counts}; /remix -> {remix[0]}, "
        f"/harmonize -> {harmonize[0]} (MIDI re-parsed to {mt_tokens} tokens; "
        f"launches {mt_counts['s2s_slab_w8']} s2s_slab_w8)")
    if not ok:
        raise AssertionError("the HTTP phase failed")


def train_inputs(B, L, K, H, Dh, dev, seed, pad=False) -> dict:
    """bf16 operands of the train attention drawn on ``dev``: q, k, v, wkr of
    unit scale, u and v biases of 0.5, dO of unit scale; with ``pad`` each
    batch row b pads its first (37 b) mod (L / 2) window keys; with ``pad ==
    "rows"`` batch row 0 pads every key instead and row 1 its last 128."""
    rng = np.random.default_rng(seed)
    HD = H * Dh
    bf = lambda shape, std: normal(shape, std, rng, dev).to(torch.bfloat16)
    mask = None
    if pad:
        n = (37 * torch.arange(B, device=dev)) % (L // 2)
        mask = torch.arange(L, device=dev)[None, :] < n[:, None]
    if pad == "rows":
        mask[0] = True
        mask[1] = torch.arange(L, device=dev) >= L - 128
    return dict(q=bf((B, L, HD), 1.0), k=bf((B, K, HD), 1.0), v=bf((B, K, HD), 1.0),
                wkr=bf((K, HD), 1.0), u=bf((H, Dh), 0.5), vb=bf((H, Dh), 0.5), pad=mask,
                do=bf((B, L, HD), 1.0))


def train_run(fn, inp, H, win_size, win_k, mem_valid, attn_p=0.0, attn_seed=None,
              **acc) -> list:
    """``fn``'s output and its gradients of q, k, v, wkr, u, v (from dO), as
    float64 tensors (zeros for an input the output does not depend on)."""
    leaves = [inp[n].detach().clone().requires_grad_(True)
              for n in ("q", "k", "v", "wkr", "u", "vb")]
    out = fn(*leaves, win_size, win_k, mem_valid, H, inp["pad"], True, attn_p,
             attn_seed if attn_p else None, **acc)
    out.backward(inp["do"])
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in leaves]
    return [t.detach().double() for t in (out, *grads)]


def rel(x, ref) -> float:
    return float((x - ref).norm() / ref.norm().clamp_min(1e-300))


def mt_run(fn, inp, H, kind, attn_p=0.0, attn_seed=None, **acc) -> list:
    """``fn``'s output and its gradients as :func:`train_run` gives them, for
    the multitask attention of ``kind`` ("bidir", with the key padding
    ``inp["pad"]``, or "cross")."""
    leaves = [inp[n].detach().clone().requires_grad_(True)
              for n in ("q", "k", "v", "wkr", "u", "vb")]
    pad = {"pad_mask": inp["pad"]} if kind == "bidir" else {}
    out = fn(*leaves, H, **pad, attn_p=attn_p, attn_seed=attn_seed if attn_p else None, **acc)
    out.backward(inp["do"])
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in leaves]
    return [t.detach().double() for t in (out, *grads)]


def train_check(kernel, plain, inp, H, run=train_run, **case):
    """The float64 check of the train attention (TRAIN_REL): ``kernel``'s
    output and gradients against a float64 run of ``plain``, each within
    TRAIN_REL + PLAIN_K x the float32 plain version's distance; ``run``
    (:func:`train_run`, or :func:`mt_run` with its kind) calls them. Returns
    (ok, {output: (distance, float32 plain distance, bound, max |kernel -
    float32 plain|)})."""
    got = run(kernel, inp, H, **case)
    ref64 = run(plain, inp, H, **case, acc=torch.float64)
    ref32 = run(plain, inp, H, **case, acc=torch.float32)
    report, ok = {}, True
    for name, g, r64, r32 in zip(TRAIN_OUTPUTS, got, ref64, ref32):
        d_plain = rel(r32, r64)
        d, bound = rel(g, r64), TRAIN_REL + PLAIN_K * d_plain
        report[name] = (d, d_plain, bound, float((g - r32).abs().max()))
        ok = ok and d <= bound and bool(torch.isfinite(g).all())
    return ok, report


def train_kernel_phase(cfg, dev, seed):
    """The flash train kernels against their plain version on each case;
    returns {"train_fwd" / "train_bwd": (largest |kernel - float32 plain|,
    largest distance over its bound)}."""
    H, Dh, K = cfg.n_heads, cfg.d_head, TRAIN_M + TRAIN_L
    worst = {"train_fwd": (0.0, 0.0), "train_bwd": (0.0, 0.0)}
    before = launches()
    for i, (name, case, pad) in enumerate(TRAIN_CASES):
        inp = train_inputs(TRAIN_B, TRAIN_L, K, H, Dh, dev, seed + i, pad)
        ok, report = train_check(ftr.flash_train_attention, ftr.flash_train_attention_plain,
                                 inp, H, **case, attn_seed=TRAIN_SEED)
        torch.cuda.synchronize()
        say(f"kernel: flash_train {name} B={TRAIN_B} L={TRAIN_L} K={K} {case}: " + "; ".join(
            f"{k} |d|/|ref| {d:.3e} (plain f32 {dp:.2e}, bound {b:.3e}, max|d| {m:.2e})"
            for k, (d, dp, b, m) in report.items()))
        if not ok:
            raise AssertionError(f"flash train kernels disagree with their plain version "
                                 f"on case {name}")
        for key, names in (("train_fwd", TRAIN_OUTPUTS[:1]), ("train_bwd", TRAIN_OUTPUTS[1:])):
            for k in names:
                d, _, b, m = report[k]
                worst[key] = (max(worst[key][0], m), max(worst[key][1], d / b))
    set_launches(before)
    return worst


def train_bytes_and_flops(inp, vecs, B, L, K, H, Dh, blocked):
    """Bytes each pass must move (inputs read once, outputs written once)
    and its products' operations over the (query, key) pairs this data
    leaves visible (2 per multiply-add): the forward's AC, BD and P.V; the
    backward's recomputed AC and BD, dP, dV, dK, dQ's two terms and dWkr."""
    nbytes = lambda t: t.numel() * t.element_size()
    ops = sum(nbytes(t) for t in (inp["q"], inp["k"], inp["v"], inp["wkr"], inp["u"],
                                   inp["vb"], *vecs))
    stats = 2 * B * H * L * 4                     # the forward's row max and sum
    fwd_bytes = ops + nbytes(inp["q"]) + stats    # + out
    bwd_bytes = (ops + nbytes(inp["do"]) + B * L * H * 4 + stats      # + dO, delta
                 + nbytes(inp["q"]) + 2 * nbytes(inp["k"])            # dq, dk, dv
                 + (K + 2) * H * Dh * 4)                              # dwkr, du, dv f32
    pairs = int((~blocked).sum()) * H
    return (fwd_bytes, 3 * 2 * pairs * Dh), (bwd_bytes, 8 * 2 * pairs * Dh), pairs


def train_timing_phase(cfg, dev, seed, M=TRAIN_M, prefix="train"):
    """CUDA-event medians of the forward and backward kernels (the wrapper's
    launches, 100 each) and of the plain version's forward and backward, at
    the flagship's train shape: causal, full memory of M slots (M = 0: the
    multitask decoder's call), dropout 0.1, as the main path trains. Keys
    ``<prefix>_fwd``, ``<prefix>_bwd``."""
    H, Dh, B, L, K = cfg.n_heads, cfg.d_head, TRAIN_B, TRAIN_L, M + TRAIN_L
    inp = train_inputs(B, L, K, H, Dh, dev, seed)
    vecs = ftr.mask_vectors(B, L, K, 1, 1, M, device=dev)
    plan = ftr.kernel_plan(*vecs)
    sc = float(np.float32(1.0 / math.sqrt(Dh)))
    ops = [inp[n].contiguous() for n in ("q", "k", "v", "wkr")] + [
        inp["u"].reshape(-1), inp["vb"].reshape(-1)]
    args = dict(H=H, sc=sc, attn_p=cfg.attn_p, seed=TRAIN_SEED)
    out, m, l = ftr._launch_fwd(*ops, plan, **args)
    delta = (inp["do"].float() * out.float()).reshape(B, L, H, Dh).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    fwd = lambda: ftr._launch_fwd(*ops, plan, **args)
    bwd = lambda: ftr._launch_bwd(*ops, plan, inp["do"], delta, m, l, **args)
    leaves = [t.detach().clone().requires_grad_(True) for t in ops]
    plain = lambda: ftr.flash_train_attention_plain(*leaves, 1, 1, M, H, None, True,
                                                    cfg.attn_p, TRAIN_SEED)
    blocked = ftr.blocked_mask(*vecs)
    (fb, ff), (bb, bf), pairs = train_bytes_and_flops(inp, vecs, B, L, K, H, Dh, blocked)
    dense = 2 * B * H * L * K * Dh
    result = timed_pair(prefix, fwd, bwd, plain, leaves, inp["do"], (fb, ff), (bb, bf))
    for key, nbytes, flops in ((f"{prefix}_fwd", fb, ff), (f"{prefix}_bwd", bb, bf)):
        bound_ms, bound_by, times, again = (result[key][k] for k in (
            "bound_ms", "bound_by", "ms_first", "ms_again"))
        say(f"timing: flash_train {key[-3:]} B={B} L={L} K={K} kernel median "
            f"{times:.4f} ms (again {again:.4f}) plain {result[key]['plain_ms']:.4f} ms "
            f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP over "
            f"{pairs / (B * H):.0f} visible pairs a head, by {bound_by}; dense L x K "
            f"products: {(3 if key.endswith('fwd') else 8) * dense / 1e9:.2f} GFLOP)")
    tiles = plan[3]
    slots = ftr.partial_slots(B, L, H, dev)
    say(f"timing: flash_train B={B} L={L} K={K} tile pairs computed "
        f"{int((tiles != ftr.SKIP).sum())} of {tiles.numel()} "
        f"({int((tiles == ftr.VISIBLE).sum())} without a mask test); dWkr partials "
        f"{slots} slots of (K, H Dh) f32, {slots * K * H * Dh * 4 / 1e6:.1f} MB")
    return result


def timed_pair(prefix, fwd, bwd, plain, leaves, do, fwd_work, bwd_work) -> dict:
    """The forward and backward kernels' CUDA-event medians of 100 launches
    (taken twice, in turns with the plain version's 10), the plain version's
    forward and backward, and the bound of each from its (bytes, flops).
    Returns {"<prefix>_fwd" / "_bwd": dict(ms, plain_ms, bound_ms, bound_by,
    ms_first, ms_again)}."""
    graph = plain()
    plain_bwd = lambda: torch.autograd.grad(graph, leaves, do, retain_graph=True)
    times = {"fwd": time_ms(fwd, 100), "bwd": time_ms(bwd, 100)}
    plain_ms = {"fwd": time_ms(plain, 10), "bwd": time_ms(plain_bwd, 10)}
    again = {"fwd": time_ms(fwd, 100), "bwd": time_ms(bwd, 100)}
    result = {}
    for part, (nbytes, flops) in (("fwd", fwd_work), ("bwd", bwd_work)):
        bound_ms, bound_by = bound(nbytes, flops)
        result[f"{prefix}_{part}"] = dict(
            ms=min(times[part], again[part]), plain_ms=plain_ms[part], bound_ms=bound_ms,
            bound_by=bound_by, ms_first=times[part], ms_again=again[part])
    return result


def train_corpus(root: Path, seed: int):
    """A synthetic corpus of 5 train songs and 1 valid song a genre; returns the
    idxenc lists (train, valid)."""
    synthcorpus.make_corpus(root, songs_per_genre=5, val_per_genre=1, base_seed=seed)
    vocab = MusicVocab.create()
    return load_corpus(root / "train", vocab), load_corpus(root / "valid", vocab)


def train_phase(seed: int):
    """The main path of training on the flagship (see the module docstring);
    returns the launch counts of the fit."""
    vocab = MusicVocab.create()
    cfg = btp_phase1_config(len(vocab))
    with tempfile.TemporaryDirectory() as tmp:
        train, valid = train_corpus(Path(tmp) / "corpus", seed)
        loader = LMStreamLoader(train, vocab, bs=TRAIN_B, bptt=cfg.ctx_len, seed=seed,
                                encode_position=cfg.encode_position,
                                transpose_range=cfg.transpose_range)
        valid_loader = LMStreamLoader(valid, vocab, bs=TRAIN_B, bptt=cfg.ctx_len,
                                      shuffle=False, transpose_range=None,
                                      encode_position=cfg.encode_position)
        n_steps, n_valid = len(loader), len(valid_loader)
        if not 16 <= n_steps <= 32:
            raise AssertionError(f"the corpus gives {n_steps} steps an epoch, not 16-32")
        learner = MusicLearner(cfg, vocab, generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        reset_launches()
        plain_calls = ftr.flash_train_attention_plain.calls
        result = learner.fit_one_cycle(loader, epochs=1, valid_loader=valid_loader,
                                       seed=seed, log_fn=lambda line: say(f"train: {line}"))
        torch.cuda.synchronize()
        counts = launches()
        entry, losses = result.history[0], result.losses
        first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
        toks = n_steps * TRAIN_B * cfg.ctx_len
        say(f"train: fit_one_cycle 41M flagship B={TRAIN_B} bptt={cfg.ctx_len} "
            f"{n_steps} steps + {n_valid} valid batches in {entry['time_s']:.2f} s: "
            f"{n_steps / entry['time_s']:.3f} steps/s, {toks / entry['time_s']:.0f} tok/s; "
            f"loss first 4 {first:.4f} last 4 {last:.4f}, valid {entry['valid_loss']:.4f}; "
            f"launches {counts}; plain version calls "
            f"{ftr.flash_train_attention_plain.calls - plain_calls}")
        want = only(flash_train_fwd=8 * (n_steps + n_valid), flash_train_bwd=8 * n_steps)
        if counts != want:
            raise AssertionError(f"training launched {counts}, expected {want}")
        if ftr.flash_train_attention_plain.calls != plain_calls:
            raise AssertionError("training called the plain train attention on the card")
        if not (np.isfinite(losses).all() and last < first):
            raise AssertionError(f"the loss did not fall: first 4 {first}, last 4 {last}")
        path = Path(tmp) / "ckpt"
        learner.save(str(path))
        back = MusicLearner.load(str(path))
        if back.step != n_steps:
            raise AssertionError(f"the manifest records step {back.step}, not {n_steps}")
        midi = prompt_midi(seed, vocab)
        reset_launches()
        full = predict_nw_genre(back, midi, genre="jazz", max_len=32, seed=seed)
        gen_counts = launches()
        if gen_counts != only(slab_w8=32):
            raise AssertionError(f"generation after training launched {gen_counts}")
        seed_item = MusicItem.from_file(midi, vocab).trim_to_beat(32).set_genre("jazz") \
            .remove_eos()
        checks = check_continuation(seed_item, full.data[len(seed_item.data):], vocab,
                                    piano_range=False)
        say(f"train: saved {path.name} step {back.step}, reloaded on the card, 32 tokens "
            f"through slab_w8: {checks}")
    return counts


def mt_train_kernel_phase(cfg, dev, seed):
    """The multitask train step's kernels against their plain versions on
    each of MT_TRAIN_CASES; returns {"<kind>_fwd" / "_bwd": (largest |kernel -
    float32 plain|, largest distance over its bound)}, kind "bidir", "cross"
    or "train0" (flash_train_attention at M = 0)."""
    H, Dh, B = cfg.n_heads, cfg.d_head, MT_TRAIN_B
    worst = {}
    before = launches()
    for i, (name, kind, L, K, pad, case) in enumerate(MT_TRAIN_CASES):
        inp = train_inputs(B, L, K, H, Dh, dev, seed + 100 + i, pad)
        kernel, plain = MT_TRAIN_FNS[kind]
        run = train_run if kind == "train" else functools.partial(mt_run, kind=kind)
        ok, report = train_check(kernel, plain, inp, H, run=run, **case, attn_seed=TRAIN_SEED)
        torch.cuda.synchronize()
        say(f"kernel: {name} B={B} L={L} K={K} pad={pad} {case}: " + "; ".join(
            f"{k} |d|/|ref| {d:.3e} (plain f32 {dp:.2e}, bound {b:.3e}, max|d| {m:.2e})"
            for k, (d, dp, b, m) in report.items()))
        if not ok:
            raise AssertionError(f"the {kind} train kernels disagree with their plain version "
                                 f"on case {name}")
        kind = "train0" if kind == "train" else kind
        for part, names in (("fwd", TRAIN_OUTPUTS[:1]), ("bwd", TRAIN_OUTPUTS[1:])):
            key = f"{kind}_{part}"
            for k in names:
                d, _, b, m = report[k]
                w = worst.get(key, (0.0, 0.0))
                worst[key] = (max(w[0], m), max(w[1], d / b))
    set_launches(before)
    return worst


def mt_bytes_and_flops_train(inp, B, L, K, H, Dh, vis_pairs, bd_pairs):
    """Bytes each pass of a multitask train kernel must move (inputs read
    once, outputs written once) and its products' operations (2 per
    multiply-add) over the pairs this data needs: AC, P.V and, in the
    backward, dP, dV, dK and dQ's AC term over the pairs with a visible key;
    BD and, in the backward, dQ's BD term and dWkr over the pairs whose BD
    the function keeps."""
    nbytes = lambda t: t.numel() * t.element_size()
    ins = sum(nbytes(inp[n]) for n in ("q", "k", "v", "wkr", "u", "vb"))
    stats = 2 * B * H * L * 4
    fwd_bytes = ins + nbytes(inp["q"]) + stats
    bwd_bytes = (ins + nbytes(inp["do"]) + B * L * H * 4 + stats
                 + nbytes(inp["q"]) + 2 * nbytes(inp["k"]) + (K + 2) * H * Dh * 4)
    return ((fwd_bytes, 2 * Dh * (2 * vis_pairs + bd_pairs)),
            (bwd_bytes, 2 * Dh * (5 * vis_pairs + 3 * bd_pairs)))


def mt_train_timing_phase(cfg, dev, seed):
    """CUDA-event medians of the bidirectional and cross kernels' forward and
    backward (100 launches each) and of their plain versions, at the
    multitask train step's shape (B 16, W 512, no padding, dropout 0.1 as
    the main path trains), beside the bound; then flash_train_attention at
    M = 0. Keys bidir_*, cross_*, train0_*."""
    H, Dh, B, W = cfg.n_heads, cfg.d_head, MT_TRAIN_B, MT_TRAIN_W
    sc = float(np.float32(1.0 / math.sqrt(Dh)))
    result = {}
    for kind in ("bidir", "cross"):
        bidir = kind == "bidir"
        inp = train_inputs(B, W, W, H, Dh, dev, seed)
        ops = [inp[n].contiguous() for n in ("q", "k", "v", "wkr")] + [
            inp["u"].reshape(-1), inp["vb"].reshape(-1)]
        kp = torch.zeros((B, W), dtype=torch.int32, device=dev) if bidir else None
        tiles = ftr.bidir_tile_map(kp) if bidir else None
        args = dict(H=H, sc=sc, attn_p=cfg.attn_p, seed=TRAIN_SEED)
        fwd = lambda: ftr._mt_launch_fwd(bidir, *ops, kp, tiles, **args)
        out, m, l = fwd()
        delta = (inp["do"].float() * out.float()).reshape(B, W, H, Dh).sum(-1)
        delta = delta.transpose(1, 2).contiguous()
        bwd = lambda: ftr._mt_launch_bwd(bidir, *ops, kp, tiles, inp["do"], delta, m, l, **args)
        leaves = [t.detach().clone().requires_grad_(True) for t in ops]
        pad = {"pad_mask": None} if bidir else {}
        plain_fn = MT_TRAIN_FNS[kind][1]
        plain = lambda: plain_fn(*leaves, H, **pad, attn_p=cfg.attn_p, attn_seed=TRAIN_SEED)
        pairs = B * H * W * W
        # bidir: every key visible, BD zero on one column; cross: BD kept on the
        # band j <= i + K - L, here the lower triangle with the diagonal
        bd_pairs = B * H * (W * (W - 1) if bidir else W * (W + 1) // 2)
        work = mt_bytes_and_flops_train(inp, B, W, W, H, Dh, pairs, bd_pairs)
        got = timed_pair(kind, fwd, bwd, plain, leaves, inp["do"], *work)
        for key, r in got.items():
            nbytes, flops = work[0] if key.endswith("fwd") else work[1]
            say(f"timing: flash_{key} B={B} W={W} {H}x{Dh} dropout {cfg.attn_p} kernel median "
                f"{r['ms_first']:.4f} ms (again {r['ms_again']:.4f}) plain {r['plain_ms']:.4f} "
                f"ms bound {r['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.2f} GFLOP, by {r['bound_by']})")
        result.update(got)
        n_tiles = B * (W // ftr.TILE) ** 2
        band = (ftr.cross_band_classes(W, W) != ftr.NO_BD).sum() * B
        say(f"timing: flash_{kind} B={B} W={W} tile pairs computed {n_tiles} of {n_tiles}"
            + ("" if bidir else f" ({int(band)} with a BD term)") + "; dWkr partials "
            f"{ftr.partial_slots(B, W, H, dev)} slots of (K, H Dh) f32, "
            f"{ftr.mt_partial_bytes(B, W, W, H, Dh, dev) / 1e6:.1f} MB")
    # bidir under the smoke's leading key padding: the fully padded key tiles
    # are skipped
    inp = train_inputs(B, W, W, H, Dh, dev, seed, pad=True)
    ops = [inp[n].contiguous() for n in ("q", "k", "v", "wkr")] + [
        inp["u"].reshape(-1), inp["vb"].reshape(-1)]
    kp = inp["pad"].to(torch.int32).contiguous()
    tiles = ftr.bidir_tile_map(kp)
    args = dict(H=H, sc=sc, attn_p=cfg.attn_p, seed=TRAIN_SEED)
    fwd = lambda: ftr._mt_launch_fwd(True, *ops, kp, tiles, **args)
    out, m, l = fwd()
    delta = (inp["do"].float() * out.float()).reshape(B, W, H, Dh).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    bwd = lambda: ftr._mt_launch_bwd(True, *ops, kp, tiles, inp["do"], delta, m, l, **args)
    say(f"timing: flash_bidir B={B} W={W} leading key padding: tile pairs computed "
        f"{int((tiles != ftr.SKIP).sum())} of {tiles.numel()} "
        f"({int((tiles == ftr.VISIBLE).sum())} without a mask test); kernel median "
        f"fwd {time_ms(fwd, 100):.4f} ms, bwd {time_ms(bwd, 100):.4f} ms")
    result.update(train_timing_phase(cfg, dev, seed, M=0, prefix="train0"))
    return result


def mt_train_corpus(root: Path, seed: int, vocab):
    """A synthetic corpus of 3 songs a genre on disk (the mask task's LM
    stream), and 18 two-track Piano + Bass items (6 songs of each genre
    whose melody or comping is a piano) for the seq2seq task."""
    synthcorpus.make_corpus(root, songs_per_genre=3, val_per_genre=0, base_seed=seed)
    styles = synthcorpus.GENRE_STYLES
    piano = [g for g, st in styles.items()
             if synthcorpus.PIANO in (st["melody_ins"], st["comp_ins"])]
    items = [MultitrackItem.from_npenc(synthcorpus.generate_song(g, seed + 50_000 + i), vocab)
             for g in piano for i in range(6)]
    items = [it for it in items
             if len(it.first_instrument) > 16 and len(it.second_instrument) > 16]
    return load_corpus(root / "train", vocab), items


# the multitask flash kernels a task batch launches a step, forward and backward
MT_STEP_LAUNCHES = {"msk": {"flash_bidir": 10}, "s2s": {"flash_bidir": 20, "flash_cross": 20,
                                                         "flash_train": 20}}
MT_START_WINDOW = 3
# The flash route's wiring (mt._flash_train_block: the wkr slices, the (H,
# Dh) biases, which padding reaches which kernel, the post-norms, the blocks
# without a feed-forward) against the score path at the flagship's width: the
# trained model's multi_loss on one batch, window 3 at diagonal 0, no
# dropout, and its gradient over every parameter (relative Frobenius
# distance of all the leaves together). The two routes differ by bf16
# roundings only (each rounds its attention output, the score path its
# probabilities where the kernels round q + u, q + v and P). On an H100
# (PERF.md) the gaps were 9.5e-7 and 5.3e-5 in the loss, 4.6e-4 and 2.3e-3
# in the gradient (mask, padded s2s); the bounds leave 38x and 8.6x the
# larger. A wiring fault moves the gradient by O(1).
MT_ROUTE_LOSS_ATOL = 2e-3
MT_ROUTE_GRAD_REL = 2e-2
MT_ROUTE_PAD = 40          # key-padded columns of the s2s batch's row 1


def mt_route_check(params, cfg, batch, pad_idx, dev):
    """(flash loss, score-path loss, relative gradient distance) of
    ``multi_loss`` on ``batch`` through ``flash_train=None`` (the kernels on
    the card) and ``flash_train=False``."""
    xd, yd = batch
    xs = {task: _batch_to_device(d, dev) for task, d in xd.items() if d is not None}
    ys = _batch_to_device(yd, dev)
    losses, grads = [], []
    for flash in (None, False):
        p = master_params(params, dev)
        out = mt.forward(p, cfg, xs, pad_idx=pad_idx, win_size=3, win_k=0, flash_train=flash)
        loss, _ = multi_loss(out, ys, pad_idx)
        leaves = txl.tree_leaves(p)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads.append(torch.cat([(torch.zeros_like(t) if gi is None else gi).flatten()
                                for t, gi in zip(leaves, g)]))
        losses.append(float(loss.detach()))
    rel = float(torch.linalg.vector_norm(grads[0] - grads[1])
                / torch.linalg.vector_norm(grads[1]))
    return losses[0], losses[1], rel


def mt_train_phase(seed: int):
    """The main path of multitask training on the 85M flagship (see the
    module docstring); returns the launch counts of the fit."""
    vocab = MusicVocab.create()
    cfg = multitask_config(len(vocab))
    B, L = MT_TRAIN_B, cfg.ctx_len
    with tempfile.TemporaryDirectory() as tmp:
        corpus, items = mt_train_corpus(Path(tmp) / "corpus", seed, vocab)
        rng = np.random.default_rng(seed)
        loader = LMStreamLoader(corpus, vocab, bs=B, bptt=L, seed=seed)
        mask_batches = [mask_lm_tfm_pitchdur(b, vocab, rng) for b in loader]
        s2s_loader = S2SLoader(items, vocab, bs=min(B, len(items)), bptt=L, seed=seed)
        s2s_batches = []
        for _ in range(max(len(mask_batches) // max(len(s2s_loader), 1), 1)):
            s2s_batches.extend(list(s2s_loader))
        n_mask, n_s2s = len(mask_batches), len(s2s_batches)
        if not (8 <= n_mask <= 16 and len(items) >= 16 and s2s_loader.bs == B):
            raise AssertionError(f"{n_mask} mask batches (8-16 wanted), {len(items)} two-track "
                                 f"items (16 wanted), s2s batch {s2s_loader.bs}")
        learner = multitask_model_learner(cfg, vocab, seed=seed)     # device=None: the card
        torch.cuda.synchronize()
        reset_launches()
        plain_calls = [f.calls for f in (ftr.flash_train_attention_plain,
                                         ftr.flash_bidir_attention_plain,
                                         ftr.flash_cross_attention_plain)]
        result = learner.fit(mask_batches, epochs=2, seed=seed,
                             dataloaders=[mask_batches, s2s_batches],
                             starting_mask_window=MT_START_WINDOW,
                             log_fn=lambda line: say(f"mt train: {line}"))
        torch.cuda.synchronize()
        counts = launches()
        say(f"mt train: windows (win_size, win_k) a step: {result.windows}")
        want = only(**{f"{k}_{part}": n_mask * MT_STEP_LAUNCHES["msk"].get(k, 0)
                       + n_s2s * MT_STEP_LAUNCHES["s2s"].get(k, 0)
                       for k in MT_STEP_LAUNCHES["s2s"] for part in ("fwd", "bwd")})
        plain_now = [f.calls for f in (ftr.flash_train_attention_plain,
                                       ftr.flash_bidir_attention_plain,
                                       ftr.flash_cross_attention_plain)]
        for entry, n, toks in ((result.history[0], n_mask, n_mask * B * L),
                               (result.history[1], n_s2s, n_s2s * 2 * B * L)):
            losses = result.losses[:n] if entry["epoch"] == 0 else result.losses[n_mask:]
            first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
            say(f"mt train: epoch {entry['epoch']} ({'mask' if entry['epoch'] == 0 else 's2s'}) "
                f"85M flagship B={B} bptt={L}: {n} steps in {entry['time_s']:.2f} s, "
                f"{n / entry['time_s']:.3f} steps/s, {toks / entry['time_s']:.0f} target tok/s; "
                f"loss first 4 {first:.4f} last 4 {last:.4f}")
            if not (np.isfinite(losses).all() and last < first):
                raise AssertionError(f"the loss of epoch {entry['epoch']} did not fall: "
                                     f"first 4 {first}, last 4 {last}")
        say(f"mt train: launches {counts}; plain version calls "
            f"{[b - a for a, b in zip(plain_calls, plain_now)]}")
        if counts != want:
            raise AssertionError(f"multitask training launched {counts}, expected {want}")
        if plain_now != plain_calls:
            raise AssertionError("multitask training called a plain train attention on the card")
        if not any(w > 1 for w, _ in result.windows[n_mask:]):
            raise AssertionError("no seq2seq step ran a curriculum window")
        xd, yd = s2s_batches[0]
        padded = {}
        for task, d in xd.items():
            pad = np.zeros((B, L), bool)
            pad[1, -MT_ROUTE_PAD:] = True
            padded[task] = {**d, "enc_pad": pad, "dec_pad": pad}
        for name, batch in (("mask", mask_batches[0]), ("s2s padded", (padded, yd))):
            fl, sc, rel = mt_route_check(learner.params, cfg, batch, vocab.pad_idx,
                                         torch.device("cuda"))
            say(f"mt train: route check on a {name} batch, window 3: loss kernels {fl:.6f} "
                f"score path {sc:.6f} (|gap| {abs(fl - sc):.3e}, bound "
                f"{MT_ROUTE_LOSS_ATOL}); gradient relative distance {rel:.3e} (bound "
                f"{MT_ROUTE_GRAD_REL})")
            if not (abs(fl - sc) <= MT_ROUTE_LOSS_ATOL and rel <= MT_ROUTE_GRAD_REL):
                raise AssertionError(f"the flash route's loss or gradient on the {name} batch "
                                     f"differs from the score path's")
        path = Path(tmp) / "mt_ckpt"
        learner.save(str(path))
        back = MultitaskLearner.load(str(path))
        if back.step != n_mask + n_s2s:
            raise AssertionError(f"the manifest records step {back.step}, not {n_mask + n_s2s}")
        gen = mt_tasks(back, "trained", seed + 3, "slab_w8", n_s2s=64, n_nw=64)
        say(f"mt train: saved {path.name} step {back.step}, reloaded on the card; "
            f"generation launched {gen}")
    return counts


# The multitask flash prefill kernels against their plain version, by
# flash_check's exact-float32 check (FLASH_RTOL, FLASH_ATOL): (name, causal,
# B, W, pads). The bidirectional cases pad on the right, as the encoder's
# windows are padded, and every query row counts (the encoder output at a
# padded position feeds the cross-attention keys): a row whose keys are all
# padding averages V over all W keys. The causal case pads on the left, as
# flash_check's.
MT_PREFILL_CASES = (
    ("bidir", False, 16, 512, (0, 17, 300)),
    ("bidir, a fully padded row", False, 4, 512, (0, 512, 100)),
    ("bidir W=64", False, 16, 64, (0, 5, 40)),
    ("bidir W=96 (tail tile)", False, 8, 96, (0, 17, 50)),
    ("bidir W=40 (one partial tile)", False, 4, 40, (0, 9, 40)),
    ("causal", True, 16, 512, (0, 17, 300)),
)
MT_PREFILL_B, MT_PREFILL_W = 16, 512   # the batched prefill the auto rule takes


def encoder_check(args, H, causal):
    """``flash_encoder_attention`` on ``args`` (from flash_inputs) against its
    float32 plain version on the same values. Returns (max |d| over the rows
    checked, the largest |d| / (FLASH_RTOL |ref| + FLASH_ATOL) there, every
    row finite); the rows checked are all of them (bidirectional) or the
    real query rows (causal, as flash_check)."""
    pad = args[-1]
    ref = fp.flash_encoder_attention_plain(*[t.float() for t in args[:-1]], pad, H,
                                           causal=causal)
    got = fp.flash_encoder_attention(*args, H, causal=causal)
    torch.cuda.synchronize()
    rows = ~pad if causal else torch.ones_like(pad)
    d = (got.float() - ref).abs()[rows]
    ratio = (d / (FLASH_RTOL * ref.abs()[rows] + FLASH_ATOL)).max().item()
    return d.max().item(), ratio, bool(torch.isfinite(got.float()).all())


def mt_prefill_kernel_phase(cfg, dev, seed):
    """``flash_encoder_attention`` (bidirectional and causal) against its
    plain version in the MT_PREFILL_CASES; returns each variant's largest
    error and largest error over its bound."""
    worst = {}
    for i, (name, causal, B, W, pads) in enumerate(MT_PREFILL_CASES):
        args = flash_inputs(B, W, pads, cfg.n_heads, cfg.d_head, dev, seed + 100 + i,
                            right=not causal)
        err, ratio, finite = encoder_check(args, cfg.n_heads, causal)
        say(f"kernel: flash_encoder {name} B={B} W={W} pads={pads} "
            f"{'real' if causal else 'all'} rows: max|d| {err:.3e}, max |d| / "
            f"({FLASH_RTOL:.3e} |ref| + {FLASH_ATOL}) = {ratio:.3f} (must be <= 1); "
            f"all rows finite={finite}")
        if not (ratio <= 1.0 and finite):
            raise AssertionError(f"flash_encoder_attention ({name}) disagrees with its "
                                 "plain version")
        worse(worst, "mt_causal" if causal else "mt_bidir", (err, ratio))
    return worst


def mt_windows(cfg, B, W, seed, dev):
    """Random (B, W) token windows on the card: encoder tokens right-padded
    and decoder tokens left-padded by 0, 17 or 300 (rows in turn), with
    positions that advance by 0-2 a token."""
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = lambda: torch.randint(5, 300, (B, W), generator=g, device=dev)
    pos = lambda: torch.cumsum(torch.randint(0, 3, (B, W), generator=g, device=dev), 1)
    n = torch.tensor([(0, 17, 300)[b % 3] for b in range(B)], device=dev)[:, None]
    col = torch.arange(W, device=dev)[None]
    enc_pad, dec_pad = col >= W - n, col < n
    xe, xd = toks(), toks()
    xe[enc_pad], xd[dec_pad] = 1, 1
    return xe, pos(), enc_pad, xd, pos(), dec_pad


def mt_prefill_phase(learner, label, dev, seed, B=MT_PREFILL_B, W=MT_PREFILL_W):
    """``encode``, ``decoder_prefill`` and ``lm_prefill`` at (B, W) under the
    auto rule (which must take the flash kernels: one launch a layer, the
    bidirectional kernel for the encoder, the causal one for each prefill),
    held to their ``flash=False`` branch: the encoder output over every
    position and the caches by layer over the valid slots in relative
    (Frobenius) norm within l * PREFILL_LAYER_RTOL at depth l, the logits
    within PREFILL_LOGITS_ATOL / RTOL with the same argmax; then the three
    at B = 1, which must launch nothing. Returns the launch counts."""
    cfg, p = learner.cfg, learner.engine("s2s").params
    M = cfg.mem_len
    xe, pe, enc_pad, xd, pd, dec_pad = mt_windows(cfg, B, W, seed, dev)
    reset_launches()
    enc = mt.encode(p, cfg, xe, pe, pad_cols=enc_pad)
    torch.cuda.synchronize()
    n_enc = launches()
    if n_enc != only(flash_encoder_bidir=cfg.enc_layers):
        raise AssertionError(f"{label} encode at B={B} W={W} launched {n_enc}")
    ref_enc = mt.encode(p, cfg, xe, pe, pad_cols=enc_pad, flash=False)
    enc_rel = ((enc.float() - ref_enc.float()).norm() / ref_enc.float().norm()).item()
    enc_ok = enc_rel <= cfg.enc_layers * PREFILL_LAYER_RTOL and bool(
        torch.isfinite(enc.float()).all())
    say(f"mt prefill {label}: encode B={B} W={W} launches {n_enc['flash_encoder_bidir']}; "
        f"output |d| / |ref| over every position {enc_rel:.3e} within "
        f"{cfg.enc_layers} * {PREFILL_LAYER_RTOL:.3e}={enc_ok}")
    ok = enc_ok
    total = dict(n_enc)
    for name, fn, extra in (("decoder_prefill", mt.decoder_prefill, (enc,)),
                            ("lm_prefill", mt.lm_prefill, ())):
        kw = dict(enc_pad=enc_pad) if extra else {}
        reset_launches()
        logits, cache = fn(p, cfg, xd, pd, dec_pad, *extra, **kw)
        torch.cuda.synchronize()
        counts = launches()
        if counts != only(flash_encoder_causal=cfg.dec_layers):
            raise AssertionError(f"{label} {name} at B={B} W={W} launched {counts}")
        total["flash_encoder_causal"] += counts["flash_encoder_causal"]
        ref_logits, ref_cache = fn(p, cfg, xd, pd, dec_pad, *extra, flash=False, **kw)
        logits, ref_logits = logits.float(), ref_logits.float()
        logit_ok = bool((logits - ref_logits).abs().le(
            PREFILL_LOGITS_ATOL + PREFILL_LOGITS_RTOL * ref_logits.abs()).all())
        same_argmax = bool(torch.equal(logits.argmax(-1), ref_logits.argmax(-1)))
        valid = (~dec_pad)[:, -M:]
        if W < M:                 # the cache's first M - W slots hold no token
            valid = torch.cat([torch.zeros((B, M - W), dtype=torch.bool, device=dev), valid], 1)
        rel, cache_err = cache_diff_by_layer(cache, ref_cache, valid)
        cache_ok = all(r <= l * PREFILL_LAYER_RTOL for l, r in enumerate(rel))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (logits, cache.k, cache.v))
        say(f"mt prefill {label}: {name} B={B} W={W} launches "
            f"{counts['flash_encoder_causal']}; max|d logits| "
            f"{(logits - ref_logits).abs().max().item():.3e} within atol "
            f"{PREFILL_LOGITS_ATOL} rtol {PREFILL_LOGITS_RTOL}={logit_ok}, same argmax="
            f"{same_argmax}; cache on valid slots |d| / |ref| by layer "
            f"{' '.join(f'{r:.2e}' for r in rel)} within l * {PREFILL_LAYER_RTOL:.3e}="
            f"{cache_ok} (max|d| {cache_err:.3e}); finite={finite}")
        ok = ok and logit_ok and same_argmax and cache_ok and finite
    if not ok:
        raise AssertionError(f"{label}: the multitask flash prefill disagrees with its "
                             "flash=False branch")
    reset_launches()
    one = [t[:1] for t in (xe, pe, enc_pad, xd, pd, dec_pad)]
    enc1 = mt.encode(p, cfg, *one[:2], pad_cols=one[2])
    mt.decoder_prefill(p, cfg, *one[3:], enc1, enc_pad=one[2])
    mt.lm_prefill(p, cfg, *one[3:])
    torch.cuda.synchronize()
    if launches() != only():
        raise AssertionError(f"{label}: the B=1 prefills launched {launches()}")
    say(f"mt prefill {label}: encode, decoder_prefill, lm_prefill at B=1 launch nothing")
    return total


def mt_prefill_timing_phase(cfg, dev, seed, B=MT_PREFILL_B, W=MT_PREFILL_W):
    """CUDA-event medians of 100 launches of each flash_encoder_attention
    variant at (B, W) with no padding (every pair is work the data needs) and
    of 100 calls of its plain version, beside the bound. No single PyTorch
    call computes the skewed bias with its spill (library_ms null). These
    launches do not count as the main path's."""
    before = launches()
    H, Dh = cfg.n_heads, cfg.d_head
    HD = H * Dh
    q, k, v, wkr, u, vb, pad = flash_inputs(B, W, (0,), H, Dh, dev, seed + 7)
    times = {}
    for causal in (False, True):
        kernel = lambda: fp.flash_encoder_attention(q, k, v, wkr, u, vb, pad, H, causal=causal)
        plain = lambda: fp.flash_encoder_attention_plain(q, k, v, wkr, u, vb, pad, H,
                                                         causal=causal)
        ms = time_ms(kernel, 100)
        plain_ms = time_ms(plain, 100)
        ms_again = time_ms(kernel, 100)
        nbytes = 2 * (4 * B * W * HD + W * HD + 2 * HD) + B * W   # q k v out, wkr, u v, pad
        pairs = B * H * (W * (W + 1) // 2 if causal else W * W)
        flops = 3 * 2 * pairs * Dh                                # AC, BD and P.V products
        bound_ms, bound_by = bound(nbytes, flops)
        name = "causal" if causal else "bidir"
        say(f"timing: flash_encoder[{name}] B={B} W={W} {H}x{Dh} kernel median {ms:.4f} ms "
            f"(again {ms_again:.4f}) plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP, by {bound_by}); library: none")
        times[f"mt_{name}"] = dict(ms=min(ms, ms_again), plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
    set_launches(before)
    return times


# The fused (exact bf16) s2s / nw step against a float64 run of its plain
# version, the float64 check of check_case on the fused step's outputs:
# |dh_out| and the largest difference of the written bf16 K/V slot entries,
# each within its fixed bound + PLAIN_K x the float32 plain version's, every
# other slot byte-identical. FUSED_SLOT_ATOL is the cache tolerance that the
# JAX package's tests hold this kernel's written slot to
# (tests/test_fused_s2s.py); H_ATOL as the slab steps'.
FUSED_SLOT_ATOL = 5e-2
FUSED_METRICS = (("dh", 0), ("slot", 1))
FUSED_PTRS = lambda M: (0, 31, M - 1)


def fused_ring(cfg, kind, rng, dev):
    """A random bf16 head-major ring (K, V each (L, 1, H, M, Dh)) drawn on
    the card: entries of std 0.5, each slot scaled by exp(N(0, 0.7^2)) on a
    short ring (as ring_kv)."""
    L, H, Dh, M = cfg.dec_layers, cfg.n_heads, cfg.d_head, cfg.mem_len

    def ring():
        x = normal((L, 1, H, M, Dh), 0.5, rng, dev)
        if kind == "short":
            x.mul_(torch.exp(normal((L, 1, 1, M, 1), 0.7, rng, dev)))
        return x.to(torch.bfloat16)
    return [ring(), ring()]


def fused_cross(cfg, Le, rng, dev):
    """A random bf16 encode-time context of Le slots (K, V and relative keys
    of std 0.5, (L, H, Le, Dh), drawn on the card), its last Le / 4 columns
    padded: (ck, cv, cwkr, cblocked)."""
    L, H, Dh = cfg.dec_layers, cfg.n_heads, cfg.d_head
    ck, cv, cwkr = (normal((L, H, Le, Dh), 0.5, rng, dev).to(torch.bfloat16) for _ in range(3))
    cblocked = (torch.arange(Le, device=dev)[None] >= Le - Le // 4).to(torch.int32)
    return ck, cv, cwkr, cblocked


def fused_wkr(learner):
    eng = learner.engine("s2s")
    return mt.precompute_dec_wkr(eng.params, eng.cfg, eng.cfg.mem_len)


def fused_step(task, cfg, stacked, wkr, kv, cross, blocked, h_in, ptr, acc=None, clone=True):
    """One launch of the task's fused kernel (``acc`` None) or of its plain
    version in ``acc``, on copies of the ring ``kv`` (on ``kv`` itself with
    ``clone`` False)."""
    if clone:
        kv = [t.clone() for t in kv]
    M = cfg.mem_len
    if acc is not None:
        return fs.s2s_fused_plain(stacked, cfg, h_in, wkr, *kv, *(cross or (None,) * 4),
                                  blocked, ptr, M, acc=acc)
    if task == "s2s":
        return fs.fused_s2s_step_core(stacked, cfg, h_in, wkr, *kv, *cross, blocked, ptr, M)
    return fs.fused_nw_step_core(stacked, cfg, h_in, wkr, *kv, blocked, ptr, M)


def fused_diff(got, ref, kv, ptr):
    """One fused step's result ``got`` against ``ref`` (both (h_out, kc,
    vc), from the ring ``kv``): max |dh_out|, the largest difference of the
    written K/V slot entries, and whether every other slot of ``got`` is
    byte-identical to ``kv``."""
    M = kv[0].shape[3]
    other = torch.arange(M, device=kv[0].device) != ptr
    untouched = all(torch.equal(g[:, :, :, other], t[:, :, :, other])
                    for g, t in zip(got[1:], kv))
    dh = (got[0].double() - ref[0].double()).abs().max().item()
    slot = max((g[:, :, :, ptr].double() - r[:, :, :, ptr].double()).abs().max().item()
               for g, r in zip(got[1:], ref[1:]))
    return dh, slot, untouched


def fused_bounds(plain_diff) -> dict:
    fixed = {"dh": H_ATOL, "slot": FUSED_SLOT_ATOL}
    return {m: fixed[m] + PLAIN_K * plain_diff[i] for m, i in FUSED_METRICS}


def within_fused_bounds(diff, plain_diff) -> bool:
    """The float64 check of one fused_diff against the float32 plain
    version's ``plain_diff`` on the same case; the other slots must be
    byte-identical."""
    limit = fused_bounds(plain_diff)
    return all(diff[i] <= limit[m] for m, i in FUSED_METRICS) and diff[2]


def mt_fused_kernel_phase(learner, label, rng, dev, le_values, bias_std):
    """The fused s2s / nw kernels on the card against a float64 run of their
    plain version (within_fused_bounds), ptr in FUSED_PTRS on each kind of
    RINGS, each s2s case at every Le of ``le_values`` with padded encoder
    columns; with ``bias_std`` non-zero biases. Returns the largest |dh_out|
    and the largest |dh_out| over its bound, by variant."""
    cfg = learner.cfg
    stacked, _ = mt_weights(learner, "fused", rng, dev, bias_std)
    wkr = fused_wkr(learner)
    embed32 = learner.engine("s2s").params["embed"].float()
    worst = {}
    for task in MT_TASKS:
        for Le in (le_values if task == "s2s" else (0,)):
            cross = fused_cross(cfg, Le, rng, dev) if task == "s2s" else None
            for ptr in FUSED_PTRS(cfg.mem_len):
                for kind in RINGS:
                    kv = fused_ring(cfg, kind, rng, dev)
                    blocked = torch.from_numpy(ring_blocked(1, cfg.mem_len, ptr, kind)).to(dev)
                    h_in = embed32[torch.from_numpy(rng.integers(12, 140, 1)).to(dev)]
                    args = (task, cfg, stacked, wkr, kv, cross, blocked, h_in, ptr)
                    ref = fused_step(*args, acc=torch.float64)
                    f32 = fused_step(*args, acc=torch.float32)
                    got = fused_step(*args)
                    torch.cuda.synchronize()
                    diff, plain_diff = fused_diff(got, ref, kv, ptr), fused_diff(f32, ref, kv, ptr)
                    limit = fused_bounds(plain_diff)
                    say(f"kernel: {task}[fused] vs float64 {label} Le={Le} ptr={ptr:3d} "
                        f"ring={kind} max|dh_out|={diff[0]:.3e} (plain_f32 {plain_diff[0]:.3e}, "
                        f"bound {limit['dh']:.3e}) max|d slot|={diff[1]:.3e} (plain_f32 "
                        f"{plain_diff[1]:.3e}, bound {limit['slot']:.3e}) "
                        f"other_slots_identical={diff[2]}")
                    if not within_fused_bounds(diff, plain_diff):
                        raise AssertionError(f"{task}[fused] kernel disagrees with its plain "
                                             "version")
                    worse(worst, f"{task}_fused", (diff[0], diff[0] / limit["dh"]))
    return worst


def mt_fused_timing_phase(learner, rng, dev):
    """The fused s2s (Le = 512) and nw steps at B = 1, M = 512 on the
    flagship's widths: CUDA-event medians of 100 kernel launches and of 100
    calls of the plain version, beside the bound from the bytes the step must
    move. These launches do not count as the main path's."""
    cfg = learner.cfg
    stacked, _ = mt_weights(learner, "fused", rng, dev, 0.1)
    wkr = fused_wkr(learner)
    h_in = learner.engine("s2s").params["embed"].float()[:1]
    M, L, HD = cfg.mem_len, cfg.dec_layers, cfg.n_heads * cfg.d_head
    before = launches()
    times = {}
    for task in MT_TASKS:
        kv = fused_ring(cfg, "full", rng, dev)
        cross = fused_cross(cfg, 512, rng, dev) if task == "s2s" else None
        blocked = torch.from_numpy(ring_blocked(1, M, 100, "full")).to(dev)
        args = (task, cfg, stacked, wkr, kv, cross, blocked, h_in, 100)
        ms = time_ms(lambda: fused_step(*args), 100)
        plain_ms = time_ms(lambda: fused_step(*args, acc=torch.float32), 100)
        ms_again = time_ms(lambda: fused_step(*args), 100)
        nbytes, flops = mt_bytes_and_flops(task, cfg, (stacked, None), wkr, kv, cross,
                                           slot_bytes=2 * 2 * HD)
        bound_ms, bound_by = bound(nbytes, flops)
        say(f"timing: {task}[fused] B=1 M={M} Le={512 if cross else 0} kernel median "
            f"{ms:.4f} ms (again {ms_again:.4f}) plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP, by "
            f"{bound_by}); library: none; 1 wrapper launch = "
            f"{fs.fused_kernels_per_step(L, task == 's2s')} CUDA kernel")
        grid = fs.step_grid("fused", cfg, M, 512 if cross else 0, cross is not None, dev)
        dev_ms = one_kernel_line(f"{task}[fused]", lambda: fused_step(*args, clone=False), grid)
        times[f"{task}_fused"] = dict(ms=min(ms, ms_again), plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_ms)
    set_launches(before)
    return times


# The fused step's greedy tokens against the exact ring step's ('xla') on
# the trained demo: equal, or, where a logit tie broke the other way, the two
# chosen tokens' logits (from the 'xla' route's model functions on the common
# prefix) within the JAX package's logit tolerance for this kernel against
# the ring step (tests/test_fused_s2s.py: atol 0.08, rtol 0.02).
FUSED_LOGITS_ATOL, FUSED_LOGITS_RTOL = 0.08, 0.02


def next_logits(engine, kind, inp, toks):
    """The logits after ``toks`` (the target so far) from the model
    functions, as the engine builds its windows: the next-word prefill, or
    the encoder over ``inp`` and the seq2seq prefill."""
    from deepmusicgeneration_tpu_torch.codec.index import position_enc
    from deepmusicgeneration_tpu_torch.decode.multitask_engine import _bucket as mt_bucket
    p, cfg, v = engine.params, engine.cfg, engine.vocab
    x, pos, pad = engine._left_window(toks, position_enc(toks, v).astype(np.int64))
    if kind == "nw":
        return mt.lm_prefill(p, cfg, x, pos, pad)[0][0].float()
    inp = np.asarray(inp[:1024], np.int64)
    We = mt_bucket(len(inp))
    ib, ipb, ipad = (np.full((1, We), v.pad_idx, np.int64), np.zeros((1, We), np.int64),
                     np.ones((1, We), bool))
    ib[0, :len(inp)], ipb[0, :len(inp)], ipad[0, :len(inp)] = \
        inp, position_enc(inp, v).astype(np.int64), False
    ib, ipb, ipad = (engine._tensor(a) for a in (ib, ipb, ipad))
    enc = mt.encode(p, cfg, ib, ipb, pad_cols=ipad)
    return mt.decoder_prefill(p, cfg, x, pos, pad, enc, enc_pad=ipad)[0][0].float()


def fused_greedy_phase(demo, seed, n_words=64):
    """64 greedy steps of harmonize and next-word on the demo with the fused
    kernel and with the exact ring step: the tokens must be equal, or the
    first divergence must be a near-tie (FUSED_LOGITS_ATOL / RTOL). Returns
    the fused launches."""
    vocab = demo.vocab
    multi = MultitrackItem.from_file(two_track_midi(seed, vocab), vocab)
    inp = multi.first_instrument.data
    targ = multi.second_instrument.trim_to_beat(8).remove_eos().data
    learners = {k: MultitaskLearner(demo.cfg, vocab, demo.params, device=demo.device,
                                    decode_kernel=k) for k in ("fused", "xla")}
    total = dict.fromkeys(launches(), 0)
    for kind in ("s2s", "nw"):
        out = {}
        for k, lr in learners.items():
            reset_launches()
            eng = lr.engine(kind)
            out[k] = (eng.predict_s2s(inp, targ, n_words=n_words, greedy=True)[len(targ):]
                      if kind == "s2s" else eng.predict_nw(targ, n_words=n_words, greedy=True))
            torch.cuda.synchronize()
            if k == "fused":
                if launches() != only(**{f"{kind}_fused": n_words}):
                    raise AssertionError(f"fused {kind} launched {launches()}")
                total[f"{kind}_fused"] += n_words
        a, b = np.asarray(out["fused"]), np.asarray(out["xla"])
        n = min(len(a), len(b))
        diverged = np.nonzero(a[:n] != b[:n])[0]
        if len(diverged) == 0 and len(a) == len(b):
            say(f"mt fused greedy: {kind} {len(a)} tokens, fused equal to xla")
            continue
        i = int(diverged[0]) if len(diverged) else n
        if i == n:
            raise AssertionError(f"fused {kind}: {len(a)} tokens against xla's {len(b)}")
        logits = next_logits(learners["xla"].engine(kind), kind, inp,
                             np.concatenate([targ, b[:i]]).astype(np.int64))
        la, lb = logits[int(a[i])].item(), logits[int(b[i])].item()
        near_tie = abs(la - lb) <= FUSED_LOGITS_ATOL + FUSED_LOGITS_RTOL * abs(lb)
        say(f"mt fused greedy: {kind} first divergence at step {i} of {n}: fused "
            f"{int(a[i])} xla {int(b[i])}, their logits {la:.4f} / {lb:.4f}, gap "
            f"{abs(la - lb):.4f} within atol {FUSED_LOGITS_ATOL} rtol "
            f"{FUSED_LOGITS_RTOL}={near_tie}")
        if not near_tie:
            raise AssertionError(f"fused {kind} diverged from xla beyond a near-tie")
    return total


def mt_fused_phase(flagship, demo, seed: int) -> dict:
    """harmonize (200 words), next-word (256) and remix on the flagship's
    shapes and on the demo with ``decode_kernel='fused'``: one fused launch a
    token step and no other kernel (mt_tasks); then the greedy comparison
    with the exact ring step on the demo. Returns the launch counts of the
    task runs."""
    total = dict.fromkeys(launches(), 0)
    for i, (label, lr) in enumerate((("flagship", flagship), ("demo", demo))):
        fused = MultitaskLearner(lr.cfg, lr.vocab, lr.params, device=lr.device,
                                 decode_kernel="fused")
        for key, n in mt_tasks(fused, f"{label} fused", seed + 10 + i, "fused").items():
            total[key] += n
    fused_greedy_phase(demo, seed)
    return total


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
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions' f32 products
    device_phase()
    build_phase()
    t0 = time.perf_counter()
    learner = MusicLearner.load(str(CKPT))     # device=None → the card
    engine = learner.engine
    say(f"load: {CKPT} {engine.cfg.n_layers}L d{engine.cfg.d_model} "
        f"ff{engine.cfg.d_inner} {engine.cfg.n_heads}x{engine.cfg.d_head} "
        f"mem {engine.cfg.mem_len} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(args.seed)
    wkr_mt = wkr_table(engine)
    # each kernel's largest error (|dh_out| for the slab steps) and largest
    # error over the bound the check applied to it
    err = {}
    for mode, batches in KERNEL_CASE_BATCHES:
        worse(err, mode, timed(f"kernel {mode} B in {batches}", kernel_phase, engine,
                               wkr_mt, rng, dev, mode, batches))
    modes_rng = np.random.default_rng(args.seed + 2)
    for mode, batches, rows in MODE_CASE_BATCHES:
        worse(err, mode, timed(f"kernel {mode} B in {batches} R {rows or 'min(B, 8)'}",
                               kernel_phase, engine, wkr_mt, modes_rng, dev, mode, batches,
                               rows))
    edge_rng = np.random.default_rng(args.seed + 4)
    for mode, batches, M, chain in MULTIROW_EDGE_CASES:
        worse(err, mode, timed(f"kernel {mode} B in {batches} M {M or 'mem_len'}",
                               edge_phase, engine, edge_rng, dev, mode, batches, M, chain))
    allrows_rng = np.random.default_rng(args.seed + 5)
    for mode, batches, M, chain in ALLROWS_CHAIN_CASES + ALLROWS_EDGE_CASES:
        worse(err, mode, timed(f"kernel {mode} B in {batches} M {M or 'mem_len'}",
                               edge_phase, engine, allrows_rng, dev, mode, batches, M, chain))
    slab_w8_rng = np.random.default_rng(args.seed + 6)
    for mode, batches, M, chain in SLAB_W8_EDGE_CASES:
        worse(err, mode, timed(f"kernel {mode} B in {batches} M {M or 'mem_len'}",
                               edge_phase, engine, slab_w8_rng, dev, mode, batches, M, chain))
    err["flash"] = timed("kernel flash", flash_phase, engine.cfg, dev, args.seed)
    timed("flash entries", flash_entry_phase, dev, args.seed)
    flagship, demo = timed("mt load", mt_load_phase, dev, args.seed)
    for label, learner_mt, le_values, bias_std in (("flagship", flagship, MT_LE, 0.1),
                                                   ("demo", demo, (64, 128), 0.0)):
        for key, e in timed(f"mt kernel {label}", mt_kernel_phase, learner_mt, label, rng,
                            dev, le_values, bias_std).items():
            worse(err, key, e)
    items = batch_prompts(learner.vocab, args.seed, 64)
    timed("prefill", prefill_phase, learner, items[:16], dev)
    timing = timed("timing", timing_phase, engine, wkr_mt, rng, dev, args.seed, modes_rng)
    timing.update(timed("mt timing", mt_timing_phase, flagship, rng, dev))
    n_single = timed("main", main_path_phase, learner, args.seed, args.n_words)
    entries = {"flash": dict(fp.flash_prefill_attention.entries)}
    batched, batch_failed = timed("batch", batched_phase, learner, items, args.seed,
                                  args.n_words)
    entries["flash"] = entries_ran(fp.flash_prefill_attention, entries["flash"])
    n_slab = timed("continuous", continuous_phase, learner, items[16:48], args.seed)
    n_slab_ar = timed("slab_ar", slab_ar_phase, learner, items[48:], args.seed)
    n_modes = timed("modes", explicit_modes_phase, learner, items, args.seed, args.n_words)
    n_mt = timed("mt tasks", mt_main_phase, flagship, demo, args.seed)
    timed("http", http_phase, learner, demo, args.seed)
    train_cfg = btp_phase1_config(len(learner.vocab))
    err.update(timed("train kernel", train_kernel_phase, train_cfg, dev, args.seed))
    timing.update(timed("train timing", train_timing_phase, train_cfg, dev, args.seed))
    n_train = timed("train", train_phase, args.seed)
    mt_cfg = flagship.cfg
    err.update(timed("mt train kernel", mt_train_kernel_phase, mt_cfg, dev, args.seed))
    timing.update(timed("mt train timing", mt_train_timing_phase, mt_cfg, dev, args.seed))
    n_mt_train = timed("mt train", mt_train_phase, args.seed)
    err.update(timed("mt prefill kernel", mt_prefill_kernel_phase, mt_cfg, dev, args.seed))
    entries["mt_causal"] = dict(fp.flash_encoder_attention.entries)
    n_mt_prefill = timed("mt prefill", mt_prefill_phase, flagship, "flagship", dev, args.seed)
    entries["mt_causal"] = entries_ran(fp.flash_encoder_attention, entries["mt_causal"])
    timing.update(timed("mt prefill timing", mt_prefill_timing_phase, mt_cfg, dev, args.seed))
    fused_rng = np.random.default_rng(args.seed + 1)
    for label, learner_mt, le_values, bias_std in (("flagship", flagship, MT_LE, 0.1),
                                                   ("demo", demo, (64, 128), 0.0)):
        for key, e in timed(f"mt fused kernel {label}", mt_fused_kernel_phase, learner_mt,
                            label, fused_rng, dev, le_values, bias_std).items():
            worse(err, key, e)
    timing.update(timed("mt fused timing", mt_fused_timing_phase, flagship, fused_rng, dev))
    n_fused = timed("mt fused tasks", mt_fused_phase, flagship, demo, args.seed)
    row10_rng = np.random.default_rng(args.seed + 3)
    err.update(row10_kernel_phase(engine, wkr_mt, row10_rng, dev, args.seed + 7))
    timing.update(timed("row10 timing", row10_timing_phase, engine, wkr_mt, row10_rng, dev))
    n_stack = timed("stack", stack_path_phase, learner, items, args.n_words)
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    csrc = "deepmusicgeneration_tpu_torch/ops/csrc/"
    src = "deepmusicgeneration_tpu/ops/"
    entry = lambda name, source, replaces, launched, key: {
        "name": name, "route": "cuda", "source": csrc + source,
        "replaces": src + replaces, "launches": launched, "max_abs_err": err[key][0],
        "max_err_over_bound": err[key][1],
        **{k: timing[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        # the decode steps: the chain and the CUDA kernels a step that the
        # profiler recorded in their timed step
        **{k: timing[key][k] for k in ("chain", "kernels_a_step") if k in timing[key]},
        # the causal flash prefill: which entry of its source the main path ran
        **({"entry": entries[key]} if key in entries else {})}
    say(json.dumps({"kernels": [
        entry("fused_slab_core[slab_w8]", "slab_decode.cu", "fused_decode.py:1163",
              n_single, "slab_w8"),
        entry("fused_slab_allrows_core[slab_ar_w8]", "slab_decode.cu",
              "fused_decode.py:1589", batched["slab_ar_w8"], "slab_ar_w8"),
        entry("flash_prefill_attention", "flash_prefill.cu", "flash_prefill.py:292",
              batched["flash_prefill"], "flash"),
        entry("fused_slab_core[slab]", "slab_decode.cu", "fused_decode.py:1163",
              n_slab, "slab"),
        entry("fused_slab_allrows_core[slab_ar]", "slab_decode.cu",
              "fused_decode.py:1589", n_slab_ar, "slab_ar"),
        *[entry(f"fused_slab_core[{mode}]", "slab_decode.cu", "fused_decode.py:1163",
                n_modes[mode], mode) for mode in ("slab_int8", "slab4", "slab4_w8")],
        entry("fused_multirow_core[multirow]", "multirow_decode.cu", "fused_decode.py:546",
              n_modes["multirow"], "multirow"),
        entry("fused_multirow_q_core[multirow_int8]", "multirow_decode.cu",
              "fused_decode.py:779", n_modes["multirow_int8"], "multirow_int8"),
        *[entry(f"{wrapper}[{mode}]", "s2s_slab.cu", f"fused_s2s.py:{line}",
                n_mt[f"{task}_{mode}"], f"{task}_{mode}")
          for task, wrapper, line in (("s2s", "fused_s2s_slab_core", 614),
                                      ("nw", "fused_nw_slab_core", 736))
          for mode in MT_MODES],
        *[entry(f"flash_train_attention[{part}]", "flash_train.cu", "flash_train.py:804",
                n_train[f"flash_train_{part}"], f"train_{part}") for part in ("fwd", "bwd")],
        *[entry(f"{wrapper}[{part}]", "flash_mt.cu", f"flash_train.py:{line}",
                n_mt_train[f"flash_{kind}_{part}"], f"{kind}_{part}")
          for kind, wrapper, line in (("bidir", "flash_bidir_attention", 772),
                                      ("cross", "flash_cross_attention", 789))
          for part in ("fwd", "bwd")],
        *[entry(f"flash_encoder_attention[{kind}]", source, "flash_prefill.py:240",
                n_mt_prefill[f"flash_encoder_{kind}"], f"mt_{kind}")
          for kind, source in (("bidir", "flash_encoder.cu"), ("causal", "flash_prefill.cu"))],
        *[entry(f"{wrapper}[fused]", "s2s_fused.cu", f"fused_s2s.py:{line}",
                n_fused[f"{task}_fused"], f"{task}_fused")
          for task, wrapper, line in (("s2s", "fused_s2s_step_core", 248),
                                      ("nw", "fused_nw_step_core", 346))],
        entry("fused_stack_decode", "multirow_decode.cu", "fused_decode.py:185",
              n_stack["fused_stack"], "fused_stack"),
        entry("fused_batched_decode", "multirow_decode.cu", "fused_decode.py:345",
              n_stack["fused_batched"], "fused_batched"),
        # no path runs the int8-score step over int8 panels: its launches are 0
        entry("fused_slab_core[slab_int8_w8]", "slab_decode.cu", "fused_decode.py:1163",
              0, "slab_int8_w8")]}))
    if batch_failed:
        say(f"FAILED: generate_batch B=64 rows failed their checks: {batch_failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
