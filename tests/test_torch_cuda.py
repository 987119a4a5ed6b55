"""Tests of the PyTorch port that need a CUDA card (marker ``cuda``).

They import only torch, numpy and the port (the card's machine has no JAX),
so they also run without this directory's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Each test decides inside itself whether a card is present and skips
without one. Each kernel is held against its plain PyTorch version on the
same card at the demo checkpoint's shapes; ``chip_smoke.py`` repeats that at
the flagship's widths.
"""

import os
from concurrent.futures import Future
from unittest import mock

import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu_torch.codec.grammar import grammar_violations
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.decode.continuous import ContinuousEngine
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.ops import flash_prefill as fp
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd
from deepmusicgeneration_tpu_torch.tasks.generate import predict_nw_genre
from deepmusicgeneration_tpu_torch.tasks.serve import GenerationService
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_genre_model")

# same arithmetic, other summation order: a value may cross a bf16 rounding
# point at the kernel's cast points (2^-8 relative) and propagate through the
# layers; h_out is post-LayerNorm (entries of order 1)
H_ATOL = 5e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _step_inputs(engine, B, ptr, dev):
    cfg, M = engine.cfg, engine.cfg.mem_len
    L, HD = cfg.n_layers, cfg.n_heads * cfg.d_head
    wkr_mt = txl.precompute_wkr(engine.params, cfg, M).permute(0, 2, 1, 3) \
        .reshape(L, M + 1, HD).to(torch.bfloat16).contiguous()
    rng = np.random.default_rng(B * 1000 + ptr)
    k, v = (torch.from_numpy(rng.normal(scale=0.5, size=(L, B, M, HD))
                             .astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
    kv = fd.quantize_kv_slot_major(k, v)
    g = np.broadcast_to(np.arange(M) - M, (B, M)).copy()
    g[:, :ptr] = np.arange(ptr)
    g[0, ptr + 1:ptr + 20] = txl.PAD_G
    blocked = torch.from_numpy(((ptr - g < 1) | (ptr - g > M)).astype(np.int32)).to(dev)
    h_in = engine.params["embed"].float()[torch.from_numpy(rng.integers(12, 140, B)).to(dev)]
    return h_in, wkr_mt, kv, blocked


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,ptr", [
    ("slab_w8", 1, 5), ("slab_w8", 1, 32), ("slab_w8", 3, 31), ("slab_w8", 3, 255),
    ("slab_ar_w8", 8, 5), ("slab_ar_w8", 16, 255), ("slab_ar_w8", 24, 31),
    ("slab", 1, 5), ("slab", 3, 255), ("slab", 16, 31),
    ("slab_ar", 8, 5), ("slab_ar", 16, 255), ("slab_ar", 24, 31)])
def test_kernel_matches_plain(name, B, ptr):
    dev = _card()
    import chip_smoke as cs
    core = cs.CORES[name]
    learner = MusicLearner.load(DEMO)
    engine = learner.engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, w_scales = cs.weights(engine, name)
    h_in, wkr_mt, kv, blocked = _step_inputs(engine, B, ptr, dev)

    ref = fd.slab_plain(stacked, w_scales, cfg, h_in, wkr_mt,
                        *[t.clone() for t in kv], blocked, ptr)
    n0 = core.launches[name]
    got = core(stacked, cfg, h_in, wkr_mt, *[t.clone() for t in kv], blocked, ptr,
               M, rows_per_cell=1, weights_int8=w_scales is not None, w_scales=w_scales)
    torch.cuda.synchronize()
    assert core.launches[name] == n0 + 1
    assert (got[0] - ref[0]).abs().max().item() <= H_ATOL
    other = torch.arange(M, device=dev) != ptr
    for g_t, before in zip(got[1:], kv):   # only slot ptr was written
        assert torch.equal(g_t[:, :, other], before[:, :, other])
    for i in (1, 3):   # written int8 rows: at most one quantization step apart
        d = (got[i][:, :, ptr].int() - ref[i][:, :, ptr].int()).abs()
        assert d.max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,pads", [(8, 256, (0, 17, 200)), (2, 4096, (0, 999)),
                                      (1, 128, (0,))])
def test_flash_kernel_matches_plain(B, W, pads):
    """The demo checkpoint's head layout (8 x 32) through the flash prefill
    kernel, on chip_smoke.py's peaked inputs: every entry of a real query row
    within FLASH_RTOL |ref| + FLASH_ATOL of the float32 plain version (the
    bound chip_smoke.py derives), every row finite."""
    dev = _card()
    from chip_smoke import flash_check, flash_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    args = flash_inputs(B, W, pads, 8, 32, dev, B + W)
    n0 = fp.flash_prefill_attention.launches
    _, ratio, finite = flash_check(args, 8)
    assert fp.flash_prefill_attention.launches == n0 + 1
    assert finite and ratio <= 1.0


@pytest.mark.cuda
def test_prefill_flash_matches_materialized():
    """txl.prefill through the flash kernel against its materialized branch
    on the demo checkpoint, 10 left-padded prompts (chip_smoke.py's bounds)."""
    dev = _card()
    import chip_smoke
    learner = MusicLearner.load(DEMO)
    items = [MusicItem.from_file(chip_smoke.prompt_midi(s, learner.vocab),
                                 learner.vocab).set_genre("pop").remove_eos()
             for s in range(10)]
    n0 = fp.flash_prefill_attention.launches
    chip_smoke.prefill_phase(learner, items, dev)   # raises on a disagreement
    assert fp.flash_prefill_attention.launches == n0 + learner.cfg.n_layers


@pytest.mark.cuda
def test_prefill_kernel_route_against_exact_attention():
    """txl.prefill on the flagship and the smoke's 16 service prompts by
    three routes: the flash kernel, the materialized branch, and the flash
    branch with its attention computed exactly (the plain version in
    float64 on the same inputs, rounded to bf16 as the kernel rounds its
    output). The kernel route differs from the exact one only where a bf16
    rounding of its float32 output lands elsewhere, so each layer's cache is
    within chip_smoke.py's l * 2^-8 of it; prints each route's per-layer
    difference from the exact one."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    learner = MusicLearner.load(str(cs.CKPT))
    engine = learner.engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    items = cs.batch_prompts(learner.vocab, 0, 16)
    x, pad = cs.window(items, learner.vocab.pad_idx, 512, dev)

    def exact(q, k, v, wkr, u_bias, v_bias, pad_mask, n_heads, scale=True,
              block_rows=0):
        return fp.flash_prefill_attention_plain(
            *[t.double() for t in (q, k, v, wkr, u_bias, v_bias)], pad_mask, n_heads,
            scale).to(q.dtype)

    with mock.patch.object(txl, "flash_prefill_attention", exact):
        ref = txl.prefill(engine.params, cfg, x, pad, flash=True)
    routes = {"kernel": txl.prefill(engine.params, cfg, x, pad, flash=True),
              "materialized": txl.prefill(engine.params, cfg, x, pad, flash=False)}
    torch.cuda.synchronize()
    rel = {}
    for name, (logits, cache) in routes.items():
        rel[name], worst = cs.cache_diff_by_layer(cache, ref[1], ~pad[:, -M:])
        dl = (logits.float() - ref[0].float()).abs().max().item()
        print(f"prefill {name} vs exact attention: max|d logits| {dl:.3e}; cache "
              f"|d| / |ref| by layer {' '.join(f'{r:.2e}' for r in rel[name])}, "
              f"max|d| {worst:.3e}", flush=True)
    assert all(r <= l * cs.PREFILL_LAYER_RTOL for l, r in enumerate(rel["kernel"]))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slab_kernels_against_float64(seed):
    """chip_smoke.py's kernel-phase cases at flagship widths (seed 0 is the
    smoke's own draw) for the four slab modes, each kernel and the float32
    plain version held against a float64 run of the plain version
    (``slab_plain(acc=float64)``, the same bf16 cast points) by the smoke's
    own check (``chip_smoke.within_bounds``): h_out within H_ATOL, written
    int8 entries within one step for slab_w8 and two for the other modes,
    in a share capped by TWO_STEP_SHARE_CAP, scales within 1e-2, every other
    slot byte-identical. Prints each case, with the share of written entries
    two steps from float64 (the cap's measurement) and the kernel against
    the float32 plain version."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(str(cs.CKPT)).engine
    wkr_mt = cs.wkr_table(engine)
    rng = np.random.default_rng(seed)
    bad = []
    for name, batches in cs.KERNEL_CASE_BATCHES:
        for B, ptr, full, kv, blocked, h_in in cs.kernel_cases(engine, rng, dev, batches):
            args = (name, engine, wkr_mt, kv, blocked, h_in, ptr)
            ref, f32 = cs.plain_step(*args), cs.plain_step(*args, acc=torch.float32)
            got = cs.run_step(*args)
            torch.cuda.synchronize()
            cells = []
            for what, a, b in ((f"{name} vs f64", got, ref), ("plain_f32 vs f64", f32, ref),
                               (f"{name} vs plain_f32", got, f32)):
                diff = cs.step_diff(a, b, kv, ptr)
                cells.append(f"{what}: dh {diff[0]:.2e} step {diff[1]} share "
                             f"{diff[2]:.4f} two_steps {diff[3]:.6f}")
                if what == f"{name} vs f64" and not cs.within_bounds(name, diff):
                    bad.append(cells[-1])
            print(f"seed {seed} {name} B={B} ptr={ptr} ring={'full' if full else 'part'}"
                  f": " + " | ".join(cells), flush=True)
    assert not bad, bad


@pytest.mark.cuda
def test_main_path_goes_through_the_kernel():
    """predict_nw_genre at B = 1 on the card runs slab_w8 once per step."""
    _card()
    from chip_smoke import prompt_midi
    learner = MusicLearner.load(DEMO)
    vocab = learner.vocab
    midi = prompt_midi(0, vocab)
    assert learner.engine.resolve_kernel(1) == "slab_w8"
    n0 = fd.fused_slab_core.launches["slab_w8"]
    full = predict_nw_genre(learner, midi, genre="pop", max_len=32, seed=1)
    assert fd.fused_slab_core.launches["slab_w8"] == n0 + 32
    seed_item = MusicItem.from_file(midi, vocab).trim_to_beat(32) \
        .set_genre("pop").remove_eos()
    pred = full.data[len(seed_item.data):]
    back = MusicItem.from_file(full.to_midi_bytes(), vocab)
    assert len(pred) > 0 and back.data[0] == vocab.bos_idx
    assert grammar_violations(pred, vocab, prev_idx=int(seed_item.data[-1])) == 0


@pytest.mark.cuda
def test_batched_path_goes_through_both_kernels():
    """Ten requests through the service: one batch of 16 rows, the flash
    prefill once per layer, slab_ar_w8 once per step, slab_w8 never."""
    _card()
    from chip_smoke import prompt_midi
    learner = MusicLearner.load(DEMO)
    vocab = learner.vocab
    items = [MusicItem.from_file(prompt_midi(s, vocab), vocab).set_genre("pop")
             .remove_eos() for s in range(10)]
    import chip_smoke as cs
    service = GenerationService(learner, max_batch=16, max_wait_s=1.0)
    cs.reset_launches()
    try:
        futs = [service.submit(it.data, n_words=24, seed=2) for it in items]
        preds = [f.result(timeout=300) for f in futs]
    finally:
        service.close()
    assert service.batch_sizes == [(10, 16)]
    assert cs.launches() == cs.only(slab_ar_w8=24, flash_prefill=learner.cfg.n_layers)
    for it, pred in zip(items, preds):
        assert len(pred) > 0
        assert grammar_violations(pred, vocab, prev_idx=int(it.data[-1])) == 0
        back = MusicItem.from_file(it.append(MusicItem(pred, vocab)).to_midi_bytes(),
                                   vocab)
        assert back.data[0] == vocab.bos_idx


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["slab", "slab_ar"])
def test_continuous_midflight_join_matches_solo(kernel):
    """On the card, requests that join a busy continuous batch (the ring
    pointer and clock away from 0) emit exactly what they emit decoded
    alone on the same kernel, greedy and sampled; the auto kernel is slab."""
    _card()
    import chip_smoke as cs
    learner = MusicLearner.load(DEMO)
    items = cs.batch_prompts(learner.vocab, 0, 3)
    make = lambda: ContinuousEngine(learner.params, learner.cfg, learner.vocab,
                                    n_slots=8, chunk=16,
                                    decode_kernel=None if kernel == "slab" else kernel)
    assert make().kernel == kernel
    jobs = [dict(n_words=96, greedy=True, seed=1),
            dict(n_words=64, seed=2, temperatures=(1.6, 1.3)),
            dict(n_words=80, seed=3, top_k=0, top_p=0.9)]
    cs.reset_launches()
    eng, futs = make(), []
    for i, kw in enumerate(jobs):
        futs.append(Future())
        eng.insert(2 * i + 1, items[i].data, future=futs[i], **kw)
        eng.step_chunk()
    while not all(f.done() for f in futs):
        eng.step_chunk()
    assert cs.launches()[kernel] > 0
    for it, kw, f in zip(items, jobs, futs):
        alone = make().generate(it.data, **kw)
        np.testing.assert_array_equal(alone, f.result())
        assert grammar_violations(f.result(), learner.vocab, prev_idx=int(it.data[-1])) == 0


@pytest.mark.cuda
def test_flash_prefill_at_window_96():
    """A bf16 config with ctx_len = mem_len = 96 (the demo weights) at B = 8:
    generate_batch's window is 96, not a multiple of the kernel's 64-row
    tile; the auto rules take the flash prefill (its tail tile) and
    slab_ar_w8, and txl.prefill through the kernel equals its materialized
    branch within test_prefill_flash_matches_materialized's bounds."""
    dev = _card()
    import chip_smoke as cs
    demo = MusicLearner.load(DEMO)
    cfg = demo.cfg.replace(ctx_len=96, mem_len=96)
    learner = MusicLearner(cfg, demo.vocab, demo.params)
    items = cs.batch_prompts(learner.vocab, 5, 8)
    cs.reset_launches()
    toks, lengths = learner.engine.generate_batch([it.data for it in items], n_words=16,
                                                  seed=1)
    assert cs.launches() == cs.only(slab_ar_w8=16, flash_prefill=cfg.n_layers)
    assert (lengths > 0).all()
    cs.prefill_phase(learner, items, dev, W=96)   # raises on a disagreement
