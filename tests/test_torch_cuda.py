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
                                      (1, 128, (0,)), (8, 96, (0, 17, 50))])
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
@pytest.mark.parametrize("H,Dh", [(12, 64), (8, 32)])
def test_flash_wgmma_entry_gives_the_same_bits(H, Dh):
    """The wgmma entry adds in a fixed order: two calls on the same inputs
    (B 16, W 512, padded rows) give the same bits, every row."""
    dev = _card()
    from chip_smoke import flash_inputs
    args = flash_inputs(16, 512, (0, 17, 300), H, Dh, dev, 3)
    e0 = fp.flash_prefill_attention.entries["wgmma"]
    first = fp.flash_prefill_attention(*args, H)
    second = fp.flash_prefill_attention(*args, H)
    torch.cuda.synchronize()
    assert fp.flash_prefill_attention.entries["wgmma"] == e0 + 2
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [512, 96])
def test_flash_row_alone_equals_its_row_in_a_batch(W):
    """A batch row's output, padded query rows included, is the same bits
    alone as in a batch of 16 (at W 96 its tail tile's keys past W come from
    no other batch row)."""
    dev = _card()
    from chip_smoke import flash_inputs
    q, k, v, wkr, u, vb, pad = flash_inputs(16, W, (0, 17, 50), 12, 64, dev, W)
    batch = fp.flash_prefill_attention(q, k, v, wkr, u, vb, pad, 12)
    for b in (0, 1, 2, 15):
        one = fp.flash_prefill_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], wkr, u, vb,
                                         pad[b:b + 1], 12)
        torch.cuda.synchronize()
        assert torch.equal(one[0], batch[b]), f"batch row {b}"


@pytest.mark.cuda
@pytest.mark.parametrize("H,Dh", [(6, 128), (48, 16)])
def test_flash_cuda_core_entry_matches_plain(H, Dh):
    """Head widths outside the wgmma entry's run the kept CUDA-core entry,
    held to the float32 plain version as test_flash_kernel_matches_plain
    (W 200: a tail tile)."""
    dev = _card()
    from chip_smoke import flash_check, flash_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    args = flash_inputs(8, 200, (0, 17, 50), H, Dh, dev, Dh)
    before = dict(fp.flash_prefill_attention.entries)
    _, ratio, finite = flash_check(args, H)
    assert fp.flash_prefill_attention.entries == {**before,
                                                  "cuda_core": before["cuda_core"] + 1}
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
    smoke's own draw, K/V drawn on the card) for the four slab modes, each
    kernel held to the smoke's float64 check (``chip_smoke.within_bounds``):
    |dh_out|, the largest int8 step, the two-step share and the written
    scales' relative difference each within its fixed bound plus PLAIN_K
    times the float32 plain version's, every other slot byte-identical.
    Prints each case with both distances, and the largest share of its
    bound that each distance took."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(str(cs.CKPT)).engine
    bad, largest = [], {}
    for name, tag, kernel, plain in cs.float64_cases(engine, cs.wkr_table(engine),
                                                     np.random.default_rng(seed), dev):
        limit = cs.bounds(name, plain)
        for metric, i in cs.DRIFT_METRICS:
            largest[metric] = max(largest.get(metric, 0.0), kernel[i] / limit[metric])
        line = (f"seed {seed} {name} {tag}: kernel vs f64 {[f'{d:.2e}' for d in kernel[:5]]}"
                f" | plain_f32 vs f64 {[f'{d:.2e}' for d in plain[:5]]}")
        if not cs.within_bounds(name, kernel, plain):
            bad.append(line)
        print(line, flush=True)
    print(f"seed {seed} largest distance over its bound: {largest}", flush=True)
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("mode,batches,rows", [
    ("slab_int8", (1, 16), None), ("slab_int8", (16,), 4), ("slab4", (1, 16), None),
    ("slab4", (16,), 16), ("slab4_w8", (3,), None), ("multirow", (1, 16), None),
    ("multirow_int8", (1, 16), None)])
def test_explicit_modes_against_float64(mode, batches, rows):
    """The explicit modes' kernels at the demo checkpoint's widths, every
    case of chip_smoke.py's kernel phase held to its float64 check
    (``chip_smoke.check_case`` raises on a disagreement)."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(DEMO).engine
    dh, ratio = cs.kernel_phase(engine, cs.wkr_table(engine), np.random.default_rng(7),
                                dev, mode, batches, rows)
    print(f"{mode} B in {batches} R {rows}: max |dh_out| {dh:.3e}, {ratio:.3f} of its bound")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_slab_int8_against_float64_flagship(seed):
    """slab_int8 at the flagship's widths over more card draws than the
    smoke's (B in {1, 64}, every ptr and ring), each case held to the
    float64 check with slab_int8's own two-step cap; prints the largest
    share of its bound each distance took."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(str(cs.CKPT)).engine
    wkr_mt, largest, bad = cs.wkr_table(engine), {}, []
    for B, ptr, kind, kv, blocked, h_in in cs.kernel_cases(
            engine, np.random.default_rng(seed), dev, (1, 64), "slab_int8"):
        args = ("slab_int8", engine, wkr_mt, kv, blocked, h_in, ptr)
        ref, f32 = cs.plain_step(*args), cs.plain_step(*args, acc=torch.float32)
        got = cs.run_step(*args)
        torch.cuda.synchronize()
        kernel = cs.step_diff(got, ref, kv, ptr, "slab_int8")
        plain = cs.step_diff(f32, ref, kv, ptr, "slab_int8")
        limit = cs.bounds("slab_int8", plain)
        for metric, i in cs.DRIFT_METRICS:
            largest[metric] = max(largest.get(metric, 0.0), kernel[i] / limit[metric])
        if not cs.within_bounds("slab_int8", kernel, plain):
            bad.append((B, ptr, kind, kernel[:5], plain[:5]))
    print(f"seed {seed} slab_int8 largest distance over its bound: {largest}")
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,rows,kv_int8", [
    ("slab_int8", None, False), ("slab4", 4, False), ("slab4_w8", None, False),
    ("multirow", None, False), ("multirow_int8", None, False), ("multirow", None, True)])
def test_explicit_mode_paths_go_through_the_kernel(kernel, rows, kv_int8):
    """generate_batch of 8 prompts with an explicit mode launches its kernel
    once a step and the flash prefill once a layer; the outputs re-parse.
    multirow with kv_int8 runs the multirow_int8 step, as in JAX."""
    _card()
    import chip_smoke as cs
    learner = MusicLearner.load(DEMO)
    vocab = learner.vocab
    items = [MusicItem.from_file(cs.prompt_midi(s, vocab), vocab).set_genre("jazz")
             .remove_eos() for s in range(8)]
    cs.reset_launches()
    toks, lengths = learner.engine.generate_batch(
        [it.data for it in items], n_words=16, seed=3, decode_kernel=kernel,
        rows_per_cell=rows, kv_int8=kv_int8)
    ran = "multirow_int8" if kv_int8 else kernel
    assert cs.launches() == cs.only(**{ran: 16}, flash_prefill=learner.cfg.n_layers)
    for i, it in enumerate(items):
        cs.check_continuation(it, toks[i][: lengths[i]], vocab)


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
    alone on the same kernel, greedy and sampled; the auto kernel is slab,
    which at these 8 slots runs the tensor-core chain."""
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


@pytest.mark.cuda
def test_s2s_kernel_against_float64():
    """chip_smoke.py's multitask kernel phase on the demo multitask
    checkpoint: fused_s2s_slab_core and fused_nw_slab_core in modes slab_w8
    and slab against s2s_slab_plain(acc=float64), by the smoke's float64
    check (raises on a disagreement), with one launch of the task's wrapper
    per case."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    torch.backends.cuda.matmul.allow_tf32 = False
    learner = MultitaskLearner.load(str(cs.MT_DEMO))
    cs.reset_launches()
    worst = cs.mt_kernel_phase(learner, "demo", np.random.default_rng(5), dev, (64, 128), 0.1)
    cases = 4 * len(cs.RINGS)
    assert cs.launches() == cs.only(s2s_slab_w8=2 * cases, s2s_slab=2 * cases,
                                    nw_slab_w8=cases, nw_slab=cases)
    print(worst)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["slab_w8", "slab", "fused"])
def test_multitask_tasks_go_through_the_kernel(kernel):
    """Harmonize and next-word on the demo multitask checkpoint launch the
    s2s / nw kernel once a token step (auto picks slab_w8; slab and the
    exact bf16 fused step on request); remix launches none; every output
    re-parses with no grammar violation."""
    _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    learner = MultitaskLearner.load(str(cs.MT_DEMO),
                                    decode_kernel="auto" if kernel == "slab_w8" else kernel)
    counts = cs.mt_tasks(learner, "demo", 3, kernel, n_s2s=48, n_nw=40)
    assert counts == cs.only(**{f"s2s_{kernel}": 48, f"nw_{kernel}": 40})


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("case", ["causal", "mem40", "win3", "pad", "dropout", "m0_pad"])
def test_flash_train_kernels_against_float64(case, Dh):
    """The flash train forward and backward kernels against the plain version
    by chip_smoke.py's float64 check (output and six gradients), at B 2,
    L 256, K 512, four heads, in the smoke's five cases; and at M = 0 (K 256)
    with key padding and dropout: batch row 1 pads its first 37 keys, so its
    rows 0..36 see no key, inside query tile 0 whose key tiles 1..3 the
    causal mask blocks whole: the tile map must skip none of them."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    torch.backends.cuda.matmul.allow_tf32 = False
    if case == "m0_pad":
        kw, pad, K = dict(win_size=1, win_k=1, mem_valid=0, attn_p=0.1), True, 256
    else:
        kw, pad = {name: (c, p) for name, c, p in cs.TRAIN_CASES}[case]
        kw, K = dict(kw, mem_valid=min(kw["mem_valid"], 256)), 512
    inp = cs.train_inputs(2, 256, K, 4, Dh, dev, seed=Dh, pad=pad)
    if case == "m0_pad":
        tiles = ftr.tile_map(*ftr.mask_vectors(2, 256, K, 1, 1, 0, inp["pad"], dev))
        assert (tiles[1, 0] == ftr.MIXED).all() and (tiles[0, 0, 1:] == ftr.SKIP).all()
    before = dict(ftr.flash_train_attention.launches)
    ok, report = cs.train_check(ftr.flash_train_attention, ftr.flash_train_attention_plain,
                                inp, 4, **kw, attn_seed=cs.TRAIN_SEED)
    print(case, Dh, report)
    assert ok, report
    assert ftr.flash_train_attention.launches == {k: n + 1 for k, n in before.items()}


@pytest.mark.cuda
def test_flash_train_backward_is_reproducible():
    """dWkr, du and dv are summed over the batch in a fixed order: two
    backward passes on the same inputs give the same bits."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    inp = cs.train_inputs(4, 128, 256, 2, 64, dev, seed=1)
    runs = [cs.train_run(ftr.flash_train_attention, inp, 2, 1, 1, 128, attn_p=0.1,
                         attn_seed=7) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_train_backward_is_reproducible_with_skipped_tiles():
    """The same at the multitask decoder's shape (B 16, L = K = 512, eight
    heads, M = 0, causal, key padding, dropout): tile pairs skipped, query
    tiles with fully blocked rows, several batch rows a dQ block."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    inp = cs.train_inputs(16, 512, 512, 8, 64, dev, seed=3, pad=True)
    tiles = ftr.tile_map(*ftr.mask_vectors(16, 512, 512, 1, 1, 0, inp["pad"], dev))
    assert (tiles == ftr.SKIP).any() and ftr.partial_slots(16, 512, 8, dev) < 16 * 8
    runs = [cs.train_run(ftr.flash_train_attention, inp, 8, 1, 1, 0, attn_p=0.1,
                         attn_seed=7) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_train_refuses_what_the_kernels_do_not_take():
    dev = _card()
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    z = lambda *s, dt=torch.bfloat16: torch.zeros(s, dtype=dt, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        ftr.flash_train_attention(z(2, 128, 128, dt=torch.float32),
                                  z(2, 256, 128, dt=torch.float32),
                                  z(2, 256, 128, dt=torch.float32),
                                  z(256, 128, dt=torch.float32), z(2, 64), z(2, 64), 1, 1, 0, 2)
    with pytest.raises(ValueError, match="multiples"):
        ftr.flash_train_attention(z(2, 96, 128), z(2, 192, 128), z(2, 192, 128), z(192, 128),
                                  z(2, 64), z(2, 64), 1, 1, 0, 2)


@pytest.mark.cuda
def test_train_step_goes_through_the_kernels():
    """A bf16 model at B = 8, L = M = 128: the train step's auto rule takes
    the flash train kernels, one forward and one backward launch per layer,
    and never the plain version; its loss equals the materialized branch's
    within bf16 rounding."""
    dev = _card()
    from deepmusicgeneration_tpu_torch.models.config import small_test_config
    from deepmusicgeneration_tpu_torch.models.precision import master_params
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    from deepmusicgeneration_tpu_torch.train import loop
    cfg = small_test_config().replace(dtype="bfloat16", d_model=128, n_heads=2, d_head=64,
                                      ctx_len=128, mem_len=128)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 300, (3, 8, 128)).astype(np.int32)
    losses = {}
    for flash in (None, False):
        opt = loop.make_optimizer(10)
        params = master_params(txl.init_txl(cfg), dev)
        state = loop.TrainState(params, opt.init(params), txl.init_state(cfg, 8, device=dev), 0)
        step = loop.make_train_step(cfg, opt, pad_idx=1, flash=flash)
        before, calls = dict(ftr.flash_train_attention.launches), \
            ftr.flash_train_attention_plain.calls
        for i in range(2):
            state, m = step(state, {"x": x[i], "y": x[i + 1]}, None, win_size=1 + 2 * i)
        torch.cuda.synchronize()
        losses[flash] = float(m["loss"])
        got = {k: n - before[k] for k, n in ftr.flash_train_attention.launches.items()}
        assert got == ({"fwd": 4, "bwd": 4} if flash is None else {"fwd": 0, "bwd": 0})
        assert ftr.flash_train_attention_plain.calls == calls
    assert abs(losses[None] - losses[False]) < 2e-2, losses


MT_CASES = {   # (kind, L, K, pad, case): chip_smoke.py's multitask cases at B 2, 4 heads
    "bidir": ("bidir", 256, 256, False, {}),
    "bidir_pad": ("bidir", 256, 256, True, {}),
    "bidir_dropout": ("bidir", 256, 256, False, dict(attn_p=0.1)),
    "cross": ("cross", 256, 256, False, {}),
    "cross_l128_k256": ("cross", 128, 256, False, {}),
    "cross_dropout": ("cross", 256, 256, False, dict(attn_p=0.1)),
    # batch row 0 fully padded (its query tiles skip nothing), row 1's last
    # two key tiles padded (skipped)
    "bidir_pad_rows": ("bidir", 256, 256, "rows", dict(attn_p=0.1)),
    "cross_l128_k256_dropout": ("cross", 128, 256, False, dict(attn_p=0.1)),
    "train_m0_pad": ("train", 256, 256, True, dict(win_size=1, win_k=1, mem_valid=0)),
    "train_m0_win3": ("train", 256, 256, False, dict(win_size=3, win_k=0, mem_valid=0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("case", list(MT_CASES))
def test_flash_mt_kernels_against_float64(case, Dh):
    """The bidirectional and cross train kernels, and the train kernel with
    no memory (the multitask decoder's call), against their plain versions
    by chip_smoke.py's float64 check (output and six gradients)."""
    import functools
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    kind, L, K, pad, kw = MT_CASES[case]
    inp = cs.train_inputs(2, L, K, 4, Dh, dev, seed=Dh + 1, pad=pad)
    if pad == "rows":
        from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
        tiles = ftr.bidir_tile_map(inp["pad"].to(torch.int32))
        assert (tiles[0] == ftr.MIXED).all() and (tiles[1, :, 2:] == ftr.SKIP).all()
    kernel, plain = cs.MT_TRAIN_FNS[kind]
    run = cs.train_run if kind == "train" else functools.partial(cs.mt_run, kind=kind)
    before = dict(kernel.launches)
    ok, report = cs.train_check(kernel, plain, inp, 4, run=run, **kw, attn_seed=cs.TRAIN_SEED)
    print(case, Dh, report)
    assert ok, report
    assert kernel.launches == {k: n + 1 for k, n in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bidir", "cross"])
def test_flash_mt_backward_is_reproducible(kind):
    """dWkr, du and dv (and the bidirectional dQ seam) are summed in a fixed
    order: two backward passes on the same inputs give the same bits, at the
    multitask train shape (B 16, W 512, eight heads, dropout) with several
    batch rows a dQ block and, bidir, the leading key padding's skipped
    tiles."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    inp = cs.train_inputs(16, 512, 512, 8, 64, dev, seed=2, pad=True)
    assert ftr.partial_slots(16, 512, 8, dev) < 16 * 8
    if kind == "bidir":
        assert (ftr.bidir_tile_map(inp["pad"].to(torch.int32)) == ftr.SKIP).any()
    runs = [cs.mt_run(cs.MT_TRAIN_FNS[kind][0], inp, 8, kind, attn_p=0.1, attn_seed=7)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mt_train_step_goes_through_the_kernels():
    """A bf16 multitask model at B = 8, L = 128 on the card: one fit step of
    a mask batch launches one bidirectional forward and backward a layer, an
    s2s batch one of each kernel a layer and task; never a plain version."""
    dev = _card()
    from deepmusicgeneration_tpu_torch.models.config import MultitaskConfig
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    from deepmusicgeneration_tpu_torch.vocab import MusicVocab
    vocab = MusicVocab.create()
    cfg = MultitaskConfig(vocab_size=len(vocab), enc_layers=2, dec_layers=2, d_model=128,
                          d_inner=256, n_heads=2, d_head=64, ctx_len=128, mem_len=128)
    rng = np.random.default_rng(0)
    tok = lambda: rng.integers(4, len(vocab), (8, 128)).astype(np.int32)
    s2s = ({"s2f": {"enc": tok(), "dec": tok()}, "f2s": {"enc": tok(), "dec": tok()}},
           {"s2f": tok(), "f2s": tok()})
    batches = [({"msk": {"x": tok()}}, {"msk": tok()}), s2s] * 2
    wrappers = (ftr.flash_bidir_attention, ftr.flash_cross_attention, ftr.flash_train_attention)
    before = [dict(w.launches) for w in wrappers]
    plains = (ftr.flash_bidir_attention_plain, ftr.flash_cross_attention_plain,
              ftr.flash_train_attention_plain)
    calls = [p.calls for p in plains]
    learner = MultitaskLearner(cfg, vocab, generator=torch.Generator().manual_seed(0))
    result = learner.fit(batches, epochs=1, log_fn=lambda s: None)
    torch.cuda.synchronize()
    got = [{k: n - b[k] for k, n in w.launches.items()} for w, b in zip(wrappers, before)]
    # per epoch: 2 mask steps (2 layers) + 2 s2s steps (2 tasks x 2 layers)
    assert got == [{"fwd": 4 + 8, "bwd": 4 + 8}, {"fwd": 8, "bwd": 8}, {"fwd": 8, "bwd": 8}]
    assert [p.calls for p in plains] == calls
    assert np.isfinite(result.losses).all()


@pytest.mark.cuda
def test_mt_flash_route_matches_the_score_path():
    """A bf16 multitask model at B = 8, L = 128 on the card: the multi_loss
    and its gradients through the flash kernels against the score path
    (``flash_train=False``), window 3, on a mask batch and on an s2s batch
    with key padding, by chip_smoke.py's route check and its bounds."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.models.config import MultitaskConfig
    from deepmusicgeneration_tpu_torch.ops import flash_train as ftr
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    from deepmusicgeneration_tpu_torch.vocab import MusicVocab
    vocab = MusicVocab.create()
    cfg = MultitaskConfig(vocab_size=len(vocab), enc_layers=2, dec_layers=2, d_model=128,
                          d_inner=256, n_heads=2, d_head=64, ctx_len=128, mem_len=128)
    params = MultitaskLearner(cfg, vocab, generator=torch.Generator().manual_seed(0)).params
    rng = np.random.default_rng(1)
    tok = lambda: rng.integers(4, len(vocab), (8, 128)).astype(np.int32)
    pad = np.zeros((8, 128), bool)
    pad[1, -40:] = True
    s2s = {t: {"enc": tok(), "dec": tok(), "enc_pad": pad, "dec_pad": pad}
           for t in ("s2f", "f2s")}
    wrappers = (ftr.flash_bidir_attention, ftr.flash_cross_attention, ftr.flash_train_attention)
    before = [w.launches["bwd"] for w in wrappers]
    for name, batch in (("mask", ({"msk": {"x": tok()}}, {"msk": tok()})),
                        ("s2s", (s2s, {"s2f": tok(), "f2s": tok()}))):
        fl, sc, rel = cs.mt_route_check(params, cfg, batch, vocab.pad_idx, dev)
        print(name, fl, sc, rel)
        assert abs(fl - sc) <= cs.MT_ROUTE_LOSS_ATOL, (name, fl, sc)
        assert rel <= cs.MT_ROUTE_GRAD_REL, (name, rel)
    assert [w.launches["bwd"] - b for w, b in zip(wrappers, before)] == [2 + 4, 4, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("case", range(6))           # chip_smoke.MT_PREFILL_CASES
def test_flash_encoder_kernel_matches_plain(case, Dh):
    """chip_smoke.py's multitask prefill kernel cases at B <= 4, 2 heads:
    flash_encoder_attention (bidirectional, every row; causal, the real rows)
    against its float32 plain version by the exact-float32 check."""
    dev = _card()
    import chip_smoke as cs
    assert len(cs.MT_PREFILL_CASES) == 6
    name, causal, B, W, pads = cs.MT_PREFILL_CASES[case]
    args = cs.flash_inputs(min(B, 4), W, pads, 2, Dh, dev, 11 + case, right=not causal)
    err, ratio, finite = cs.encoder_check(args, 2, causal)
    print(name, err, ratio)
    assert ratio <= 1.0 and finite


@pytest.mark.cuda
def test_mt_prefill_goes_through_the_kernels():
    """encode, decoder_prefill and lm_prefill on the demo multitask
    checkpoint at B = 8, W = 128 take the flash kernels under the auto rule,
    one launch a layer, and agree with their flash=False branch by
    chip_smoke.py's bounds; at B = 1 they launch nothing."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    learner = MultitaskLearner.load(str(cs.MT_DEMO))
    counts = cs.mt_prefill_phase(learner, "demo", dev, 3, B=8, W=128)   # raises on a fault
    cfg = learner.cfg
    assert counts == cs.only(flash_encoder_bidir=cfg.enc_layers,
                             flash_encoder_causal=2 * cfg.dec_layers)


@pytest.mark.cuda
def test_fused_kernels_against_float64():
    """chip_smoke.py's fused kernel phase on the demo multitask checkpoint
    with biases of std 0.1: fused_s2s_step_core and fused_nw_step_core
    against s2s_fused_plain(acc=float64) by the fused check (raises on a
    disagreement), one launch of the task's wrapper per case."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    torch.backends.cuda.matmul.allow_tf32 = False
    learner = MultitaskLearner.load(str(cs.MT_DEMO))
    cs.reset_launches()
    worst = cs.mt_fused_kernel_phase(learner, "demo", np.random.default_rng(6), dev, (64, 128),
                                     0.1)
    cases = len(cs.FUSED_PTRS(learner.cfg.mem_len)) * len(cs.RINGS)
    assert cs.launches() == cs.only(s2s_fused=2 * cases, nw_fused=cases)
    print(worst)


def _mt_step_case(mode, task, Le):
    """One multitask step case on the demo checkpoint's widths with biases of
    std 0.1, a short ring at ptr = M - 1 and, for s2s, ``Le`` encoder slots:
    (call: the wrapper on fresh copies of the ring; at_grid(g): the same
    step launched on g blocks; the co-resident grid; the float64 check of
    one launch, which raises on a disagreement)."""
    dev = _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.ops import fused_s2s as fs
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    torch.backends.cuda.matmul.allow_tf32 = False
    learner = MultitaskLearner.load(str(cs.MT_DEMO))
    cfg = learner.cfg
    M, L, HD = cfg.mem_len, cfg.dec_layers, cfg.n_heads * cfg.d_head
    rng = np.random.default_rng(21)
    ptr = M - 1
    blocked = torch.from_numpy(cs.ring_blocked(1, M, ptr, "short")).to(dev)
    h_in = learner.engine("s2s").params["embed"].float()[:1]
    grid = fs.step_grid(mode, cfg, M, Le, task == "s2s", dev)
    if mode == "fused":
        stacked, _ = cs.mt_weights(learner, "fused", rng, dev, 0.1)
        wkr = cs.fused_wkr(learner)
        kv = cs.fused_ring(cfg, "short", rng, dev)
        cross = cs.fused_cross(cfg, Le, rng, dev) if task == "s2s" else None
        args = (task, cfg, stacked, wkr, kv, cross, blocked, h_in, ptr)

        def check():
            ref, f32 = (cs.fused_step(*args, acc=acc) for acc in (torch.float64, torch.float32))
            got = cs.fused_step(*args)
            torch.cuda.synchronize()
            assert cs.within_fused_bounds(cs.fused_diff(got, ref, kv, ptr),
                                          cs.fused_diff(f32, ref, kv, ptr))

        return (lambda **kw: cs.fused_step(*args, **kw),
                lambda g: fs._fused_launch(stacked, cfg, h_in, wkr, *[t.clone() for t in kv],
                                           cross, blocked, ptr, M, grid=g), grid, check)
    weights = cs.mt_weights(learner, mode, rng, dev, 0.1)
    wkr_mt = cs.mt_wkr(learner)
    kv = cs.ring_kv(L, 1, M, HD, "short", rng, dev)
    cross = cs.mt_cross(cfg, Le, rng, dev) if task == "s2s" else None
    args = (task, cfg, weights, wkr_mt, kv, cross, blocked, h_in, ptr)
    return (lambda **kw: cs.mt_step(*args, **kw),
            lambda g: fs._launch(mode, *weights, cfg, h_in, wkr_mt, *[t.clone() for t in kv],
                                 cross, blocked, ptr, M, grid=g), grid,
            lambda: cs.check_case(f"{task}[{mode}]", mode, kv, ptr, lambda: cs.mt_step(*args),
                                  lambda acc: cs.mt_step(*args, acc=acc), f"Le={Le} ptr={ptr}"))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["s2s", "nw"])
@pytest.mark.parametrize("mode", ["slab_w8", "slab", "fused"])
def test_mt_step_is_one_kernel_a_call(mode, task):
    """A wrapper call of each multitask step variant runs exactly one CUDA
    kernel, the persistent step (5 calls on one ring: 5 launches counted by
    the wrapper, only the step kernel and at most 5 under torch.profiler;
    chip_smoke.step_kernels), and counts one launch."""
    import chip_smoke as cs
    call, _, _, _ = _mt_step_case(mode, task, 1024)
    _, recorded = cs.step_kernels(f"{task}[{mode}]", lambda: call(clone=False), 5)
    assert 0 < recorded <= 5
    cs.reset_launches()
    call(clone=False)
    assert cs.launches() == cs.only(**{f"{task}_{mode}": 1})


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["s2s", "nw"])
@pytest.mark.parametrize("mode", ["slab_w8", "slab", "fused"])
def test_mt_step_bits_do_not_depend_on_launch_or_grid(mode, task):
    """At Le = 1024 and ptr = M - 1: two launches give the same bits, a
    launch on half the co-resident grid (and on 7 blocks) gives them too,
    and the step passes the float64 check."""
    call, at_grid, grid, check = _mt_step_case(mode, task, 1024)
    a, b = call(), call()
    c, d = at_grid(max(1, grid // 2)), at_grid(7)
    torch.cuda.synchronize()
    for other in (b, c, d):
        assert all(torch.equal(x, y) for x, y in zip(a, other))
    check()


@pytest.mark.cuda
def test_fused_greedy_follows_the_exact_ring_step():
    """32 greedy steps of harmonize and next-word on the demo with the fused
    kernel equal those of the exact ring step, or diverge first at a
    near-tie (chip_smoke.py's greedy check)."""
    _card()
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
    counts = cs.fused_greedy_phase(MultitaskLearner.load(str(cs.MT_DEMO)), 4, n_words=32)
    assert counts == cs.only(s2s_fused=32, nw_fused=32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,batches", [("fused_stack", (1,)), ("fused_batched", (1, 16)),
                                          ("slab_int8_w8", (1, 16))])
def test_row10_kernels_against_float64(mode, batches):
    """fused_stack_decode, fused_batched_decode and the int8-score slab step
    over int8 panels at the demo checkpoint's widths, every case of
    chip_smoke.py's kernel phase held to its float64 check (raises on a
    disagreement, or if fused_stack changes rows 1-7 of its h block)."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(DEMO).engine
    cs.reset_launches()
    dh, ratio = cs.kernel_phase(engine, cs.wkr_table(engine), np.random.default_rng(8),
                                dev, mode, batches)
    cases = len(batches) * len(cs.kernel_ptrs(mode, engine.cfg.mem_len)) * len(cs.RINGS)
    assert cs.launches() == cs.only(**{mode: cases})
    print(f"{mode} B in {batches}: max |dh_out| {dh:.3e}, {ratio:.3f} of its bound")


@pytest.mark.cuda
def test_stack_path_follows_the_exact_ring_step():
    """chip_smoke.py's row-10 path on the demo checkpoint: one prompt at
    B = 1 and 16 at B = 16, 32 greedy steps of one launch each, the MIDI
    re-parsed; then the stack phase's gate at every step of the path driven
    by the float64 plain step (the logits within STACK_F64_ATOL + PLAIN_K x
    the float32 plain step's distance, the argmax rule, the written slot,
    rows 1-7 of the h block), the exact ring step's shares reported."""
    _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    learner = MusicLearner.load(DEMO)
    items = cs.batch_prompts(learner.vocab, 0, 16)
    assert cs.stack_path_phase(learner, items, 32) == {"fused_stack": 32, "fused_batched": 32}


@pytest.mark.cuda
@pytest.mark.parametrize("batches,extra,chain", [((3, 5), 0, True), ((1, 5, 16), 8, False)],
                         ids=["chain_B3_B5", "old_chain_mem_len_plus_8"])
def test_row10_edge_cases_against_float64(batches, extra, chain):
    """fused_batched_decode's tensor-core chain below 8 rows (B = 3 and 5:
    clusters of 4 with padded rows), and its old chain (fused_batched_step)
    at mem_len + 8, a size the chain refuses, at the demo checkpoint's
    widths: every case of chip_smoke.py's kernel phase held to its float64
    check (raises on a disagreement), one launch counted a case."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(DEMO).engine
    M = engine.cfg.mem_len + extra
    cs.reset_launches()
    dh, ratio = cs.edge_phase(engine, np.random.default_rng(18), dev, "fused_batched", batches,
                              M if extra else None, chain)
    cases = len(batches) * len(cs.kernel_ptrs("fused_batched", M)) * len(cs.RINGS)
    assert cs.launches() == cs.only(fused_batched=cases)
    print(f"fused_batched B in {batches} M={M}: max |dh_out| {dh:.3e}, {ratio:.3f} of its bound")


def _row10_case(engine, B, ptr, kind, rng, dev):
    """Row 10's inputs at B rows: the caches, blocked and h_in (B rows of
    embedded tokens) of a ring of ``kind``, and the relative table."""
    import chip_smoke as cs
    cfg, M = engine.cfg, engine.cfg.mem_len
    kv, blocked = cs.ring_inputs(cfg, B, M, ptr, kind, rng, dev, "fused_batched")
    h_in = engine.params["embed"].float()[torch.from_numpy(rng.integers(12, 140, B)).to(dev)]
    return kv, blocked, h_in, cs.mode_wkr("fused_batched", cs.wkr_table(engine), cfg.n_heads)


@pytest.mark.cuda
def test_row10_chain_bits_repeat_and_do_not_depend_on_the_batch():
    """On the tensor-core chain two launches of fused_batched_decode on the
    same B = 16 inputs give the same bits, and so do two of
    fused_stack_decode; each row of the B = 16 step (h_out and its caches)
    equals a B = 1 fused_batched step of that row alone and, row 0, the
    fused_stack step of it (row 0 of its h block), bit for bit: the K
    chunks and every sum order come from the widths, never from B."""
    dev = _card()
    import chip_smoke as cs
    engine = MusicLearner.load(DEMO).engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, _ = engine.stacked()
    rng = np.random.default_rng(19)
    for ptr, kind in ((31, "part"), (M - 1, "full"), (5, "short")):
        kv, blocked, h_in, wkr = _row10_case(engine, 16, ptr, kind, rng, dev)
        assert fd.tc_path("fused_batched", cfg, 16, M) and fd.tc_path("fused_stack", cfg, 1, M)
        batched = lambda h, caches, blk: fd.fused_batched_decode(
            stacked, cfg, h, wkr, *[t.clone() for t in caches], blk, ptr, M)
        a, b = batched(h_in, kv, blocked), batched(h_in, kv, blocked)
        block = torch.cat([h_in[:1], torch.randn(7, cfg.d_model, device=dev)])
        stack = lambda: fd.fused_stack_decode(stacked, cfg, block, wkr,
                                              *[t[:, :1].clone() for t in kv], blocked[:1], ptr, M)
        s1, s2 = stack(), stack()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (kind, ptr)
        assert all(torch.equal(x, y) for x, y in zip(s1, s2)), (kind, ptr)
        assert torch.equal(s1[0][1:], block[1:])
        assert torch.equal(s1[0][:1], a[0][:1]), (kind, ptr)
        assert all(torch.equal(x[:, :1], y) for x, y in zip(a[1:], s1[1:])), (kind, ptr)
        for r in (0, 5, 15):
            one = batched(h_in[r:r + 1].contiguous(), [t[:, r:r + 1] for t in kv],
                          blocked[r:r + 1].contiguous())
            torch.cuda.synchronize()
            assert torch.equal(a[0][r:r + 1], one[0]), (kind, ptr, r)
            assert all(torch.equal(x[:, r:r + 1], y) for x, y in zip(a[1:], one[1:])), (kind, r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused_stack", "fused_batched"])
def test_row10_chain_kernels(mode):
    """Row 10's steps on the tensor-core chain: the library counts 7 kernels
    a layer, and under torch.profiler a step (B = 1 for fused_stack, 16 for
    fused_batched) runs only the chain's kernels, that many a step. The
    profiler can drop records, so a window that recorded fewer is taken
    again, up to three windows."""
    dev = _card()
    import chip_smoke as cs
    engine = MusicLearner.load(DEMO).engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    per_step = 7 * cfg.n_layers
    assert fd.kernels_per_step(cfg.n_layers, mode, True) == per_step
    assert fd.planned_kernels_per_step(cfg.n_layers, mode, True) == per_step
    B = 1 if mode == "fused_stack" else 16
    kv, blocked, h_in, wkr = _row10_case(engine, B, 40, "part", np.random.default_rng(20), dev)
    if mode == "fused_stack":
        h_in = torch.cat([h_in, torch.zeros(7, cfg.d_model, device=dev)])
    stacked, _ = engine.stacked()
    step = lambda: cs.CORES[mode](stacked, cfg, h_in, wkr, *kv, blocked, 40, M)
    for _ in range(3):
        recorded, chain = cs.chain_kernels(mode, step, per_step, True, n=4)
        if recorded == per_step:
            break
    assert chain == "tensor-core" and recorded == per_step


TC_MODES = ("slab4_w8", "multirow_int8", "slab4", "slab_int8", "multirow", "slab",
            "slab_ar_w8", "slab_ar", "slab_w8")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 24, 64])
@pytest.mark.parametrize("mode", TC_MODES)
def test_tc_modes_against_float64(mode, B):
    """slab4_w8, multirow_int8, slab4, slab_int8 (min(B, 8) rows a cell),
    multirow, slab, slab_ar_w8, slab_ar and slab_w8 on their tensor-core
    chain (csrc/tc_decode.cuh) at B >= 8 at the demo checkpoint's widths:
    every case of chip_smoke.py's kernel phase held to its float64 check
    (raises on a disagreement), one launch counted a case."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(DEMO).engine
    M = engine.cfg.mem_len
    assert fd.tc_path(mode, engine.cfg, B, M)
    cs.reset_launches()
    dh, ratio = cs.kernel_phase(engine, cs.wkr_table(engine), np.random.default_rng(9), dev,
                                mode, (B,))
    assert cs.launches() == cs.only(**{mode: len(cs.kernel_ptrs(mode, M)) * len(cs.RINGS)})
    print(f"{mode} B={B}: max |dh_out| {dh:.3e}, {ratio:.3f} of its bound")


@pytest.mark.cuda
@pytest.mark.parametrize("batches,extra,chain", [((3, 5), 0, True), ((1, 5, 16), 8, False)],
                         ids=["chain_B3_B5", "old_chain_mem_len_plus_8"])
def test_multirow_edge_cases_against_float64(batches, extra, chain):
    """multirow's tensor-core chain below 8 rows (B = 3 and 5: clusters of 4
    with padded rows), and its old chain (multirow_step) at mem_len + 8, a
    size the chain refuses, at the demo checkpoint's widths: every case of
    chip_smoke.py's kernel phase held to its float64 check (raises on a
    disagreement), one launch counted a case."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(DEMO).engine
    M = engine.cfg.mem_len + extra
    cs.reset_launches()
    dh, ratio = cs.edge_phase(engine, np.random.default_rng(11), dev, "multirow", batches,
                              M if extra else None, chain)
    cases = len(batches) * len(cs.kernel_ptrs("multirow", M)) * len(cs.RINGS)
    assert cs.launches() == cs.only(multirow=cases)
    print(f"multirow B in {batches} M={M}: max |dh_out| {dh:.3e}, {ratio:.3f} of its bound")


@pytest.mark.cuda
@pytest.mark.parametrize("batches,extra,chain", [((1, 2, 4), 0, True), ((1, 4), 8, False)],
                         ids=["chain_B1_B2_B4", "old_chain_mem_len_plus_8"])
def test_slab_w8_edge_cases_against_float64(batches, extra, chain):
    """slab_w8, whose tensor-core chain serves every B: the chain below 8
    rows (B = 1, 2 and 4, one cluster of 4 with padded rows), and the old
    chain (slab_w8_step, the route for the sizes tc_accepts refuses) at
    mem_len + 8, at the demo checkpoint's widths: every case of
    chip_smoke.py's kernel phase held to its float64 check (raises on a
    disagreement), one launch counted a case."""
    mode = "slab_w8"
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(DEMO).engine
    M = engine.cfg.mem_len + extra
    cs.reset_launches()
    dh, ratio = cs.edge_phase(engine, np.random.default_rng(17), dev, mode, batches,
                              M if extra else None, chain)
    cases = len(batches) * len(cs.kernel_ptrs(mode, M)) * len(cs.RINGS)
    assert cs.launches() == cs.only(**{mode: cases})
    print(f"{mode} B in {batches} M={M}: max |dh_out| {dh:.3e}, {ratio:.3f} of its bound")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,batches,extra,chain", [
    ("slab_ar_w8", (1, 4), 0, False), ("slab_ar", (1, 4), 0, False),
    ("slab_ar_w8", (8, 16), 8, False), ("slab_ar", (8, 16), 8, False),
    ("slab_ar_w8", (72, 128), 0, True), ("slab_ar", (72,), 0, True)],
    ids=["w8_old_chain_B1_B4", "bf16_old_chain_B1_B4", "w8_old_chain_mem_len_plus_8",
         "bf16_old_chain_mem_len_plus_8", "w8_chain_B72_B128", "bf16_chain_B72"])
def test_allrows_edge_cases_against_float64(mode, batches, extra, chain):
    """The all-rows steps' old chain (slab_ar_w8_step / slab_ar_step, the
    route for the sizes tc_accepts refuses) at B = 1 and 4 and at mem_len + 8
    (not a multiple of 16) at B = 8 and 16, and their tensor-core chain at
    B = 72 (a second row group of 8 live rows) and 128 (two whole ones), at
    the demo checkpoint's widths: every case of chip_smoke.py's kernel phase
    held to its float64 check (raises on a disagreement), one launch counted
    a case."""
    dev = _card()
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = MusicLearner.load(DEMO).engine
    M = engine.cfg.mem_len + extra
    cs.reset_launches()
    dh, ratio = cs.edge_phase(engine, np.random.default_rng(14), dev, mode, batches,
                              M if extra else None, chain)
    cases = len(batches) * len(cs.kernel_ptrs(mode, M)) * len(cs.RINGS)
    assert cs.launches() == cs.only(**{mode: cases})
    print(f"{mode} B in {batches} M={M}: max |dh_out| {dh:.3e}, {ratio:.3f} of its bound")


@pytest.mark.cuda
def test_slab_ar_chain_equals_slab_chain():
    """At B = 16 the slab_ar step and the slab step run one instantiation of
    the tensor-core chain (bf16 panels, GroupSlotI8 over the int8 ring): on
    the same inputs their h_out and caches are equal bit for bit."""
    dev = _card()
    import chip_smoke as cs
    engine = MusicLearner.load(DEMO).engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    wkr_mt = cs.wkr_table(engine)
    rng = np.random.default_rng(15)
    for ptr, kind in ((31, "part"), (M - 1, "full"), (5, "short")):
        kv, blocked = cs.ring_inputs(cfg, 16, M, ptr, kind, rng, dev, "slab")
        h_in = engine.params["embed"].float()[torch.from_numpy(rng.integers(12, 140, 16)).to(dev)]
        assert fd.tc_path("slab", cfg, 16, M) and fd.tc_path("slab_ar", cfg, 16, M)
        a = cs.run_step("slab_ar", engine, wkr_mt, kv, blocked, h_in, ptr)
        b = cs.run_step("slab", engine, wkr_mt, kv, blocked, h_in, ptr)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (kind, ptr)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", TC_MODES)
def test_tc_step_bits_repeat_and_do_not_depend_on_the_batch(mode):
    """On the tensor-core chain two launches on the same B = 64 inputs give
    the same bits, and rows 8-15 of that step (h_out and the caches) equal
    a B = 8 step of those rows alone, bit for bit: the K chunks and every
    sum order are fixed by the widths, never by B. slab_int8 runs 8 rows a
    cell, so rows 8-15 are one cell in both steps: its scales come from that
    cell alone."""
    dev = _card()
    import chip_smoke as cs
    engine = MusicLearner.load(DEMO).engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    wkr_mt = cs.wkr_table(engine)
    rng = np.random.default_rng(12)
    for ptr, kind in ((31, "part"), (M - 1, "full"), (5, "short")):
        kv, blocked = cs.ring_inputs(cfg, 64, M, ptr, kind, rng, dev, mode)
        h_in = engine.params["embed"].float()[torch.from_numpy(rng.integers(12, 140, 64)).to(dev)]
        args = (mode, engine, wkr_mt, kv, blocked, h_in, ptr)
        a, b = cs.run_step(*args), cs.run_step(*args)
        sub = [t[:, 8:16].contiguous() for t in kv]
        r8 = cs.run_step(mode, engine, wkr_mt, sub, blocked[8:16].contiguous(),
                         h_in[8:16].contiguous(), ptr)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (kind, ptr)
        assert torch.equal(a[0][8:16], r8[0]), (kind, ptr)
        assert all(torch.equal(x[:, 8:16], y) for x, y in zip(a[1:], r8[1:])), (kind, ptr)


@pytest.mark.cuda
def test_slab_w8_row0_equals_slab_ar_w8():
    """slab_w8 and slab_ar_w8 bind one chain entry (slab_w8_tc_step, int8
    panels over the int8 ring), so slab_w8 at B = 1 gives row 0 of
    slab_ar_w8's B = 8 step on the same inputs: h_out and the written
    caches, bit for bit, since the K chunks come from the widths alone."""
    dev = _card()
    import chip_smoke as cs
    one_mode, one_b, twin, twin_b = "slab_w8", 1, "slab_ar_w8", 8
    engine = MusicLearner.load(DEMO).engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    wkr_mt = cs.wkr_table(engine)
    rng = np.random.default_rng(16)
    for ptr, kind in ((31, "part"), (M - 1, "full"), (5, "short")):
        kv, blocked = cs.ring_inputs(cfg, twin_b, M, ptr, kind, rng, dev, twin)
        h_in = engine.params["embed"].float()[
            torch.from_numpy(rng.integers(12, 140, twin_b)).to(dev)]
        assert fd.tc_path(one_mode, cfg, one_b, M) and fd.tc_path(twin, cfg, twin_b, M)
        a = cs.run_step(twin, engine, wkr_mt, kv, blocked, h_in, ptr)
        b = cs.run_step(one_mode, engine, wkr_mt, [t[:, :1].contiguous() for t in kv],
                        blocked[:1].contiguous(), h_in[:1].contiguous(), ptr)
        torch.cuda.synchronize()
        assert torch.equal(a[0][:1], b[0][:1]), (kind, ptr)
        assert all(torch.equal(x[:, :1], y) for x, y in zip(a[1:], b[1:])), (kind, ptr)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", TC_MODES)
def test_tc_step_kernels(mode):
    """The kernel library counts 7 kernels a layer on the tensor-core chain
    (9 for slab_int8) and 10 (12) on the old one, as planned_kernels_per_step
    mirrors it, and asks for the scratch that fd.tc_scratch_layout mirrors;
    under torch.profiler a chain step at B = 16 runs only the chain's
    kernels, at most that many (chip_smoke.chain_kernels raises otherwise),
    and their names show the chain."""
    dev = _card()
    import chip_smoke as cs
    engine = MusicLearner.load(DEMO).engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    L, int8 = cfg.n_layers, mode in fd.INT8_SCORE_MODES
    for tc in (False, True):
        assert fd.kernels_per_step(L, mode, tc) == fd.planned_kernels_per_step(L, mode, tc)
    per_step = (9 if int8 else 7) * L
    assert fd.kernels_per_step(L, mode, True) == per_step
    source = fd._source(mode)
    for B in (8, 16, 64):
        want = fd.tc_scratch_layout(B, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head, M,
                                    int8)["total"][0]
        got = getattr(fd._lib(source), f"{source}_scratch_floats")(
            B, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_head, M, int(int8) | 2)
        assert got == want, (B, got, want)
    kv, blocked = cs.ring_inputs(cfg, 16, M, 40, "part", np.random.default_rng(13), dev, mode)
    h_in = engine.params["embed"].float()[:16].contiguous()
    stacked, w_scales = cs.weights(engine, mode)
    wkr = cs.mode_wkr(mode, cs.wkr_table(engine))
    kw = {} if mode in cs.MULTIROW_MODES else dict(weights_int8=w_scales is not None,
                                                    w_scales=w_scales,
                                                    **cs.SLAB_ARGS.get(mode, {}))
    step = lambda: cs.CORES[mode](stacked, cfg, h_in, wkr, *kv, blocked, 40, M, **kw)
    recorded, chain = cs.chain_kernels(mode, step, per_step, True, n=4)
    assert 0 < recorded <= per_step and chain == "tensor-core"
