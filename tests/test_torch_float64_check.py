"""chip_smoke.py's float64 check of the slab kernels still catches a wrong
kernel.

On the card the check holds a kernel's distance from a float64 run of its
plain version to a fixed bound plus twice the float32 plain version's
distance (``within_bounds``). Here, on the CPU, a plain version with one
deliberate fault plays the kernel: the self term of the attention dropped,
each slot's value scale ``vsc`` taken from its neighbouring slot, or the
last decoder layer's second feed-forward bias dropped. Each fault must
fail the check on a case where the true plain version passes it.

The first two faults run on chip_smoke.py's short ring at ptr 0, for the
genre step (``slab_plain``) and the multitask step (``s2s_slab_plain``):
decoding right after a prompt of 8 tokens (so the fresh token's self term
carries about a ninth of the attention), its K/V slot rows of varying
magnitude (so neighbouring slots' value scales differ). On the smoke's full
and partly full rings, whose slots all hold N(0, 0.5^2) entries, a dropped
self term moved h_out by 2.1e-2 and one int8 step on the demo genre model
(ptr 31, full ring): within the fixed bounds, which is why the smoke has
short rings too.

The last layer's feed-forward shows only in h_out (it writes no slot), so
its fault runs on a partly full ring at ptr 31 where the float32 plain
version drifts from float64 (h_out by 9.1e-4 and one int8 step: a bf16
rounding flip), with the smoke's flagship biases of std 0.1. The bound on
|dh_out| there is 5.2e-2 and the fault moves h_out by 0.25; a bound of a
ratio of thousands times the plain version's drift, as an earlier form of
the check had, came to 35 there and let the fault pass.

The exact bf16 step (``s2s_fused_plain``, the plain version of the fused
kernel) is held by the smoke's fused check (``within_fused_bounds``: |dh_out|
and the written bf16 K/V slot); the same two faults, the self term dropped on
the short ring and the last layer's second feed-forward bias dropped on the
partly full ring with biases of std 0.1, must fail it.
"""

import inspect
import os
import textwrap

import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd
from deepmusicgeneration_tpu_torch.ops import fused_s2s as fs
from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner, MusicLearner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHORT = {"ring": "short", "ptr": 0, "bias_std": 0.0}
DRIFTS = {"ring": "part", "ptr": 31, "bias_std": 0.1}
# (plain version, the text of the faulty line, its replacement, the case)
FAULTS = {
    ("genre", "self_dropped"): (fd.slab_plain, "e_self = torch.exp(self_score - mx)",
                                "e_self = torch.zeros_like(mx)", SHORT),
    ("genre", "vsc_neighbour"): (fd.slab_plain, "e * v_s[:, None, :]",
                                 "e * torch.roll(v_s, 1, dims=1)[:, None, :]", SHORT),
    ("s2s", "self_dropped"): (fs.s2s_slab_plain, "e_self = torch.exp(self_score - mx)",
                              "e_self = torch.zeros_like(mx)", SHORT),
    ("s2s", "vsc_neighbour"): (fs.s2s_slab_plain, "_bf(e * vsc[l, 0, :, 0], acc)",
                               "_bf(e * torch.roll(vsc[l, 0, :, 0], 1, dims=0), acc)", SHORT),
    ("s2s", "last_ff2_bias_dropped"): (
        fs.s2s_slab_plain, "@ deq(stacked.ff2_w, 3, D) + bias(stacked.ff2_b, l)",
        "@ deq(stacked.ff2_w, 3, D) + (bias(stacked.ff2_b, l) if l < L - 1 else 0.0)",
        DRIFTS),
}


def _mutant(fn, old: str, new: str):
    """``fn`` recompiled from its source with the one line ``old`` replaced.
    Where that line is in a module function that ``fn`` calls (the genre
    plain versions share ``fused_decode._step_plain``), that function is
    recompiled with the fault and ``fn`` recompiled to call it."""
    namespace = dict(fn.__globals__)
    target = fn
    if old not in inspect.getsource(fn):
        target = next(namespace[n] for n in fn.__code__.co_names
                      if inspect.isfunction(namespace.get(n))
                      and old in inspect.getsource(namespace[n]))
    src = textwrap.dedent(inspect.getsource(target))
    assert src.count(old) == 1, old
    exec(compile(src.replace(old, new), f"<{target.__name__} with a fault>", "exec"),
         namespace)
    if target is not fn:
        exec(compile(textwrap.dedent(inspect.getsource(fn)), f"<{fn.__name__}>", "exec"),
             namespace)
    return namespace[fn.__name__]


CPU = torch.device("cpu")


def _genre_case(rng, ring, ptr, bias_std):
    """The case on the demo genre checkpoint's slab_w8 step (B = 2); returns
    ``run(fn, acc)`` and the caches."""
    assert not bias_std
    engine = MusicLearner.load(os.path.join(ROOT, "checkpoints", "demo_genre_model"),
                               device="cpu").engine
    cfg = engine.cfg
    kv, blocked = cs.ring_inputs(cfg, 2, cfg.mem_len, ptr, ring, rng, CPU)
    h_in = engine.params["embed"].float()[torch.from_numpy(rng.integers(12, 140, 2))]
    stacked, w_scales = cs.weights(engine, "slab_w8")
    wkr_mt = cs.wkr_table(engine)
    return (lambda fn, acc: fn(stacked, w_scales, cfg, h_in, wkr_mt,
                               *[t.clone() for t in kv], blocked, ptr, acc=acc)), kv


def _s2s_case(rng, ring, ptr, bias_std):
    """The case on the demo multitask checkpoint's slab_w8 seq2seq step (a
    cross context of 128 slots as chip_smoke.py draws it; with ``bias_std``
    the biases drawn as the smoke draws the flagship's)."""
    learner = MultitaskLearner.load(str(cs.MT_DEMO), device="cpu")
    cfg = learner.cfg
    M, L, HD = cfg.mem_len, cfg.dec_layers, cfg.n_heads * cfg.d_head
    weights = cs.mt_weights(learner, "slab_w8", rng, CPU, bias_std)
    kv = cs.ring_kv(L, 1, M, HD, ring, rng, CPU)
    blocked = torch.from_numpy(cs.ring_blocked(1, M, ptr, ring))
    cross = cs.mt_cross(cfg, 128, rng, CPU)
    h_in = learner.engine("s2s").params["embed"].float()[torch.from_numpy(
        rng.integers(12, 140, 1))]
    wkr_mt = cs.mt_wkr(learner)
    return (lambda fn, acc: fn(*weights, cfg, h_in, wkr_mt, *[t.clone() for t in kv],
                               *cross, blocked, ptr, M, acc=acc)), kv


@pytest.mark.parametrize("step,fault", list(FAULTS))
def test_check_fails_a_faulty_plain_version(step, fault):
    plain, old, new, case = FAULTS[(step, fault)]
    run, kv = (_genre_case if step == "genre" else _s2s_case)(np.random.default_rng(0),
                                                              **case)
    ptr = case["ptr"]
    ref = run(plain, torch.float64)
    f32 = run(plain, torch.float32)
    plain_diff = cs.step_diff(f32, ref, kv, ptr)
    if case is DRIFTS:
        # the float32 plain version took a bf16 flip: far beyond float32 noise
        assert plain_diff[0] > 1e-4 and plain_diff[1] >= 1, plain_diff
    # the true plain version passes, in the kernel's place
    assert cs.within_bounds("slab_w8", plain_diff, plain_diff)
    bad = run(_mutant(plain, old, new), torch.float32)
    bad_diff = cs.step_diff(bad, ref, kv, ptr)
    assert not cs.within_bounds("slab_w8", bad_diff, plain_diff), (bad_diff, plain_diff)


FUSED_FAULTS = {
    "self_dropped": ("e_self = torch.exp(self_score - mx)", "e_self = torch.zeros_like(mx)",
                     SHORT),
    "last_ff2_bias_dropped": (
        "@ w(stacked.ff2_w, l) + bias(stacked.ff2_b, l)",
        "@ w(stacked.ff2_w, l) + (bias(stacked.ff2_b, l) if l < L - 1 else 0.0)", DRIFTS),
}


def _fused_case(rng, ring, ptr, bias_std):
    """The case on the demo multitask checkpoint's fused seq2seq step (a
    bf16 ring and a cross context of 128 slots as chip_smoke.py draws them)."""
    learner = MultitaskLearner.load(str(cs.MT_DEMO), device="cpu")
    cfg = learner.cfg
    stacked, _ = cs.mt_weights(learner, "fused", rng, CPU, bias_std)
    kv = cs.fused_ring(cfg, ring, rng, CPU)
    blocked = torch.from_numpy(cs.ring_blocked(1, cfg.mem_len, ptr, ring))
    cross = cs.fused_cross(cfg, 128, rng, CPU)
    h_in = learner.engine("s2s").params["embed"].float()[torch.from_numpy(
        rng.integers(12, 140, 1))]
    wkr = cs.fused_wkr(learner)
    return (lambda fn, acc: fn(stacked, cfg, h_in, wkr, *[t.clone() for t in kv], *cross,
                               blocked, ptr, cfg.mem_len, acc=acc)), kv


@pytest.mark.parametrize("fault", list(FUSED_FAULTS))
def test_fused_check_fails_a_faulty_plain_version(fault):
    old, new, case = FUSED_FAULTS[fault]
    run, kv = _fused_case(np.random.default_rng(0), **case)
    ptr = case["ptr"]
    ref = run(fs.s2s_fused_plain, torch.float64)
    plain_diff = cs.fused_diff(run(fs.s2s_fused_plain, torch.float32), ref, kv, ptr)
    # the true plain version passes, in the kernel's place
    assert cs.within_fused_bounds(plain_diff, plain_diff)
    bad = run(_mutant(fs.s2s_fused_plain, old, new), torch.float32)
    bad_diff = cs.fused_diff(bad, ref, kv, ptr)
    assert not cs.within_fused_bounds(bad_diff, plain_diff), (bad_diff, plain_diff)
