"""The persistent multitask decode step's work plan, on the CPU.

``csrc/s2s_step.cuh`` runs a token step of the multitask decoder as one
launch: phases between grid barriers, each a list of work items fixed by the
shape. ``ops/fused_s2s.py::step_plan`` lists those phases and items with the
kernel's constants, and ``s2s_slab_planned`` / ``s2s_fused_planned`` compute
a step through them as a launch of any grid size walks it. Here, at
``small_multitask_config`` widths: every output column, ring slot and
encoder position is covered exactly once, the write of slot ``ptr`` comes
after its only reader, the plan does not depend on the grid size, and the
planned step equals the plain versions (``s2s_slab_plain``,
``s2s_fused_plain``) run in float64 in all six variants.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu_torch.models.config import small_multitask_config
from deepmusicgeneration_tpu_torch.ops import fused_s2s as fs

CFG = small_multitask_config()
L, D, Dff, H, Dh, M = (CFG.dec_layers, CFG.d_model, CFG.d_inner, CFG.n_heads, CFG.d_head,
                       CFG.mem_len)
HD = H * Dh
STEP_SOURCE = (Path(fs.__file__).parent / "csrc" / "s2s_step.cuh").read_text()
# float64 sums in another order: last-bit differences (~1e-16) only
F64_RTOL = 1e-10


def _ptr(kind: str) -> int:
    S, _ = fs.chunk_plan(M, H, Dh)
    return {"zero": 0, "seam": S, "last": M - 1}[kind]


@pytest.mark.parametrize("kind", ["zero", "seam", "last"])
@pytest.mark.parametrize("task,Le", [("s2s", 64), ("s2s", 200), ("s2s", 1024), ("nw", 0)])
def test_plan_covers_every_output_once(task, Le, kind):
    """Each product's (K row, column) pairs, each attention phase's (head,
    position) pairs and, for the self ring, (head, slot) pairs under ``ptr``
    are covered exactly once; every split-K chunk has its own partial slot."""
    ptr = _ptr(kind)
    plan = fs.step_plan(CFG, M, Le, task == "s2s")
    kinds = [ph.kind for ph in plan]
    per_layer = 8 if task == "s2s" else 3
    assert len(plan) == L * per_layer + 1 and kinds[-1] == "end"
    widths = {"qkv": (D, 3 * HD), "q2": (D, HD), "ff1": (D, Dff), "ff2": (Dff, D)}
    for ph in plan[:-1]:
        if ph.kind in widths:
            K, N = widths[ph.kind]
            seen = np.zeros((K, N), np.int64)
            chunks = {}
            for _, c, n0, n1, k0, k1 in ph.items:
                seen[k0:k1, n0:n1] += 1
                assert chunks.setdefault(c, (k0, k1)) == (k0, k1)   # one K range a slot
            assert (seen == 1).all(), ph
            assert sorted(chunks) == list(range(len(chunks)))
            continue
        n = M if ph.kind in ("ssc", "spv") else Le
        seen = np.zeros((H, n), np.int64)
        slots = np.zeros((H, M), np.int64)
        for _, h, c, p0, p1 in ph.items:
            seen[h, p0:p1] += 1
            if ph.kind in ("ssc", "spv"):
                slots[h, (np.arange(p0, p1) + ptr) % M] += 1
        assert (seen == 1).all(), ph
        if ph.kind in ("ssc", "spv"):
            assert (slots == 1).all(), ph


@pytest.mark.parametrize("task", ["s2s", "nw"])
@pytest.mark.parametrize("kind", ["zero", "seam", "last"])
def test_slot_write_follows_its_only_reader(task, kind):
    """Slot ``ptr`` of layer l is read by the chunk-0 items of layer l's
    self-score and self-P.V phases only (ring position 0), and is written
    once, by block 0 in a later phase, before any phase of layer l + 1."""
    ptr = _ptr(kind)
    plan = fs.step_plan(CFG, M, 96, task == "s2s")
    for l in range(L):
        readers = []
        for i, ph in enumerate(plan):
            if ph.kind in ("ssc", "spv") and ph.layer == l:
                for _, h, c, p0, p1 in ph.items:
                    if ptr in (np.arange(p0, p1) + ptr) % M:
                        readers.append((i, c, p0))
        assert len(readers) == 2 * H and all(c == 0 and p0 == 0 for _, c, p0 in readers)
        writes = [i for i, ph in enumerate(plan) if ph.write == l]
        assert len(writes) == 1
        assert writes[0] > max(i for i, _, _ in readers)
        assert all(ph.layer > l or ph.kind == "end"
                   for ph in plan[writes[0] + 1:] if ph.kind in ("ssc", "spv"))


def test_plan_does_not_depend_on_grid():
    """The plan takes no grid size; any grid's blocks (item = block, + grid,
    ...) take each item exactly once, and the planned step gives the same
    bits at every grid size."""
    plan = fs.step_plan(CFG, M, 200, True)
    for grid in (1, 3, 7, 64, 132, 1000):
        for ph in plan:
            taken = sorted(it for b in range(grid) for it in range(b, len(ph.items), grid))
            assert taken == list(range(len(ph.items)))
    args = _slab_inputs(np.random.default_rng(3), "slab_w8", "s2s", 200, 17)
    outs = []
    for grid in (1, 5, 132):
        kv = [t.clone() for t in args[5:9]]
        outs.append(fs.s2s_slab_planned(*args[:5], *kv, *args[9:], acc=torch.float32,
                                        grid=grid))
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_plan_constants_match_the_kernel_source():
    """The plan's constants are the kernel's (csrc/s2s_step.cuh)."""
    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", STEP_SOURCE).group(1))

    assert (const("kGemvCols"), const("kGemvItems"), const("kGemvMinChunk"),
            const("kGemvMaxChunk")) == (fs.GEMV_COLS, fs.GEMV_ITEMS, fs.GEMV_MIN_CHUNK,
                                         fs.GEMV_MAX_CHUNK)
    assert (const("kAttnItems"), const("kAttnMinChunk"), const("kAttnMaxChunk"),
            const("kAttnTileElems")) == (fs.ATTN_ITEMS, fs.ATTN_MIN_CHUNK, fs.ATTN_MAX_CHUNK,
                                         fs.ATTN_TILE_ELEMS)
    # the flagship's cut: qkv 24 tiles x 4 chunks, q2 8 x 16, ff1 32 x 4, ff2 8 x 16;
    # self ring chunks of 64 (8 a head), cross chunks of 128 at Le = 1024
    assert fs.gemv_plan(512, 1536) == (128, 24, 4)
    assert fs.gemv_plan(512, 512) == (32, 8, 16)
    assert fs.gemv_plan(512, 2048) == (128, 32, 4)
    assert fs.gemv_plan(2048, 512) == (128, 8, 16)
    assert fs.chunk_plan(512, 8, 64) == (64, 8)
    assert fs.chunk_plan(1024, 8, 64) == (128, 8)


def _t(rng, shape, std, dtype=torch.float32):
    return torch.from_numpy(rng.normal(scale=std, size=shape).astype(np.float32)).to(dtype)


def _stacked(rng, wdtype):
    bf = torch.bfloat16
    g = lambda: (1.0 + _t(rng, (L, 1, D), 0.1))
    st = fs.StackedMTDec(
        qkv_w=_t(rng, (L, D, 3 * HD), D ** -0.5, bf), qkv_b=_t(rng, (L, 1, 3 * HD), 0.1, bf),
        ln1_g=g(), ln1_b=_t(rng, (L, 1, D), 0.1),
        q2_w=_t(rng, (L, D, HD), D ** -0.5, bf), q2_b=_t(rng, (L, 1, HD), 0.1, bf),
        ln2_g=g(), ln2_b=_t(rng, (L, 1, D), 0.1),
        ff1_w=_t(rng, (L, D, Dff), D ** -0.5, bf), ff1_b=_t(rng, (L, 1, Dff), 0.1, bf),
        ff2_w=_t(rng, (L, Dff, D), Dff ** -0.5, bf), ff2_b=_t(rng, (L, 1, D), 0.1, bf),
        ff3_g=g(), ff3_b=_t(rng, (L, 1, D), 0.1),
        u=_t(rng, (1, HD), 0.3, bf), v=_t(rng, (1, HD), 0.3, bf))
    return fs.quantize_mt_weights(st) if wdtype == "int8" else (st, None)


def _blocked(ptr):
    """A ring holding a prompt of 10 tokens plus ptr decoded ones: slots
    past ptr + 10 never written yet."""
    b = np.zeros((1, M), np.int32)
    b[0, min(M, ptr + 10):] = 1
    b[0, ptr] = 0
    return torch.from_numpy(b)


def _slab_inputs(rng, mode, task, Le, ptr):
    stacked, w_scales = _stacked(rng, "int8" if mode == "slab_w8" else "bf16")
    i8 = lambda shape: torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    pos = lambda shape: torch.from_numpy(rng.uniform(0.002, 0.01, shape).astype(np.float32))
    kv = [i8((L, 1, M, HD)), pos((L, 1, M, 1)), i8((L, 1, M, HD)), pos((L, 1, M, 1))]
    wkr_mt = _t(rng, (L, M + 1, HD), 0.5, torch.bfloat16)
    if task == "s2s":
        cb = np.zeros((1, Le), np.int32)
        cb[0, Le - Le // 4:] = 1
        cross = [i8((L, Le, HD)), pos((L, Le, 1)), i8((L, Le, HD)), pos((L, Le, 1)),
                 _t(rng, (L, Le, HD), 0.5, torch.bfloat16), torch.from_numpy(cb)]
    else:
        cross = [None] * 6
    h_in = _t(rng, (1, D), 1.0)
    return (stacked, w_scales, CFG, h_in, wkr_mt, *kv, *cross, _blocked(ptr), ptr, M)


def _fused_inputs(rng, task, Le, ptr):
    stacked, _ = _stacked(rng, "bf16")
    bf = torch.bfloat16
    kc, vc = (_t(rng, (L, 1, H, M, Dh), 0.5, bf) for _ in range(2))
    wkr = _t(rng, (L, H, M + 1, Dh), 0.5, bf)
    if task == "s2s":
        cb = np.zeros((1, Le), np.int32)
        cb[0, Le - Le // 4:] = 1
        cross = [*(_t(rng, (L, H, Le, Dh), 0.5, bf) for _ in range(3)), torch.from_numpy(cb)]
    else:
        cross = [None] * 4
    return (stacked, CFG, _t(rng, (1, D), 1.0), wkr, kc, vc, *cross, _blocked(ptr), ptr, M)


def _close(a, b):
    if a.dtype == torch.int8:
        return torch.equal(a, b)
    a, b = a.double(), b.double()
    return bool(((a - b).abs() <= F64_RTOL * b.abs().max()).all())


@pytest.mark.parametrize("task", ["s2s", "nw"])
@pytest.mark.parametrize("mode", ["slab_w8", "slab", "fused"])
@pytest.mark.parametrize("ptr", [0, 37])
def test_planned_step_matches_plain_in_float64(task, mode, ptr):
    """The step through the plan (chunk partials, the global-max softmax,
    fixed-order combines) against the plain version, both in float64: h_out
    and the written cache (the other slots unchanged) within F64_RTOL, the
    int8 entries equal."""
    rng = np.random.default_rng(11 + ptr)
    if mode == "fused":
        args = _fused_inputs(rng, task, 200, ptr)
        ref = fs.s2s_fused_plain(*args[:4], *[t.clone() for t in args[4:6]], *args[6:],
                                 acc=torch.float64)
        got = fs.s2s_fused_planned(*args[:4], *[t.clone() for t in args[4:6]], *args[6:],
                                   acc=torch.float64, grid=7)
    else:
        args = _slab_inputs(rng, mode, task, 200, ptr)
        ref = fs.s2s_slab_plain(*args[:5], *[t.clone() for t in args[5:9]], *args[9:],
                                acc=torch.float64)
        got = fs.s2s_slab_planned(*args[:5], *[t.clone() for t in args[5:9]], *args[9:],
                                  acc=torch.float64, grid=7)
    assert got[0].dtype == torch.float64 and got[0].shape == (1, D)
    for a, b in zip(got, ref):
        assert _close(a, b)
