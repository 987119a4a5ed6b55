"""The slab step's modes ``slab_int8``, ``slab4`` and ``slab4_w8`` against the
JAX package's Pallas kernel in interpret mode.

``quantize_kv_slot_major_int4`` must be bit-identical to JAX's. The plain
PyTorch version of ``fused_slab_core`` (what the wrapper runs for CPU
tensors) is held against JAX ``fused_slab_core`` in interpret mode on the
bf16 setup config of ``tests/test_fused_decode.py`` (2 layers, d 128, 2 x 64
heads, mem_len 128), in the cases of ``test_fused_decode.py``'s slab tests:
``slab_int8`` at 8 and 32 rows a cell (one batch, so the query scale per
cell differs), the same over int8 weight panels (``slab_int8_w8``), ``slab4`` with the ring pointer on the high- and the
low-nibble side of one packed row, at 8 and 16 rows, and ``slab4_w8``. The
CUDA kernels are held against the plain version in ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import TXLConfig as JConfig
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu.ops import fused_decode as jfd
from deepmusicgeneration_tpu_torch.models.config import TXLConfig
from deepmusicgeneration_tpu_torch.ops import fused_decode as tfd
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy

SETUP = dict(vocab_size=324, n_layers=2, d_model=128, d_inner=256, n_heads=2,
             d_head=64, ctx_len=128, mem_len=128, dtype="bfloat16", bias=False)
# h_out (post-LayerNorm, entries of order 1): plain torch and Pallas
# interpret take the same float32 arithmetic and bf16 cast points in another
# summation order. In the bf16-score modes that moves h_out by float32 noise
# (the slab and slab_w8 modes measured 4.8e-7, tests/test_torch_fused_decode.py)
# or, where one bf16 cast takes the other side of a rounding point, by up to
# 2.5e-5 here (1e-4 leaves room for such a flip, as there);
# the int8-score mode also rounds q and the probabilities to int8, where a
# value within float32 noise of a half-point may round the other way and
# move one score or one P.V term by a step of 1/127 of its row's largest.
H_ATOL = {"slab_int8": 2e-3, "slab_int8_w8": 2e-3, "slab4": 1e-4, "slab4_w8": 1e-4}
# a fresh-slot scale is max|k| / qmax of a float32 row whose sum order
# differs: at most a few float32 ulps
SCALE_RTOL = 1e-5
# slab_int8, layers after the first: once a half-point flip has moved a
# layer's output (h_out by up to 2.8e-4 in these cases), the next layers'
# k1 / v1 rows and so their scales move with it (measured 1.1e-4)
INT8_LATER_SCALE_RTOL = 1e-3
# written int8 / int4 entries: equal except where a value lies within
# float32 noise of a rounding half-point, which moves it one step; at most
# this many such entries a case (of L x B x HD x 2)
MAX_HALF_POINT_FLIPS = 4


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JConfig(**SETUP), TXLConfig(**SETUP)
    jp = cast_params_for_inference(jtxl.init_txl(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    jst, tst = jfd.stack_txl_layers(jp), tfd.stack_txl_layers(tp)
    wkr = jtxl.precompute_wkr(jp, jcfg, jcfg.mem_len)
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    wkr_mt = wkr.transpose(0, 2, 1, 3).reshape(L, M + 1, HD).astype(jnp.bfloat16)
    return (jcfg, cfg, (jst, None), (tst, None), jfd.quantize_stacked_weights(jst),
            tfd.quantize_stacked_weights(tst), wkr_mt)


def test_quantize_kv_slot_major_int4_bit_identical():
    rng = np.random.default_rng(4)
    k = rng.normal(scale=0.7, size=(2, 3, 64, 64)).astype(np.float32)
    v = rng.normal(scale=0.2, size=(2, 3, 64, 64)).astype(np.float32)
    k[1, 2, 40] = 0.0   # an all-zero slot row on the low-nibble side
    v[0, 0, 5] = 0.0    # and one on the high side: each takes the 1e-6 floor
    ref = jfd.quantize_kv_slot_major_int4(jnp.asarray(k, jnp.bfloat16),
                                          jnp.asarray(v, jnp.bfloat16))
    got = tfd.quantize_kv_slot_major_int4(torch.from_numpy(k).bfloat16(),
                                          torch.from_numpy(v).bfloat16())
    assert got[0].shape == (2, 3, 32, 64) and got[0].dtype == torch.int8
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[1][1, 2, 40, 0].item() == np.float32(1e-6) / np.float32(7.0)


def _ring(jcfg, B, ptr, full, seed, int4):
    """Random K/V quantized by JAX's slot-major quantizer (int8, or int4
    nibble pairs), h_in and the blocked mask of a ring at ``ptr``: full
    (slot ptr holds the oldest token, at distance exactly M: live) or partly
    full (a prompt of M // 3 tokens plus ptr decoded ones); row 1 has a pad
    slot more."""
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    rng = np.random.default_rng(seed)
    k = rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32)
    v = rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32)
    quantizer = jfd.quantize_kv_slot_major_int4 if int4 else jfd.quantize_kv_slot_major
    kv = quantizer(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    slot = np.arange(M)
    if full:
        g = np.where(slot < ptr, slot, slot - M)            # g_cur = ptr
    else:
        g = np.where(slot < ptr, slot, jtxl.PAD_G)
        g[M - M // 3:] = np.arange(-(M // 3), 0)
    g = np.broadcast_to(g, (B, M)).copy()
    g[1, (ptr + 2) % M] = jtxl.PAD_G
    blocked = (((ptr - g) < 1) | ((ptr - g) > M)).astype(np.int32)
    h_in = rng.normal(size=(B, jcfg.d_model)).astype(np.float32)
    return [np.asarray(t) for t in kv], h_in, blocked


def _run_both(model, mode, B, R, ptr, full, seed):
    """JAX's kernel in interpret mode and the port's wrapper (its plain
    version) on the same ring; returns (port, JAX, the input caches)."""
    jcfg, cfg, jbf, tbf, jw8, tw8, wkr_mt = model
    int4, w8 = mode.startswith("slab4"), mode.endswith("_w8")
    (jst, jws), (tst, tws) = (jw8, tw8) if w8 else (jbf, tbf)
    score = "int8" if mode.startswith("slab_int8") else "bf16"
    kv, h_in, blocked = _ring(jcfg, B, ptr, full, seed, int4)
    M = jcfg.mem_len
    ref = jfd.fused_slab_decode(
        jst, jcfg, jnp.asarray(h_in), wkr_mt, *[jnp.asarray(t) for t in kv],
        jnp.asarray(blocked), jnp.asarray(ptr, jnp.int32), M, rows_per_cell=R,
        score_mode=score, weights_int8=w8, w_scales=jws, kv_int4=int4,
        interpret=True)
    wkr_t = torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16()
    got = tfd.fused_slab_core(
        tst, cfg, torch.from_numpy(h_in), wkr_t,
        *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked),
        ptr, M, rows_per_cell=R, score_mode=score, weights_int8=w8, w_scales=tws,
        kv_int4=int4)
    assert sum(tfd.fused_slab_core.launches.values()) == 0   # CPU: plain
    return [t.numpy() for t in got], [np.asarray(t) for t in ref], kv


def _half_point_flips(got, ref):
    """Entries of two written slots that differ: each by one step at most;
    returns how many differ."""
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    return int((d > 0).sum())


def _check_int8_scores(model, mode, R, ptr, full):
    got, ref, kv = _run_both(model, mode, 32, R, ptr, full, seed=R + ptr)
    np.testing.assert_allclose(got[0], ref[0], atol=H_ATOL[mode], rtol=0)
    M = kv[0].shape[2]
    other = np.arange(M) != ptr
    for g, r, before in zip(got[1:], ref[1:], kv):
        np.testing.assert_array_equal(g[:, :, other], before[:, :, other])
        np.testing.assert_array_equal(r[:, :, other], before[:, :, other])
    flips = sum(_half_point_flips(got[i][:, :, ptr], ref[i][:, :, ptr]) for i in (1, 3))
    assert flips <= MAX_HALF_POINT_FLIPS, flips
    for i in (2, 4):
        np.testing.assert_allclose(got[i][0, :, ptr], ref[i][0, :, ptr],
                                   rtol=SCALE_RTOL, atol=0)
        np.testing.assert_allclose(got[i][1:, :, ptr], ref[i][1:, :, ptr],
                                   rtol=INT8_LATER_SCALE_RTOL, atol=0)


@pytest.mark.parametrize("R,ptr,full", [(8, 39, False), (32, 127, True)])
def test_plain_slab_int8_matches_pallas_interpret(model, R, ptr, full):
    """score_mode='int8' at 4 cells of 8 rows and 1 cell of 32 rows."""
    _check_int8_scores(model, "slab_int8", R, ptr, full)


@pytest.mark.parametrize("R,ptr,full", [(8, 39, False), (32, 127, True)])
def test_plain_slab_int8_w8_matches_pallas_interpret(model, R, ptr, full):
    """score_mode='int8' over int8 weight panels (weights_int8=True), which
    no engine mode selects, to slab_int8's bounds."""
    _check_int8_scores(model, "slab_int8_w8", R, ptr, full)


def test_slab_int8_rows_per_cell_changes_the_result(model):
    """The query scale is per cell: 8 and 32 rows a cell give other h_out
    on one input (and the other modes would not)."""
    jcfg, cfg, _, (tst, _), _, _, wkr_mt = model
    kv, h_in, blocked = _ring(jcfg, 32, 39, False, seed=5, int4=False)
    wkr_t = torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16()
    out = {R: tfd.fused_slab_core(
        tst, cfg, torch.from_numpy(h_in), wkr_t,
        *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked), 39,
        jcfg.mem_len, rows_per_cell=R, score_mode="int8")[0] for R in (8, 32)}
    assert (out[8] - out[32]).abs().max().item() > 1e-4


@pytest.mark.parametrize("mode,R,ptr", [
    ("slab4", 8, 39),       # high-nibble side (slot < M/2), packed row 39
    ("slab4", 8, 103),      # low-nibble side (slot >= M/2), the same packed row
    ("slab4", 16, 39), ("slab4_w8", 8, 103)])
def test_plain_slab4_matches_pallas_interpret(model, mode, R, ptr):
    got, ref, kv = _run_both(model, mode, 16, R, ptr, True, seed=R + ptr)
    np.testing.assert_allclose(got[0], ref[0], atol=H_ATOL[mode], rtol=0)
    M = kv[1].shape[2]
    M2, pm, side = M // 2, ptr % (M // 2), ptr // (M // 2)
    rows, slots = np.arange(M2) != pm, np.arange(M) != ptr
    for i, before in zip((1, 3), kv[0::2]):   # packed K, V: other rows untouched
        np.testing.assert_array_equal(got[i][:, :, rows], before[:, :, rows])
        np.testing.assert_array_equal(ref[i][:, :, rows], before[:, :, rows])
    for i, before in zip((2, 4), kv[1::2]):   # scales: other slots untouched
        np.testing.assert_array_equal(got[i][:, :, slots], before[:, :, slots])
        np.testing.assert_allclose(got[i][:, :, ptr], ref[i][:, :, ptr],
                                   rtol=SCALE_RTOL, atol=0)
    nib = lambda a, s: (a[:, :, pm].astype(np.int32) & 255) >> 4 if s == 0 \
        else a[:, :, pm].astype(np.int32) & 15
    flips = 0
    for i, before in zip((1, 3), kv[0::2]):
        # the partner slot's nibble keeps its value; the fresh one is written
        np.testing.assert_array_equal(nib(got[i], 1 - side), nib(before, 1 - side))
        flips += _half_point_flips(nib(got[i], side), nib(ref[i], side))
    assert flips <= MAX_HALF_POINT_FLIPS, flips


def test_slab_mode_arguments(model):
    """int4 needs M % 64 == 0 and bf16 scores; int8 scores take int8 weight
    panels too (``slab_int8_w8``)."""
    jcfg, cfg, _, (tst, _), _, (qst, qws), wkr_mt = model
    kv, h_in, blocked = _ring(jcfg, 8, 3, True, seed=1, int4=True)
    args = [torch.from_numpy(h_in),
            torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16(),
            *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked), 3,
            jcfg.mem_len]
    with pytest.raises(ValueError, match="kv_int4"):
        tfd.fused_slab_core(tst, cfg, *args, score_mode="int8", kv_int4=True)
    kv8, h8, blocked8 = _ring(jcfg, 8, 3, True, seed=1, int4=False)
    args8 = [torch.from_numpy(h8), args[1], *[torch.from_numpy(t.copy()) for t in kv8],
             torch.from_numpy(blocked8), 3, jcfg.mem_len]
    h_w8 = tfd.fused_slab_core(qst, cfg, *args8, score_mode="int8", weights_int8=True,
                               w_scales=qws)[0]
    h_bf = tfd.fused_slab_core(tst, cfg, *args8, score_mode="int8")[0]
    assert torch.isfinite(h_w8).all() and (h_w8 - h_bf).abs().max().item() > 1e-4
    with pytest.raises(ValueError, match="kt"):   # int8-sized cache given int4 rows
        tfd.fused_slab_core(tst, cfg, *args)


def _faulty_slab_plain(old: str, new: str):
    """``slab_plain`` running a copy of ``fused_decode._step_plain`` whose
    line ``old`` is replaced by ``new``."""
    import inspect
    import textwrap
    namespace = dict(tfd.slab_plain.__globals__)
    for fn, swap in ((tfd._step_plain, (old, new)), (tfd.slab_plain, None)):
        src = textwrap.dedent(inspect.getsource(fn))
        if swap:
            assert src.count(swap[0]) == 1, swap[0]
            src = src.replace(*swap)
        exec(compile(src, f"<{fn.__name__} with a fault>", "exec"), namespace)
    return namespace["slab_plain"]


@pytest.mark.parametrize("old,new", [
    ("e_self = torch.exp(self_score - mx)", "e_self = torch.zeros_like(mx)"),
    ("e * v_s[:, None, :]", "e * torch.roll(v_s, 1, dims=1)[:, None, :]")],
    ids=["self_dropped", "vsc_neighbour"])
def test_card_check_of_slab_int8_fails_a_faulty_plain_version(old, new):
    """chip_smoke.py's float64 check of slab_int8, with its own two-step
    cap, passes the float32 plain version in the kernel's place and fails a
    plain version with a fault, on the smoke's short ring (a prompt of 8
    tokens, slot rows of varying magnitude) at ptr 0 on the demo checkpoint,
    two rows in one cell."""
    import chip_smoke as cs
    from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
    engine = MusicLearner.load(str(cs.CKPT.parent / "demo_genre_model"),
                               device="cpu").engine
    cfg, rng, cpu = engine.cfg, np.random.default_rng(0), torch.device("cpu")
    kv, blocked = cs.ring_inputs(cfg, 2, cfg.mem_len, 0, "short", rng, cpu, "slab_int8")
    h_in = engine.params["embed"].float()[torch.from_numpy(rng.integers(12, 140, 2))]
    stacked, _ = cs.weights(engine, "slab_int8")
    run = lambda fn, acc: fn(stacked, None, cfg, h_in, cs.wkr_table(engine),
                             *[t.clone() for t in kv], blocked, 0, acc=acc,
                             score_mode="int8", rows_per_cell=2)
    ref = run(tfd.slab_plain, torch.float64)
    plain_diff = cs.step_diff(run(tfd.slab_plain, torch.float32), ref, kv, 0, "slab_int8")
    assert cs.within_bounds("slab_int8", plain_diff, plain_diff)
    bad = cs.step_diff(run(_faulty_slab_plain(old, new), torch.float32), ref, kv, 0,
                       "slab_int8")
    assert not cs.within_bounds("slab_int8", bad, plain_diff), (bad, plain_diff)
    assert bad[3] > 0.3   # about half the written entries two steps off or more
