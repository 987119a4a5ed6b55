"""The port's multitask slab decode step against the JAX package's Pallas
kernel.

The weight stack and both quantizers must be bit-identical to JAX's. The
plain PyTorch version (``s2s_slab_plain``, what the wrappers run for CPU
tensors) is held against JAX ``fused_s2s_slab_core`` / ``fused_nw_slab_core``
in Pallas interpret mode, in all four variants (seq2seq and next-word, int8
and bf16 weight panels), on ``small_multitask_config`` widths with random
weights and on the demo checkpoint's (d_head 32, mem_len 128, GELU), at ring
pointers 0, 31, 32 and M - 1 on a partly full and a full ring, with padded
encoder columns. The CUDA kernel itself is held against the plain version in
the ``cuda``-marked tests, which skip without a card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import multitask as jmt
from deepmusicgeneration_tpu.models.config import small_multitask_config as j_small
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference as j_cast
from deepmusicgeneration_tpu.ops import fused_decode as jfd
from deepmusicgeneration_tpu.ops import fused_s2s as jfs
from deepmusicgeneration_tpu.train.learner import MultitaskLearner as JLearner
from deepmusicgeneration_tpu_torch.models.config import MultitaskConfig
from deepmusicgeneration_tpu_torch.ops import fused_s2s as tfs
from deepmusicgeneration_tpu_torch.train.checkpoint import multitask_params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_multitask_model")

# plain torch vs Pallas interpret: the same float32 arithmetic and bf16
# rounding points in another summation order, on post-LayerNorm values of
# order 1
H_ATOL = 1e-4
# At the demo widths a float32 value at a bf16 cast point sometimes lies
# within float32 noise of a rounding point, so that one of the two rounds it
# the other way (a flip of 2^-8 relative, carried through the later layers,
# on either side). Such a flip case is still held against JAX, at the
# distances one flip reaches: h_out within FLIP_ATOL (measured up to
# 1.42e-3), the written int8 entries at most one step apart in a share of at
# most FLIP_SLOT_SHARE (measured 24 of 2048), their scales within
# FLIP_SCALE_RTOL (measured 6.3e-4), every other slot untouched. The float64
# run of the plain version (the same cast points, exact sums) says which
# side flipped: the other is within F64_ATOL of it (measured <= 1.7e-6).
F64_ATOL = 1e-5
FLIP_ATOL = 2e-3
FLIP_SLOT_SHARE = 1 / 32
FLIP_SCALE_RTOL = 2e-3
# a written int8 entry is round(x / scale) of a float32 value summed in
# another order: it may differ by one step where x / scale lies within
# float32 noise of a rounding half-point; the genre all-rows step's test
# (test_torch_allrows.py) found at most 1 in 4096 such entries
SLOT_TIE_SHARE = 1 / 4096
SCALE_RTOL = 1e-5


def _tree(jp, rng, bias_std):
    """The numpy copy of a JAX tree, with non-zero biases drawn by ``rng``
    where the init gave zeros (so a bias dropped anywhere shows)."""
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if bias_std:
        for lp in tree["decoder"]["layers"]:
            for sub in (lp["mha1"], lp["mha2"], lp):
                for k in [k for k in sub if k.endswith("_b") and not k.startswith("ln")
                          and not k.startswith("ff_ln")]:
                    sub[k] = (rng.normal(scale=bias_std, size=sub[k].shape)
                              .astype(np.float32)).astype(sub[k].dtype)
    return tree


@pytest.fixture(scope="module", params=["small", "demo"])
def setup(request):
    rng = np.random.default_rng(7)
    if request.param == "small":
        jcfg = j_small()
        jp = j_cast(jmt.init_multitask(jax.random.PRNGKey(3), jcfg))
        tree = _tree(jp, rng, bias_std=0.1)
    else:
        jl = JLearner.load(DEMO)
        jcfg = jl.cfg
        tree = _tree(j_cast(jl.params), rng, bias_std=0.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = MultitaskConfig.from_dict(jcfg.to_dict())
    tp = multitask_params_from_numpy(tree, cfg)
    return jcfg, cfg, jp, tp


def _np(t):
    return np.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())


def test_stack_and_weight_quantizer_bit_identical(setup):
    jcfg, cfg, jp, tp = setup
    js, ts = jfs.stack_mt_dec_layers(jp), tfs.stack_mt_dec_layers(tp)
    for name in js._fields:
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name), np.float32))
    (jq, jws), (tq, tws) = jfs.quantize_mt_weights(js), tfs.quantize_mt_weights(ts)
    for name in ("qkv_w", "q2_w", "ff1_w", "ff2_w"):
        np.testing.assert_array_equal(getattr(tq, name).numpy(), np.asarray(getattr(jq, name)))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))


def _cross(jcfg, Le, rng):
    L, H, Dh = jcfg.dec_layers, jcfg.n_heads, jcfg.d_head
    draw = lambda *s: rng.normal(scale=0.5, size=s).astype(np.float32)
    k, v, wkr = draw(L, 1, H, Le, Dh), draw(L, 1, H, Le, Dh), draw(L, H, Le, Dh)
    k[0, 0, 1, 3] = 0.0             # an all-zero head row: not a whole slot
    v[:, :, :, 5] = 0.0             # an all-zero slot takes the 1e-6 scale floor
    return k, v, wkr


def test_cross_quantizer_bit_identical(setup):
    jcfg, *_ = setup
    k, v, wkr = _cross(jcfg, 64, np.random.default_rng(2))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = jfs.quantize_cross_slot_major(jmt.CrossCache(bf(k), bf(v), bf(wkr)))
    tb = lambda a: torch.from_numpy(a).bfloat16()
    from deepmusicgeneration_tpu_torch.models.multitask import CrossCache
    got = tfs.quantize_cross_slot_major(CrossCache(tb(k), tb(v), tb(wkr)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r, np.float32))


def _ring(jcfg, ptr, full, rng):
    L, M, HD = jcfg.dec_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    k = rng.normal(scale=0.5, size=(L, 1, M, HD)).astype(np.float32)
    v = rng.normal(scale=0.5, size=(L, 1, M, HD)).astype(np.float32)
    kv = [np.asarray(t) for t in jfd.quantize_kv_slot_major(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))]
    slot = np.arange(M)
    if full:                                   # every slot valid, g_cur = ptr
        g = np.where(slot < ptr, slot, slot - M)
    else:                                      # a prompt of M // 3 tokens + ptr decoded
        g = np.where(slot < ptr, slot, jmt.PAD_G)
        g[M - M // 3:] = np.arange(-(M // 3), 0)
    dist = ptr - g
    return kv, ((dist < 1) | (dist > M)).astype(np.int32)[None]


VARIANTS = [("s2s", True), ("s2s", False), ("nw", True), ("nw", False)]


@pytest.mark.parametrize("task,weights_int8", VARIANTS)
def test_plain_matches_pallas_interpret(setup, task, weights_int8):
    jcfg, cfg, jp, tp = setup
    L, M, HD = jcfg.dec_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    Le = M
    rng = np.random.default_rng(1000 * VARIANTS.index((task, weights_int8)) + M)
    js, ts = jfs.stack_mt_dec_layers(jp), tfs.stack_mt_dec_layers(tp)
    jws = tws = None
    if weights_int8:
        (js, jws), (ts, tws) = jfs.quantize_mt_weights(js), tfs.quantize_mt_weights(ts)
    wkr = rng.normal(scale=0.5, size=(L, M + 1, HD)).astype(np.float32)
    wkr_j = jnp.asarray(wkr, jnp.bfloat16)
    wkr_t = torch.from_numpy(wkr).bfloat16()
    cross_j = cross_t = ()
    if task == "s2s":
        k, v, cw = _cross(jcfg, Le, rng)
        jc = jfs.quantize_cross_slot_major(
            jmt.CrossCache(*(jnp.asarray(a, jnp.bfloat16) for a in (k, v, cw))))
        cblocked = (np.arange(Le)[None] >= Le - Le // 4).astype(np.int32)   # padding
        cross_j = (*jc, jnp.asarray(cblocked))
        cross_t = tuple(torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                        if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a))
                        for a in cross_j)
    n_diff, n_entries, n_flips = 0, 0, 0
    for ptr in (0, 31, 32, M - 1):
        for full in (False, True):
            kv, blocked = _ring(jcfg, ptr, full, rng)
            h_in = rng.normal(size=(1, jcfg.d_model)).astype(np.float32)
            jargs = (js, jcfg, jnp.asarray(h_in), wkr_j, *[jnp.asarray(t) for t in kv])
            targs = (ts, cfg, torch.from_numpy(h_in), wkr_t,
                     *[torch.from_numpy(t.copy()) for t in kv])
            kw = dict(weights_int8=weights_int8)
            if task == "s2s":
                ref = jfs.fused_s2s_slab_core(*jargs, *cross_j, jnp.asarray(blocked),
                                              jnp.asarray(ptr, jnp.int32), M,
                                              w_scales=jws, interpret=True, **kw)
                got = tfs.fused_s2s_slab_core(*targs, *cross_t, torch.from_numpy(blocked),
                                              ptr, M, w_scales=tws, **kw)
            else:
                ref = jfs.fused_nw_slab_core(*jargs, jnp.asarray(blocked),
                                             jnp.asarray(ptr, jnp.int32), M,
                                             w_scales=jws, interpret=True, **kw)
                got = tfs.fused_nw_slab_core(*targs, torch.from_numpy(blocked), ptr, M,
                                             w_scales=tws, **kw)
            ref, got = [np.asarray(t) for t in ref], [t.numpy() for t in got]
            dh = np.abs(got[0] - ref[0]).max()
            flip = dh > H_ATOL
            if flip:
                assert dh <= FLIP_ATOL, (ptr, full, dh)
                exact = _plain64(ts, tws, cfg, h_in, wkr_t, kv, cross_t, blocked, ptr, M)
                assert min(np.abs(got[0] - exact).max(),
                           np.abs(ref[0] - exact).max()) <= F64_ATOL
                n_flips += 1
            other = np.arange(M) != ptr
            for g, r, before in zip(got[1:], ref[1:], kv):
                # only the 32-slot band of ptr is written back; slot ptr changes
                np.testing.assert_array_equal(g[:, :, other], before[:, :, other])
                np.testing.assert_array_equal(r[:, :, other], before[:, :, other])
            case_diff, case_entries = 0, 0
            for i in (0, 2):      # written int8 rows: identical but for half-point ties
                d = np.abs(got[1 + i][:, :, ptr].astype(int) - ref[1 + i][:, :, ptr])
                assert d.max() <= 1
                case_diff += int((d > 0).sum())
                case_entries += d.size
            if flip:
                assert case_diff <= case_entries * FLIP_SLOT_SHARE, (case_diff, case_entries)
            else:
                n_diff, n_entries = n_diff + case_diff, n_entries + case_entries
            for i in (1, 3):      # their scales
                np.testing.assert_allclose(got[1 + i][:, :, ptr], ref[1 + i][:, :, ptr],
                                           rtol=FLIP_SCALE_RTOL if flip else SCALE_RTOL)
    assert n_diff <= n_entries * SLOT_TIE_SHARE, (n_diff, n_entries)
    assert n_flips <= 4, n_flips          # a rare event: at most half the cases


def _plain64(ts, tws, cfg, h_in, wkr_t, kv, cross_t, blocked, ptr, M):
    """h_out of the plain version with float64 sums between the cast points."""
    cross = cross_t or (None,) * 6
    return tfs.s2s_slab_plain(ts, tws, cfg, torch.from_numpy(h_in), wkr_t,
                              *[torch.from_numpy(t.copy()) for t in kv], *cross,
                              torch.from_numpy(blocked), ptr, M, acc=torch.float64)[0].numpy()


def test_kernel_widths_and_wrapper_checks(setup):
    """kernel_accepts follows the CUDA kernel's widths; the wrappers check
    their operands and count no launch for a CPU tensor."""
    jcfg, cfg, jp, tp = setup
    assert tfs.kernel_accepts(cfg)
    assert not tfs.kernel_accepts(cfg.replace(d_head=48, d_model=48 * cfg.n_heads))
    assert not tfs.kernel_accepts(cfg.replace(d_model=cfg.d_model + 4))
    ts = tfs.stack_mt_dec_layers(tp)
    L, M, HD = cfg.dec_layers, cfg.mem_len, cfg.n_heads * cfg.d_head
    kv = [torch.zeros((L, 1, M, HD), dtype=torch.int8), torch.ones((L, 1, M, 1)),
          torch.zeros((L, 1, M, HD), dtype=torch.int8), torch.ones((L, 1, M, 1))]
    wkr = torch.zeros((L, M + 1, HD), dtype=torch.bfloat16)
    h = torch.zeros((1, cfg.d_model))
    blocked = torch.zeros((1, M), dtype=torch.int32)
    before = dict(tfs.fused_nw_slab_core.launches)
    tfs.fused_nw_slab_core(ts, cfg, h, wkr, *kv, blocked, 3, M)
    assert tfs.fused_nw_slab_core.launches == before
    with pytest.raises(ValueError, match="w_scales"):
        tfs.fused_nw_slab_core(ts, cfg, h, wkr, *kv, blocked, 3, M, weights_int8=True)
    with pytest.raises(ValueError, match="ptr"):
        tfs.fused_nw_slab_core(ts, cfg, h, wkr, *kv, blocked, M, M)
    with pytest.raises(TypeError, match="wkr_mt"):
        tfs.fused_nw_slab_core(ts, cfg, h, wkr.float(), *kv, blocked, 0, M)
