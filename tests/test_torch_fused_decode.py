"""The port's slab decode cores against the JAX package's Pallas kernels.

The quantizers must be bit-identical to JAX's. The plain PyTorch version of
``fused_slab_core`` (what the wrapper runs for CPU tensors) is held against
JAX ``fused_slab_core(..., weights_int8=True)`` in Pallas interpret mode on
``small_test_config`` shapes (mem_len 64); the bf16-weight modes ``slab``
and ``slab_ar`` against JAX ``fused_slab_core`` / ``fused_slab_allrows_core``
with ``weights_int8=False`` on the same shapes. The CUDA kernels themselves
are held against the plain version in the ``cuda``-marked tests, which skip
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import small_test_config as j_small
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu.ops import fused_decode as jfd
from deepmusicgeneration_tpu_torch.models.config import small_test_config
from deepmusicgeneration_tpu_torch.ops import fused_decode as tfd
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy

# plain torch vs Pallas interpret: the same float32 arithmetic and bf16
# rounding points in another summation order; measured max |dh| 4.8e-7 on
# post-LayerNorm values of order 1. 1e-4 leaves room for a rare bf16 flip.
H_ATOL = 1e-4
# a fresh-slot scale is max|k| / 127 of a float32 row whose sum order
# differs: at most a few float32 ulps
SCALE_RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_small(), small_test_config()
    jp = cast_params_for_inference(jtxl.init_txl(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    js = jfd.quantize_stacked_weights(jfd.stack_txl_layers(jp))
    ts = tfd.quantize_stacked_weights(tfd.stack_txl_layers(tp))
    wkr = jtxl.precompute_wkr(jp, jcfg, jcfg.mem_len)
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    wkr_mt = wkr.transpose(0, 2, 1, 3).reshape(L, M + 1, HD).astype(jnp.bfloat16)
    return jcfg, cfg, js, ts, wkr_mt


@pytest.fixture(scope="module")
def bf16_stacks():
    """The bf16 weight stacks of ``model``'s weights, JAX's and the port's."""
    jcfg, cfg = j_small(), small_test_config()
    jp = cast_params_for_inference(jtxl.init_txl(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    return jfd.stack_txl_layers(jp), tfd.stack_txl_layers(tp)


def test_quantize_stacked_weights_bit_identical(model):
    _, _, (jst, jws), (tst, tws), _ = model
    for name in ("qkv_w", "out_w", "ff1_w", "ff2_w"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))


def test_quantize_kv_slot_major_bit_identical():
    rng = np.random.default_rng(4)
    k = rng.normal(scale=0.7, size=(2, 3, 64, 64)).astype(np.float32)
    v = rng.normal(scale=0.2, size=(2, 3, 64, 64)).astype(np.float32)
    v[0, 0, 5] = 0.0   # an all-zero row takes the 1e-6 scale floor
    ref = jfd.quantize_kv_slot_major(jnp.asarray(k, jnp.bfloat16),
                                     jnp.asarray(v, jnp.bfloat16))
    got = tfd.quantize_kv_slot_major(torch.from_numpy(k).bfloat16(),
                                     torch.from_numpy(v).bfloat16())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _inputs(jcfg, R, ptr, seed):
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    rng = np.random.default_rng(seed)
    k = rng.normal(scale=0.5, size=(L, R, M, HD)).astype(np.float32)
    v = rng.normal(scale=0.5, size=(L, R, M, HD)).astype(np.float32)
    kv = jfd.quantize_kv_slot_major(jnp.asarray(k, jnp.bfloat16),
                                    jnp.asarray(v, jnp.bfloat16))
    h_in = rng.normal(size=(R, jcfg.d_model)).astype(np.float32)
    # a partly filled ring: the first rows' oldest slots are still pads
    g = np.broadcast_to(np.arange(M) - M, (R, M)).copy()
    g[:, :ptr] = np.arange(ptr)
    g[0, ptr + 1:ptr + 9] = jtxl.PAD_G
    dist = ptr - g
    blocked = ((dist < 1) | (dist > M)).astype(np.int32)
    return [np.asarray(t) for t in kv], h_in, blocked


@pytest.mark.parametrize("R,ptr", [(1, 5), (1, 32), (2, 31), (2, 63)])
def test_plain_slab_w8_matches_pallas_interpret(model, R, ptr):
    jcfg, cfg, (jst, jws), (tst, tws), wkr_mt = model
    M = jcfg.mem_len
    kv, h_in, blocked = _inputs(jcfg, R, ptr, seed=10 * R + ptr)
    ref = jfd.fused_slab_decode(
        jst, jcfg, jnp.asarray(h_in), wkr_mt, *[jnp.asarray(t) for t in kv],
        jnp.asarray(blocked), jnp.asarray(ptr, jnp.int32), M, rows_per_cell=R,
        weights_int8=True, w_scales=jws, interpret=True)
    ref = [np.asarray(t) for t in ref]
    wkr_t = torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16()
    got = tfd.fused_slab_core(
        tst, cfg, torch.from_numpy(h_in), wkr_t,
        *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked),
        ptr, M, rows_per_cell=R, weights_int8=True, w_scales=tws)
    got = [t.numpy() for t in got]
    np.testing.assert_allclose(got[0], ref[0], atol=H_ATOL, rtol=0)
    other = np.arange(M) != ptr
    for g, r, before in zip(got[1:], ref[1:], kv):
        # only slot ptr changes; the rest is byte-identical to the input
        np.testing.assert_array_equal(g[:, :, other], before[:, :, other])
        np.testing.assert_array_equal(r[:, :, other], before[:, :, other])
    for i in (0, 2):   # written int8 rows: identical
        np.testing.assert_array_equal(got[1 + i][:, :, ptr], ref[1 + i][:, :, ptr])
    for i in (1, 3):   # their scales
        np.testing.assert_allclose(got[1 + i][:, :, ptr], ref[1 + i][:, :, ptr],
                                   rtol=SCALE_RTOL, atol=0)


def _ring(jcfg, B, ptr, full, seed):
    """Random int8 caches, h_in and the blocked mask of a ring at pointer
    ``ptr``: full (every slot valid; slot ptr holds the oldest token at
    distance exactly M) or partly full (a prompt of M // 3 tokens plus ptr
    decoded ones); row 1 has a pad slot more."""
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    rng = np.random.default_rng(seed)
    k = rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32)
    v = rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32)
    kv = jfd.quantize_kv_slot_major(jnp.asarray(k, jnp.bfloat16),
                                    jnp.asarray(v, jnp.bfloat16))
    slot = np.arange(M)
    if full:
        g = np.where(slot < ptr, slot, slot - M)            # g_cur = ptr
    else:
        g = np.where(slot < ptr, slot, jtxl.PAD_G)
        g[M - M // 3:] = np.arange(-(M // 3), 0)
    g = np.broadcast_to(g, (B, M)).copy()
    g[1, (ptr + 2) % M] = jtxl.PAD_G
    dist = ptr - g
    blocked = ((dist < 1) | (dist > M)).astype(np.int32)
    h_in = rng.normal(size=(B, jcfg.d_model)).astype(np.float32)
    return [np.asarray(t) for t in kv], h_in, blocked


# The bf16-weight modes against Pallas interpret: the same arithmetic and
# bf16 cast points as the _w8 modes without the dequantization, in another
# float32 summation order. h_out is held to the largest difference measured
# for the _w8 modes on the CPU (5.4e-5, PERF.md); measured here up to
# 4.8e-7 over the 16 cases. A written int8 entry may move one step where its
# value lies within float32 noise of a rounding half-point; measured: the
# written entries and their scales are identical in every case.
BF16_H_ATOL = 5.4e-5


@pytest.mark.parametrize("full", [False, True], ids=["part", "full"])
@pytest.mark.parametrize("ptr", [0, 31, 32, 63])
@pytest.mark.parametrize("mode", ["slab", "slab_ar"])
def test_plain_bf16_modes_match_pallas_interpret(model, bf16_stacks, mode, ptr, full):
    jcfg, cfg, _, _, wkr_mt = model
    jp_st, tst = bf16_stacks
    M, B = jcfg.mem_len, 2
    kv, h_in, blocked = _ring(jcfg, B, ptr, full, seed=3 * ptr + full)
    jfn = jfd.fused_slab_decode if mode == "slab" else jfd.fused_slab_allrows_decode
    ref = jfn(jp_st, jcfg, jnp.asarray(h_in), wkr_mt, *[jnp.asarray(t) for t in kv],
              jnp.asarray(blocked), jnp.asarray(ptr, jnp.int32), M,
              rows_per_cell=B, weights_int8=False, interpret=True)
    ref = [np.asarray(t) for t in ref]
    core = tfd.fused_slab_core if mode == "slab" else tfd.fused_slab_allrows_core
    wkr_t = torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16()
    got = core(tst, cfg, torch.from_numpy(h_in), wkr_t,
               *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked),
               ptr, M, rows_per_cell=B)
    got = [t.numpy() for t in got]
    np.testing.assert_allclose(got[0], ref[0], atol=BF16_H_ATOL, rtol=0)
    other = np.arange(M) != ptr
    for g, r, before in zip(got[1:], ref[1:], kv):
        # only slot ptr changes; the rest is byte-identical to the input
        np.testing.assert_array_equal(g[:, :, other], before[:, :, other])
        np.testing.assert_array_equal(r[:, :, other], before[:, :, other])
    for i in (0, 2):   # written int8 rows: at most one step apart
        d = np.abs(got[1 + i][:, :, ptr].astype(int) - ref[1 + i][:, :, ptr].astype(int))
        assert d.max() <= 1, d.max()
    for i in (1, 3):   # their scales
        np.testing.assert_allclose(got[1 + i][:, :, ptr], ref[1 + i][:, :, ptr],
                                   rtol=SCALE_RTOL, atol=0)
    assert sum(core.launches.values()) == 0   # CPU: no kernel launch


def test_plain_float64_accumulate(model):
    """``slab_plain(acc=float64)`` keeps the bf16 cast points and runs the
    rest in float64: h_out comes back in float64 within H_ATOL of the float32
    run, only slot ptr is written, its int8 entries at most one step from
    the float32 run's and its scales stay float32."""
    jcfg, cfg, _, (tst, tws), wkr_mt = model
    M, ptr = jcfg.mem_len, 31
    kv, h_in, blocked = _inputs(jcfg, 2, ptr, seed=7)
    wkr_t = torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16()
    run = lambda acc: tfd.slab_plain(
        tst, tws, cfg, torch.from_numpy(h_in), wkr_t,
        *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked), ptr,
        acc=acc)
    f32, f64 = run(torch.float32), run(torch.float64)
    assert f64[0].dtype == torch.float64 and f64[2].dtype == torch.float32
    np.testing.assert_allclose(f64[0].numpy(), f32[0].numpy().astype(np.float64),
                               atol=H_ATOL, rtol=0)
    other = np.arange(M) != ptr
    for g, before in zip(f64[1:], kv):
        np.testing.assert_array_equal(g.numpy()[:, :, other], before[:, :, other])
    for i in (1, 3):
        d = (f64[i][:, :, ptr].int() - f32[i][:, :, ptr].int()).abs()
        assert d.max().item() <= 1


def test_unported_modes_raise(model):
    jcfg, cfg, _, (tst, tws), _ = model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfd.fused_slab_core(tst, cfg, None, None, None, None, None, None, None,
                            0, jcfg.mem_len, score_mode="int8", weights_int8=True,
                            w_scales=tws)


def test_wrapper_checks_inputs(model):
    jcfg, cfg, _, (tst, tws), wkr_mt = model
    kv, h_in, blocked = _inputs(jcfg, 1, 3, seed=1)
    args = [torch.from_numpy(h_in), torch.zeros((2, 65, 64), dtype=torch.bfloat16),
            *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked)]
    with pytest.raises(ValueError, match="ptr"):
        tfd.fused_slab_core(tst, cfg, *args, 64, jcfg.mem_len, rows_per_cell=1,
                            weights_int8=True, w_scales=tws)
    args[5] = args[5].double()   # vs with the wrong dtype
    with pytest.raises(TypeError, match="vs"):
        tfd.fused_slab_core(tst, cfg, *args, 3, jcfg.mem_len, rows_per_cell=1,
                            weights_int8=True, w_scales=tws)
