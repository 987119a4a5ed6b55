"""The port's all-rows decode core (``slab_ar_w8``) against the JAX package's
Pallas kernel.

The plain PyTorch version of ``fused_slab_allrows_core`` (what the wrapper
runs for CPU tensors) is held against JAX
``fused_slab_allrows_decode(..., weights_int8=True)`` in Pallas interpret
mode on the bf16 ``setup`` config of ``tests/test_fused_decode.py``
(2 layers, d_model 128, 2 x 64 heads, mem_len 128) at B = 16, on a partly
filled and on a full ring. On a full ring slot ``ptr`` holds the oldest
token at distance exactly M, which stays visible: attention must read its
old contents before the fresh token is written there. The CUDA kernel itself
is held against the plain version in the ``cuda``-marked tests.
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

B = 16
# plain torch vs Pallas interpret: the same float32 arithmetic and bf16
# rounding points in another summation order. The two JAX kernels
# (fused_slab_core and fused_slab_allrows_core) differ from each other by up
# to 9.0e-5 on this config's post-LayerNorm h_out (entries of order 1) when
# a sum lands on the other side of a bf16 rounding point; 1e-4 covers that.
H_ATOL = 1e-4
# a fresh-slot scale is max|k| / 127 of a float32 row. In layer 0 only the
# sum order differs: at most a few float32 ulps. Deeper layers' k and v come
# from the layer below's output, which carries that layer's drift (at most
# H_ATOL on entries of order 1; measured 2.6e-5 relative on a scale).
SCALE_RTOL = 1e-5
SCALE_RTOL_DEEP = 2 * H_ATOL
# A written int8 entry is round(x / scale). The two JAX kernels write
# identical entries here, but torch's float32 matmul sums the qkv products in
# another order than XLA's dot, so an x within float32 noise of a rounding
# half-point lands one step away: measured in 1 of 4096 entries in 2 of the 8
# cases (layer 0 in one of them), none in the others.
SLOT_MAX_STEP = 1
SLOT_MAX_SHARE = 1e-3


@pytest.fixture(scope="module")
def model():
    kw = dict(vocab_size=324, n_layers=2, d_model=128, d_inner=256, n_heads=2,
              d_head=64, ctx_len=128, mem_len=128, dtype="bfloat16", bias=False)
    jcfg, cfg = JConfig(**kw), TXLConfig(**kw)
    jp = cast_params_for_inference(jtxl.init_txl(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    js = jfd.quantize_stacked_weights(jfd.stack_txl_layers(jp))
    ts = tfd.quantize_stacked_weights(tfd.stack_txl_layers(tp))
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    wkr_mt = jtxl.precompute_wkr(jp, jcfg, M).transpose(0, 2, 1, 3) \
        .reshape(L, M + 1, HD).astype(jnp.bfloat16)
    return jcfg, cfg, js, ts, wkr_mt


def _ring(jcfg, ptr, full, seed):
    """Random int8 caches and the blocked mask of a ring at pointer ``ptr``:
    full (every slot valid, slot ptr at distance M) or partly full (a prompt
    of M // 3 tokens plus ptr decoded ones); rows differ in a few slots."""
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    rng = np.random.default_rng(seed)
    k = rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32)
    v = rng.normal(scale=0.5, size=(L, B, M, HD)).astype(np.float32)
    kv = jfd.quantize_kv_slot_major(jnp.asarray(k, jnp.bfloat16),
                                    jnp.asarray(v, jnp.bfloat16))
    slot = np.arange(M)
    if full:
        g = np.where(slot < ptr, slot, slot - M)           # g_cur = ptr
    else:
        g = np.where(slot < ptr, slot, jtxl.PAD_G)
        g[M - M // 3:] = np.arange(-(M // 3), 0)
    g = np.broadcast_to(g, (B, M)).copy()
    for b in range(1, B, 3):
        g[b, (ptr + 1 + b) % M] = jtxl.PAD_G
    dist = ptr - g
    blocked = ((dist < 1) | (dist > M)).astype(np.int32)
    h_in = rng.normal(size=(B, jcfg.d_model)).astype(np.float32)
    return [np.asarray(t) for t in kv], h_in, blocked


@pytest.mark.parametrize("full", [False, True], ids=["part", "full"])
@pytest.mark.parametrize("ptr", [5, 39])
@pytest.mark.parametrize("R", [4, 8])
def test_plain_slab_ar_w8_matches_pallas_interpret(model, R, ptr, full):
    jcfg, cfg, (jst, jws), (tst, tws), wkr_mt = model
    M = jcfg.mem_len
    kv, h_in, blocked = _ring(jcfg, ptr, full, seed=100 * R + 2 * ptr + full)
    ref = jfd.fused_slab_allrows_decode(
        jst, jcfg, jnp.asarray(h_in), wkr_mt, *[jnp.asarray(t) for t in kv],
        jnp.asarray(blocked), jnp.asarray(ptr, jnp.int32), M, rows_per_cell=R,
        weights_int8=True, w_scales=jws, interpret=True)
    ref = [np.asarray(t) for t in ref]
    wkr_t = torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16()
    got = tfd.fused_slab_allrows_core(
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
    for i in (0, 2):   # written int8 rows: identical up to half-point flips
        d = np.abs(got[1 + i][:, :, ptr].astype(int) - ref[1 + i][:, :, ptr].astype(int))
        assert d.max() <= SLOT_MAX_STEP and (d > 0).mean() <= SLOT_MAX_SHARE, \
            (d.max(), (d > 0).sum())
    for i in (1, 3):   # their scales
        np.testing.assert_allclose(got[1 + i][0, :, ptr], ref[1 + i][0, :, ptr],
                                   rtol=SCALE_RTOL, atol=0)
        np.testing.assert_allclose(got[1 + i][1:, :, ptr], ref[1 + i][1:, :, ptr],
                                   rtol=SCALE_RTOL_DEEP, atol=0)
    assert tfd.fused_slab_allrows_core.launches["slab_ar_w8"] == 0   # CPU: no kernel launch


def test_allrows_checks_its_arguments(model):
    jcfg, cfg, _, (tst, tws), wkr_mt = model
    kv, h_in, blocked = _ring(jcfg, 3, True, seed=1)
    wkr_t = torch.from_numpy(np.array(wkr_mt.astype(jnp.float32))).bfloat16()
    args = [torch.from_numpy(h_in), wkr_t,
            *[torch.from_numpy(t.copy()) for t in kv], torch.from_numpy(blocked)]
    # the bf16-weight mode (slab_ar) takes bf16 panels, not int8 ones
    with pytest.raises(TypeError, match="qkv_w"):
        tfd.fused_slab_allrows_core(tst, cfg, *args, 3, jcfg.mem_len,
                                    weights_int8=False)
    with pytest.raises(ValueError, match="rows_per_cell"):
        tfd.fused_slab_allrows_core(tst, cfg, *args, 3, jcfg.mem_len,
                                    rows_per_cell=6, weights_int8=True, w_scales=tws)
    with pytest.raises(ValueError, match="w_scales"):
        tfd.fused_slab_allrows_core(tst, cfg, *args, 3, jcfg.mem_len,
                                    weights_int8=True)
    args[3] = args[3][:, :8].contiguous()   # ks for 8 rows, h_in for 16
    with pytest.raises(ValueError, match="ks"):
        tfd.fused_slab_allrows_core(tst, cfg, *args, 3, jcfg.mem_len,
                                    weights_int8=True, w_scales=tws)
