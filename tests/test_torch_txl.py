"""The port's relative-attention primitives, prompt prefill and exact ring
decode step against the JAX package's, on the same parameters and inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import small_test_config as j_small
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference as j_cast
from deepmusicgeneration_tpu.ops import rel_attention as jra
from deepmusicgeneration_tpu.train.learner import MusicLearner as JLearner
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import small_test_config
from deepmusicgeneration_tpu_torch.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu_torch.ops import rel_attention as ra
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_genre_model")

# float32 on both sides: only summation order differs (measured ~1e-6)
F32_ATOL = 1e-4
# bf16 activations: XLA and PyTorch round matmul outputs and GELU at the
# same points but sum in other orders, so a value may land one bf16 ulp
# (2^-8 relative) apart and propagate; measured max |dlogit| 1.1e-2 on
# logits up to ~7 for the demo checkpoint
BF16_ATOL = 5e-2


def test_sinusoid_tables_identical():
    for n, d in ((7, 16), (513, 512)):
        np.testing.assert_array_equal(ra.backwards_pos_enc(n, d).numpy(),
                                      np.asarray(jra.backwards_pos_enc(n, d)))


@pytest.mark.parametrize("shape", [(2, 3, 5, 5), (1, 2, 4, 9)])
def test_rel_shift_exact_spill(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(ra.rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jra.rel_shift(jnp.asarray(x))))


@pytest.mark.parametrize("x_len,m_len,win,k,mem_valid",
                         [(6, 0, 1, 1, None), (8, 4, 2, 1, 3), (5, 3, 1, 2, None)])
def test_causal_window_mask(x_len, m_len, win, k, mem_valid):
    got = ra.causal_window_mask(x_len, m_len, win, k, mem_valid).numpy()
    ref = np.asarray(jra.causal_window_mask(x_len, m_len, win, k, mem_valid))
    np.testing.assert_array_equal(got, ref)


def test_rel_attention_matches():
    rng = np.random.default_rng(1)
    B, H, Q, K, Dh = 2, 3, 6, 6, 8
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            [(B, H, Q, Dh), (B, H, K, Dh), (B, H, K, Dh), (H, K, Dh),
             (H, 1, Dh), (H, 1, Dh)]]
    mask = np.asarray(jra.causal_window_mask(Q, 0))
    ref = jra.rel_attention(*[jnp.asarray(a) for a in arrs], mask=jnp.asarray(mask))
    got = ra.rel_attention(*[torch.from_numpy(a) for a in arrs],
                           mask=torch.from_numpy(mask.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL)


def _models(kind):
    if kind == "small_f32":
        jcfg = j_small()
        jp = jtxl.init_txl(jax.random.PRNGKey(2), jcfg)
        return jcfg, jp, small_test_config(), F32_ATOL
    jl = JLearner.load(DEMO)
    return jl.cfg, j_cast(jl.params), None, BF16_ATOL


@pytest.mark.parametrize("kind", ["small_f32", "demo_bf16"])
def test_prefill_and_ring_step_logits(kind):
    jcfg, jp, cfg, atol = _models(kind)
    if cfg is None:   # the demo checkpoint's config, through the port's class
        from deepmusicgeneration_tpu_torch.models.config import TXLConfig
        cfg = TXLConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    if cfg.dtype == "bfloat16":
        tp = cast_params_for_inference(tp)
    rng = np.random.default_rng(3)
    B, W, M = 2, cfg.mem_len // 2, cfg.mem_len
    x = rng.integers(5, 300, size=(B, W))
    pad = np.zeros((B, W), bool)
    pad[1, :W // 3] = True                 # row 1 left-padded
    jl, jc = jtxl.prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pad), flash=False)
    tl, tc = txl.prefill(tp, cfg, torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))

    jr, tr = jtxl.ring_from_prefill(jc, jcfg), txl.ring_from_prefill(tc, cfg)
    np.testing.assert_array_equal(tr.g.numpy(), np.asarray(jr.g))
    jw, tw = jtxl.precompute_wkr(jp, jcfg, M), txl.precompute_wkr(tp, cfg, M)
    for step in range(3):   # three steps: the in-place ring write is read back
        tok = rng.integers(5, 300, size=(B,))
        jlog, jr = jtxl.decode_step_ring(jp, jcfg, jnp.asarray(tok),
                                         jnp.zeros((B,), jnp.int32), jr, jw)
        tlog, tr = txl.decode_step_ring(tp, cfg, torch.from_numpy(tok),
                                        torch.zeros((B,), dtype=torch.int32), tr, tw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=atol, rtol=0)
    np.testing.assert_array_equal(tr.g.numpy(), np.asarray(jr.g))
    assert (tr.ptr, tr.g_cur) == (int(jr.ptr), int(jr.g_cur))


def test_init_kv_cache_shapes():
    cfg = small_test_config()
    c = txl.init_kv_cache(cfg, 3)
    assert tuple(c.k.shape) == (cfg.n_layers, 3, cfg.mem_len, cfg.n_heads, cfg.d_head)
    assert c.k.dtype == torch.float32 and c.valid.dtype == torch.int32
