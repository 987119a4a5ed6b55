"""The port's multitask model parts (encoder, seq2seq and next-word prefill,
cross-attention cache, ring decode steps) against the JAX package's, on the
same parameters and inputs: the small float32 config and the trained demo
checkpoint in bf16."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import multitask as jmt
from deepmusicgeneration_tpu.models.config import multitask_config as j_flagship
from deepmusicgeneration_tpu.models.config import small_multitask_config as j_small
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference as j_cast
from deepmusicgeneration_tpu.train.learner import MultitaskLearner as JLearner
from deepmusicgeneration_tpu_torch.models import multitask as mt
from deepmusicgeneration_tpu_torch.models.config import (MultitaskConfig,
                                                         multitask_config,
                                                         small_multitask_config)
from deepmusicgeneration_tpu_torch.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu_torch.train.checkpoint import multitask_params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_multitask_model")

# float32 on both sides: only the summation order differs
F32_TOL = dict(atol=1e-4, rtol=0)
# bf16 activations: both round at the same points but sum in other orders,
# so a value may land one bf16 ulp apart and propagate through the layers
# (the genre port's tolerance for the bf16 demo model)
BF16_TOL = dict(atol=0.15, rtol=0.05)


def _models(kind):
    if kind == "small_f32":
        jcfg = j_small()
        jp = jmt.init_multitask(jax.random.PRNGKey(2), jcfg)
        return jcfg, jp, small_multitask_config(), F32_TOL
    jl = JLearner.load(DEMO)
    return jl.cfg, j_cast(jl.params), MultitaskConfig.from_dict(jl.cfg.to_dict()), BF16_TOL


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def _inputs(rng, B, W, lo=5, hi=300):
    x = rng.integers(lo, hi, size=(B, W)).astype(np.int32)
    pos = np.cumsum(rng.integers(0, 3, size=(B, W)), axis=1).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("kind", ["small_f32", "demo_bf16"])
def test_model_parts_match_jax(kind):
    jcfg, jp, cfg, tol = _models(kind)
    tp = multitask_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    if cfg.dtype == "bfloat16":
        tp = cast_params_for_inference(tp)
    t, j = torch.from_numpy, jnp.asarray
    rng = np.random.default_rng(3)
    B, M = 2, cfg.mem_len
    We, Wd = M // 2, M // 2

    # encoder over a right-padded window: pad columns must not leak
    xe, pe = _inputs(rng, B, We)
    enc_pad = np.zeros((B, We), bool)
    enc_pad[1, We - We // 3:] = True
    xe[enc_pad] = 1
    j_enc = jmt.encode(jp, jcfg, j(xe), j(pe), pad_cols=j(enc_pad))
    t_enc = mt.encode(tp, cfg, t(xe), t(pe), pad_cols=t(enc_pad))
    _close(t_enc, j_enc, tol)

    # seq2seq prefill over a left-padded target
    xd, pd = _inputs(rng, B, Wd)
    dec_pad = np.zeros((B, Wd), bool)
    dec_pad[0, :Wd // 4] = True
    xd[dec_pad] = 1
    enc_in = j_enc if kind == "small_f32" else j(t_enc.float().numpy()).astype(jnp.bfloat16)
    jl, jc = jmt.decoder_prefill(jp, jcfg, j(xd), j(pd), j(dec_pad), enc_in,
                                 enc_pad=j(enc_pad), flash=False)
    tl, tc = mt.decoder_prefill(tp, cfg, t(xd), t(pd), t(dec_pad), t_enc,
                                enc_pad=t(enc_pad))
    _close(tl, jl, tol)
    _close(tc.k, jc.k, tol)
    _close(tc.v, jc.v, tol)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))

    jx, tx = jmt.precompute_cross(jp, jcfg, enc_in), mt.precompute_cross(tp, cfg, t_enc)
    for a, b in zip(tx, jx):
        _close(a, b, tol)

    jr, tr = jmt.dec_ring_from_prefill(jc), mt.dec_ring_from_prefill(tc)
    np.testing.assert_array_equal(tr.g.numpy(), np.asarray(jr.g))
    jw, tw = jmt.precompute_dec_wkr(jp, jcfg, M), mt.precompute_dec_wkr(tp, cfg, M)
    _close(tw, jw, tol)
    for step in range(8):     # the in-place ring writes are read back
        tok, pos = rng.integers(5, 300, size=(B,)), rng.integers(0, 500, size=(B,))
        jlog, jr = jmt.decoder_step_ring(jp, jcfg, j(tok), j(pos), jr, jx, jw,
                                         enc_pad=j(enc_pad))
        tlog, tr = mt.decoder_step_ring(tp, cfg, t(tok), t(pos), tr, tx, tw,
                                        enc_pad=t(enc_pad))
        _close(tlog, jlog, tol)
    np.testing.assert_array_equal(tr.g.numpy(), np.asarray(jr.g))
    assert (tr.ptr, tr.g_cur) == (int(jr.ptr), int(jr.g_cur))
    _close(tr.k, jr.k, tol)

    # next-word: attention-only prefill and ring steps
    jl, jc = jmt.lm_prefill(jp, jcfg, j(xd), j(pd), j(dec_pad), flash=False)
    tl, tc = mt.lm_prefill(tp, cfg, t(xd), t(pd), t(dec_pad))
    _close(tl, jl, tol)
    _close(tc.k, jc.k, tol)
    jr, tr = jmt.dec_ring_from_prefill(jc), mt.dec_ring_from_prefill(tc)
    for step in range(8):
        tok, pos = rng.integers(5, 300, size=(B,)), rng.integers(0, 500, size=(B,))
        jlog, jr = jmt.lm_step_ring(jp, jcfg, j(tok), j(pos), jr, jw)
        tlog, tr = mt.lm_step_ring(tp, cfg, t(tok), t(pos), tr, tw)
        _close(tlog, jlog, tol)
    _close(tr.v, jr.v, tol)


def test_embedding_zero_at_padding_indices():
    cfg = small_multitask_config()
    tp = mt.init_multitask(cfg, torch.Generator().manual_seed(0))
    x = torch.tensor([[1, 7, 7]])
    pos = torch.tensor([[0, 32, 33]])           # beat 0, bar 1 / beat 1, bar 1
    emb = mt.embed_tokens(tp, cfg, x, pos)
    assert torch.equal(emb[0, 0], torch.zeros(cfg.d_model))
    assert torch.allclose(emb[0, 1], tp["embed"][7] + tp["bar_enc"][1])
    assert torch.allclose(emb[0, 2], tp["embed"][7] + tp["beat_enc"][1] + tp["bar_enc"][1])


def test_init_matches_jax_shapes_and_distribution():
    """init_multitask: the JAX tree's structure, shapes and dtypes, weights
    of std 0.02, LayerNorm gains near 1, zero biases and padding row."""
    cfg = multitask_config()
    jp = jax.eval_shape(lambda r: jmt.init_multitask(r, j_flagship()), jax.random.PRNGKey(0))
    tp = mt.init_multitask(cfg, torch.Generator().manual_seed(1))
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    lp = tp["decoder"]["layers"][3]
    assert abs(lp["ff1_w"].std().item() - 0.02) < 1e-3
    assert abs(lp["mha2"]["ln_g"].mean().item() - 1.0) < 5e-3
    assert not lp["mha1"]["q_b"].any() and not tp["head_b"].any()
    assert not tp["embed"][1].any()
    assert sum(x.numel() for x in jax.tree_util.tree_leaves(tp)) > 80e6   # the 85M flagship
