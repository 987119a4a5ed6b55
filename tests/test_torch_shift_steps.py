"""The shift-append decode steps (``txl.decode_step``, ``mt.decoder_step``,
``mt.lm_step``, ``mt.init_dec_cache``) and the small helpers
``txl.txl_config_41m``, ``mt.param_count`` and ``sampling.num_choices``
against the JAX package's, on the same parameters and inputs.

Each step runs three times after a prefill on the small float32 config and
on the trained demo checkpoint in bf16: the logits, the caches and
``valid`` (which saturates at M: row 0's prompt fills M - 1 slots) must
match JAX's. Then, as JAX's own tests do, the shift-append step must equal
the port's ring step over M + 2 steps, past the ring's wrap-around.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import multitask as jmt
from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import small_multitask_config as j_small_mt
from deepmusicgeneration_tpu.models.config import small_test_config as j_small
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference as j_cast
from deepmusicgeneration_tpu.ops import sampling as jsampling
from deepmusicgeneration_tpu.train.learner import MultitaskLearner as JMTLearner
from deepmusicgeneration_tpu.train.learner import MusicLearner as JLearner
from deepmusicgeneration_tpu_torch.models import multitask as mt
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import (MultitaskConfig, TXLConfig,
                                                         small_multitask_config,
                                                         small_test_config)
from deepmusicgeneration_tpu_torch.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu_torch.ops import sampling
from deepmusicgeneration_tpu_torch.train.checkpoint import (multitask_params_from_numpy,
                                                            params_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")

# float32 on both sides: only the summation order differs
F32_TOL = dict(atol=1e-4, rtol=0)
# bf16: the tolerances of the port's ring-step tests, tests/test_torch_txl.py
# (genre) and tests/test_torch_mt_model.py (multitask): both sides round at
# the same points but sum in other orders, so a value may land one bf16 ulp
# apart and propagate through the layers
GENRE_BF16_TOL = dict(atol=5e-2, rtol=0)
MT_BF16_TOL = dict(atol=0.15, rtol=0.05)
# the shift-append step against the ring step (JAX's tests/test_model.py and
# tests/test_multitask.py hold JAX's two steps to the same)
RING_ATOL = 1e-3


def _jit(fn):
    """A JAX function jitted with its config (argument 1) and any ``flash``
    static: one compile is faster here than op-by-op dispatch."""
    import inspect
    flash = ("flash",) if "flash" in inspect.signature(fn).parameters else ()
    return jax.jit(fn, static_argnums=(1,), static_argnames=flash)


J_PREFILL, J_STEP = _jit(jtxl.prefill), _jit(jtxl.decode_step)
J_ENCODE, J_DEC_PREFILL, J_DEC_STEP = _jit(jmt.encode), _jit(jmt.decoder_prefill), \
    _jit(jmt.decoder_step)
J_LM_PREFILL, J_LM_STEP = _jit(jmt.lm_prefill), _jit(jmt.lm_step)


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def _window(rng, B, W, M, pad_tok):
    """Left-padded prompts: row 0 fills M - 1 slots of the cache, row 1 a
    third of the window."""
    x = rng.integers(5, 300, size=(B, W)).astype(np.int32)
    pad = np.zeros((B, W), bool)
    pad[0, :W - (M - 1)] = True
    pad[1, :W - W // 3] = True
    x[pad] = pad_tok
    return x, pad


def _genre(kind):
    if kind == "small_f32":
        jcfg = j_small()
        return jcfg, jtxl.init_txl(jax.random.PRNGKey(2), jcfg), small_test_config(), F32_TOL
    jl = JLearner.load(os.path.join(CKPT, "demo_genre_model"))
    return jl.cfg, j_cast(jl.params), TXLConfig.from_dict(jl.cfg.to_dict()), GENRE_BF16_TOL


@pytest.mark.parametrize("kind", ["small_f32", "demo_bf16"])
def test_txl_decode_step_matches_jax(kind):
    jcfg, jp, cfg, tol = _genre(kind)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    if cfg.dtype == "bfloat16":
        tp = cast_params_for_inference(tp)
    rng = np.random.default_rng(5)
    B, M = 2, cfg.mem_len
    x, pad = _window(rng, B, M, M, 0)
    _, jc = J_PREFILL(jp, jcfg, jnp.asarray(x), jnp.asarray(pad), flash=False)
    _, tc = txl.prefill(tp, cfg, torch.from_numpy(x), torch.from_numpy(pad))
    for step in range(3):
        tok = rng.integers(5, 300, size=(B,)).astype(np.int32)
        jl, jc = J_STEP(jp, jcfg, jnp.asarray(tok), jnp.zeros((B,), jnp.int32), jc)
        tl, tc = txl.decode_step(tp, cfg, torch.from_numpy(tok),
                                 torch.zeros((B,), dtype=torch.int32), tc)
        _close(tl, jl, tol)
        _close(tc.k, jc.k, tol)
        _close(tc.v, jc.v, tol)
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    assert tc.valid.tolist() == [M, M // 3 + 3]          # row 0 saturated at M
    assert tc.k.dtype == cfg.act_dtype and tc.k.shape == (cfg.n_layers, B, M, cfg.n_heads,
                                                          cfg.d_head)


def test_txl_shift_step_equals_ring_step():
    """Over M + 2 steps (the ring wraps around, valid saturates) on a
    ragged batch."""
    cfg = small_test_config()
    tp = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jtxl.init_txl(jax.random.PRNGKey(3), j_small())), cfg)
    rng = np.random.default_rng(11)
    B, W, M = 2, cfg.ctx_len, cfg.mem_len
    x, pad = _window(rng, B, W, M, 0)
    _, cache = txl.prefill(tp, cfg, torch.from_numpy(x), torch.from_numpy(pad))
    ring = txl.ring_from_prefill(txl.KVCache(cache.k.clone(), cache.v.clone(), cache.valid),
                                 cfg)
    wkr = txl.precompute_wkr(tp, cfg, M)
    zero = torch.zeros((B,), dtype=torch.int32)
    for t in range(M + 2):
        tok = torch.from_numpy(rng.integers(5, 300, size=(B,)))
        l_shift, cache = txl.decode_step(tp, cfg, tok, zero, cache)
        l_ring, ring = txl.decode_step_ring(tp, cfg, tok, zero, ring, wkr)
        np.testing.assert_allclose(l_ring.numpy(), l_shift.numpy(), atol=RING_ATOL,
                                   err_msg=f"step {t}")
    assert cache.valid.tolist() == [M, M]


def _multitask(kind):
    if kind == "small_f32":
        jcfg = j_small_mt()
        return (jcfg, jmt.init_multitask(jax.random.PRNGKey(2), jcfg),
                small_multitask_config(), F32_TOL)
    jl = JMTLearner.load(os.path.join(CKPT, "demo_multitask_model"))
    return jl.cfg, j_cast(jl.params), MultitaskConfig.from_dict(jl.cfg.to_dict()), MT_BF16_TOL


def _encoded(jp, jcfg, tp, cfg, rng, B, Le):
    """A right-padded source through both encoders; the port's steps read
    the port's encoding and JAX's its own, as the engines do (bf16: the
    port's, so both decoders see the same source)."""
    xe = rng.integers(5, 300, size=(B, Le)).astype(np.int32)
    pe = np.cumsum(rng.integers(0, 3, size=(B, Le)), axis=1).astype(np.int32)
    enc_pad = np.zeros((B, Le), bool)
    enc_pad[1, Le - Le // 3:] = True
    xe[enc_pad] = 1
    j_enc = J_ENCODE(jp, jcfg, jnp.asarray(xe), jnp.asarray(pe), pad_cols=jnp.asarray(enc_pad),
                     flash=False)
    t_enc = mt.encode(tp, cfg, torch.from_numpy(xe), torch.from_numpy(pe),
                      pad_cols=torch.from_numpy(enc_pad))
    if cfg.dtype == "bfloat16":
        j_enc = jnp.asarray(t_enc.float().numpy()).astype(jnp.bfloat16)
    return j_enc, t_enc, enc_pad


@pytest.mark.parametrize("kind", ["small_f32", "demo_bf16"])
def test_mt_shift_steps_match_jax(kind):
    jcfg, jp, cfg, tol = _multitask(kind)
    tp = multitask_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    if cfg.dtype == "bfloat16":
        tp = cast_params_for_inference(tp)
    t, j = torch.from_numpy, jnp.asarray
    rng = np.random.default_rng(7)
    B, M = 2, cfg.mem_len
    j_enc, t_enc, enc_pad = _encoded(jp, jcfg, tp, cfg, rng, B, M // 2)
    x, pad = _window(rng, B, M, M, 1)
    pos = np.cumsum(rng.integers(0, 3, size=(B, M)), axis=1).astype(np.int32)
    runs = (("s2s", lambda: J_DEC_PREFILL(jp, jcfg, j(x), j(pos), j(pad), j_enc,
                                          enc_pad=j(enc_pad), flash=False),
             lambda: mt.decoder_prefill(tp, cfg, t(x), t(pos), t(pad), t_enc,
                                        enc_pad=t(enc_pad)),
             lambda tok, p, c: J_DEC_STEP(jp, jcfg, j(tok), j(p), c, j_enc,
                                          enc_pad=j(enc_pad)),
             lambda tok, p, c: mt.decoder_step(tp, cfg, t(tok), t(p), c, t_enc,
                                               enc_pad=t(enc_pad))),
            ("lm", lambda: J_LM_PREFILL(jp, jcfg, j(x), j(pos), j(pad), flash=False),
             lambda: mt.lm_prefill(tp, cfg, t(x), t(pos), t(pad)),
             lambda tok, p, c: J_LM_STEP(jp, jcfg, j(tok), j(p), c),
             lambda tok, p, c: mt.lm_step(tp, cfg, t(tok), t(p), c)))
    for task, j_prefill, t_prefill, j_step, t_step in runs:
        (_, jc), (_, tc) = j_prefill(), t_prefill()
        for step in range(3):
            tok = rng.integers(5, 300, size=(B,)).astype(np.int32)
            p = rng.integers(0, 500, size=(B,)).astype(np.int32)
            (jl, jc), (tl, tc) = j_step(tok, p, jc), t_step(tok, p, tc)
            _close(tl, jl, tol)
            _close(tc.k, jc.k, tol)
            _close(tc.v, jc.v, tol)
            np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
        assert tc.valid.tolist() == [M, M // 3 + 3], task


def test_mt_shift_steps_equal_ring_steps():
    """decoder_step / lm_step against decoder_step_ring / lm_step_ring over
    M + 2 steps on a ragged batch with a padded source."""
    cfg = small_multitask_config()
    tp = multitask_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jmt.init_multitask(jax.random.PRNGKey(4), j_small_mt())), cfg)
    rng = np.random.default_rng(4)
    B, M = 2, cfg.mem_len
    enc_out, enc_pad = _port_encoding(tp, cfg, rng, B, 10)
    x, pad = _window(rng, B, cfg.ctx_len, M, 1)
    pos = np.cumsum(rng.integers(0, 3, size=(B, cfg.ctx_len)), axis=1).astype(np.int32)
    t = torch.from_numpy
    wkr = mt.precompute_dec_wkr(tp, cfg, M)
    cross = mt.precompute_cross(tp, cfg, enc_out)
    for task in ("s2s", "lm"):
        if task == "s2s":
            _, cache = mt.decoder_prefill(tp, cfg, t(x), t(pos), t(pad), enc_out,
                                          enc_pad=enc_pad)
        else:
            _, cache = mt.lm_prefill(tp, cfg, t(x), t(pos), t(pad))
        ring = mt.dec_ring_from_prefill(mt.DecKVCache(cache.k.clone(), cache.v.clone(),
                                                      cache.valid))
        for step in range(M + 2):
            tok = t(rng.integers(5, 300, size=(B,)))
            p = t(rng.integers(0, 500, size=(B,)))
            if task == "s2s":
                l_shift, cache = mt.decoder_step(tp, cfg, tok, p, cache, enc_out,
                                                 enc_pad=enc_pad)
                l_ring, ring = mt.decoder_step_ring(tp, cfg, tok, p, ring, cross, wkr,
                                                    enc_pad=enc_pad)
            else:
                l_shift, cache = mt.lm_step(tp, cfg, tok, p, cache)
                l_ring, ring = mt.lm_step_ring(tp, cfg, tok, p, ring, wkr)
            np.testing.assert_allclose(l_ring.numpy(), l_shift.numpy(), atol=RING_ATOL,
                                       err_msg=f"{task} step {step}")
        assert cache.valid.tolist() == [M, M], task


def _port_encoding(tp, cfg, rng, B, Le):
    xe = rng.integers(5, 300, size=(B, Le))
    pe = np.cumsum(rng.integers(0, 3, size=(B, Le)), axis=1)
    enc_pad = np.zeros((B, Le), bool)
    enc_pad[1, -3:] = True
    enc_pad = torch.from_numpy(enc_pad)
    return mt.encode(tp, cfg, torch.from_numpy(xe), torch.from_numpy(pe),
                     pad_cols=enc_pad), enc_pad


def test_init_dec_cache_matches_jax():
    for jcfg, cfg in ((j_small_mt(), small_multitask_config()),
                      (j_small_mt().replace(dtype="bfloat16"),
                       small_multitask_config().replace(dtype="bfloat16"))):
        jc, tc = jmt.init_dec_cache(jcfg, 3, mem_len=40), mt.init_dec_cache(cfg, 3, mem_len=40)
        for a, b in zip(tc, jc):
            assert tuple(a.shape) == b.shape and not a.any()
        assert tc.k.dtype == cfg.act_dtype and tc.valid.dtype == torch.int32
        assert mt.init_dec_cache(cfg, 1).k.shape[2] == cfg.mem_len


def test_param_counts_and_41m_config_match_jax():
    jcfg = j_small_mt()
    jp = jmt.init_multitask(jax.random.PRNGKey(0), jcfg)
    tp = multitask_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     small_multitask_config())
    assert mt.param_count(tp) == jmt.param_count(jp)
    assert txl.txl_config_41m().to_dict() == jtxl.txl_config_41m().to_dict()


def test_num_choices_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(4, 324)).astype(np.float32)
    logits[rng.random((4, 324)) < 0.7] = sampling.FILTER_VALUE      # filtered out
    logits[3] = sampling.FILTER_VALUE
    got = sampling.num_choices(torch.from_numpy(logits))
    ref = jsampling.num_choices(jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[3].item() == 0
