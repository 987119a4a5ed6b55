"""The port's multitask flash prefill (``flash_encoder_attention``, the
encoder's bidirectional attention and the decoder prefill's causal one)
against the JAX package.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against JAX's Pallas kernel in interpret mode, both variants, at B 2, W 32
and 64, 2 heads, with key padding and a row whose keys are all padding.
``encode`` / ``decoder_prefill`` / ``lm_prefill`` with ``flash=True`` (the
plain version on the CPU) are held against JAX's ``flash=False`` branch on
``small_multitask_config`` (float32) and on the trained demo checkpoint
(bf16), within the tolerances JAX's tests hold its own flash prefill to
(tests/test_multitask.py). The auto rule and the training forward's routing
are checked here; the CUDA kernels against the plain version are in the
``cuda``-marked tests, which skip without a card.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import multitask as jmt
from deepmusicgeneration_tpu.models.config import small_multitask_config as j_small
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference as j_cast
from deepmusicgeneration_tpu.ops import flash_prefill as jfp
from deepmusicgeneration_tpu.train.learner import MultitaskLearner as JLearner
from deepmusicgeneration_tpu_torch.models import multitask as mt
from deepmusicgeneration_tpu_torch.models.config import MultitaskConfig, multitask_config
from deepmusicgeneration_tpu_torch.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu_torch.ops import flash_prefill as tfp
from deepmusicgeneration_tpu_torch.train.checkpoint import multitask_params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_multitask_model")

# plain version vs the Pallas kernel in interpret mode: the same float32
# function with the same bf16 cast points (q + u, q + v, the normalized
# probabilities, the output); only the summation order differs, so an output
# may round to the neighbouring bf16 value: one ulp, at most 2^-7 |ref|
ULP_RTOL, ULP_ATOL = 2.0 ** -7, 1e-6
# JAX's tolerances for its flash prefill against its materialized branch
# (tests/test_multitask.py): outputs and caches, logits
OUT_ATOL = 0.05
LOGITS_TOL = dict(atol=0.15, rtol=0.05)


def _attention_inputs(B, W, H, Dh, causal, seed):
    """bf16-exact numpy q, k, v, wkr, u, v biases and a pad mask: row 0
    padded in part (on the left for the causal variant, the right for the
    bidirectional one), row 1 entirely."""
    rng = np.random.default_rng(seed)
    draw = lambda std, *s: rng.normal(scale=std, size=s).astype(np.float32)
    HD = H * Dh
    arrays = [draw(1.3, B, W, HD), draw(1.3, B, W, HD), draw(1.0, B, W, HD),
              draw(1.3, W, HD), draw(0.5, H, Dh), draw(0.5, H, Dh)]
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in arrays]
    pad = np.zeros((B, W), bool)
    pad[0, :7] = causal
    pad[0, W - 9:] = not causal
    pad[1] = True
    return arrays, pad


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("W", [32, 64])
def test_plain_encoder_attention_matches_pallas_interpret(causal, W):
    B, H, Dh = 2, 2, 32
    arrays, pad = _attention_inputs(B, W, H, Dh, causal, seed=W + causal)
    ref = jfp.flash_encoder_attention(*[jnp.asarray(a, jnp.bfloat16) for a in arrays],
                                      jnp.asarray(pad), H, causal=causal, interpret=True)
    before = dict(tfp.flash_encoder_attention.launches)
    got = tfp.flash_encoder_attention(*[torch.from_numpy(a).bfloat16() for a in arrays],
                                      torch.from_numpy(pad), H, causal=causal)
    assert tfp.flash_encoder_attention.launches == before     # CPU: no kernel launch
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=ULP_RTOL, atol=ULP_ATOL)
    # the fully padded row attends uniformly to every key (the fill is finite)
    np.testing.assert_allclose(got[1], np.broadcast_to(arrays[2][1].mean(0), (W, H * Dh)),
                               rtol=2.0 ** -7, atol=1e-3)


def _models(kind):
    """(JAX config, JAX params, port config, port params)."""
    if kind == "small_f32":
        jcfg = j_small()
        jp = jmt.init_multitask(jax.random.PRNGKey(2), jcfg)
    else:
        jl = JLearner.load(DEMO)
        jcfg, jp = jl.cfg, j_cast(jl.params)
    cfg = MultitaskConfig.from_dict(jcfg.to_dict())
    tp = multitask_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    if cfg.dtype == "bfloat16":
        tp = cast_params_for_inference(tp)
    return jcfg, jp, cfg, tp


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("kind", ["small_f32", "demo_bf16"])
def test_flash_prefills_on_cpu_match_jax(kind):
    """encode, decoder_prefill and lm_prefill with flash=True against JAX's
    flash=False branch: encoder windows padded on the right, decoder ones
    on the left, W = 64."""
    jcfg, jp, cfg, tp = _models(kind)
    rng = np.random.default_rng(3)
    B, W = 2, 64
    t, j = torch.from_numpy, jnp.asarray
    xe = rng.integers(5, 300, (B, W)).astype(np.int32)
    pe = np.cumsum(rng.integers(0, 3, (B, W)), 1).astype(np.int32)
    enc_pad = np.zeros((B, W), bool)
    enc_pad[1, W - 20:] = True
    xe[enc_pad] = 1
    j_enc = jmt.encode(jp, jcfg, j(xe), j(pe), pad_cols=j(enc_pad), flash=False)
    t_enc = mt.encode(tp, cfg, t(xe), t(pe), pad_cols=t(enc_pad), flash=True)
    np.testing.assert_allclose(_f32(t_enc), np.asarray(j_enc, np.float32), atol=OUT_ATOL, rtol=0)

    xd = rng.integers(5, 300, (B, W)).astype(np.int32)
    pd = np.cumsum(rng.integers(0, 3, (B, W)), 1).astype(np.int32)
    dec_pad = np.zeros((B, W), bool)
    dec_pad[0, :17] = True
    xd[dec_pad] = 1
    enc = t(np.array(j_enc, np.float32)).to(cfg.act_dtype)       # the same encoder output
    for name, jargs, targs, kw in (
            ("decoder_prefill", (j_enc,), (enc,), dict(enc_pad=enc_pad)),
            ("lm_prefill", (), (), {})):
        j_logits, j_cache = getattr(jmt, name)(jp, jcfg, j(xd), j(pd), j(dec_pad), *jargs,
                                               flash=False, **{k: j(a) for k, a in kw.items()})
        t_logits, t_cache = getattr(mt, name)(tp, cfg, t(xd), t(pd), t(dec_pad), *targs,
                                              flash=True, **{k: t(a) for k, a in kw.items()})
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **LOGITS_TOL)
        for got, ref in ((t_cache.k, j_cache.k), (t_cache.v, j_cache.v)):
            np.testing.assert_allclose(_f32(got), np.asarray(ref, np.float32), atol=OUT_ATOL,
                                       rtol=0)
        np.testing.assert_array_equal(t_cache.valid.numpy(), np.asarray(j_cache.valid))


def test_flash_rule():
    """JAX's rule with the card in the TPU's place: bf16, B >= 8, W <= 512,
    heads both kernels take; never on the CPU; an explicit choice wins, and
    an explicit True on the card raises where the kernels do not take the
    heads."""
    cfg = multitask_config()                       # bf16, 8 x 64 heads
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert mt._flash_ok(cfg, 16, 512, None, cuda)
    assert mt._flash_ok(cfg, 8, 64, None, cuda)
    assert not mt._flash_ok(cfg, 7, 512, None, cuda)
    assert not mt._flash_ok(cfg, 16, 1024, None, cuda)
    assert not mt._flash_ok(cfg, 16, 512, None, cpu)
    assert not mt._flash_ok(cfg.replace(dtype="float32"), 16, 512, None, cuda)
    narrow = cfg.replace(d_head=16, d_model=128)    # the bidirectional kernel takes 32 or 64
    assert not mt._flash_ok(narrow, 16, 512, None, cuda)
    assert mt._flash_ok(cfg, 1, 2048, True, cuda) and not mt._flash_ok(cfg, 16, 512, False, cuda)
    assert mt._flash_ok(narrow, 16, 512, True, cpu)  # the plain version takes any heads
    with pytest.raises(ValueError, match="d_head=16"):
        mt._flash_ok(narrow, 16, 512, True, cuda)


def test_training_forward_never_takes_the_flash_prefill():
    """forward passes flash=False to every stack, as JAX's does, even where
    the auto rule would take the kernels (made to say yes here)."""
    cfg = MultitaskConfig(vocab_size=324, enc_layers=1, dec_layers=1, d_model=64,
                          d_inner=128, n_heads=2, d_head=32, ctx_len=32, mem_len=32,
                          dtype="float32")
    params = mt.init_multitask(cfg, torch.Generator().manual_seed(0))
    B, W = 2, 16
    g = torch.Generator().manual_seed(1)
    toks = lambda: torch.randint(5, 300, (B, W), generator=g)
    inp = {"msk": {"x": toks()}, "lm": {"x": toks()},
           "s2f": {"enc": toks(), "dec": toks()}}
    calls = []
    orig = mt.stack_forward

    def spy(*a, **kw):
        calls.append(kw.get("flash"))
        return orig(*a, **kw)

    auto_yes = lambda cfg, B, W, flash, device: True if flash is None else flash
    with mock.patch.object(mt, "_flash_ok", auto_yes), \
            mock.patch.object(mt, "stack_forward", spy), \
            mock.patch.object(mt, "_flash_self_attn", side_effect=AssertionError("flash")):
        out = mt.forward(params, cfg, inp)
    assert set(out) == {"msk", "lm", "s2f"}
    assert calls == [False] * 4
