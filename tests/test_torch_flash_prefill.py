"""The port's flash prefill attention and ``txl.prefill(flash=True)`` against
the JAX package.

The plain PyTorch version of ``flash_prefill_attention`` (what the wrapper
runs for CPU tensors) is held against JAX ``flash_prefill_attention`` in
Pallas interpret mode: the whole-window kernel at W = 128 and W = 96 (not a
multiple of the CUDA kernel's 64-row tile) and the row-blocked kernel
(``block_rows=128``) at W = 512, with left-padded rows.
The whole prefill is held against JAX ``txl.prefill(flash=True)`` with the
kernel patched to interpret mode, as ``tests/test_fused_decode.py`` does.
The CUDA kernel itself is held against the plain version in the
``cuda``-marked tests.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import TXLConfig as JConfig
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu.ops import flash_prefill as jfp
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import TXLConfig
from deepmusicgeneration_tpu_torch.ops import flash_prefill as tfp
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy

# Same function, other summation order. In float32 both sides keep f32
# probabilities: the bound of test_blocked_prefill_matches_whole_kernel. In
# bf16 both round the probabilities to bf16 before P.V and the output to
# bf16; a sum on the other side of a rounding point moves an output of
# magnitude < 2 by one bf16 step (2^-7 at most): 2e-2 covers that.
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,block_rows", [(128, 0), (512, 128), (96, 0)],
                         ids=["whole", "blocked", "tail"])
def test_plain_matches_pallas_interpret(W, block_rows, dtype):
    B, H, Dh = 2, 2, 64
    HD = H * Dh
    rng = np.random.default_rng(W + len(dtype))
    r = lambda *s: rng.normal(scale=0.4, size=s).astype(np.float32)
    q, k, v, wkr, u, vb = r(B, W, HD), r(B, W, HD), r(B, W, HD), r(W, HD), r(H, Dh), r(H, Dh)
    pad = np.zeros((B, W), bool)
    pad[0, :33] = True
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jfp.flash_prefill_attention(
        *[jnp.asarray(a, jdt) for a in (q, k, v, wkr, u, vb)], jnp.asarray(pad), H,
        interpret=True, block_rows=block_rows)
    got = tfp.flash_prefill_attention(
        *[torch.from_numpy(a).to(tdt) for a in (q, k, v, wkr, u, vb)],
        torch.from_numpy(pad), H, block_rows=block_rows)
    assert got.dtype == tdt and got.shape == (B, W, HD)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    keep = ~pad
    np.testing.assert_allclose(got[keep], ref[keep], atol=ATOL[dtype], rtol=0)
    assert np.isfinite(got).all()
    assert tfp.flash_prefill_attention.launches == 0   # CPU: no kernel launch


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=324, n_layers=2, d_model=128, d_inner=256, n_heads=2,
              d_head=64, ctx_len=128, mem_len=128, dtype="bfloat16", bias=False)
    jcfg, cfg = JConfig(**kw), TXLConfig(**kw)
    jp = cast_params_for_inference(jtxl.init_txl(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, tp


def test_prefill_flash_matches_jax(setup):
    """txl.prefill(flash=True) on the bf16 setup config at B = 4 with two
    left-padded rows, with JAX's own bounds for its flash prefill against
    the materialized one (tests/test_fused_decode.py)."""
    jcfg, cfg, jp, tp = setup
    B, W = 4, cfg.ctx_len
    rng = np.random.default_rng(3)
    toks = rng.integers(12, 140, (B, W))
    pad = np.zeros((B, W), bool)
    pad[0, :17] = True
    pad[1, :5] = True
    toks = np.where(pad, 1, toks)

    orig = jfp.flash_prefill_attention

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch.object(jfp, "flash_prefill_attention", interp):
        ref_logits, ref_cache = jtxl.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                             jnp.asarray(pad), flash=True)
    got_logits, got_cache = txl.prefill(tp, cfg, torch.from_numpy(toks),
                                        torch.from_numpy(pad), flash=True)
    ref_logits, got_logits = np.asarray(ref_logits), got_logits.numpy()
    np.testing.assert_allclose(got_logits, ref_logits, atol=0.15, rtol=0.05)
    assert (got_logits.argmax(-1) == ref_logits.argmax(-1)).all()
    valid = ~pad[:, -cfg.mem_len:]
    for g, r in ((got_cache.k, ref_cache.k), (got_cache.v, ref_cache.v)):
        g = g.float().numpy()[:, valid]
        r = np.asarray(r.astype(jnp.float32))[:, valid]
        np.testing.assert_allclose(g, r, atol=0.05)
    np.testing.assert_array_equal(got_cache.valid.numpy(), np.asarray(ref_cache.valid))


def test_flash_is_never_auto_on_the_cpu(setup):
    _, cfg, _, tp = setup
    for B, W in ((8, 128), (2, 4096)):
        assert not txl._flash_auto(cfg, torch.zeros((B, W), dtype=torch.long))
    toks = torch.randint(12, 140, (8, 128))
    pad = torch.zeros((8, 128), dtype=torch.bool)
    auto = txl.prefill(tp, cfg, toks, pad)
    plain = txl.prefill(tp, cfg, toks, pad, flash=False)
    assert torch.equal(auto[0], plain[0])


def test_wrapper_checks_its_arguments():
    q = torch.zeros((2, 128, 128), dtype=torch.bfloat16)
    wkr = torch.zeros((128, 128), dtype=torch.bfloat16)
    u = torch.zeros((2, 64), dtype=torch.bfloat16)
    pad = torch.zeros((2, 128), dtype=torch.bool)
    with pytest.raises(ValueError, match="block_rows"):
        tfp.flash_prefill_attention(q, q, q, wkr, u, u, pad, 2, block_rows=96)
    with pytest.raises(ValueError, match="wkr"):
        tfp.flash_prefill_attention(q, q, q, wkr[:64], u, u, pad, 2)
    with pytest.raises(ValueError, match="u_bias"):
        tfp.flash_prefill_attention(q, q, q, wkr, u[:1], u, pad, 2)
