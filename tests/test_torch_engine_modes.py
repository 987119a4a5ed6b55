"""The genre engine's explicit decode modes against the JAX package.

``txl.quantize_ring`` must be bit-identical to JAX's and
``decode_step_ring_q`` (the exact step over an int8 ring, ``kv_int8`` on
``xla``) must give JAX's logits. Then ``GenerationEngine.generate_batch``
with ``decode_kernel`` in ``slab_int8``, ``slab4``, ``slab4_w8``,
``multirow``, ``multirow_int8``, ``slab_int8`` at 4 rows a cell, and
``xla`` with ``kv_int8`` must give the greedy tokens of JAX's
``generate_compiled`` with the same settings, its Pallas kernels patched to
interpret mode (the JAX engine runs them only on a TPU); the port runs the
kernels' plain versions on the CPU. The config is a narrow bf16 one (2
layers, d 64, 2 x 32 heads, mem_len 64) so that each JAX compile stays
short; ``xla`` with ``kv_int8`` runs it at float32.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.codec.grammar import allowed_ins_mask
from deepmusicgeneration_tpu.codec.index import position_enc
from deepmusicgeneration_tpu.decode import engine as je
from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import TXLConfig as JConfig
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu.ops import fused_decode as jfd
from deepmusicgeneration_tpu.train.synthcorpus import GENRE_STYLES, generate_song
from deepmusicgeneration_tpu.vocab import MusicVocab as JVocab
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.decode import engine as te
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import TXLConfig
from deepmusicgeneration_tpu_torch.ops import fused_decode
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(vocab_size=324, n_layers=2, d_model=64, d_inner=128, n_heads=2,
              d_head=32, ctx_len=64, mem_len=64, dtype="bfloat16", bias=False)
B, N_WORDS = 8, 8
# decode_step_ring_q's logits against JAX's: the same bf16 / float32 steps
# in another summation order; a bf16 rounding flip moves a logit by ~1e-3
LOGITS_ATOL = 2e-2
# the written int8 slots: one int8 step is 1/127 of the row's largest entry
# while a bf16 ulp is 2^-8 of an entry, so where XLA (which may keep bf16
# intermediates in float32) and torch round k1 / v1 to different bf16
# neighbours the int8 value may move one step: measured 13 of 1152 entries
# at bf16, none at float32. At most this share of them
SLOT_FLIP_SHARE = {"bfloat16": 0.03, "float32": 0.005}


def _models(dtype):
    jcfg, cfg = JConfig(**{**NARROW, "dtype": dtype}), TXLConfig(**{**NARROW, "dtype": dtype})
    jp = jtxl.init_txl(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def setup():
    return _models("bfloat16")


def test_quantize_ring_bit_identical():
    rng = np.random.default_rng(3)
    k = rng.normal(scale=0.6, size=(2, 3, 2, 16, 32)).astype(np.float32)
    v = rng.normal(scale=0.3, size=(2, 3, 2, 16, 32)).astype(np.float32)
    k[1, 0, 1, 4] = 0.0                  # an all-zero (slot, head) row: 1e-8 floor
    g = np.zeros((3, 16), np.int32)
    ref = jtxl.quantize_ring(jtxl.RingKVCache(
        k=jnp.asarray(k, jnp.bfloat16), v=jnp.asarray(v, jnp.bfloat16), g=jnp.asarray(g),
        ptr=jnp.int32(0), g_cur=jnp.int32(0)))
    got = txl.quantize_ring(txl.RingKVCache(
        k=torch.from_numpy(k).bfloat16(), v=torch.from_numpy(v).bfloat16(),
        g=torch.from_numpy(g), ptr=0, g_cur=0))
    for name in ("k_q", "k_s", "v_q", "v_s"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert got.k_s[1, 0, 1, 4, 0].item() == np.float32(1e-8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_step_ring_q_matches_jax(dtype):
    """Three steps over a partly full int8 ring: logits within LOGITS_ATOL,
    the written int8 slots equal to JAX's but for half-point flips."""
    jcfg, cfg = JConfig(**{**NARROW, "dtype": dtype}), TXLConfig(**{**NARROW, "dtype": dtype})
    jp = jtxl.init_txl(jax.random.PRNGKey(0), jcfg)
    if dtype == "bfloat16":
        jp = cast_params_for_inference(jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    L, H, Dh, M, Bq = 2, 2, 32, 64, 3
    rng = np.random.default_rng(8)
    k = rng.normal(scale=0.5, size=(L, Bq, H, M, Dh)).astype(np.float32)
    v = rng.normal(scale=0.5, size=(L, Bq, H, M, Dh)).astype(np.float32)
    g = np.where(np.arange(M) < 40, jtxl.PAD_G, np.arange(M) - M).astype(np.int32)
    g = np.broadcast_to(g, (Bq, M)).copy()
    jc = jtxl.quantize_ring(jtxl.RingKVCache(
        k=jnp.asarray(k, jnp.bfloat16), v=jnp.asarray(v, jnp.bfloat16), g=jnp.asarray(g),
        ptr=jnp.int32(0), g_cur=jnp.int32(0)))
    tc = txl.quantize_ring(txl.RingKVCache(
        k=torch.from_numpy(k).bfloat16(), v=torch.from_numpy(v).bfloat16(),
        g=torch.from_numpy(g), ptr=0, g_cur=0))
    jw, tw = jtxl.precompute_wkr(jp, jcfg, M), txl.precompute_wkr(tp, cfg, M)
    for step in range(3):
        toks = rng.integers(12, 140, Bq)
        jl, jc = jtxl.decode_step_ring_q(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                         jnp.zeros(Bq, jnp.int32), jc, jw)
        tl, tc = txl.decode_step_ring_q(tp, cfg, torch.from_numpy(toks),
                                        torch.zeros(Bq, dtype=torch.int32), tc, tw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
        assert tc.ptr == int(jc.ptr) == step + 1
    for name in ("k_q", "v_q"):
        got = getattr(tc, name).numpy().astype(np.int32)
        ref = np.asarray(getattr(jc, name)).astype(np.int32)
        np.testing.assert_array_equal(got[:, :, :, 3:], ref[:, :, :, 3:])   # untouched
        d = np.abs(got[:, :, :, :3] - ref[:, :, :, :3])
        assert d.max() <= 1 and (d > 0).mean() <= SLOT_FLIP_SHARE[dtype], \
            (d.max(), (d > 0).sum())
    np.testing.assert_array_equal(tc.g.numpy(), np.asarray(jc.g))


def _prompts(vocab, n, seed=40):
    genres = list(GENRE_STYLES)
    return [MusicItem.from_npenc(generate_song(genres[i % len(genres)], seed + i),
                                 vocab).data[:30 + 10 * i] for i in range(n)]


# (port decode_kernel, rows_per_cell or None, kv_int8) -> JAX SamplerSettings
# fields, as the JAX engine maps them (decode/engine.py:642-656)
CASES = {
    ("slab_int8", None, False): dict(fused=True, slab=True, score_mode="int8"),
    ("slab_int8", 4, False): dict(fused=True, slab=True, score_mode="int8"),
    ("slab4", None, False): dict(fused=True, slab=True, kv_int4=True),
    ("slab4_w8", None, False): dict(fused=True, slab=True, kv_int4=True,
                                    weights_int8=True),
    ("multirow", None, False): dict(fused=True),
    ("multirow_int8", None, False): dict(fused=True, kv_int8=True),
    # on a float32 model, as the exact path's parity test does
    # (tests/test_torch_engine.py): at bf16, XLA may keep the exact step's
    # intermediates in float32 where torch rounds them, and a near-tie can
    # then go the other way, int8 ring or not
    ("xla", None, True): dict(kv_int8=True),
}


def _jax_tokens(jp, jcfg, prompts, fields, rpc):
    """JAX generate_compiled's greedy tokens, the fused kernels in interpret
    mode."""
    jvocab = JVocab.create()
    M, W = jcfg.mem_len, 64
    toks = np.full((B, W), jvocab.pad_idx, np.int32)
    pad = np.ones((B, W), bool)
    pos = np.zeros((B, W), np.int32)
    last = np.zeros(B, np.int32)
    for i, s in enumerate(prompts):   # the engine's packing: the last W tokens
        s = np.asarray(s)[-W:]
        p = position_enc(s, jvocab)
        toks[i, W - len(s):], pad[i, W - len(s):] = s, False
        pos[i, W - len(s):], last[i] = p, p[-1]
    jeng = je.GenerationEngine(jp, jcfg, jvocab)
    settings = je.SamplerSettings(n_words=N_WORDS, top_k=30, greedy=True,
                                  rows_per_cell=rpc, **fields)
    interp = lambda f: lambda *a, **k: f(*a, **{**k, "interpret": True})
    # a jit of its own, so that the patched kernels are traced
    gen = jax.jit(je.generate_compiled.__wrapped__,
                  static_argnames=("cfg", "settings", "window", "mem_len"))
    with mock.patch.object(jfd, "fused_slab_core", interp(jfd.fused_slab_core)), \
         mock.patch.object(jfd, "fused_multirow_core", interp(jfd.fused_multirow_core)), \
         mock.patch.object(jfd, "fused_multirow_q_core", interp(jfd.fused_multirow_q_core)):
        out, lengths = gen(
            jeng.params, jcfg, jnp.asarray(toks), jnp.asarray(pad), jnp.asarray(pos),
            jnp.asarray(last), jeng.tables("genre"), jnp.ones(3, jnp.float32),
            jnp.float32(0.6), jnp.int32(4), jnp.asarray(allowed_ins_mask(jvocab, None)),
            jax.random.PRNGKey(0), settings, window=W, mem_len=M,
            stacked=(None if not settings.fused else jeng.stacked_q()
                     if settings.weights_int8 else jeng.stacked()))
    return np.asarray(out), np.asarray(lengths)


@pytest.mark.parametrize("kernel,rows,kv_int8", list(CASES),
                         ids=[f"{k}-r{r}-kv{int(q)}" for k, r, q in CASES])
def test_explicit_mode_greedy_matches_jax(setup, kernel, rows, kv_int8):
    jcfg, cfg, jp, tp = _models("float32") if kernel == "xla" else setup
    vocab = MusicVocab.create()
    prompts = _prompts(vocab, B)
    ref, ref_len = _jax_tokens(jp, jcfg, prompts, CASES[(kernel, rows, kv_int8)],
                               rows or 8)
    learner = MusicLearner(cfg, vocab, tp, device="cpu")
    got, got_len = learner.engine.generate_batch(
        prompts, n_words=N_WORDS, greedy=True, decode_kernel=kernel,
        rows_per_cell=rows, kv_int8=kv_int8)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_len, ref_len)
    for core in (fused_decode.fused_slab_core, fused_decode.fused_multirow_core,
                 fused_decode.fused_multirow_q_core):
        assert sum(core.launches.values()) == 0          # CPU: the plain versions


@pytest.fixture(scope="module")
def demo():
    return MusicLearner.load(os.path.join(ROOT, "checkpoints", "demo_genre_model"),
                             device="cpu")


@pytest.fixture(scope="module")
def narrow(setup):
    """The narrow bf16 model's port learner on the CPU."""
    _, cfg, _, tp = setup
    return MusicLearner(cfg, MusicVocab.create(), tp, device="cpu")


@pytest.mark.parametrize("kernel", te.KERNELS)
def test_every_kernel_name_runs_on_the_cpu(narrow, kernel):
    """All ten of the JAX engine's names run through ``generate_batch`` (the
    kernels' plain versions); two copies of a prompt decode alike."""
    prompt = _prompts(narrow.vocab, 1, seed=9)[0]
    toks, lengths = narrow.engine.generate_batch([prompt, prompt], n_words=4,
                                                 greedy=True, decode_kernel=kernel)
    assert toks.shape == (2, 4) and (lengths > 0).all()
    np.testing.assert_array_equal(toks[0], toks[1])


def test_kernel_rules(demo):
    """The JAX engine's alignment per kernel, read for the port; the auto
    rule does not change; rows_per_cell must divide B; ``generate`` takes
    the same arguments."""
    cfg = demo.cfg
    assert te.slab_ok(cfg, 80, "multirow") and not te.slab_ok(cfg, 80, "multirow_int8")
    assert te.slab_ok(cfg, 96, "slab_int8") and not te.slab_ok(cfg, 96, "slab4")
    assert te.slab_ok(cfg, 128, "slab4_w8") and not te.slab_ok(cfg, 80)
    f32 = TXLConfig(**{**NARROW, "dtype": "float32"})
    assert not te.slab_ok(f32, 64, "multirow")
    engine = demo.engine
    assert engine.resolve_kernel(8) == "xla"                 # the CPU
    prompt = _prompts(demo.vocab, 1)[0]
    with pytest.raises(ValueError, match="rows_per_cell"):
        engine.generate_batch([prompt] * 3, n_words=2, decode_kernel="slab_int8",
                              rows_per_cell=2)
    with pytest.raises(ValueError, match="mem_len % 64"):
        engine.generate_batch([prompt], n_words=2, decode_kernel="slab4", mem_len=96)
    with pytest.raises(ValueError, match="decode_kernel"):
        engine.generate_batch([prompt], n_words=2, decode_kernel="fused")
    toks, _ = engine.generate_batch([prompt], n_words=3, greedy=True,
                                    decode_kernel="multirow", mem_len=80)
    assert toks.shape == (1, 3)
    # generate passes the mode's arguments through to generate_batch
    kw = dict(n_words=3, greedy=True, decode_kernel="slab_int8", rows_per_cell=1)
    one = engine.generate(prompt, **kw)
    toks, lengths = engine.generate_batch([prompt], **kw)
    np.testing.assert_array_equal(one, toks[0][: lengths[0]])
