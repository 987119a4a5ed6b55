"""The port's batched path on the CPU: the engine's kernel choice, the
``slab_ar_w8`` + flash-prefill generation against the JAX package, and the
static coalescing ``GenerationService``.

The JAX side runs ``generate_compiled`` with the all-rows int8 decode and
the flash prefill, both Pallas kernels patched to interpret mode (the JAX
engine never picks them off the TPU); the port runs the plain versions of
its two kernels. Greedy tokens must be identical.
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
from deepmusicgeneration_tpu.ops import flash_prefill as jfp
from deepmusicgeneration_tpu.ops import fused_decode as jfd
from deepmusicgeneration_tpu.train.synthcorpus import GENRE_STYLES, generate_song
from deepmusicgeneration_tpu.vocab import MusicVocab as JVocab
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import TXLConfig
from deepmusicgeneration_tpu_torch.ops import flash_prefill, fused_decode
from deepmusicgeneration_tpu_torch.tasks.serve import GenerationService
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_genre_model")


@pytest.fixture(scope="module")
def vocab():
    return MusicVocab.create()


def _prompts(vocab, n, seed=40):
    genres = list(GENRE_STYLES)
    return [MusicItem.from_npenc(generate_song(genres[i % len(genres)], seed + i),
                                 vocab).data[:60 + 20 * i] for i in range(n)]


def test_resolve_kernel_batched_policy():
    learner = MusicLearner.load(DEMO, device="cpu")
    engine = learner.engine
    assert [engine.resolve_kernel(b) for b in (1, 8, 12, 16)] == ["xla"] * 4
    engine.device = torch.device("cuda")                # the rule on a card
    picks = {b: engine.resolve_kernel(b) for b in (1, 4, 8, 12, 16, 64)}
    assert picks == {1: "slab_w8", 4: "slab_w8", 8: "slab_ar_w8", 12: "xla",
                     16: "slab_ar_w8", 64: "slab_ar_w8"}
    assert engine.resolve_kernel(16, mem_len=100) == "xla"   # not 32-aligned


def test_slab_ar_w8_generation_matches_jax(vocab):
    """B = 8, 8 greedy steps on the bf16 setup config of
    tests/test_fused_decode.py: the port's generate_batch with
    decode_kernel='slab_ar_w8' and the flash prefill gives the tokens of JAX
    generate_compiled with settings fused/slab/allrows/weights_int8 and
    flash_prefill=True."""
    kw = dict(vocab_size=324, n_layers=2, d_model=128, d_inner=256, n_heads=2,
              d_head=64, ctx_len=128, mem_len=128, dtype="bfloat16", bias=False)
    jcfg, cfg = JConfig(**kw), TXLConfig(**kw)
    jp = jtxl.init_txl(jax.random.PRNGKey(0), jcfg)
    jvocab = JVocab.create()
    prompts = _prompts(vocab, 8)
    B, M, W = 8, jcfg.mem_len, 128
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
    settings = je.SamplerSettings(n_words=8, top_k=30, greedy=True, fused=True,
                                  slab=True, allrows=True, weights_int8=True,
                                  rows_per_cell=8, flash_prefill=True)
    interp = lambda f: lambda *a, **k: f(*a, **{**k, "interpret": True})
    # a jit of its own, so the patched kernels are traced
    gen = jax.jit(je.generate_compiled.__wrapped__,
                  static_argnames=("cfg", "settings", "window", "mem_len"))
    with mock.patch.object(jfd, "fused_slab_allrows_core",
                           interp(jfd.fused_slab_allrows_core)), \
         mock.patch.object(jfp, "flash_prefill_attention",
                           interp(jfp.flash_prefill_attention)):
        ref, ref_len = gen(
            jeng.params, jcfg, jnp.asarray(toks), jnp.asarray(pad), jnp.asarray(pos),
            jnp.asarray(last), jeng.tables("genre"), jnp.ones(3, jnp.float32),
            jnp.float32(0.6), jnp.int32(4), jnp.asarray(allowed_ins_mask(jvocab, None)),
            jax.random.PRNGKey(0), settings, window=W, mem_len=M,
            stacked=jeng.stacked_q())
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    learner = MusicLearner(cfg, vocab, tp, device="cpu")
    # the CPU never auto-picks the flash prefill: substitute the card's rule
    with mock.patch.object(txl, "_flash_auto", lambda cfg, x: True):
        got, got_len = learner.engine.generate_batch(
            prompts, n_words=8, greedy=True, decode_kernel="slab_ar_w8")
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got_len, np.asarray(ref_len))
    assert fused_decode.fused_slab_allrows_core.launches["slab_ar_w8"] == 0   # CPU: plain
    assert flash_prefill.flash_prefill_attention.launches == 0


@pytest.fixture(scope="module")
def learner():
    return MusicLearner.load(DEMO, device="cpu")


@pytest.mark.parametrize("n,rows", [(5, 8), (3, 4)])
def test_service_coalesces_and_matches_generate_batch(learner, vocab, n, rows):
    """n concurrent requests ride one batch of the next power of two rows;
    each result is that row of a direct generate_batch of the padded batch."""
    prompts = _prompts(vocab, n, seed=7)
    service = GenerationService(learner, max_batch=16, max_wait_s=0.5)
    try:
        futs = [service.submit(p, n_words=12, temperatures=(1.2, 1.2, 1.0),
                               seed=3) for p in prompts]
        results = [f.result(timeout=120) for f in futs]
    finally:
        service.close()
    assert service.batch_sizes == [(n, rows)]
    padded = prompts + [prompts[0]] * (rows - n)
    toks, lengths = learner.engine.generate_batch(
        padded, n_words=12, temperatures=(1.2, 1.2, 1.0), seed=3)
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res, toks[i][: lengths[i]])


def test_service_close_joins_the_worker(learner):
    service = GenerationService(learner)
    service.close()
    assert not service._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        service.submit(np.arange(4))
