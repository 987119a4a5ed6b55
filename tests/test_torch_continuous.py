"""The port's continuous-batching engine (``decode/continuous.py``).

Against the JAX package's ``ContinuousEngine`` on the same weights: greedy
tokens are identical on the exact ``xla`` path (a float32 model) and on the
``slab`` path (the bf16 setup config of ``tests/test_continuous.py``; JAX
runs its Pallas kernel in interpret mode, the port the kernel's plain
version), with prompts of different lengths joining mid-flight.

Inside the port, mirroring ``tests/test_continuous.py``: a request that
joins a busy batch emits exactly what it emits alone (greedy and sampled,
on ``xla`` and ``slab``), per-row settings hold, and the service streams
mixed requests and recovers from a failed step. Everything runs on the CPU.
"""

from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.decode import continuous as jc
from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import TXLConfig as JConfig
from deepmusicgeneration_tpu.models.config import small_test_config as j_small
from deepmusicgeneration_tpu.ops import sampling as jsampling
from deepmusicgeneration_tpu.train.synthcorpus import GENRE_STYLES, generate_song
from deepmusicgeneration_tpu.vocab import MusicVocab as JVocab
from deepmusicgeneration_tpu_torch.codec.grammar import grammar_violations
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.decode import engine as te
from deepmusicgeneration_tpu_torch.decode.continuous import (
    ContinuousEngine, ContinuousGenerationService)
from deepmusicgeneration_tpu_torch.models.config import TXLConfig, small_test_config
from deepmusicgeneration_tpu_torch.ops import fused_decode, sampling
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

SLAB_KW = dict(vocab_size=324, n_layers=2, d_model=128, d_inner=256, n_heads=2,
               d_head=64, ctx_len=128, mem_len=128, dtype="bfloat16", bias=False)


@pytest.fixture(scope="module")
def vocab():
    return MusicVocab.create()


@pytest.fixture(scope="module")
def prompts(vocab):
    genres = list(GENRE_STYLES)
    return [MusicItem.from_npenc(generate_song(genres[i], 30 + i), vocab)
            .data[:50 + 37 * i] for i in range(3)]


def _shared(jcfg, cfg, key):
    jp = jtxl.init_txl(jax.random.PRNGKey(key), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)


@pytest.fixture(scope="module")
def exact(vocab):
    """float32 small_test_config weights, JAX's and the port's."""
    return (j_small(), small_test_config(), *_shared(j_small(), small_test_config(), 0))


@pytest.fixture(scope="module")
def slab_setup():
    jcfg, cfg = JConfig(**SLAB_KW), TXLConfig(**SLAB_KW)
    return (jcfg, cfg, *_shared(jcfg, cfg, 0))


def fresh(setup, vocab, **kw):
    _, cfg, _, tp = setup
    kw.setdefault("n_slots", 4)
    kw.setdefault("chunk", 8)
    return ContinuousEngine(tp, cfg, vocab, device="cpu", **kw)


def _staggered(make, prompts, jobs):
    """Decode ``jobs`` ((prompt index, slot, chunks to wait, kwargs), ...)
    on one engine from ``make()``, each inserted after its wait."""
    eng = make()
    futs, waited = [None] * len(jobs), 0
    for i, (p, slot, wait, kw) in enumerate(jobs):
        while waited < wait:
            eng.step_chunk()
            waited += 1
        futs[i] = Future()
        eng.insert(slot, prompts[p], future=futs[i], **kw)
    while not all(f.done() for f in futs):
        eng.step_chunk()
    return [f.result() for f in futs]


JOBS = [(0, 0, 0, dict(n_words=24, greedy=True)),
        (1, 2, 1, dict(n_words=16, greedy=True)),
        (2, 1, 2, dict(n_words=20, greedy=True))]


def test_greedy_tokens_match_jax_xla(exact, vocab, prompts):
    """Three prompts of 50, 87 and 124 tokens join one batch at steps 0, 8
    and 16 (chunk 8) on the exact path: every request's tokens equal JAX's
    ContinuousEngine's on the same float32 weights."""
    jcfg, cfg, jp, tp = exact
    jv = JVocab.create()
    ref = _staggered(lambda: jc.ContinuousEngine(jp, jcfg, jv, n_slots=4, chunk=8,
                                                 decode_kernel="xla"), prompts, JOBS)
    got = _staggered(lambda: fresh(exact, vocab, decode_kernel="xla"), prompts, JOBS)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert all(len(g) > 8 for g in got)


def test_greedy_tokens_match_jax_slab(slab_setup, vocab, prompts):
    """The same joins on the slab path (chunk 4): the port's plain version of
    the slab kernel against JAX's Pallas kernel in interpret mode."""
    jcfg, cfg, jp, tp = slab_setup
    jv = JVocab.create()
    jobs = [(p, slot, wait, dict(kw, n_words=kw["n_words"] // 2))
            for p, slot, wait, kw in JOBS]
    ref = _staggered(lambda: jc.ContinuousEngine(jp, jcfg, jv, n_slots=4, chunk=4,
                                                 decode_kernel="slab", interpret=True),
                     prompts, jobs)
    got = _staggered(lambda: fresh(slab_setup, vocab, chunk=4, decode_kernel="slab"),
                     prompts, jobs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert sum(fused_decode.fused_slab_core.launches.values()) == 0   # CPU: plain


def test_solo_greedy_matches_static_engine(exact, vocab, prompts):
    """One resident row == the static engine's xla path, token for token."""
    _, cfg, _, tp = exact
    want = te.GenerationEngine(tp, cfg, vocab, device="cpu").generate(
        prompts[0], n_words=32, greedy=True, decode_kernel="xla")
    got = fresh(exact, vocab).generate(prompts[0], n_words=32, greedy=True)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("kernel", ["xla", "slab"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_midflight_join_is_bit_identical(slab_setup, vocab, prompts, kernel, greedy):
    """A row grafted into a busy batch (ptr != 0, g_cur != 0) decodes
    exactly as it does alone on the same kernel: the ring rotation and clock
    rebase are lossless, and a sampled row's draws depend on its own seed and
    step only."""
    kw = dict(greedy=greedy, temperatures=(1.5, 1.5, 1.2))
    make = lambda: fresh(slab_setup, vocab, chunk=4, decode_kernel=kernel)
    solo_a = make().generate(prompts[0], n_words=14, seed=5, **kw)
    solo_b = make().generate(prompts[1], n_words=10, seed=6, **kw)
    a, b = _staggered(make, prompts, [(0, 0, 0, dict(n_words=14, seed=5, **kw)),
                                      (1, 3, 2, dict(n_words=10, seed=6, **kw))])
    np.testing.assert_array_equal(solo_a, a)
    np.testing.assert_array_equal(solo_b, b)


def test_sampled_reproducible_across_batch_compositions(exact, vocab, prompts):
    """A request's sampled stream depends only on its own seed, whichever
    rows share the batch; another seed gives another stream."""
    kw = dict(n_words=40, seed=7, temperatures=(1.5, 1.5, 1.5))
    solo = fresh(exact, vocab).generate(prompts[0], **kw)
    got = _staggered(lambda: fresh(exact, vocab), prompts,
                     [(1, 2, 0, dict(n_words=64, seed=3)), (0, 0, 1, kw)])[1]
    np.testing.assert_array_equal(solo, got)
    other = fresh(exact, vocab).generate(prompts[0], **dict(kw, seed=8))
    assert not (len(other) == len(solo) and np.array_equal(other, solo))


def test_per_row_settings_respected(exact, vocab, prompts):
    """Rows with different settings share one batch: the instrument
    whitelist applies to its own row, the grammar holds everywhere."""
    out_a, out_b = _staggered(lambda: fresh(exact, vocab), prompts, [
        (0, 0, 0, dict(n_words=96, temperatures=(2.0, 2.0, 2.0), allowed_ins=["Bass"],
                       seed=3)),
        (1, 1, 0, dict(n_words=96, temperatures=(1.0, 1.0), top_p=0.9, min_bars=2,
                       seed=4))])
    for out, p in ((out_a, prompts[0]), (out_b, prompts[1])):
        assert len(out) > 0
        assert grammar_violations(out, vocab, prev_idx=int(p[-1])) == 0
    ilo, ihi = vocab.ins_range
    ins = out_a[(out_a >= ilo) & (out_a < ihi)]
    assert len(ins) > 0 and (ins == ilo + 2).all()   # Bass == i2 only


def test_per_row_top_k_matches_static_filter():
    """The per-row filter keeps exactly the static filter's set for every
    row's own k and p (ties at the k-th value survive), and equals JAX's
    per-row ``_filter_sorted`` on the same inputs."""
    rng = np.random.default_rng(0)
    B, V = 5, 64
    logits = rng.normal(size=(B, V)).astype(np.float32)
    logits[:, :7] = logits[:, 7:8]                  # ties at the threshold
    ks = np.array([0, 3, 7, 30, 64], np.int32)
    ps = np.array([0.8, 0.0, 0.5, 0.9, 0.3], np.float32)
    tl = torch.from_numpy(logits)
    got = sampling._filter_sorted(tl, torch.from_numpy(ks), torch.from_numpy(ps))
    ref = jsampling._filter_sorted(jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(ps))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    idx, nc = sampling.filter_sample_sorted_rows(
        torch.zeros(B, dtype=torch.long), torch.zeros(B, dtype=torch.long), tl,
        torch.from_numpy(ks), torch.from_numpy(ps), torch.ones(B, dtype=torch.bool))
    for i in range(B):
        one, n_one = sampling.filter_sample_sorted(None, tl[i:i + 1], int(ks[i]),
                                                   float(ps[i]), greedy=True)
        assert int(idx[i]) == int(one[0]) and int(nc[i]) == int(n_one[0])


def test_row_streams_depend_on_seed_and_step_only():
    """A row's uniforms are a function of its (seed, step): the same in any
    batch, different for another seed or step, and spread over (0, 1)."""
    keys = sampling.row_keys([3, 11, 3, 2 ** 40 + 3, 2 ** 63 - 1])
    steps = torch.tensor([0, 4, 1, 0, 9])
    u = sampling.row_uniforms(keys, steps, 324)
    for b in range(5):
        assert torch.equal(u[b], sampling.row_uniforms(keys[b:b + 1], steps[b:b + 1], 324)[0])
    assert not torch.equal(u[0], u[2]) and not torch.equal(u[0], u[3])
    assert 0.0 < u.min() and u.max() < 1.0 and abs(u.mean().item() - 0.5) < 0.03


def test_per_row_shapes_keep_the_static_results(exact, vocab):
    """prepare_logits and advance_state with per-row (B, 3) temperatures,
    (B,) min_bars, a (B, V) mask and a (B,) flag give the results of the
    static engine's (3,), scalar, (V,) and bool arguments bit for bit."""
    rng = np.random.default_rng(2)
    B, V = 4, len(vocab.itos)
    tables = te.build_tables(vocab)
    st = te.SampleState(
        prev_tok=torch.tensor([vocab.sep_idx, 5, vocab.dur_range[0] + 3, vocab.bos_idx],
                              dtype=torch.int32),
        last_pos=torch.tensor([96, 130, 64, 200], dtype=torch.int32),
        start_pos=torch.tensor([0, 64, 64, 0], dtype=torch.int32),
        last_xxsep=torch.tensor([False, True, False, False]),
        repeat_count=torch.tensor([0, 3, 7, 1], dtype=torch.int32),
        done=torch.tensor([False, False, True, False]),
        n_emitted=torch.tensor([3, 0, 9, 1], dtype=torch.int32))
    logits = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32))
    temps = torch.tensor([1.3, 0.7, 1.9])
    ins = torch.from_numpy(rng.random(V) > 0.2)
    ref = te.prepare_logits(logits, st, tables, temps, 1, ins)
    got = te.prepare_logits(logits, st, tables, temps.expand(B, 3).contiguous(),
                            torch.ones(B, dtype=torch.int32), ins.expand(B, V))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    idx = torch.tensor([vocab.dur_range[0] + 8, 7, 9, vocab.bos_idx])
    nc = torch.tensor([1, 5, 2, 30])
    for flag in (False, True):
        ref = te.advance_state(idx, nc, st, got[1], tables, flag)
        out = te.advance_state(idx, nc, st, got[1], tables, torch.full((B,), flag))
        assert torch.equal(ref[0], out[0])
        assert all(torch.equal(a, b) for a, b in zip(ref[1], out[1]))


def test_budget_not_chunk_aligned(exact, vocab, prompts):
    """A 20-token budget with chunk 8 finishes mid-chunk and trims pads."""
    out = fresh(exact, vocab).generate(prompts[0], n_words=20,
                                       temperatures=(2.0, 2.0, 2.0), seed=1)
    assert 0 < len(out) <= 20
    assert not (out == vocab.pad_idx).any()


def test_slot_freed_and_reused(exact, vocab, prompts):
    eng = fresh(exact, vocab, n_slots=2)
    f0 = Future()
    eng.insert(0, prompts[0], n_words=16, greedy=True, future=f0)
    while not f0.done():
        eng.step_chunk()
    assert eng.free_slots() == [0, 1]
    f1 = Future()
    eng.insert(0, prompts[1], n_words=16, greedy=True, future=f1)
    while not f1.done():
        eng.step_chunk()
    assert len(f1.result()) > 0
    eng.insert(1, prompts[1], n_words=4)
    with pytest.raises(ValueError, match="busy"):
        eng.insert(1, prompts[0], n_words=4)


def test_service_streams_mixed_requests(exact, vocab, prompts):
    """More requests than slots, mixed settings: all complete, each as its
    own solo decode; a bad request fails only its own future."""
    svc = ContinuousGenerationService(engine=fresh(exact, vocab, n_slots=2))
    kws = [dict(n_words=16 + 8 * (i % 2), temperatures=(2.0, 2.0, 2.0), seed=i,
                top_k=[30, 5, 0][i % 3]) for i in range(5)]
    try:
        bad = svc.submit(prompts[0], temperatures=(1.0, 1.0, 1.0, 1.0))
        futs = [svc.submit(prompts[i % 3], **kw) for i, kw in enumerate(kws)]
        outs = [f.result(timeout=300) for f in futs]
        with pytest.raises(ValueError, match="temperatures"):
            bad.result(timeout=300)
    finally:
        svc.close()
    for i, out in enumerate(outs):
        assert 0 < len(out) <= kws[i]["n_words"]
        assert grammar_violations(out, vocab, prev_idx=int(prompts[i % 3][-1])) == 0
        solo = fresh(exact, vocab).generate(prompts[i % 3], **kws[i])
        np.testing.assert_array_equal(out, solo)


def test_service_recovers_after_step_failure(exact, vocab, prompts):
    """A failed step fails the resident futures and rebuilds the resident
    batch, so later requests still succeed."""
    eng = fresh(exact, vocab, n_slots=2)
    orig_step, calls = eng.step_chunk, {"n": 0}

    def exploding_step():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device failure")
        return orig_step()

    eng.step_chunk = exploding_step
    svc = ContinuousGenerationService(engine=eng)
    try:
        f1 = svc.submit(prompts[0], n_words=8, seed=0)
        with pytest.raises(RuntimeError, match="injected"):
            f1.result(timeout=300)
        out = svc.submit(prompts[1], n_words=8, seed=1).result(timeout=300)
        assert 0 < len(out) <= 8
    finally:
        svc.close()
    assert calls["n"] >= 2
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(prompts[0])


def test_engine_reset_clears_slots(exact, vocab, prompts):
    eng = fresh(exact, vocab)
    eng.insert(0, prompts[0], n_words=8)
    assert eng.free_slots() != list(range(4))
    eng.reset()
    assert eng.free_slots() == list(range(4))
    out = eng.generate(prompts[1], n_words=8, seed=3)    # usable after reset
    assert 0 < len(out) <= 8


def test_numpy_integer_top_k(exact, vocab, prompts):
    """A numpy integer top_k (from a JSON or numpy config) gives the stream
    of the same Python int."""
    a = fresh(exact, vocab).generate(prompts[0], n_words=12, top_k=np.int64(5), seed=2)
    b = fresh(exact, vocab).generate(prompts[0], n_words=12, top_k=5, seed=2)
    np.testing.assert_array_equal(a, b)


def test_slab_ar_matches_slab_stream(slab_setup, vocab, prompts):
    """The all-rows step shares the slab cache layout and quantization: a
    greedy stream on 'slab_ar' equals the 'slab' one (on the CPU both run
    the same plain version)."""
    a = fresh(slab_setup, vocab, chunk=4, decode_kernel="slab").generate(
        prompts[0], n_words=10, greedy=True)
    b = fresh(slab_setup, vocab, chunk=4, decode_kernel="slab_ar").generate(
        prompts[0], n_words=10, greedy=True)
    np.testing.assert_array_equal(a, b)


def test_kernel_choice_and_device(exact, slab_setup, vocab):
    """On the CPU the auto pick is 'xla', as JAX off the TPU; an explicit
    slab kernel needs the slab config; device=None means the card; the
    JAX constructor's other table options are not ported."""
    assert fresh(slab_setup, vocab).kernel == "xla"
    with pytest.raises(ValueError, match="slab"):
        fresh(exact, vocab, decode_kernel="slab")        # float32 config
    with pytest.raises(NotImplementedError, match="item 9"):
        fresh(exact, vocab, temp_mode="twotemp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousEngine(slab_setup[3], slab_setup[1], vocab)
