"""The port's sampler, generation engine and genre-continuation task against
the JAX package: greedy tokens of the exact path are identical on float32
models; the slab_w8 path runs end to end to a MIDI that re-parses and passes
the codec's checks."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.decode.engine import GenerationEngine as JEngine
from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import small_test_config as j_small
from deepmusicgeneration_tpu.ops import sampling as jsampling
from deepmusicgeneration_tpu.train.learner import MusicLearner as JLearner
from deepmusicgeneration_tpu.train.synthcorpus import generate_song
from deepmusicgeneration_tpu_torch.codec.grammar import grammar_violations
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.codec.validate import roundtrip_ok
from deepmusicgeneration_tpu_torch.decode.engine import GenerationEngine
from deepmusicgeneration_tpu_torch.models.config import TXLConfig, small_test_config
from deepmusicgeneration_tpu_torch.models.txl import _flash_auto as txl_rule
from deepmusicgeneration_tpu_torch.ops import fused_decode
from deepmusicgeneration_tpu_torch.ops import sampling
from deepmusicgeneration_tpu_torch.tasks.generate import predict_nw_genre
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_genre_model")


@pytest.fixture(scope="module")
def vocab():
    return MusicVocab.create()


@pytest.fixture(scope="module")
def song_midi(tmp_path_factory, vocab):
    """A synthcorpus song written to MIDI with the port's codec."""
    path = tmp_path_factory.mktemp("midi") / "pop.mid"
    MusicItem.from_npenc(generate_song("pop", 11), vocab).write_midi(str(path))
    return str(path)


def test_codec_tokens_match_jax(song_midi, vocab):
    from deepmusicgeneration_tpu.codec.item import MusicItem as JItem
    from deepmusicgeneration_tpu.vocab import MusicVocab as JVocab
    ref = JItem.from_file(song_midi, JVocab.create())
    got = MusicItem.from_file(song_midi, vocab)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.position, ref.position)
    assert got.to_midi_bytes() == ref.to_midi_bytes()


@pytest.mark.parametrize("top_k,top_p", [(30, 0.65), (3, 0.0), (0, 0.9), (5, 0.3)])
def test_filter_sorted_matches_jax(top_k, top_p):
    rng = np.random.default_rng(top_k)
    logits = rng.normal(size=(4, 324)).astype(np.float32)
    logits[0, :10] = 2.5                 # ties at the k-th value survive
    logits[1, 100:] = sampling.FILTER_VALUE   # grammar-banned entries stay dead
    ref = jsampling._filter_sorted(jnp.asarray(logits), top_k, top_p)
    got = sampling._filter_sorted(torch.from_numpy(logits), top_k, top_p)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    idx, nkept = sampling.filter_sample_sorted(None, torch.from_numpy(logits),
                                               top_k, top_p, greedy=True)
    j_idx, j_n = jsampling.filter_sample_sorted(None, jnp.asarray(logits), top_k,
                                                top_p, greedy=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(nkept.numpy(), np.asarray(j_n))


def test_sampling_draws_stay_in_filtered_set_and_follow_the_seed():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 324))
                              .astype(np.float32))
    filt, order, keep = sampling._filter_sorted(logits, 30, 0.65)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        draws.append(torch.stack([sampling.filter_sample_sorted(gen, logits, 30, 0.65)[0]
                                  for _ in range(20)]))
    assert torch.equal(draws[0], draws[1])
    allowed = [set(order[b][keep[b]].tolist()) for b in range(3)]
    assert all(int(t) in allowed[b] for row in draws[0] for b, t in enumerate(row))


def _f32_models(kind):
    if kind == "small_init":
        jcfg = j_small()
        return jcfg, jtxl.init_txl(jax.random.PRNGKey(5), jcfg)
    jl = JLearner.load(DEMO)   # trained weights give non-degenerate greedy runs
    cast = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jl.params)
    return jl.cfg.replace(dtype="float32"), cast


@pytest.mark.parametrize("kind", ["small_init", "demo_as_f32"])
def test_greedy_tokens_identical_to_jax_xla_path(kind, vocab):
    jcfg, jp = _f32_models(kind)
    cfg = small_test_config() if kind == "small_init" else \
        TXLConfig.from_dict(jcfg.to_dict())
    from deepmusicgeneration_tpu.vocab import MusicVocab as JVocab
    prompt = MusicItem.from_npenc(generate_song("jazz", 21), vocab).data[:150]
    ref_toks, ref_len = JEngine(jp, jcfg, JVocab.create()).generate_batch(
        [prompt], n_words=48, greedy=True, decode_kernel="xla")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    engine = GenerationEngine(tp, cfg, vocab, device="cpu")
    assert engine.resolve_kernel(1) == "xla"
    toks, lengths = engine.generate_batch([prompt], n_words=48, greedy=True)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(lengths, np.asarray(ref_len))


def test_resolve_kernel_policy(vocab):
    learner = MusicLearner.load(DEMO, device="cpu")
    engine = learner.engine
    assert engine.resolve_kernel(1) == "xla"            # off the card
    engine.device = torch.device("cuda")                # the rule on a card
    assert [engine.resolve_kernel(b) for b in (1, 4, 7, 8, 16)] == \
        ["slab_w8"] * 3 + ["slab_ar_w8"] * 2
    assert engine.resolve_kernel(1, mem_len=100) == "xla"  # not 32-aligned
    assert engine.resolve_kernel(1, decode_kernel="xla") == "xla"


def test_two_temperatures_expand_like_jax(song_midi, vocab):
    """A (t_note, t_dur) pair is (t_note, t_dur, t_dur), as in the JAX
    engine: the same greedy tokens as the 3-tuple, and the same sampled
    tokens from the same seed (the temperatures shape the draw)."""
    engine = MusicLearner.load(DEMO, device="cpu").engine
    prompt = MusicItem.from_file(song_midi, vocab).trim_to_beat(16) \
        .set_genre("pop").remove_eos().data
    kw = dict(n_words=24, top_p=0.9, min_bars=1)
    pair = engine.generate_batch([prompt], temperatures=(0.7, 1.6), greedy=True, **kw)
    three = engine.generate_batch([prompt], temperatures=(0.7, 1.6, 1.6), greedy=True,
                                  **kw)
    np.testing.assert_array_equal(pair[0], three[0])
    np.testing.assert_array_equal(pair[1], three[1])
    toks, lengths = engine.generate_batch([prompt], temperatures=(0.5, 2.0), seed=4,
                                          **kw)
    ref = engine.generate_batch([prompt], temperatures=(0.5, 2.0, 2.0), seed=4, **kw)
    assert 0 < lengths[0] <= 24
    np.testing.assert_array_equal(toks, ref[0])


def test_auto_rules_respect_kernel_limits(vocab):
    """The card's rules, read with the device given as an argument: at
    ctx_len = mem_len = 96 (W = 96, not a multiple of 64) the flash prefill
    (which has a tail tile) and the slab kernels apply; at d_head = 48,
    which the kernels are not built for, the rules pick the materialized
    prefill and the exact decode, and an explicit slab kernel raises."""
    engine = MusicLearner.load(DEMO, device="cpu").engine
    engine.device = torch.device("cuda")                # the rule on a card
    cuda = torch.device("cuda")
    x8 = lambda W: torch.zeros((8, W), dtype=torch.long)
    base = engine.cfg
    engine.cfg = base.replace(ctx_len=96, mem_len=96)
    assert txl_rule(engine.cfg, x8(96), cuda)
    assert [engine.resolve_kernel(b) for b in (1, 8)] == ["slab_w8", "slab_ar_w8"]
    engine.cfg = base.replace(d_model=384, n_heads=8, d_head=48)
    assert not txl_rule(engine.cfg, x8(96), cuda)
    assert not txl_rule(engine.cfg, torch.zeros((2, 4096), dtype=torch.long), cuda)
    assert [engine.resolve_kernel(b) for b in (1, 8)] == ["xla", "xla"]
    with pytest.raises(ValueError, match="d_head=48"):
        engine.generate_batch([np.arange(12, 40)], n_words=4, decode_kernel="slab_w8")
    engine.cfg = base
    assert txl_rule(base, x8(256), cuda) and not txl_rule(base, x8(256), "cpu")


def test_device_none_means_the_card(vocab):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = small_test_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine({}, cfg, vocab)


def _checked_continuation(full, seed_item, vocab, tmp_path):
    out = tmp_path / "out.mid"
    full.write_midi(str(out))
    back = MusicItem.from_file(str(out), vocab)
    pred = full.data[len(seed_item.data):]
    assert len(pred) > 8 and back.data[0] == vocab.bos_idx
    assert grammar_violations(pred, vocab, prev_idx=int(seed_item.data[-1])) == 0
    assert roundtrip_ok(back.data, vocab)
    return pred


def test_slab_w8_path_end_to_end_on_cpu(song_midi, vocab, tmp_path):
    """Explicit slab_w8 on the CPU runs the kernel's plain version, through
    int8 weights and the int8 ring, to a MIDI that re-parses."""
    learner = MusicLearner.load(DEMO, device="cpu")
    seed_item = MusicItem.from_file(song_midi, vocab).trim_to_beat(16) \
        .set_genre("pop").remove_eos()
    new = learner.engine.generate(seed_item.data, seed_pos=seed_item.position,
                                  n_words=48, temperatures=(1.2, 1.2, 1.0),
                                  min_bars=2, top_k=30, top_p=0.65, seed=3,
                                  decode_kernel="slab_w8")
    full = seed_item.append(MusicItem(new, vocab))
    _checked_continuation(full, seed_item, vocab, tmp_path)
    assert fused_decode.fused_slab_core.launches["slab_w8"] == 0   # CPU: no kernel launch


def test_predict_nw_genre_on_cpu(song_midi, vocab, tmp_path):
    learner = MusicLearner.load(DEMO, device="cpu")
    full = predict_nw_genre(learner, song_midi, genre="pop", max_len=32,
                            cutoff_beat=16, seed=1)
    seed_item = MusicItem.from_file(song_midi, vocab).trim_to_beat(16) \
        .set_genre("pop").remove_eos()
    _checked_continuation(full, seed_item, vocab, tmp_path)
