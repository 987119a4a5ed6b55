"""The port's multitask engines and sampler options against the JAX
package: the two-temperature tables and the seq2seq stopping rules equal
JAX's on random states; greedy tokens of the exact (``xla``) path of the
seq2seq, next-word and mask-infill (parallel and sequential) engines are
identical to JAX's on the trained demo checkpoint in float32; sampled runs
follow their seed; the kernel rule; the learner and tasks end to end."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.codec.item import MultitrackItem as JMultitrack
from deepmusicgeneration_tpu.decode import engine as je
from deepmusicgeneration_tpu.decode import multitask_engine as jme
from deepmusicgeneration_tpu.train.learner import MultitaskLearner as JLearner
from deepmusicgeneration_tpu.train.synthcorpus import generate_song
from deepmusicgeneration_tpu.vocab import MusicVocab as JVocab
from deepmusicgeneration_tpu_torch.codec.grammar import grammar_violations
from deepmusicgeneration_tpu_torch.codec.item import MultitrackItem, MusicItem
from deepmusicgeneration_tpu_torch.decode import engine as te
from deepmusicgeneration_tpu_torch.decode import multitask_engine as tme
from deepmusicgeneration_tpu_torch.models.config import MultitaskConfig
from deepmusicgeneration_tpu_torch.tasks.harmonize import (nw_predict_from_midi,
                                                           s2s_predict_from_midi)
from deepmusicgeneration_tpu_torch.tasks.remix import predict_mask_remix
from deepmusicgeneration_tpu_torch.train.checkpoint import multitask_params_from_numpy
from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_multitask_model")
SYNTH = os.path.join(ROOT, "checkpoints", "synth_multitask_model")


@pytest.fixture(scope="module")
def vocab():
    return MusicVocab.create()


def _f32(path):
    """A JAX multitask checkpoint cast to float32 (config and weights), and
    the same weights in the port: greedy parity needs logits that agree to
    float32 noise, not to bf16 roundings."""
    jl = JLearner.load(path)
    jcfg = jl.cfg.replace(dtype="float32")
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jl.params)
    cfg = MultitaskConfig.from_dict(jcfg.to_dict())
    tp = multitask_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def demo():
    return _f32(DEMO)


@pytest.fixture(scope="module")
def tracks():
    """A two-track (Piano melody, Bass) synthcorpus song: the source and a
    target prefix, as s2s_predict_from_midi splits them."""
    mt = JMultitrack.from_npenc(generate_song("electronic", 3), JVocab.create())
    inp = mt.first_instrument.data
    targ = mt.second_instrument.trim_to_beat(8).remove_eos().data
    return inp, targ


# -- sampler options -----------------------------------------------------------

def _random_state(rng, B, V):
    st = dict(prev_tok=rng.integers(0, V, B), last_pos=rng.integers(0, 600, B),
              start_pos=rng.integers(0, 200, B), last_xxsep=rng.random(B) < 0.5,
              repeat_count=rng.integers(0, 9, B), done=rng.random(B) < 0.2,
              n_emitted=rng.integers(0, 50, B))
    st["prev_tok"][: B // 2] = 8                   # xxsep: durations move last_pos
    j = je.SampleState(**{k: jnp.asarray(v, jnp.bool_ if v.dtype == bool else jnp.int32)
                          for k, v in st.items()})
    t = te.SampleState(**{k: torch.from_numpy(v if v.dtype == bool else v.astype(np.int32))
                          for k, v in st.items()})
    return j, t


# (temperature table, sampler settings) of the seq2seq, next-word and genre engines
SETTINGS = {
    "s2s": ("twotemp", dict(use_min_bars_ban=False, bar_stop=False, pos_stop=True,
                            eos_stop=True)),
    "nw": ("twotemp", dict()),
    "genre": ("genre", dict()),
}


@pytest.mark.parametrize("kind", list(SETTINGS))
def test_sampler_options_match_jax(kind, vocab):
    rng = np.random.default_rng(len(kind))
    V, B = len(vocab), 64
    temp_mode, kw = SETTINGS[kind]
    js = je.SamplerSettings(n_words=32, temp_mode=temp_mode, **kw)
    ts = te.SamplerSettings(n_words=32, **kw)
    jt = je.build_tables(JVocab.create(), temp_mode)
    tt = te.build_tables(vocab, temp_mode)
    for name in ("allowed", "prev_class", "temp_slot"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
    assert tt.eos_idx == jt.eos_idx
    for trial in range(4):
        jst, tst = _random_state(rng, B, V)
        logits = rng.normal(size=(B, V)).astype(np.float32)
        temps = np.asarray([1.3, 0.8, 0.6], np.float32)
        overlay = rng.random(V) < 0.9
        min_bars = 2
        jl, jx = je.prepare_logits(jnp.asarray(logits), jst, jt, jnp.asarray(temps),
                                   jnp.asarray(min_bars), jnp.asarray(overlay), js)
        tl, tx = te.prepare_logits(torch.from_numpy(logits), tst, tt, torch.from_numpy(temps),
                                   min_bars, torch.from_numpy(overlay), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        idx = rng.integers(0, V, B)
        idx[::5] = vocab.eos_idx
        idx[1::7] = vocab.bos_idx
        idx[: B // 2: 3] = vocab.dur_range[0] + rng.integers(0, 64, len(idx[: B // 2: 3]))
        nc = rng.integers(0, 6, B)
        max_pos = rng.integers(0, 700, B)
        frac = (0.5, 0.9)[trial % 2]
        ji, jn = je.advance_state(jnp.asarray(idx, jnp.int32), jnp.asarray(nc, jnp.int32), jst,
                                  jx, jt, js, jnp.float32(frac), jnp.asarray(max_pos, jnp.int32))
        ti, tn = te.advance_state(torch.from_numpy(idx), torch.from_numpy(nc), tst, tx, tt,
                                  frac > 0.8, ts, torch.from_numpy(max_pos.astype(np.int32)))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        for a, b in zip(tn, jn):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- greedy parity on the exact path --------------------------------------------

def test_s2s_greedy_tokens_identical_to_jax(demo, tracks, vocab):
    jcfg, jp, cfg, tp = demo
    inp, targ = tracks
    ref = jme.S2SEngine(jp, jcfg, JVocab.create(), decode_kernel="xla").predict_s2s(
        inp, targ, target_ins="Bass", n_words=32, greedy=True)
    eng = tme.S2SEngine(tp, cfg, vocab, device="cpu")
    assert eng.kernel == "xla"
    got = eng.predict_s2s(inp, targ, target_ins="Bass", n_words=32, greedy=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert len(got) > len(targ)


def test_nw_greedy_tokens_identical_to_jax(demo, tracks, vocab):
    jcfg, jp, cfg, tp = demo
    prompt = MusicItem.from_npenc(generate_song("jazz", 8), vocab).data[:120]
    ref = jme.NWEngine(jp, jcfg, JVocab.create(), decode_kernel="xla").predict_nw(
        prompt, n_words=32, greedy=True)
    got = tme.NWEngine(tp, cfg, vocab, device="cpu").predict_nw(prompt, n_words=32,
                                                                greedy=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert len(got) > 0


@pytest.mark.parametrize("parallel", [True, False])
def test_mask_greedy_fill_identical_to_jax(demo, vocab, parallel):
    jcfg, jp, cfg, tp = demo
    data = MusicItem.from_npenc(generate_song("pop", 4), vocab).data[:160].copy()
    notes = np.nonzero((data >= vocab.note_range[0]) & (data < vocab.note_range[1]))[0]
    sel = notes[3:27:3]                                    # 8 masks
    data[sel] = vocab.mask_idx
    ref = jme.MaskEngine(jp, jcfg, JVocab.create()).predict_mask(
        data, greedy=True, parallel=parallel)
    got = tme.MaskEngine(tp, cfg, vocab, device="cpu").predict_mask(
        data, greedy=True, parallel=parallel)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (got != vocab.mask_idx).all()


def test_s2s_greedy_tokens_identical_to_jax_on_the_85m_checkpoint(tracks, vocab):
    """The same seq2seq parity on the 85M flagship checkpoint (float32)."""
    jcfg, jp, cfg, tp = _f32(SYNTH)
    inp, targ = tracks
    ref = jme.S2SEngine(jp, jcfg, JVocab.create(), decode_kernel="xla").predict_s2s(
        inp, targ, target_ins="Bass", n_words=32, greedy=True)
    t0 = time.perf_counter()
    got = tme.S2SEngine(tp, cfg, vocab, device="cpu").predict_s2s(
        inp, targ, target_ins="Bass", n_words=32, greedy=True)
    print(f"port S2S, 85M, 32 words on the CPU: {time.perf_counter() - t0:.1f} s")
    np.testing.assert_array_equal(got, np.asarray(ref))


# -- seeds, kernel rule, learner and tasks -------------------------------------

def test_sampled_runs_follow_the_seed(demo, tracks, vocab):
    _, _, cfg, tp = demo
    inp, targ = tracks
    s2s = tme.S2SEngine(tp, cfg, vocab, device="cpu")
    runs = [s2s.predict_s2s(inp, targ, n_words=24, seed=s) for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    nw = tme.NWEngine(tp, cfg, vocab, device="cpu")
    a, b = (nw.predict_nw(targ, n_words=24, seed=5) for _ in range(2))
    np.testing.assert_array_equal(a, b)
    mask = tme.MaskEngine(tp, cfg, vocab, device="cpu")
    data = targ.copy()
    data[np.nonzero((data >= vocab.note_range[0]) & (data < vocab.note_range[1]))[0][:6]] = \
        vocab.mask_idx
    for parallel in (True, False):
        a, b = (mask.predict_mask(data, seed=2, parallel=parallel) for _ in range(2))
        np.testing.assert_array_equal(a, b)


def test_kernel_rule(vocab):
    """On the CPU 'auto' is 'xla'; on the card it is 'slab_w8' where the
    slab steps apply; explicit choices are honoured or refused."""
    cfg = MultitaskConfig(dtype="bfloat16")                  # the 85M flagship
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tme._pick_dec_kernel(cfg, "auto", cpu) == "xla"
    assert tme._pick_dec_kernel(cfg, "auto", cuda) == "slab_w8"
    assert tme._pick_dec_kernel(cfg.replace(mem_len=100), "auto", cuda) == "xla"
    assert tme._pick_dec_kernel(cfg.replace(dtype="float32"), "auto", cuda) == "xla"
    assert tme._pick_dec_kernel(cfg.replace(d_head=48, d_model=384), "auto", cuda) == "xla"
    for k in ("slab", "slab_w8", "xla"):
        assert tme._pick_dec_kernel(cfg, k, cpu) == k
    with pytest.raises(ValueError, match="slab"):
        tme._pick_dec_kernel(cfg.replace(mem_len=100), "slab_w8", cpu)
    assert tme._pick_dec_kernel(cfg, "fused", cpu) == "fused"
    with pytest.raises(ValueError, match="fused"):
        tme._pick_dec_kernel(cfg.replace(dtype="float32"), "fused", cpu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tme.NWEngine({}, cfg, vocab)


@pytest.mark.parametrize("kernel", ["slab_w8", "slab"])
def test_slab_path_follows_the_exact_one_on_cpu(kernel, vocab, tracks):
    """The slab steps' plain versions (what a CPU tensor runs) drive the
    seq2seq and next-word engines end to end on the bf16 demo checkpoint;
    the output is grammatical and its first tokens follow the exact path."""
    learner = MultitaskLearner.load(DEMO, device="cpu", decode_kernel=kernel)
    exact = MultitaskLearner.load(DEMO, device="cpu", decode_kernel="xla")
    inp, targ = tracks
    vi = lambda d, **kw: MusicItem(d, vocab, **kw)
    got = learner.predict_s2s(vi(inp), vi(targ, ins="Bass"), n_words=32, greedy=True)
    ref = exact.predict_s2s(vi(inp), vi(targ, ins="Bass"), n_words=32, greedy=True)
    assert learner.engine("s2s").kernel == kernel
    new = got.data[len(targ):]
    assert len(new) > 0 and grammar_violations(new, vocab, prev_idx=int(targ[-1])) == 0
    np.testing.assert_array_equal(new[:4], ref.data[len(targ):][:4])
    pred, full = learner.predict_nw(vi(targ), n_words=24, greedy=True)
    assert len(pred.data) > 0 and grammar_violations(pred.data, vocab,
                                                     prev_idx=int(targ[-1])) == 0


def test_tasks_end_to_end_on_cpu(tmp_path, vocab):
    """predict_mask_remix, s2s_predict_from_midi and nw_predict_from_midi on
    the demo checkpoint, from a two-track MIDI made with the port's codec;
    every output re-parses."""
    learner = MultitaskLearner.load(DEMO, device="cpu")
    midi = MusicItem.from_npenc(generate_song("electronic", 6), vocab).to_midi_bytes()
    remix = predict_mask_remix(learner, midi, mask_proportion=0.6, seed=1)
    assert (remix.data != vocab.mask_idx).all()
    multi = s2s_predict_from_midi(learner, midi, n_words=48, seed=2)
    assert isinstance(multi, MultitrackItem)
    full = nw_predict_from_midi(learner, midi, n_words=32, seed_len=8, seed=3)
    for out in (remix.to_midi_bytes(), multi.to_midi_bytes(), full.to_midi_bytes()):
        back = MusicItem.from_file(out, vocab)
        assert len(back.data) > 2 and back.data[0] == vocab.bos_idx
