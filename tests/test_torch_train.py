"""The port's genre trainer against the JAX package's: the full-window
forward with XL memory, the parameter initializer, three train steps, the
one-cycle schedule, evaluate; the synthetic corpus, the LM loader and MIDI
preprocessing; checkpoints written by either package and read by the other;
fit_one_cycle's curriculum, loss and dropout seeding; ``cli train`` and the
fresh-weight factory. All on the CPU at small sizes, float32, dropout off
unless a test says otherwise; the JAX side runs its score path
(``flash=False``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import small_test_config as j_small
from deepmusicgeneration_tpu.train import checkpoint as jck
from deepmusicgeneration_tpu.train import data as jdata
from deepmusicgeneration_tpu.train import learner as jlearner
from deepmusicgeneration_tpu.train import loop as jloop
from deepmusicgeneration_tpu.train import preprocess as jpre
from deepmusicgeneration_tpu.train import synthcorpus as jsynth
from deepmusicgeneration_tpu_torch import cli
from deepmusicgeneration_tpu_torch.app import app_utils
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import btp_phase1_config, small_test_config
from deepmusicgeneration_tpu_torch.models.precision import master_params
from deepmusicgeneration_tpu_torch.train import checkpoint as ck
from deepmusicgeneration_tpu_torch.train import data, loop, preprocess, synthcorpus
from deepmusicgeneration_tpu_torch.train import learner as tlearner
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

# float32 on both sides, XLA's and PyTorch's summation orders (measured:
# logits and memory within 7.2e-7 over the three segments)
F32_ATOL = 1e-5
# three Adam steps: loss, accuracy and gradient norm relative to JAX's
# (measured 3.2e-7), each parameter leaf relative to its norm (measured
# 1.2e-6 through torch.optim.AdamW; Adam divides by sqrt(v) + 1e-5, so a
# last-bit difference in a gradient moves a small entry by about its own
# relative size)
STEP_RTOL = 1e-5
B, SEG = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; in the parallel test run, torch's
    intra-op threads only contend with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vocab():
    return MusicVocab.create()


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) on small_test_config."""
    jcfg = j_small()
    jp = jtxl.init_txl(jax.random.PRNGKey(3), jcfg)
    cfg = small_test_config()
    return jcfg, jp, cfg, ck.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)


@pytest.fixture(scope="module")
def songs():
    """Six synthetic songs (npenc) from the port's corpus generator."""
    return [synthcorpus.generate_song(g, s) for g, s in
            (("jazz", 0), ("pop", 1), ("rock", 2), ("folk", 3), ("funk", 4),
             ("electronic", 5))]


@pytest.fixture(scope="module")
def corpus(songs, vocab):
    return [MusicItem.from_npenc(n, vocab).data for n in songs]


def _tokens(seed, n_seg):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 324, size=(n_seg, B, SEG)).astype(np.int32)


@pytest.mark.parametrize("win,pad", [(1, False), (3, False), (1, True)])
@pytest.mark.parametrize("flash", [False, True])
def test_forward_three_segments_with_memory(models, win, pad, flash):
    """Three consecutive segments threading the XL memory: logits and the new
    memory equal JAX's score path. ``flash=True`` walks the port's plain
    train attention (on the CPU), so both port branches are held to JAX."""
    jcfg, jp, cfg, tp = models
    xs = _tokens(win, 3)
    pm = np.zeros((B, SEG), bool)
    if pad:
        pm[0, :5] = True
        pm[1, 20:23] = True
    jstate, state = jtxl.init_state(jcfg, B), txl.init_state(cfg, B)
    wk = 0 if win > 1 else 1
    for x in xs:
        jl, jstate = jtxl.forward(jp, jcfg, jnp.asarray(x), state=jstate, win_size=win,
                                  win_k=wk, pad_mask=jnp.asarray(pm) if pad else None,
                                  flash=False)
        tl, state = txl.forward(tp, cfg, torch.from_numpy(x), state=state, win_size=win,
                                win_k=wk, pad_mask=torch.from_numpy(pm) if pad else None,
                                flash=flash)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(state.mem.numpy(), np.asarray(jstate.mem), atol=F32_ATOL)
        assert state.valid == int(jstate.valid)


def test_flash_train_auto_rule():
    """JAX's rule with a CUDA device for the TPU; where it holds but the
    CUDA kernels refuse the head width, it raises instead of handing the
    card the score path. The rule reads no tensor, so no card is needed."""
    flagship, small = btp_phase1_config(), small_test_config()
    assert txl.flash_train_auto(flagship, 16, 512, 1024, "cuda")
    assert not txl.flash_train_auto(flagship, 16, 512, 1024, "cpu")
    assert not txl.flash_train_auto(flagship, 4, 512, 1024, "cuda")
    assert not txl.flash_train_auto(small, 16, 128, 256, "cuda")        # float32
    with pytest.raises(NotImplementedError, match="d_head=16"):
        txl.flash_train_auto(small.replace(dtype="bfloat16"), 16, 128, 256, "cuda")


def test_init_txl_tree_shapes_and_statistics():
    cfg = btp_phase1_config()
    jtree = jax.eval_shape(lambda r: jtxl.init_txl(r, cfg), jax.random.PRNGKey(0))
    params = txl.init_txl(cfg, torch.Generator().manual_seed(1))
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_flatten_with_path(t, is_leaf=lambda x: x is None)[0]}
    jflat = flat(jtree)
    pflat = flat(params)
    assert sorted(jflat) == sorted(pflat)
    for k, spec in jflat.items():
        if spec is None:
            assert pflat[k] is None, k
        else:
            assert tuple(pflat[k].shape) == spec.shape and pflat[k].dtype == torch.float32, k
    assert txl.param_count(params) == 41_107_268
    assert abs(params["embed"].std().item() - 0.02) < 5e-4
    lp = params["layers"][3]
    assert abs(lp["ff1_w"].std().item() - 0.02) < 5e-4
    assert abs(lp["ln1_g"].mean().item() - 1.0) < 5e-3
    assert abs(lp["ln1_g"].std().item() - 0.02) < 5e-3
    assert not lp["ff2_b"].any() and not params["head_b"].any()
    assert lp["qkv_b"] is None
    again = txl.init_txl(cfg, torch.Generator().manual_seed(1))
    assert torch.equal(again["layers"][7]["out_w"], params["layers"][7]["out_w"])


def test_three_train_steps_match_jax(models, vocab):
    jcfg, jp, cfg, tp = models
    jopt = jloop.make_optimizer(10, peak_lr=5e-3)
    jstate = jloop.TrainState(jp, jopt.init(jp), jtxl.init_state(jcfg, B), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt, vocab.pad_idx, flash=False))
    opt = loop.make_optimizer(10, peak_lr=5e-3)
    params = master_params(tp)
    state = loop.TrainState(params, opt.init(params), txl.init_state(cfg, B), 0)
    step = loop.make_train_step(cfg, opt, vocab.pad_idx, flash=False)
    xs = _tokens(7, 4)
    for i, win in enumerate((1, 3, 1)):
        y = xs[i + 1].copy()
        y[:, ::2] = xs[i][:, ::2]        # targets the tied head predicts: acc near 0.5
        y[:, -6:] = vocab.pad_idx                       # ignored targets
        batch = {"x": xs[i], "y": y}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(i), win_size=win)
        state, m = step(state, batch, None, win_size=win)
        for key in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=STEP_RTOL, err_msg=key)
        jleaves = jax.tree_util.tree_leaves(jstate.params)
        leaves = txl.tree_leaves(state.params)
        assert len(jleaves) == len(leaves)
        for j, t in zip(jleaves, leaves):
            j = np.asarray(j)
            d = np.linalg.norm(t.detach().numpy() - j) / max(np.linalg.norm(j), 1e-30)
            assert d <= STEP_RTOL, (i, t.shape, d)
        np.testing.assert_allclose(state.mem.mem.numpy(), np.asarray(jstate.mem.mem),
                                   atol=F32_ATOL)
    assert state.step == 3


@pytest.mark.parametrize("total", [1, 7, 100])
def test_one_cycle_schedule_equals_optax(total):
    """Every step and beyond the end, at the int32 step count the optimizer
    gives optax (float32 throughout; XLA's cos and numpy's may differ in the
    last bit). At total 1 optax's warm-up interval is empty and every value
    NaN; the port's too (assert_allclose counts NaN equal to NaN)."""
    want = jloop.one_cycle_schedule(total, 5e-4)
    got = loop.one_cycle_schedule(total, 5e-4)
    steps = range(total + 3)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(jnp.int32(s))) for s in steps], rtol=1e-6)


def test_evaluate_equals_jax(models, vocab, corpus):
    jcfg, jp, cfg, tp = models
    kw = dict(bs=2, bptt=SEG, shuffle=False, transpose_range=None, encode_position=False)
    want = jlearner.MusicLearner(jcfg, vocab, params=jp).evaluate(
        jp, jdata.LMStreamLoader(corpus[:2], vocab, **kw))
    got = MusicLearner(cfg, vocab, params=tp, device="cpu").evaluate(
        tp, data.LMStreamLoader(corpus[:2], vocab, **kw))
    for k in ("valid_loss", "valid_acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("genre,seed", [("jazz", 0), ("rock", 7), ("electronic", 123),
                                        ("folk", 10_004)])
def test_generate_song_identical(genre, seed):
    np.testing.assert_array_equal(synthcorpus.generate_song(genre, seed),
                                  jsynth.generate_song(genre, seed))


def test_lm_loader_identical_batches_with_transposition(vocab, corpus):
    kw = dict(bs=3, bptt=32, shuffle=True, transpose_range=(0, 12), transpose_p=0.5,
              encode_position=True, seed=5)
    mine = data.LMStreamLoader(corpus, vocab, **kw)
    ref = jdata.LMStreamLoader(corpus, vocab, **kw)
    assert len(mine) == len(ref)
    assert (ref.transpose_values != 0).any()
    for _ in range(2):                                  # two epochs: reshuffled
        # whole epochs: a generator sets up its next epoch after its last batch
        for got, want in zip(list(mine), list(ref)):
            assert sorted(got) == sorted(want) == ["pos", "x", "y"]
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_process_file_identical_npy(tmp_path, songs, vocab):
    midi = tmp_path / "song.mid"
    MusicItem.from_npenc(songs[3], vocab).write_midi(str(midi))
    got = preprocess.process_file(midi, tmp_path / "port")
    want = jpre.process_file(midi, tmp_path / "jax")
    np.testing.assert_array_equal(np.load(got), np.load(want))


def test_port_checkpoint_loads_in_jax(tmp_path, models, vocab):
    jcfg, jp, cfg, tp = models
    trained = txl.tree_map(lambda t: t + 0.5, master_params(tp))
    ck.save_checkpoint(str(tmp_path), trained, cfg, vocab, step=37)
    template = jax.eval_shape(lambda r: jtxl.init_txl(r, jcfg), jax.random.PRNGKey(0))
    params, opt, jcfg2, jvocab, manifest = jck.load_checkpoint(str(tmp_path),
                                                               template_params=template)
    assert manifest["step"] == 37 and opt is None and jcfg2 == jcfg
    assert jvocab.layout == vocab.layout
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(txl.tree_leaves(trained))
    for j, t in zip(leaves, txl.tree_leaves(trained)):
        np.testing.assert_array_equal(np.asarray(j), t.detach().numpy())
    # byte for byte what flax writes for the same tree
    with open(tmp_path / ck.PARAMS, "rb") as f:
        from flax import serialization
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        assert f.read() == serialization.to_bytes(np_tree)


def test_jax_checkpoint_loads_in_port(tmp_path, models, vocab):
    jcfg, jp, cfg, tp = models
    jck.save_checkpoint(str(tmp_path), jp, jcfg, vocab, step=11)
    learner = MusicLearner.load(str(tmp_path), device="cpu")
    assert learner.step == 11 and learner.cfg == cfg
    for j, t in zip(jax.tree_util.tree_leaves(jp), txl.tree_leaves(learner.params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _fit_windows(monkeypatch, corpus, vocab, cfg, jcfg, n_steps_corpus):
    """The curriculum windows each fit_one_cycle hands its train step, the
    step itself replaced by a recorder."""
    seen = {"port": [], "jax": []}

    def recorder(key):
        def make(*args, **kwargs):
            def step(state, batch, rng, win_size=1):
                seen[key].append(int(win_size))
                return state, {"loss": 0.0, "acc": 0.0}
            return step
        return make

    monkeypatch.setattr(tlearner, "make_train_step", recorder("port"))
    monkeypatch.setattr(jlearner, "make_train_step", recorder("jax"))
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    kw = dict(bs=2, bptt=SEG, encode_position=False, seed=1)
    items = corpus[:n_steps_corpus]
    MusicLearner(cfg, vocab, device="cpu").fit_one_cycle(
        data.LMStreamLoader(items, vocab, **kw), epochs=2, seed=9, log_fn=lambda s: None)
    jlearner.MusicLearner(jcfg, vocab, params=jtxl.init_txl(jax.random.PRNGKey(0), jcfg)) \
        .fit_one_cycle(jdata.LMStreamLoader(items, vocab, **kw), epochs=2, seed=9,
                       log_fn=lambda s: None)
    return seen


def test_fit_window_sequence_equals_jax(monkeypatch, corpus, vocab, models):
    jcfg, _, cfg, _ = models
    seen = _fit_windows(monkeypatch, corpus, vocab, cfg, jcfg, 3)
    assert len(seen["port"]) > 100 and seen["port"] == seen["jax"]
    assert set(seen["port"]) == {1, 2, 3, 4}           # mask_steps 4: the curriculum ran


@pytest.fixture(scope="module")
def small_corpus(corpus):
    """Two songs cut to 1500 tokens each: 24 steps an epoch at bs 2 x bptt 64."""
    return [c[:1500] for c in corpus[:2]]


def test_fit_one_cycle_loss_falls(vocab, small_corpus, tmp_path):
    cfg = small_test_config()
    learner = MusicLearner(cfg, vocab, device="cpu")
    loader = data.LMStreamLoader(small_corpus, vocab, bs=2, bptt=SEG, encode_position=False)
    valid = data.LMStreamLoader(small_corpus, vocab, bs=2, bptt=SEG, shuffle=False,
                                transpose_range=None, encode_position=False)
    result = learner.fit_one_cycle(loader, epochs=2, lr=5e-3, valid_loader=valid,
                                   save_best_to=str(tmp_path / "best"), log_fn=lambda s: None)
    h = result.history
    assert h[1]["train_loss"] < h[0]["train_loss"] and h[1]["valid_loss"] < h[0]["valid_loss"]
    assert len(result.losses) == 2 * len(loader) == learner.step
    best = json.loads((tmp_path / "best" / ck.MANIFEST).read_text())
    assert best["step"] == learner.step


def test_fit_dropout_is_seeded(vocab, small_corpus):
    cfg = small_test_config().replace(embed_p=0.1, resid_p=0.1, attn_p=0.1, ff_p=0.1,
                                      output_p=0.1)

    def losses(seed):
        learner = MusicLearner(cfg, vocab, device="cpu")
        loader = data.LMStreamLoader(small_corpus[:1], vocab, bs=2, bptt=SEG,
                                     encode_position=False)
        return learner.fit_one_cycle(loader, lr=5e-3, seed=seed, log_fn=lambda s: None).losses

    a, b, c = losses(3), losses(3), losses(4)
    assert a == b and a != c


def test_cli_train_then_generate(tmp_path, songs, vocab, capsys):
    root = tmp_path / "cache"
    for i, npenc in enumerate(songs[:5]):
        d = root / ("jazz" if i % 2 else "pop")
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / f"s{i}.npy", npenc)
    ckpt = tmp_path / "ckpt"
    cli.main(["train", "--data", str(root), "--ckpt", str(ckpt), "--epochs", "1",
              "--bs", "4", "--small", "--device", "cpu"])
    manifest = json.loads((ckpt / ck.MANIFEST).read_text())
    assert manifest["step"] > 0 and manifest["config"]["d_model"] == 128
    midi = tmp_path / "prompt.mid"
    MusicItem.from_npenc(songs[5], vocab).write_midi(str(midi))
    out = tmp_path / "gen.mid"
    cli.main(["generate", "--midi", str(midi), "--ckpt", str(ckpt), "--device", "cpu",
              "--max-len", "16", "--mem-len", "128", "--out", str(out)])
    assert len(MusicItem.from_file(str(out), vocab).data) > 0
    assert "saved checkpoint" in capsys.readouterr().out


def test_factory_fresh_weights(tmp_path, monkeypatch, songs, vocab):
    """Without any checkpoint, createGenreContinuationModel ends in fresh
    flagship weights, which predict."""
    monkeypatch.setattr(app_utils, "_demo", lambda name: str(tmp_path / "none" / name))
    learner = app_utils.createGenreContinuationModel(ckpt_path=str(tmp_path / "missing"),
                                                     device="cpu")
    assert learner.cfg == btp_phase1_config() and learner.step == 0
    assert txl.param_count(learner.params) == 41_107_268
    item = MusicItem.from_npenc(songs[0], vocab)
    item = MusicItem(item.data[:40], vocab)
    pred, full = learner.predict(item, n_words=4, seed=1)
    assert len(full.data) == 40 + len(pred.data) and len(pred.data) > 0


@pytest.mark.parametrize("L,M", [(64, 64), (128, 256)])
@pytest.mark.parametrize("win", [1, 2, 3, 4])
@pytest.mark.parametrize("mem_valid", [0, 40, "M"])
def test_window_masks_match_jax(L, M, win, mem_valid):
    """causal_window_mask for every (win_size, win_k, mem_valid) the train
    step emits (win_k 1 at win_size 1, else 0; mem_valid from 0 up to M as
    the memory fills), against the JAX package's."""
    from deepmusicgeneration_tpu.ops import rel_attention as jra
    from deepmusicgeneration_tpu_torch.ops import rel_attention as ra
    mv = M if mem_valid == "M" else mem_valid
    k = 0 if win > 1 else 1
    np.testing.assert_array_equal(ra.causal_window_mask(L, M, win, k, mem_valid=mv).numpy(),
                                  np.asarray(jra.causal_window_mask(L, M, win, k, mem_valid=mv)))
