"""The port's multitask training against the JAX package's: the BERT mask
transforms and the seq2seq loader give the same batches for a seed;
``mt.forward`` gives JAX's logits on the mask, next-word and seq2seq tasks;
``MultitaskLearner.fit`` takes JAX's steps (losses, every parameter, the
curriculum's windows); checkpoints written by either package train or load
in the other. Then the port alone: the flash route's logits and gradients
against the score path's, remat, seeded dropout, the engines after ``fit``,
the flash route's auto rule on the CPU. All at a small size (2 + 2 layers,
d_model 64, two heads of 32, bptt 128), float32, dropout off unless a test
says otherwise; the JAX side runs its score path."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.codec.item import MultitrackItem as JMultitrackItem
from deepmusicgeneration_tpu.models import multitask as jmt
from deepmusicgeneration_tpu.models.config import MultitaskConfig as JMultitaskConfig
from deepmusicgeneration_tpu.train import checkpoint as jck
from deepmusicgeneration_tpu.train import data as jdata
from deepmusicgeneration_tpu.train import learner as jlearner
from deepmusicgeneration_tpu.vocab import MusicVocab as JMusicVocab
from deepmusicgeneration_tpu_torch.codec.item import MultitrackItem, MusicItem
from deepmusicgeneration_tpu_torch.models import multitask as mt
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import MultitaskConfig
from deepmusicgeneration_tpu_torch.models.precision import master_params
from deepmusicgeneration_tpu_torch.ops import flash_train as ft
from deepmusicgeneration_tpu_torch.train import checkpoint as ck
from deepmusicgeneration_tpu_torch.train import data, synthcorpus
from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
from deepmusicgeneration_tpu_torch.train.loop import multi_loss
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

# float32 on both sides, XLA's and PyTorch's summation orders (measured:
# logits within 1.8e-7 of the score path's; parameters within 3.6e-7 after
# four AdamW steps)
F32_ATOL = 1e-5
STEP_RTOL = 1e-5
# the flash route's gradients against the score path's, both float32 in
# PyTorch (measured: 2.3e-8 of a leaf's largest entry plus 1)
ROUTE_GRAD_ATOL = 1e-6
B, L = 2, 128
SMALL = dict(enc_layers=2, dec_layers=2, d_model=64, d_inner=128, n_heads=2, d_head=32,
             ctx_len=L, mem_len=L, dtype="float32", embed_p=0.0, resid_p=0.0, attn_p=0.0,
             ff_p=0.0, output_p=0.0, mask_p=0.5)
DROPOUTS = dict(embed_p=0.1, resid_p=0.1, attn_p=0.1, ff_p=0.1, output_p=0.1)
FIT_SEED, FIT_WINDOW = 5, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vocab():
    return MusicVocab.create()


@pytest.fixture(scope="module")
def models(vocab):
    """(JAX cfg, JAX params, port cfg, port params) of the small config."""
    jcfg = JMultitaskConfig(vocab_size=len(vocab), **SMALL)
    jp = jmt.init_multitask(jax.random.PRNGKey(0), jcfg)
    cfg = MultitaskConfig(vocab_size=len(vocab), **SMALL)
    tp = ck.multitask_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def songs():
    """Two-track (Piano + Bass) synthetic songs, npenc."""
    return [synthcorpus.generate_song(g, s) for g in ("jazz", "folk", "pop") for s in (1, 2)]


def _lm_batch(vocab, seed=0):
    corpus = [MusicItem.from_npenc(synthcorpus.generate_song("jazz", s), vocab).data
              for s in (3, 4)]
    return next(iter(data.LMStreamLoader(corpus, vocab, bs=B, bptt=L, seed=seed)))


@pytest.mark.parametrize("tfm", ["mask_lm_tfm_pitchdur", "mask_lm_tfm", "mask_tfm_custom"])
def test_mask_transforms_identical_to_jax(vocab, tfm):
    batch = _lm_batch(vocab)
    if tfm == "mask_tfm_custom":
        args = lambda v: (v.note_range, v.mask_idx, v.pad_idx, 0.4)
    else:
        args = lambda v: (v,)
    got = getattr(data, tfm)(batch, *args(vocab), np.random.default_rng(9))
    want = getattr(jdata, tfm)(batch, *args(JMusicVocab.create()), np.random.default_rng(9))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for task in g:
            gt, wt = (g[task], w[task]) if isinstance(g[task], dict) else (
                {"y": g[task]}, {"y": w[task]})
            for key in wt:
                np.testing.assert_array_equal(gt[key], wt[key], err_msg=f"{task}/{key}")


def test_s2s_loader_identical_to_jax(vocab, songs):
    jvocab = JMusicVocab.create()
    ours = data.S2SLoader([MultitrackItem.from_npenc(n, vocab) for n in songs], vocab, bs=2,
                          bptt=L, seed=3)
    theirs = jdata.S2SLoader([JMultitrackItem.from_npenc(n, jvocab) for n in songs], jvocab,
                             bs=2, bptt=L, seed=3)
    n = 0
    for _ in range(2):               # two epochs: the segment cursors move on
        for (gx, gy), (wx, wy) in zip(ours, theirs):
            for task in ("s2f", "f2s"):
                np.testing.assert_array_equal(gy[task], wy[task])
                for key in wx[task]:
                    np.testing.assert_array_equal(gx[task][key], wx[task][key])
            n += 1
    assert n == 2 * len(ours) == 6


def _task_inputs(vocab, seed=0):
    """A task dict of every kind, with key padding on the seq2seq task."""
    rng = np.random.default_rng(seed)
    tok = lambda: rng.integers(4, len(vocab), (B, L)).astype(np.int32)
    pos = lambda: np.sort(rng.integers(0, 300, (B, L)), axis=1).astype(np.int32)
    pad = np.zeros((B, L), bool)
    pad[1, -20:] = True
    return {"msk": {"x": tok(), "pos": pos()}, "lm": {"x": tok(), "pos": pos()},
            "s2f": {"enc": tok(), "enc_pos": pos(), "dec": tok(), "dec_pos": pos(),
                    "enc_pad": pad, "dec_pad": pad},
            "f2s": {"enc": tok(), "enc_pos": pos(), "dec": tok(), "dec_pos": pos()}}


def _torch_tasks(inp):
    return {k: {kk: torch.from_numpy(a) for kk, a in v.items()} for k, v in inp.items()}


@pytest.fixture(scope="module")
def jax_logits(models, vocab):
    jcfg, jp, _, _ = models
    inp = jax.tree_util.tree_map(jnp.asarray, _task_inputs(vocab))
    fwd = jax.jit(lambda p, x: jmt.forward(p, jcfg, x, win_size=3, win_k=0, flash_train=False))
    out = fwd(jp, inp)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("task", ["msk", "lm", "s2f", "f2s"])
def test_forward_logits_match_jax(models, vocab, jax_logits, task):
    """Window 3 at diagonal 0 in the decoder, padded keys in s2f."""
    _, _, cfg, tp = models
    got = mt.forward(tp, cfg, _torch_tasks(_task_inputs(vocab)), win_size=3, win_k=0)
    np.testing.assert_allclose(got[task].numpy(), jax_logits[task], atol=F32_ATOL, rtol=0)


def _fit_batches(vocab):
    """Four batches (the fewest with a finite one-cycle schedule: optax's
    first interval is empty below four steps), each of all four tasks (one
    structure, so JAX compiles its step once)."""
    rng = np.random.default_rng(4)
    batches = []
    for i in range(4):
        inp = _task_inputs(vocab, seed=10 + i)
        for d in inp.values():              # the loaders emit no padding
            d.pop("enc_pad", None), d.pop("dec_pad", None)
        tok = lambda: rng.integers(4, len(vocab), (B, L)).astype(np.int32)
        batches.append((inp, {task: tok() for task in inp}))
    return batches


@pytest.fixture(scope="module")
def fits(models, vocab):
    """JAX's fit and the port's on the same batches; JAX's step is wrapped to
    record each step's window and loss."""
    jcfg, jp, cfg, tp = models
    batches = _fit_batches(vocab)
    seen, real_jit = [], jax.jit

    def recording_jit(fn, *a, **k):
        step = real_jit(fn, *a, **k)

        def call(*args, **kw):
            out = step(*args, **kw)
            seen.append(((int(kw["win_size"]), int(kw["win_k"])), float(out[2])))
            return out
        return call

    jl = jlearner.MultitaskLearner(jcfg, JMusicVocab.create(), params=jp)
    with mock.patch.object(jax, "jit", recording_jit):
        jl.fit(batches, epochs=1, seed=FIT_SEED, starting_mask_window=FIT_WINDOW,
               log_fn=lambda s: None)
    learner = MultitaskLearner(cfg, vocab, params=tp, device="cpu")
    result = learner.fit(batches, epochs=1, seed=FIT_SEED, starting_mask_window=FIT_WINDOW,
                         log_fn=lambda s: None)
    return seen, jl.params, result, learner


def test_fit_window_sequence_equals_jax(fits):
    seen, _, result, _ = fits
    assert result.windows == [w for w, _ in seen]
    assert any(w > 1 for w, _ in result.windows)


def test_fit_steps_match_jax(fits):
    """Four steps of MultitaskLearner.fit: each step's loss, and every
    parameter after the last update, relative to the leaf's norm floored at
    1 (the key biases' gradients are zero in exact arithmetic, softmax being
    shift-invariant: those leaves hold rounding noise of order 1e-11)."""
    seen, jparams, result, learner = fits
    np.testing.assert_allclose(result.losses, [l for _, l in seen], rtol=STEP_RTOL)
    jleaves, tleaves = jax.tree_util.tree_leaves(jparams), txl.tree_leaves(learner.params)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        j, t = np.asarray(j), t.detach().numpy()
        assert np.linalg.norm(t - j) <= STEP_RTOL * max(np.linalg.norm(j), 1.0)


def test_predictions_after_fit_use_the_new_weights(models, vocab):
    """fit drops the engines and their device copy of the weights, so an
    engine built before training does not decode with the old ones."""
    _, _, cfg, tp = models
    learner = MultitaskLearner(cfg, vocab, params=tp, device="cpu")
    old = learner.engine("mask").params["embed"].clone()
    learner.fit(_fit_batches(vocab), epochs=1, log_fn=lambda s: None)
    new = learner.engine("mask").params["embed"]
    assert torch.equal(new, learner.params["embed"].detach())
    assert not torch.equal(new, old)


def test_port_checkpoint_loads_in_jax(tmp_path, models, vocab):
    jcfg, _, cfg, tp = models
    learner = MultitaskLearner(cfg, vocab, params=tp, device="cpu")
    learner.params = txl.tree_map(lambda t: t + 0.25, master_params(tp))
    learner.step = 23
    learner.save(str(tmp_path))
    back = jlearner.MultitaskLearner.load(str(tmp_path))
    assert back.cfg == jcfg
    jleaves = jax.tree_util.tree_leaves(back.params)
    assert len(jleaves) == len(txl.tree_leaves(learner.params))
    for j, t in zip(jleaves, txl.tree_leaves(learner.params)):
        np.testing.assert_array_equal(np.asarray(j), t.detach().numpy())


def test_jax_checkpoint_trains_in_the_port(tmp_path, models, vocab):
    jcfg, jp, cfg, _ = models
    jck.save_checkpoint(str(tmp_path), jp, jcfg, JMusicVocab.create(), step=9)
    learner = MultitaskLearner.load(str(tmp_path), device="cpu")
    assert learner.step == 9 and learner.cfg == cfg
    before = txl.tree_map(torch.Tensor.clone, learner.params)
    result = learner.fit(_fit_batches(vocab), epochs=1, log_fn=lambda s: None)
    assert learner.step == 13 and np.isfinite(result.losses).all()
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in txl.tree_leaves(learner.params))
    # every weight matrix the four tasks reach has moved
    moved = lambda a, b: not torch.equal(a, b.detach())
    assert moved(before["embed"], learner.params["embed"])
    for stack in ("encoder", "decoder"):
        for lb, la in zip(before[stack]["layers"], learner.params[stack]["layers"]):
            assert moved(lb["mha1"]["q_w"], la["mha1"]["q_w"])
    assert moved(before["decoder"]["layers"][0]["mha2"]["k_w"],
                 learner.params["decoder"]["layers"][0]["mha2"]["k_w"])


def _grads(cfg, tp, inp, **kw):
    params = master_params(tp)
    out = mt.forward(params, cfg, inp, train=True, **kw)
    loss = sum(o.logsumexp(-1).mean() for o in out.values())
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        txl.tree_leaves(params),
        torch.autograd.grad(loss, txl.tree_leaves(params), allow_unused=True))]


def _route(cfg, tp, inp, targets, flash):
    """Logits and the multi_loss gradient of every parameter through one
    route of ``mt.forward`` (window 3 at diagonal 0, dropouts off)."""
    params = master_params(tp)
    out = mt.forward(params, cfg, inp, win_size=3, win_k=0, flash_train=flash)
    loss, _ = multi_loss(out, targets, 1)
    leaves = txl.tree_leaves(params)
    return out, torch.autograd.grad(loss, leaves, allow_unused=True)


def test_flash_route_matches_the_score_path(models, vocab, jax_logits):
    """``mt.forward(flash_train=True)`` (the plain versions of the three
    flash kernels on the CPU) against ``flash_train=False`` and against
    JAX's logits, as ``tests/test_flash_train.py`` holds JAX's own two
    routes: the encoder's and decoder's blocks, the cross attention, the
    wkr slices, the (H, Dh) biases, which padding reaches which kernel and
    the blocks without a feed-forward. Logits within F32_ATOL; each
    gradient within ROUTE_GRAD_ATOL of its leaf's largest entry plus 1
    (measured: 2.3e-8, float32 on both routes)."""
    _, _, cfg, tp = models
    inp = _torch_tasks(_task_inputs(vocab))
    rng = np.random.default_rng(8)
    targets = {t: torch.from_numpy(rng.integers(0, len(vocab), (B, L))) for t in inp}
    calls = ft.flash_bidir_attention_plain.calls
    out_fl, g_fl = _route(cfg, tp, inp, targets, True)
    assert ft.flash_bidir_attention_plain.calls > calls
    out_sc, g_sc = _route(cfg, tp, inp, targets, False)
    for task in inp:
        np.testing.assert_allclose(out_fl[task].detach().numpy(), out_sc[task].detach().numpy(),
                                   atol=F32_ATOL, rtol=0, err_msg=task)
        np.testing.assert_allclose(out_fl[task].detach().numpy(), jax_logits[task],
                                   atol=F32_ATOL, rtol=0, err_msg=task)
    checked = 0
    for gf, gs in zip(g_fl, g_sc):
        assert (gf is None) == (gs is None)
        if gs is not None:
            bound = ROUTE_GRAD_ATOL * (gs.abs().max().item() + 1.0)
            assert (gf - gs).abs().max().item() <= bound
            checked += 1
    assert checked > 20


@pytest.mark.parametrize("flash", [False, True])
def test_remat_gives_the_same_gradients(models, vocab, flash):
    """Per-block recomputation redraws each block's dropout masks from the
    same seeds: the gradients are identical, bit for bit, through the score
    path and through the flash route's plain versions."""
    _, _, cfg, tp = models
    cfg = cfg.replace(**DROPOUTS)
    inp = _torch_tasks(_task_inputs(vocab))
    for a, b in zip(_grads(cfg, tp, inp, rng=7, flash_train=flash),
                    _grads(cfg, tp, inp, rng=7, flash_train=flash, remat=True)):
        assert torch.equal(a, b)


def test_dropout_is_seeded(models, vocab):
    _, _, cfg, tp = models
    cfg = cfg.replace(**DROPOUTS)
    inp = _torch_tasks(_task_inputs(vocab))
    run = lambda **kw: mt.forward(tp, cfg, inp, **kw)
    a, b, c = run(rng=11, train=True), run(rng=11, train=True), run(rng=12, train=True)
    plain, no_seed = run(), run(train=True)
    for task in a:
        assert torch.equal(a[task], b[task])
        assert not torch.equal(a[task], c[task])
        assert not torch.equal(a[task], plain[task])
        assert torch.equal(plain[task], no_seed[task])


def test_flash_train_auto_rule_never_fires_on_the_cpu(models, vocab):
    _, _, cfg, tp = models
    bf = cfg.replace(dtype="bfloat16")
    assert mt._flash_train_ok(bf, 16, 512, 512, None, "cpu") is False
    assert mt._flash_train_ok(bf, 16, 512, None, None, "cpu") is False
    assert mt._flash_train_ok(bf, 2, 128, None, True, "cpu") is True
    calls = [f.calls for f in (ft.flash_train_attention_plain, ft.flash_bidir_attention_plain,
                               ft.flash_cross_attention_plain)]
    rng = np.random.default_rng(1)
    tok = lambda: torch.from_numpy(rng.integers(4, len(vocab), (8, L)))
    mt.forward(tp, bf, {"msk": {"x": tok()}, "s2f": {"enc": tok(), "dec": tok()}})
    assert calls == [f.calls for f in (ft.flash_train_attention_plain,
                                       ft.flash_bidir_attention_plain,
                                       ft.flash_cross_attention_plain)]
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        mt.forward(tp, cfg, {"msk": {"x": tok()}}, mesh=object())
