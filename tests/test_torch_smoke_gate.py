"""``chip_smoke.py``'s checks on the CPU. The stack phase's gate
(``stack_fixed_path``) at small_test_config: it passes the float32 plain
step and refuses a step whose logits are wrong and one whose slot write is.
The check of a generated continuation, at the demo checkpoint's widths: ``check_continuation`` passes a row that
``generate_batch`` draws through the all-rows step (its plain version here)
and, with the codec's data gate on, fails one with a note outside the piano
range and names that pitch in its message. ``generate_batch(forced=...)``
replays a row and says which tokens its filter keeps, and
``check_drawn_row`` passes a note outside the piano range only where that
replay kept it."""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.models.config import small_test_config
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import PIANO_RANGE, MusicVocab

DEMO = cs.CKPT.parent / "demo_genre_model"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """In the parallel test run, torch's intra-op threads only contend with
    the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def row():
    """A prompt of the batch phase and its 24-token continuation through
    slab_ar_w8 (the auto kernel at B % 8 == 0), with the vocab."""
    learner = MusicLearner.load(str(DEMO), device=torch.device("cpu"))
    item = cs.batch_prompts(learner.vocab, 2, 1)[0]
    toks, lengths = learner.engine.generate_batch([item.data], n_words=24, seed=2,
                                                  decode_kernel="slab_ar_w8", **cs.GEN_KW)
    return item, np.array(toks[0][: lengths[0]]), learner.vocab


def test_a_generated_row_passes_the_checks(row):
    item, pred, vocab = row
    checks = cs.check_continuation(item, pred, vocab)
    assert checks["valid_npenc"] and checks["grammar_violations"] == 0


@pytest.mark.parametrize("pitch", [PIANO_RANGE[0] - 2, PIANO_RANGE[0] - 1, PIANO_RANGE[1],
                                   PIANO_RANGE[1] + 2])
def test_a_note_outside_the_piano_range_fails_the_data_gate(row, pitch):
    """The row's first note moved to ``pitch``: the gate raises and names the
    pitch; without the data gate (``piano_range=False``) the row passes."""
    item, pred, vocab = row
    lo, hi = vocab.note_range
    notes = np.nonzero((pred >= lo) & (pred < hi))[0]
    assert len(notes) > 0
    pred = pred.copy()
    pred[notes[0]] = vocab.stoi[f"n{pitch}"]
    with pytest.raises(AssertionError, match=rf"outside the piano range .*: \[{pitch}\]"):
        cs.check_continuation(item, pred, vocab)
    assert not cs.check_continuation(item, pred, vocab, piano_range=False)["valid_npenc"]


def _replay(vocab_engine, item, pred, n_words=24, kernel="slab_ar_w8", **kw):
    forced = np.full((1, n_words), vocab_engine.vocab.pad_idx, dtype=np.int32)
    forced[0, :len(pred)] = pred
    kept, lengths = vocab_engine.generate_batch([item.data], n_words=n_words,
                                                decode_kernel=kernel, forced=forced,
                                                **dict(cs.GEN_KW, **kw))
    return kept[0], int(lengths[0])


@pytest.fixture(scope="module")
def engine():
    return MusicLearner.load(str(DEMO), device=torch.device("cpu")).engine


def test_a_replay_keeps_every_token_the_step_drew(row, engine):
    """The same step and settings replayed on the row it drew keep every
    drawn token, and the replay stops where the draw did."""
    item, pred, _ = row
    kept, length = _replay(engine, item, pred)
    assert length == len(pred)
    assert kept[:length].all()


def test_a_replay_with_a_narrower_filter_drops_draws(row, engine):
    """The control: replayed with top_k 1 (the argmax alone), the same
    tokens are not all kept."""
    item, pred, _ = row
    kept, _ = _replay(engine, item, pred, top_k=1)
    assert not kept[:len(pred)].all()


@pytest.mark.parametrize("pitch", [PIANO_RANGE[0] - 2, PIANO_RANGE[1] + 2])
def test_a_drawn_note_outside_the_piano_range_is_held_to_the_replay(row, pitch):
    """The row's first note moved to ``pitch``: ``check_drawn_row`` passes it
    where the replay kept it, fails it where it did not, and still fails a
    grammar fault elsewhere in the row."""
    item, pred, vocab = row
    lo, hi = vocab.note_range
    notes = np.nonzero((pred >= lo) & (pred < hi))[0]
    pred = pred.copy()
    pred[notes[0]] = vocab.stoi[f"n{pitch}"]
    kept = np.ones(len(pred), dtype=bool)
    assert cs.check_drawn_row(item, pred, kept, vocab)["outside_kept"] == [
        f"step {notes[0]} n{pitch}"]
    kept[notes[0]] = False
    with pytest.raises(AssertionError, match=rf"do(es)? not keep .*step {notes[0]} n{pitch}"):
        cs.check_drawn_row(item, pred, kept, vocab)
    kept[notes[0]] = True
    pred[notes[0] + 1] = vocab.stoi["n60"]          # a note where a duration must be
    with pytest.raises(AssertionError, match="failed its checks"):
        cs.check_drawn_row(item, pred, kept, vocab)


def test_the_plain_step_does_not_keep_a_note_it_would_not_draw(row, engine):
    """End to end: the row's first note moved below the piano range, replayed
    on the plain step (xla) with the batch phase's settings. The trained
    model's filter does not keep that note there, so the gate fails."""
    item, pred, vocab = row
    lo, hi = vocab.note_range
    notes = np.nonzero((pred >= lo) & (pred < hi))[0]
    pred = pred.copy()
    pred[notes[0]] = vocab.stoi[f"n{PIANO_RANGE[0] - 2}"]
    kept, _ = _replay(engine, item, pred, kernel="xla")
    assert not kept[notes[0]]
    with pytest.raises(AssertionError, match="does not keep"):
        cs.check_drawn_row(item, pred, kept, vocab)


# The stack phase's gate (chip_smoke.stack_fixed_path) on the CPU, at
# small_test_config's widths: 12 steps of row 10's path driven by the float64
# plain step, the step under test and the float32 plain step on its caches.
GATE_STEPS = 12


@pytest.fixture(scope="module")
def small_learner():
    """small_test_config with weights at a trained model's scale, so that the
    logits and the attention respond to a fault as the flagship's do:
    init_txl's N(0, 0.02) draws times 10 for the products, u and v, and the
    embedding scaled to rows of the 41M checkpoint's norm (about 1.02)."""
    vocab = MusicVocab.create()
    cfg = small_test_config(len(vocab))
    p = txl.init_txl(cfg, torch.Generator().manual_seed(3))
    p["embed"] = p["embed"] * (1.02 / (0.02 * math.sqrt(cfg.d_model)))
    p["u"], p["v"] = p["u"] * 10.0, p["v"] * 10.0
    for lp in p["layers"]:
        for k in ("qkv_w", "r_w", "out_w", "ff1_w", "ff2_w"):
            lp[k] = lp[k] * 10.0
    return MusicLearner(cfg, vocab, params=p, device=torch.device("cpu"))


def _wkr_one_column_off(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr, M):
    """A faulty step: the relative-position table read one column off."""
    return fd.stack_plain(stacked, cfg, h_in, torch.roll(wkr_t, 1, -1), kt, vc, blocked, ptr)


def _slot_one_back(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr, M):
    """A faulty step: layer 1's fresh K/V written at ptr - 1, slot ptr left
    as it was; h_out is the float32 plain step's."""
    old_k, old_v = kt[1, ..., ptr].clone(), vc[1, :, :, ptr].clone()
    out = fd.stack_plain(stacked, cfg, h_in, wkr_t, kt, vc, blocked, ptr)
    back = (ptr - 1) % M
    kt[1, ..., back], vc[1, :, :, back] = kt[1, ..., ptr], vc[1, :, :, ptr]
    kt[1, ..., ptr], vc[1, :, :, ptr] = old_k, old_v
    return out


@pytest.mark.parametrize("B", [1, 4])
def test_stack_gate_passes_the_float32_plain_step(small_learner, B):
    """The wrappers on CPU tensors (the float32 plain step) pass the gate at
    every step, well inside its logit and slot bounds; the exact step's
    shares are reported."""
    items = cs.batch_prompts(small_learner.vocab, 0, B)
    cs.reset_launches()
    res = cs.stack_fixed_path(small_learner, items, GATE_STEPS)
    assert cs.launches() == cs.only()                       # CPU: the plain step
    assert res["failures"] == []
    assert res["logit_ratio"] < 0.5 and res["slot_ratio"] < 0.5
    assert res["tokens"].shape == (GATE_STEPS, B)
    assert all(0 < share < 1 for share in res["exact"].values())


@pytest.mark.parametrize("B", [1, 4])
def test_stack_gate_refuses_a_step_with_wrong_logits(small_learner, B):
    """The relative table read one column off: the largest |dlogit| leaves
    its bound (STACK_F64_ATOL + PLAIN_K x the float32 plain step's) by a
    factor of at least 4 (4.7 at B = 1, 11.9 at B = 4), at every step."""
    items = cs.batch_prompts(small_learner.vocab, 0, B)
    res = cs.stack_fixed_path(small_learner, items, GATE_STEPS, _wkr_one_column_off)
    assert res["logit_ratio"] >= 4.0
    assert len(res["failures"]) == GATE_STEPS
    assert all("|dlogit|" in f for f in res["failures"])


@pytest.mark.parametrize("B", [1, 4])
def test_stack_gate_refuses_a_wrong_slot_write(small_learner, B):
    """Layer 1's slot written at ptr - 1: the logits are the float32 plain
    step's and pass, but the written slot leaves its bound (SLOT_MAX_STEP +
    PLAIN_K x the float32 plain step's) by a factor of at least 100 (120 at
    both B) and another slot's bytes changed, at every step."""
    items = cs.batch_prompts(small_learner.vocab, 0, B)
    res = cs.stack_fixed_path(small_learner, items, GATE_STEPS, _slot_one_back)
    assert res["logit_ratio"] < 1.0
    assert res["slot_ratio"] >= 100.0
    assert len(res["failures"]) == GATE_STEPS
    assert all("written slot" in f and "another slot" in f for f in res["failures"])
