"""``chip_smoke.py``'s check of a generated continuation on the CPU, at the
demo checkpoint's widths: ``check_continuation`` passes a row that
``generate_batch`` draws through the all-rows step (its plain version here)
and, with the codec's data gate on, fails one with a note outside the piano
range and names that pitch in its message. ``generate_batch(forced=...)``
replays a row and says which tokens its filter keeps, and
``check_drawn_row`` passes a note outside the piano range only where that
replay kept it."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import PIANO_RANGE

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
