"""Seq2seq melody / accompaniment harmonization.

Mirrors the JAX package's ``tasks/harmonize.py`` (the reference's
``s2s_predict_from_midi``, deep_music_remix.py:2708-2721 and
deep_music_s2s.py:2896-2926): split the MIDI into two single-instrument
tracks, encode the source once, decode its counterpart, and merge both
tracks back into one; and ``nw_predict_from_midi``, next-word continuation
through the multitask decoder.
"""

from __future__ import annotations

from typing import Optional

from ..codec.item import MultitrackItem, MusicItem
from ..midi.score import is_empty_midi
from ..train.learner import MultitaskLearner


def s2s_predict_from_midi(
    learner: MultitaskLearner,
    midi=None,
    n_words: int = 200,
    temperatures=(1.0, 1.0),
    top_k: int = 24,
    top_p: float = 0.7,
    seed_len: Optional[float] = None,
    pred_melody: bool = True,
    first_ins: str = "Piano",
    second_ins: str = "Bass",
    seed: int = 0,
    **kwargs,
) -> MultitrackItem:
    """Other keyword arguments are accepted and not read, as in the JAX
    package."""
    multitrack = MultitrackItem.from_file(midi, learner.vocab, first_ins=first_ins,
                                          second_ins=second_ins)
    first, second = multitrack.first_instrument, multitrack.second_instrument
    inp, targ = (first, second) if pred_melody else (second, first)
    if seed_len is not None:
        targ = targ.trim_to_beat(seed_len)
    targ = targ.remove_eos()
    pred = learner.predict_s2s(inp, targ, n_words=n_words, temperatures=temperatures,
                               top_k=top_k, top_p=top_p, seed=seed)
    parts = (pred, inp) if pred_melody else (inp, pred)
    return MultitrackItem(parts[0], parts[1], learner.vocab)


def nw_predict_from_midi(learner: MultitaskLearner, midi=None, n_words: int = 400,
                         temperatures=(1.0, 1.0), top_k: int = 30, top_p: float = 0.6,
                         seed_len: Optional[float] = None, seed: int = 0,
                         **kwargs) -> MusicItem:
    """nw_predict_from_midi contract (deep_music_remix.py:2701-2707)."""
    vocab = learner.vocab
    item = (MusicItem.from_file(midi, vocab) if not is_empty_midi(midi)
            else MusicItem.empty(vocab))
    if seed_len is not None:
        item = item.trim_to_beat(seed_len)
    _, full = learner.predict_nw(item, n_words=n_words, temperatures=temperatures,
                                 top_k=top_k, top_p=top_p, seed=seed)
    return full
