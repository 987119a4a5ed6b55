"""Mask-infill remix task.

Mirrors the JAX package's ``tasks/remix.py`` (the reference's
``predictMaskModel``, app_utils.py:159-215, and ``mask_predict_from_midi``,
deep_music_remix.py:2723-2730): choose a proportion of note (or duration)
token positions, replace them with ``xxmask``, and let the bidirectional
encoder fill them again.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..codec.item import MusicItem
from ..train.learner import MultitaskLearner
from ..vocab import BOS, genre_prefix_token


def predict_mask_remix(
    learner: MultitaskLearner,
    mid_file,
    genre: str = " POP ",
    temperature_notes: float = 1.0,
    temperature_duration: float = 1.0,
    top_p: float = 0.3,
    cutoff_beat: float = 32,
    output_bpm: float = 120,
    pred_type: str = "notes",
    mask_proportion: float = 0.6,
    output_path: Optional[str] = None,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> MusicItem:
    """predictMaskModel contract. As in the reference, 'notes' uses the
    given temperatures with the engine defaults top_k 20 / top_p 0.8, and
    'duration' uses temperatures (0.8, 0.8) with top_k 40 / top_p 0.6; the
    ``top_p`` argument is not read (app_utils.py:204-211)."""
    vocab = learner.vocab
    rng = rng or np.random.default_rng(seed)
    item = MusicItem.from_file(mid_file, vocab)
    seed_item = item.trim_to_beat(cutoff_beat)
    seed_item = seed_item.set_genre(genre if genre_prefix_token(genre) != BOS else None)
    seed_item = seed_item.remove_eos()

    data = seed_item.data.copy()
    lo, hi = vocab.note_range if pred_type == "notes" else vocab.dur_range
    candidates = np.nonzero((data >= lo) & (data < hi))[0]
    n_mask = int(len(candidates) * mask_proportion)
    sel = rng.choice(candidates, n_mask, replace=False) if n_mask else []
    data[sel] = vocab.mask_idx
    masked = MusicItem(data, vocab)

    if pred_type == "notes":
        pred = learner.predict_mask(
            masked, temperatures=(temperature_notes, temperature_duration), seed=seed)
    else:
        pred = learner.predict_mask(masked, temperatures=(0.8, 0.8), top_k=40, top_p=0.6,
                                    seed=seed)
    if output_path:
        pred.write_midi(output_path, bpm=output_bpm)
    return pred


def mask_predict_from_midi(learner: MultitaskLearner, midi=None, predict_notes: bool = True,
                           temperatures=(1.0, 1.0), top_k: int = 30, top_p: float = 0.7,
                           section=None, seed: int = 0, **kwargs) -> MusicItem:
    """mask_predict_from_midi contract (deep_music_remix.py:2723-2730)."""
    item = MusicItem.from_file(midi, learner.vocab)
    masked = item.mask_pitch(section) if predict_notes else item.mask_duration(section)
    return learner.predict_mask(masked, temperatures=temperatures, top_k=top_k,
                                top_p=top_p, seed=seed)
