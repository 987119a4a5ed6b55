"""Genre-conditioned generation task (the app's main entry point).

Mirrors `predict_from_midi` (deep_music_genre.py:1975-1982) and the
`predictNwGenreModel` pipeline (app_utils.py:90-144): seed from MIDI, trim to
a beat cutoff, set/strip the genre prefix, strip a trailing EOS, map UI
instrument names to tokenizer classes, generate with per-token-type
temperatures, write MIDI.
"""

from __future__ import annotations

from typing import List, Optional

from ..codec.item import MusicItem
from ..midi.score import is_empty_midi
from ..train.learner import MusicLearner
from ..vocab import BOS, genre_prefix_token

# UI instrument labels → ACCEP_INS class names (app_utils.py:128-137)
UI_INS_MAP = {
    "Flute": "WoodwindInstrument",
    "Brass": "BrassInstrument",
    "Violin": "StringInstrument",
}


def normalize_allowed_ins(allowed_ins: Optional[List[str]]) -> Optional[List[str]]:
    if not allowed_ins:
        return None
    return [UI_INS_MAP.get(name, name) for name in allowed_ins]


def predict_from_midi(learner: MusicLearner, midi=None, n_words: int = 400,
                      temperatures=(1.0, 1.0, 1.0), top_k: int = 30,
                      top_p: float = 0.6, seed_len: Optional[float] = None,
                      **kwargs) -> MusicItem:
    vocab = learner.vocab
    seed = (MusicItem.from_file(midi, vocab) if not is_empty_midi(midi)
            else MusicItem.empty(vocab))
    if seed_len is not None:
        seed = seed.trim_to_beat(seed_len)
    _, full = learner.predict(seed, n_words=n_words, temperatures=temperatures,
                              top_k=top_k, top_p=top_p, **kwargs)
    return full


def predict_nw_genre(
    learner: MusicLearner,
    mid_file,
    genre: str = " POP ",
    temperature_notes: float = 1.8,
    temperature_duration: float = 1.8,
    temperature_ins: float = 1.0,
    top_p: float = 0.3,
    max_len: int = 512,
    cutoff_beat: float = 32,
    mem_len: int = 512,
    allowed_ins: Optional[List[str]] = None,
    output_bpm: float = 120,
    output_path: Optional[str] = None,
    seed: int = 0,
    greedy: bool = False,
) -> MusicItem:
    """predictNwGenreModel contract (app_utils.py:90-144).

    Note: matching the reference, the engine is invoked with top_k=30 and
    top_p=0.65 regardless of the ``top_p`` slider (app_utils.py:139-140).
    """
    vocab = learner.vocab
    item = MusicItem.from_file(mid_file, vocab)
    seed_item = item.trim_to_beat(cutoff_beat)
    tok = genre_prefix_token(genre)
    seed_item = seed_item.set_genre(genre if tok != BOS else None)
    seed_item = seed_item.remove_eos()

    allowed = normalize_allowed_ins(allowed_ins)
    _, full = learner.predict(
        seed_item, n_words=max_len,
        temperatures=(temperature_notes, temperature_duration, temperature_ins),
        min_bars=12, top_k=30, top_p=0.65, allowed_ins=allowed,
        mem_len=mem_len, seed=seed, greedy=greedy)
    if output_path:
        full.write_midi(output_path, bpm=output_bpm)
    return full
