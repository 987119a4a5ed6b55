"""Encoding validation (core/encodings.py:397-409, core/data_processing.py).

These checks formalise the reference's data-quality gates: minimum note
count, duration cap, piano pitch range, and minimum distinct instruments.
"""

from __future__ import annotations

import numpy as np

from ..vocab import DUR_SIZE, PIANO_RANGE, VALTSEP, MusicVocab


def is_valid_npenc(npenc: np.ndarray, note_range=PIANO_RANGE, max_dur: int = DUR_SIZE,
                   min_notes: int = 32, input_path=None, verbose: bool = False) -> bool:
    npenc = np.asarray(npenc)
    if len(npenc) < min_notes:
        if verbose:
            print("Sequence too short:", len(npenc), input_path)
        return False
    if (npenc[:, 1] >= max_dur).any():
        if verbose:
            print(f"npenc exceeds max {max_dur} duration:", npenc[:, 1].max(), input_path)
        return False
    notes = npenc[:, 0]
    if ((notes > VALTSEP) & ((notes < note_range[0]) | (notes >= note_range[1]))).any():
        if verbose:
            print(f"npenc out of piano note range {note_range}:", input_path)
        return False
    return True


def num_distinct_instruments(idxenc: np.ndarray, vocab: MusicVocab) -> int:
    lo, hi = vocab.ins_range
    ins = idxenc[(idxenc >= lo) & (idxenc < hi)]
    return len(np.unique(ins))


def check_valid_ins(idxenc: np.ndarray, vocab: MusicVocab, num_ins_thresh: int = 2) -> bool:
    """Require ≥ num_ins_thresh distinct instrument classes
    (deep_music_genre.py:657-673)."""
    return num_distinct_instruments(idxenc, vocab) >= num_ins_thresh


def roundtrip_ok(idxenc: np.ndarray, vocab: MusicVocab) -> bool:
    """idxenc → text → ids round trip sanity (data_processing.py:33-47)."""
    try:
        text = vocab.textify(idxenc)
        back = vocab.numericalize(text.split(" "))
        return list(back) == [int(x) for x in idxenc]
    except Exception:
        return False
