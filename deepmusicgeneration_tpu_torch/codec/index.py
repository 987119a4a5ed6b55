"""npenc ↔ idxenc conversion, instrument sorting and beat positions.

Vectorised re-implementation of reference `core/primitives.py:148-395`.
The npenc representation is an ``(N, 3)`` int array of rows
``[pitch, duration, instrument]`` where separator rows are
``[-1, wait_steps, -291]`` (see ``vocab.SEP_INS_VAL``); idxenc is the flat
token-id stream fed to the models.

Everything here is pure numpy with no Python-per-token loops, so a batch of
files can be tokenized at host-data-pipeline throughput.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, Optional

import numpy as np

from ..vocab import (
    ACCEP_INS,
    BOS,
    EOS,
    NOTE_SIZE,
    SAMPLE_FREQ,
    SEP_INS_VAL,
    VALTSEP,
    MusicVocab,
    genre_prefix_token,
)


class SEQType(Enum):
    Mask = 1
    Sentence = 2
    Melody = 3
    Chords = 4
    Empty = 5
    Genre = 6


def seq_prefix(seq_type: SEQType, vocab: MusicVocab, genre: Optional[str] = None) -> np.ndarray:
    """Start-of-sequence prefix ``[start_token, xxpad]`` (primitives.py:219-234)."""
    if seq_type == SEQType.Empty:
        return np.empty(0, dtype=np.int64)
    start_token = vocab.bos_idx
    if seq_type == SEQType.Genre and genre is not None:
        start_token = vocab.stoi[genre_prefix_token(genre)]
    return np.array([start_token, vocab.pad_idx], dtype=np.int64)


def npins2vocabins(ins_col: np.ndarray, ins: Optional[Dict[int, str]]) -> np.ndarray:
    """Map raw part indices in the instrument column to ACCEP_INS class ids.

    Vectorised version of `core/primitives.py:159-170`: part indices found in
    ``ins`` map to their class id (unknown class names fall back to Piano);
    separator rows (``SEP_INS_VAL``) pass through unchanged; any other value is
    an error in the upstream encoder.
    """
    if ins is None:
        return ins_col
    out = ins_col.copy()
    handled = ins_col == SEP_INS_VAL
    for part_idx, name in ins.items():
        sel = ins_col == part_idx
        out[sel] = ACCEP_INS.get(name, ACCEP_INS["Piano"])
        handled |= sel
    if not handled.all():
        bad = np.unique(ins_col[~handled])
        raise ValueError(f"instrument column values {bad} not present in ins map {ins}")
    return out


def npenc2idxenc(
    t: np.ndarray,
    vocab: MusicVocab,
    ins: Optional[Dict[int, str]] = None,
    genre: Optional[str] = None,
    seq_type: SEQType = SEQType.Sentence,
    add_eos: bool = True,
) -> np.ndarray:
    """Flatten an (N, 3) npenc into token ids (primitives.py:173-217).

    Column offsets: pitch + note_range[0], duration + dur_range[0],
    instrument + ins_range[0]. Separator rows land exactly on
    ``[xxsep, d<wait>, xxni]`` because of the -291 convention.
    """
    t = np.asarray(t, dtype=np.int64)
    if t.ndim != 2 or t.shape[1] not in (2, 3):
        raise ValueError(f"npenc must be (N, 2|3), got {t.shape}")
    t = t.copy()
    t[:, 0] += vocab.note_range[0]
    t[:, 1] += vocab.dur_range[0]
    if t.shape[1] == 3:
        t[:, 2] = npins2vocabins(t[:, 2], ins)
        t[:, 2] += vocab.ins_range[0]
    if genre is not None:
        seq_type = SEQType.Genre
    prefix = seq_prefix(seq_type, vocab, genre)
    suffix = (
        np.array([vocab.eos_idx], dtype=np.int64)
        if add_eos
        else np.empty(0, dtype=np.int64)
    )
    return np.concatenate([prefix, t.reshape(-1), suffix])


def to_valid_idxenc(t: np.ndarray, valid_range) -> np.ndarray:
    """Keep only ids inside ``valid_range`` (primitives.py:281-287)."""
    lo, hi = valid_range
    return t[(t >= lo) & (t < hi)]


def to_valid_npenc(t: np.ndarray) -> np.ndarray:
    """Truncate at the first ungrammatical row (primitives.py:289-299)."""
    if len(t) == 0:
        return t
    is_bad_note = (t[:, 0] < VALTSEP) | (t[:, 0] >= NOTE_SIZE)
    invalid_note_idx = int(is_bad_note.argmax()) if is_bad_note.any() else 0
    is_bad_dur = t[:, 1] < 0
    invalid_dur_idx = int(is_bad_dur.argmax()) if is_bad_dur.any() else 0
    invalid_idx = max(invalid_dur_idx, invalid_note_idx)
    if invalid_idx > 0:
        if invalid_note_idx > 0 and invalid_dur_idx > 0:
            invalid_idx = min(invalid_dur_idx, invalid_note_idx)
        return t[:invalid_idx]
    return t


def idxenc2npenc(t: np.ndarray, vocab: MusicVocab, validate: bool = True) -> np.ndarray:
    """Invert `npenc2idxenc` (primitives.py:238-279).

    Filters to the npenc id range, truncates after the last instrument-class
    token (so trailing partial triplets are dropped), reshapes to (N, 3) and
    removes the vocabulary offsets.
    """
    t = np.asarray(t, dtype=np.int64)
    if validate:
        t = to_valid_idxenc(t, vocab.npenc_range)
    ins_lo, ins_hi = vocab.ins_range
    is_ins = (t == vocab.ni_idx) | ((t >= ins_lo) & (t < ins_hi))
    if not is_ins.any():
        return np.empty((0, 3), dtype=np.int64)
    last_ins = int(np.nonzero(is_ins)[0][-1])
    t = t[: last_ins + 1]
    if len(t) % 3 != 0:
        # A malformed stream (reference raises on reshape); drop the
        # ungrammatical head so decoding degrades instead of crashing.
        t = t[len(t) % 3:]
    t = t.reshape(-1, 3).copy()
    if t.shape[0] == 0:
        return t
    t[:, 0] -= vocab.note_range[0]
    t[:, 1] -= vocab.dur_range[0]
    t[:, 2] -= vocab.ins_range[0]
    if validate:
        t = to_valid_npenc(t)
    return t


def sort_instruments(npenc: np.ndarray, vocab: MusicVocab = None) -> np.ndarray:
    """Stable-sort note rows by instrument id within each separator group.

    Equivalent to `core/primitives.py:301-345` but as one vectorised lexsort:
    rows are keyed by (group index, instrument id) with a stable sort, which
    preserves the high→low pitch order the encoder produced within each
    instrument. Separator positions are unchanged by construction.
    """
    npenc = np.asarray(npenc)
    if len(npenc) == 0:
        return npenc
    is_sep = npenc[:, 0] == VALTSEP
    # Group id increments at every separator row, so a separator carries the id
    # of the group it opens. Within a group the separator sorts first anyway:
    # its instrument column is SEP_INS_VAL == -291, below every class id.
    # np.lexsort is stable, so equal-instrument notes keep the encoder's
    # high→low pitch order. (The reference's Python version has an off-by-one
    # that rewrites the final separator row with a stale copy and crashes on
    # single-separator inputs — primitives.py:325-333; this implementation
    # keeps every separator row intact, which is the intended behaviour.)
    group = np.cumsum(is_sep)
    order = np.lexsort((npenc[:, 2], group))
    out = npenc[order]
    assert (out[:, 0] == VALTSEP).nonzero()[0].tolist() == is_sep.nonzero()[0].tolist()
    return out


def position_enc(idxenc: np.ndarray, vocab: MusicVocab) -> np.ndarray:
    """Cumulative beat-step position per token (primitives.py:347-385).

    Each ``xxsep`` is followed by a duration token giving the wait in steps;
    that wait is scattered at ``sep+3`` (past the trailing ``xxni``) and
    cumsummed, so every token carries the absolute step at which it occurs.
    """
    idxenc = np.asarray(idxenc, dtype=np.int64)
    sep_idxs = np.nonzero(idxenc == vocab.sep_idx)[0]
    sep_idxs = sep_idxs[sep_idxs + 2 < idxenc.shape[0]]
    dur_vals = idxenc[sep_idxs + 1].copy()
    dur_vals[dur_vals == vocab.mask_idx] = vocab.dur_range[0]
    dur_vals -= vocab.dur_range[0]
    posenc = np.zeros_like(idxenc)
    if len(sep_idxs):
        if len(idxenc) > sep_idxs[-1] + 3:
            posenc[sep_idxs + 3] = dur_vals
        else:
            posenc[sep_idxs[:-1] + 3] = dur_vals[:-1]
    return posenc.cumsum()


def find_beat(pos: np.ndarray, beat: float, sample_freq: int = SAMPLE_FREQ, side: str = "left") -> int:
    return int(np.searchsorted(pos, beat * sample_freq, side=side))


def beat2index(idxenc: np.ndarray, pos: np.ndarray, vocab: MusicVocab, beat: float,
               include_last_sep: bool = False) -> int:
    """Token index of a beat boundary (primitives.py:387-392)."""
    cutoff = find_beat(pos, beat)
    if cutoff < 2:
        return 2  # always keep the [start, pad] prefix
    if len(idxenc) < 2 or include_last_sep:
        return cutoff
    if idxenc[cutoff - 2] == vocab.sep_idx:
        return cutoff - 2
    return cutoff
