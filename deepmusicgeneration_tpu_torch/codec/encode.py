"""Score/piano-roll → npenc encoding, fully vectorised.

Re-implements reference `core/encodings.py:179-301` without per-note
Python loops: a parsed score is converted to a dense ``chordarr`` piano roll
``(timesteps, parts, 128)`` whose cells hold note durations in steps (with
``VALTCONT`` fill for held notes), then run-length encoded into npenc rows
``[pitch, dur, instrument]`` with separator rows ``[-1, wait, -291]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..vocab import (
    MAX_NOTE_DUR,
    NOTE_RANGE,
    NOTE_SIZE,
    SAMPLE_FREQ,
    SEP_INS_VAL,
    VALTCONT,
    VALTSEP,
)


def notes2chordarr(
    part_notes: Sequence[np.ndarray],
    note_size: int = NOTE_SIZE,
    max_note_dur: Optional[int] = MAX_NOTE_DUR,
) -> np.ndarray:
    """Build the chordarr piano roll from per-part note arrays.

    ``part_notes[i]`` is an ``(n_i, 3)`` int array of ``[pitch, offset_step,
    dur_steps]`` for part *i* (already quantised at SAMPLE_FREQ). Matches
    `stream2chordarr` (core/encodings.py:179-255): notes are written in
    (offset, duration) order so later/longer notes overwrite earlier ones at
    the same cell, the onset cell holds the duration and subsequent held
    steps hold ``VALTCONT``.
    """
    n_parts = len(part_notes)
    max_step = 0
    for notes in part_notes:
        if len(notes):
            max_step = max(max_step, int((notes[:, 1] + 1).max()))
    # reference sizes the roll from the raw highest offset + 1
    score_arr = np.zeros((max_step + 1 if max_step else 1, n_parts, note_size))
    for idx, notes in enumerate(part_notes):
        if not len(notes):
            continue
        notes = np.asarray(notes, dtype=np.int64)
        order = np.lexsort((notes[:, 2], notes[:, 1]))  # sort by offset, then dur
        notes = notes[order]
        pitch, offset, dur = notes[:, 0], notes[:, 1], notes[:, 2]
        if max_note_dur is not None:
            dur = np.minimum(dur, max_note_dur)
        keep = (pitch >= 0) & (pitch < note_size) & (offset >= 0)
        pitch, offset, dur = pitch[keep], offset[keep], dur[keep]
        if not len(pitch):
            continue
        need = int((offset + dur).max()) + 1
        if need > score_arr.shape[0]:
            score_arr = np.pad(score_arr, ((0, need - score_arr.shape[0]), (0, 0), (0, 0)))
        # continuation fill first, then onsets (onset cell must win; and a
        # later note's onset at a held cell overwrites the continuation, which
        # is exactly the reference's sequential-write semantics)
        for p, o, d in zip(pitch, offset, dur):
            score_arr[o, idx, p] = d
            score_arr[o + 1:o + d, idx, p] = VALTCONT
    return score_arr


def chordarr2npenc(chordarr: np.ndarray, skip_last_rest: bool = True) -> np.ndarray:
    """Run-length encode the piano roll (core/encodings.py:257-301).

    Rows are emitted per timestep sorted high→low pitch (instrument sorting
    happens later in `sort_instruments`); a separator row ``[-1, wait, -291]``
    precedes each timestep group except the first-with-zero-wait.
    """
    chordarr = np.asarray(chordarr)
    T, I, P = chordarr.shape
    t_idx, i_idx, p_idx = np.nonzero(chordarr)
    d_val = chordarr[t_idx, i_idx, p_idx]
    # only onset cells (positive durations) within the accepted midi range
    keep = (d_val > 0) & (p_idx >= NOTE_RANGE[0]) & (p_idx < NOTE_RANGE[1])
    t_idx, i_idx, p_idx, d_val = t_idx[keep], i_idx[keep], p_idx[keep], d_val[keep]
    if len(t_idx) == 0:
        return np.empty((0, 3), dtype=np.int64)
    # order: timestep asc, pitch desc, instrument asc (stable tie-break mirrors
    # timestep2npenc's sorted(..., key=pitch, reverse=True) over (i, p) order)
    order = np.lexsort((i_idx, -p_idx, t_idx))
    t_idx, i_idx, p_idx, d_val = t_idx[order], i_idx[order], p_idx[order], d_val[order]

    # group boundaries: first row of each distinct timestep
    first_of_group = np.ones(len(t_idx), dtype=bool)
    first_of_group[1:] = t_idx[1:] != t_idx[:-1]
    group_starts = np.nonzero(first_of_group)[0]
    group_ts = t_idx[group_starts]
    # wait before each group: first group waits its own timestep; later groups
    # wait the gap to the previous group's timestep
    waits = np.empty(len(group_starts), dtype=np.int64)
    waits[0] = group_ts[0]
    waits[1:] = group_ts[1:] - group_ts[:-1]
    has_sep = waits > 0  # first group at t=0 has no separator

    n_rows = len(t_idx) + int(has_sep.sum())
    out = np.empty((n_rows, 3), dtype=np.int64)
    # destination index for each note row: original position + number of
    # separators inserted at or before its group
    seps_before_group = np.cumsum(has_sep)
    group_of_row = np.cumsum(first_of_group) - 1
    note_dst = np.arange(len(t_idx)) + seps_before_group[group_of_row]
    out[note_dst, 0] = p_idx
    out[note_dst, 1] = d_val.astype(np.int64)
    out[note_dst, 2] = i_idx
    sep_dst = (group_starts + seps_before_group)[has_sep] - 1
    out[sep_dst, 0] = VALTSEP
    out[sep_dst, 1] = waits[has_sep]
    out[sep_dst, 2] = SEP_INS_VAL

    if not skip_last_rest:
        # trailing rest: reference appends [VALTSEP, wait, -291] where wait is
        # 1 (for the last group's own step) plus any trailing empty steps
        last_group_t = group_ts[-1]
        tail_wait = T - last_group_t
        if tail_wait > 0:
            out = np.concatenate(
                [out, np.array([[VALTSEP, tail_wait, SEP_INS_VAL]], dtype=np.int64)]
            )
    return out


def part_enc(chordarr: np.ndarray, part: int) -> np.ndarray:
    """npenc of a single part (core/encodings.py:493-496)."""
    return chordarr2npenc(chordarr[:, part:part + 1, :])


def avg_tempo(npenc: np.ndarray) -> str:
    """Mean-wait tempo bucket token (core/encodings.py:498-501)."""
    sep_rows = npenc[npenc[:, 0] == VALTSEP]
    avg = sep_rows[:, 1].sum() / max(npenc.shape[0], 1)
    avg = int(round(avg / SAMPLE_FREQ))
    return "mt" + str(min(avg, 9))


def avg_pitch(npenc: np.ndarray) -> float:
    notes = npenc[npenc[:, 0] > VALTSEP]
    return float(notes[:, 0].mean()) if len(notes) else 0.0
