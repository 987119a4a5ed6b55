"""npenc → piano roll → MIDI decoding (core/encodings.py:305-393).

Vectorised inverse of :mod:`.encode`: separator rows advance the timestep
cursor by their wait value; note rows write their duration at the current
timestep in their instrument lane.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..vocab import NOTE_SIZE, VALTCONT, VALTSEP
from ..midi.score import chordarr_to_midifile
from ..midi.smf import MidiFile, render_midi_bytes, write_midi_file


def npenc_len(npenc: np.ndarray) -> int:
    """Total timesteps covered (encodings.py:321-325)."""
    if len(npenc) == 0:
        return 1
    sep = npenc[:, 0] == VALTSEP
    return int(npenc[sep, 1].sum()) + 1


def npenc2chordarr(npenc: np.ndarray, note_size: int = NOTE_SIZE) -> np.ndarray:
    """Expand npenc rows into the dense (T, I, P) roll (encodings.py:305-319)."""
    npenc = np.asarray(npenc, dtype=np.int64)
    if npenc.ndim != 2 or len(npenc) == 0:
        return np.zeros((1, 1, note_size))
    if npenc.shape[1] <= 2:
        num_instruments = 1
        ins_col = np.zeros(len(npenc), dtype=np.int64)
    else:
        num_instruments = int(npenc[:, -1].max()) if len(npenc) else 1
        num_instruments = max(num_instruments, 0)
        ins_col = npenc[:, 2]
    max_len = npenc_len(npenc)
    score_arr = np.zeros((max_len, num_instruments + 1, note_size))

    is_sep = npenc[:, 0] == VALTSEP
    is_special = npenc[:, 0] < VALTSEP
    # timestep of each row: cumulative sum of separator waits seen so far
    step = np.zeros(len(npenc), dtype=np.int64)
    step[is_sep] = npenc[is_sep, 1]
    t_of_row = np.cumsum(step)
    note_rows = ~is_sep & ~is_special
    t = t_of_row[note_rows]
    n = npenc[note_rows, 0]
    d = npenc[note_rows, 1]
    i = ins_col[note_rows]
    ok = (t < max_len) & (n >= 0) & (n < note_size) & (i >= 0) & (i <= num_instruments)
    score_arr[t[ok], i[ok], n[ok]] = d[ok]
    return score_arr


def chordarr2npenc_roundtrip_ok(chordarr: np.ndarray) -> bool:
    from .encode import chordarr2npenc
    return len(chordarr2npenc(chordarr)) > 0


def npenc2midifile(npenc: np.ndarray, bpm: float = 120.0,
                   instr_list: Optional[List[str]] = None) -> MidiFile:
    """npenc → MidiFile (npenc2stream + .write('midi') equivalent)."""
    return chordarr_to_midifile(npenc2chordarr(np.asarray(npenc)), bpm=bpm, instr_list=instr_list)


def npenc2midibytes(npenc: np.ndarray, bpm: float = 120.0,
                    instr_list: Optional[List[str]] = None) -> bytes:
    return render_midi_bytes(npenc2midifile(npenc, bpm, instr_list))


def write_npenc_midi(npenc: np.ndarray, path, bpm: float = 120.0,
                     instr_list: Optional[List[str]] = None) -> None:
    write_midi_file(npenc2midifile(npenc, bpm, instr_list), path)


# -- sanitation helpers (encodings.py:434-473) ------------------------------

def trim_chordarr_rests(arr: np.ndarray, max_rests: int = 4, sample_freq: int = 4) -> np.ndarray:
    max_sample = max_rests * sample_freq
    nonzero = (arr != 0).any(axis=(1, 2))
    if not nonzero.any():
        return arr[:0]
    first = int(nonzero.argmax())
    last = len(arr) - int(nonzero[::-1].argmax())
    start_idx = first - first % max_sample
    end_trim = (len(arr) - last) - (len(arr) - last) % max_sample
    return arr[start_idx:len(arr) - end_trim]


def shorten_chordarr_rests(arr: np.ndarray, max_rests: int = 8, sample_freq: int = 4) -> np.ndarray:
    max_sample = max_rests * sample_freq
    rest_count = 0
    result = []
    for timestep in arr:
        if (timestep == 0).all():
            rest_count += 1
        else:
            if rest_count > max_sample:
                rest_count = (rest_count % sample_freq) + max_sample
            for _ in range(rest_count):
                result.append(np.zeros(timestep.shape))
            rest_count = 0
            result.append(timestep)
    for _ in range(rest_count):
        result.append(np.zeros(arr.shape[1:]))
    return np.array(result) if result else arr[:0]


def compress_chordarr(chordarr: np.ndarray) -> np.ndarray:
    return shorten_chordarr_rests(trim_chordarr_rests(chordarr))


def remove_overlaps(chordarr: np.ndarray, separate_chords: bool = True) -> np.ndarray:
    """Separate overlapping notes into different lanes (encodings.py:412-421).

    The reference delegates to music21: with ``separate_chords`` (the
    default) it routes single notes vs chords into two parts
    (`separate_melody_chord`); otherwise ``makeVoices().voicesToParts()``
    splits time-overlapping notes within a part into voices — greedy
    first-free-voice assignment in onset order — each voice becoming its own
    part. Here the same split runs directly on the chordarr roll (onset
    cells hold durations, held steps ``VALTCONT``); lanes come back as
    ``[part0_voice0, part0_voice1, ..., part1_voice0, ...]``.
    """
    if separate_chords:
        return separate_melody_chord(chordarr)
    chordarr = np.asarray(chordarr)
    T, I, P = chordarr.shape
    lanes = []
    for i in range(I):
        voices: list = []          # (lane (T,P), first free timestep)
        for t, p in np.argwhere(chordarr[:, i] > 0):   # time-major order
            d = int(chordarr[t, i, p])
            v = next((k for k, (_, free) in enumerate(voices) if free <= t),
                     None)
            if v is None:
                voices.append([np.zeros((T, P)), 0])
                v = len(voices) - 1
            lane = voices[v][0]
            lane[t, p] = d
            lane[t + 1:t + d, p] = VALTCONT
            voices[v][1] = t + d
        if not voices:              # keep an empty lane so parts stay indexed
            voices = [[np.zeros((T, P)), 0]]
        lanes.extend(lane for lane, _ in voices)
    return np.stack(lanes, axis=1)


def separate_melody_chord(chordarr: np.ndarray) -> np.ndarray:
    """Split each lane into melody vs chord lanes (encodings.py:412-430).

    The reference's music21 version puts single Notes in one part and Chords
    in another; here a timestep with one onset in a lane is melody, with
    several onsets it is a chord. Returns a roll with 2× the lanes:
    [melody_0, chord_0, melody_1, chord_1, ...].
    """
    chordarr = np.asarray(chordarr)
    T, I, P = chordarr.shape
    out = np.zeros((T, 2 * I, P))
    onsets = chordarr > 0
    n_onsets = onsets.sum(axis=2)  # (T, I)
    for i in range(I):
        mono = n_onsets[:, i] == 1
        poly = n_onsets[:, i] > 1
        out[mono, 2 * i] = chordarr[mono, i]
        out[poly, 2 * i + 1] = chordarr[poly, i]
        # continuation markers follow their onset lane
        cont = chordarr[:, i] < 0
        out[:, 2 * i][cont & (out[:, 2 * i] == 0)] = np.where(
            cont, chordarr[:, i], 0)[cont & (out[:, 2 * i] == 0)]
    return out


def chordarr_combine_parts(parts) -> np.ndarray:
    """Concatenate per-part rolls on the lane axis (encodings.py:483-487)."""
    max_ts = max(p.shape[0] for p in parts)
    padded = [pad_part_to(p, max_ts) for p in parts]
    return np.concatenate(padded, axis=1)


def pad_part_to(p: np.ndarray, target_size: int) -> np.ndarray:
    """Zero-pad a roll to ``target_size`` timesteps (encodings.py:489-491)."""
    return np.pad(p, ((0, target_size - p.shape[0]), (0, 0), (0, 0)), "constant")


def stream2npenc_parts(chordarr: np.ndarray, sort_pitch: bool = True):
    """Per-part npencs, highest average pitch first (encodings.py:477-481)."""
    from .encode import avg_pitch, part_enc
    parts = [part_enc(chordarr, i) for i in range(chordarr.shape[1])]
    parts = [p for p in parts if len(p)]
    if sort_pitch:
        parts = sorted(parts, key=avg_pitch, reverse=True)
    return parts
