"""MIDI ⇄ score-level representation with instrument classification.

Replaces the reference's music21 layer (`core/encodings.py:88-255,305-393`)
with a direct SMF-based pipeline. A :class:`Score` is a list of parts, each a
quantised ``(n, 3)`` int array of ``[pitch, offset_step, dur_step]`` rows at
``SAMPLE_FREQ`` steps per quarter note, plus the instrument-class mapping the
tokenizer needs.

Instrument classification reproduces the reference's music21 class-hierarchy
heuristics (`core/encodings.py:202-235`) via a General-MIDI program table:
keyboards → Piano, guitars → Guitar, bass guitars → Bass, winds → Woodwind,
brass → Brass, bowed/plucked strings → String, unknown/synth → Misc,
percussion & voices → rejected. The table is derived from music21's GM
mapping; divergences only affect exotic programs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..vocab import ACCEP_INS, ACCEP_INS_REV, SAMPLE_FREQ
from .smf import MidiEvent, MidiFile, MidiTrack, parse_midi_bytes, parse_midi_file

# ---------------------------------------------------------------------------
# GM program → reference instrument class (None = rejected part)
# ---------------------------------------------------------------------------

PIANO_TYPES = list(range(24)) + list(range(80, 96))     # encodings.py:5
PLUCK_TYPES = list(range(24, 40)) + list(range(104, 112))
BRIGHT_TYPES = list(range(40, 80))

_GM_CLASS: List[Optional[str]] = [None] * 128


def _fill(rng, name):
    for p in rng:
        _GM_CLASS[p] = name


_fill(range(0, 9), "Piano")            # pianos, chromatic keys, celesta
_GM_CLASS[9] = None                    # glockenspiel (pitched percussion)
_GM_CLASS[10] = "Misc"                 # music box (no music21 class)
_fill(range(11, 15), None)             # vibes/marimba/xylo/bells → percussion
_GM_CLASS[15] = "StringInstrument"     # dulcimer
_fill(range(16, 22), "Piano")          # organs, accordion (KeyboardInstrument)
_GM_CLASS[22] = "WoodwindInstrument"   # harmonica
_GM_CLASS[23] = "Piano"                # tango accordion
_fill(range(24, 32), "Guitar")
_fill(range(32, 40), "Bass")           # bass guitars ("Guitar" class + Bass name)
_fill(range(40, 47), "StringInstrument")
_GM_CLASS[47] = None                   # timpani
_fill(range(48, 52), "StringInstrument")  # string ensembles
_fill(range(52, 55), None)             # voices (Vocalist → not accepted)
_GM_CLASS[55] = "Misc"                 # orchestra hit
_fill(range(56, 64), "BrassInstrument")
_fill(range(64, 80), "WoodwindInstrument")
_fill(range(80, 104), "Misc")          # synth leads/pads/fx (unmapped → Misc)
_fill(range(104, 108), "StringInstrument")  # sitar/banjo/shamisen/koto
_GM_CLASS[108] = "Misc"                # kalimba
_GM_CLASS[109] = "WoodwindInstrument"  # bagpipe
_GM_CLASS[110] = "StringInstrument"    # fiddle
_GM_CLASS[111] = "WoodwindInstrument"  # shanai
_fill(range(112, 120), None)           # percussive
_fill(range(120, 128), "Misc")         # sound effects


def classify_program(program: Optional[int], channel: int = 0) -> Optional[str]:
    """Instrument class for a (program, channel) pair; None = reject part."""
    if channel == 9:
        return None  # GM percussion channel
    if program is None:
        return "Misc"  # instrument with no name → Misc (encodings.py:234-236)
    if 0 <= program < 128:
        return _GM_CLASS[program]
    return "Misc"


# Decode-side class → GM program (chordarr2stream / partarr2stream,
# encodings.py:343-367: Piano, AcousticBass, AcousticGuitar, TenorSaxophone,
# Trumpet, Violin)
CLASS_TO_PROGRAM = {
    "Piano": 0,
    "Guitar": 24,
    "Bass": 32,
    "WoodwindInstrument": 66,
    "BrassInstrument": 56,
    "StringInstrument": 40,
    "Misc": 0,
}


# ---------------------------------------------------------------------------
# Quantisation (music21 Stream.quantize semantics, divisors (4, 3))
# ---------------------------------------------------------------------------

def quantize_ql(x: float, divisors=(4, 3)) -> float:
    """Snap a quarterLength to the closest grid among ``1/d`` steps.

    music21's converter quantises MIDI offsets/durations with
    quarterLengthDivisors=(4, 3) before the tokenizer rounds to 16th steps;
    reproducing it keeps swung/triplet files binning identically.
    """
    best, best_err = x, None
    for d in divisors:
        cand = round(x * d) / d
        err = abs(cand - x)
        if best_err is None or err < best_err:
            best, best_err = cand, err
    return best


# ---------------------------------------------------------------------------
# Score
# ---------------------------------------------------------------------------

@dataclass
class Part:
    notes: np.ndarray                  # (n, 3) [pitch, offset_step, dur_step]
    ins_class: Optional[str] = None    # ACCEP_INS key or None (rejected)
    program: Optional[int] = None
    channel: int = 0
    name: str = ""

    def __len__(self):
        return len(self.notes)


@dataclass
class Score:
    parts: List[Part] = field(default_factory=list)
    bpm: float = 120.0
    ticks_per_quarter: int = 480

    def accepted_parts(self) -> List[Part]:
        return [p for p in self.parts if p.ins_class is not None]

    @property
    def ins_dict(self) -> Dict[int, str]:
        return {i: p.ins_class for i, p in enumerate(self.parts) if p.ins_class is not None}


def _pair_notes(events: List[MidiEvent], tpq: int, quantize: bool = True) -> np.ndarray:
    """Match note_on/note_off events into [pitch, offset_step, dur_step] rows."""
    open_notes: Dict[int, List[Tuple[int, int]]] = {}
    rows: List[Tuple[int, int, int]] = []

    def _steps(tick: int) -> int:
        ql = tick / tpq
        if quantize:
            ql = quantize_ql(ql)
        return int(round(ql * SAMPLE_FREQ))

    def _dur_steps(on_tick: int, off_tick: int) -> int:
        ql = (off_tick - on_tick) / tpq
        if quantize:
            ql = quantize_ql(ql)
        return int(round(ql * SAMPLE_FREQ))

    for e in events:
        if e.type == "note_on" and e.data[1] > 0:
            open_notes.setdefault(e.data[0], []).append((e.tick, e.data[1]))
        elif e.type == "note_off" or (e.type == "note_on" and e.data[1] == 0):
            stack = open_notes.get(e.data[0])
            if stack:
                on_tick, _vel = stack.pop(0)  # FIFO: earliest on matches first off
                rows.append((e.data[0], _steps(on_tick), _dur_steps(on_tick, e.tick)))
    # unmatched note_ons are dropped (truncated files)
    if not rows:
        return np.empty((0, 3), dtype=np.int64)
    arr = np.array(rows, dtype=np.int64)
    return arr[np.lexsort((arr[:, 2], arr[:, 1]))]


def midifile_to_score(mf: MidiFile, quantize: bool = True) -> Score:
    """Split a MidiFile into parts by (track, channel), classify, quantise.

    Mirrors music21's midiFileToStream + the reference's per-part instrument
    classification: each channel of each note-bearing track becomes a part;
    its program is the first program_change on that channel (searching the
    whole file if the track itself has none).
    """
    bpm = 120.0
    for trk in mf.tracks:
        for e in trk.events:
            if e.type == "tempo" and e.data[0] > 0:
                bpm = 60_000_000 / e.data[0]
                break
        else:
            continue
        break

    score = Score(bpm=bpm, ticks_per_quarter=mf.ticks_per_quarter)
    for trk in mf.tracks:
        if not trk.has_notes():
            continue
        for ch in trk.channels():
            ch_events = [e for e in trk.events if e.channel == ch or e.type not in ("note_on", "note_off", "program_change")]
            notes = _pair_notes([e for e in ch_events if e.type in ("note_on", "note_off")],
                                mf.ticks_per_quarter, quantize)
            if not len(notes):
                continue
            program = trk.first_program(ch)
            part = Part(
                notes=notes,
                ins_class=classify_program(program, ch),
                program=program,
                channel=ch,
                name=trk.name,
            )
            score.parts.append(part)
    return score


def load_score(path_or_bytes, quantize: bool = True) -> Score:
    """Load a score from a Standard MIDI File.

    The MusicXML, ABC and **kern readers of the JAX package are not ported
    yet (ROADMAP.md); such input raises ``NotImplementedError``.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"MThd":
        raise NotImplementedError(
            "only Standard MIDI input is ported; MusicXML, ABC and kern "
            "readers are still to port (ROADMAP.md)")
    mf = parse_midi_bytes(data)
    return midifile_to_score(mf, quantize)


def num_piano_tracks(path_or_bytes) -> int:
    """Count keyboard-class note parts (encodings.py:105-108 equivalent)."""
    score = load_score(path_or_bytes)
    return sum(1 for p in score.parts if p.ins_class == "Piano" and len(p.notes))


def is_empty_midi(path_or_bytes) -> bool:
    """True when the file has no note events (encodings.py:100-103)."""
    if path_or_bytes is None:
        return False
    try:
        if isinstance(path_or_bytes, (bytes, bytearray)):
            mf = parse_midi_bytes(bytes(path_or_bytes))
        else:
            mf = parse_midi_file(path_or_bytes)
    except Exception:
        return True
    return not any(t.has_notes() for t in mf.tracks)


# ---------------------------------------------------------------------------
# chordarr → MIDI (decode side)
# ---------------------------------------------------------------------------

def chordarr_to_midifile(chordarr: np.ndarray, bpm: float = 120.0,
                         instr_list: Optional[List[str]] = None,
                         tpq: int = 480) -> MidiFile:
    """Render a piano roll to a MidiFile (encodings.py:327-393 equivalent).

    Lane ``i`` maps to instrument class ``i % 7`` and the decode-side GM
    program from CLASS_TO_PROGRAM. ``instr_list``, when given, keeps only the
    named classes (chordarr2stream's instr_list filter).
    """
    chordarr = np.asarray(chordarr)
    T, I, P = chordarr.shape
    mf = MidiFile(format=1, ticks_per_quarter=tpq)
    meta = MidiTrack()
    meta.events.append(MidiEvent(0, "time_signature", 0, (4, 4)))
    meta.events.append(MidiEvent(0, "tempo", 0, (int(round(60_000_000 / bpm)),)))
    meta.events.append(MidiEvent(0, "key_signature", 0, (0, 0)))
    mf.tracks.append(meta)

    step_ticks = tpq // SAMPLE_FREQ
    ch = 0
    for lane in range(I):
        cls = ACCEP_INS_REV[lane % len(ACCEP_INS_REV)]
        if instr_list is not None and cls not in instr_list:
            continue
        t_idx, p_idx = np.nonzero(chordarr[:, lane, :] > 0)
        if len(t_idx) == 0:
            continue
        durs = chordarr[t_idx, lane, p_idx].astype(np.int64)
        trk = MidiTrack()
        trk.name = cls
        channel = ch if ch != 9 else 10  # skip the percussion channel
        trk.events.append(MidiEvent(0, "program_change", channel, (CLASS_TO_PROGRAM[cls],)))
        evs = []
        for t, p, d in zip(t_idx, p_idx, durs):
            on = int(t) * step_ticks
            off = int(t + d) * step_ticks
            evs.append(MidiEvent(on, "note_on", channel, (int(p), 90)))
            evs.append(MidiEvent(off, "note_off", channel, (int(p), 0)))
        # note_offs before note_ons at equal ticks so re-struck notes retrigger
        evs.sort(key=lambda e: (e.tick, 0 if e.type == "note_off" else 1))
        trk.events.extend(evs)
        mf.tracks.append(trk)
        ch = (ch + 1) % 16
        if ch == 9:
            ch += 1
    return mf


# ---------------------------------------------------------------------------
# Track compression (compress_midi_file, encodings.py:122-144)
# ---------------------------------------------------------------------------

def compress_score(score: Score, cutoff: int = 6, min_variation: int = 3) -> Optional[Score]:
    """Keep at most ``cutoff`` parts, sorted by pitch variety then note count.

    Mirrors compress_midi_file: parts must have ≥ min_variation unique pitches
    and all pitches within the piano range; returns None when nothing
    survives.
    """
    from ..vocab import PIANO_RANGE

    candidates = []
    for p in score.accepted_parts():
        pitches = set(int(x) for x in p.notes[:, 0])
        if len(pitches) < min_variation:
            continue
        if any(x < PIANO_RANGE[0] or x >= PIANO_RANGE[1] for x in pitches):
            continue
        candidates.append((len(pitches), len(p.notes), p))
    if not candidates:
        return None
    candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)
    kept = [c[2] for c in candidates[:cutoff]]
    return Score(parts=kept, bpm=score.bpm, ticks_per_quarter=score.ticks_per_quarter)
