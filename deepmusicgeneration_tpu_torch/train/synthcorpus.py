"""Synthetic grammar-valid training corpus with learnable musical structure.

A numpy copy of the JAX package's ``train/synthcorpus.py`` (``generate_song``
and ``make_corpus``): the same generative process draws the same songs from
the same seeds, so a corpus made by either package is the other's. Every
song is drawn from a structured process (key, scale, genre-specific chord
progressions with secondary dominants, phrase repetition and cadences,
per-genre instrumentation and rhythm statistics, a small form grammar with
modulations and section textures), giving a model real regularities to
learn; held-out songs from disjoint seeds measure generalization.

Songs are npenc arrays built through the codec (:func:`..codec.encode.
notes2chordarr` then :func:`chordarr2npenc`), so corpus files are
bit-compatible with the MIDI preprocessing cache
(``train/preprocess.py::process_file``): the instrument column holds
ACCEP_INS class ids and genre comes from the parent directory name.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..codec.encode import chordarr2npenc, notes2chordarr
from ..codec.validate import is_valid_npenc
from ..vocab import ACCEP_INS, MAX_NOTE_DUR, N_INS, SAMPLE_FREQ

STEPS_PER_BAR = SAMPLE_FREQ * 4  # 16

MAJOR = [0, 2, 4, 5, 7, 9, 11]
MINOR = [0, 2, 3, 5, 7, 8, 10]
DORIAN = [0, 2, 3, 5, 7, 9, 10]
MIXOLYDIAN = [0, 2, 4, 5, 7, 9, 10]

PIANO, GUITAR, BASS, WOODWIND, BRASS, STRING, MISC = range(N_INS)

# Per-genre generative statistics. `progressions` are scale-degree loops;
# `melody_durs` are (duration_steps, weight) pairs; `comp` selects the
# accompaniment pattern; `seventh` adds the 7th chord tone (jazz voicings).
GENRE_STYLES: Dict[str, dict] = {
    "electronic": dict(
        scales=[MINOR], melody_ins=PIANO, comp_ins=PIANO, bass_ins=BASS,
        counter_ins=STRING,
        progressions=[[0, 5, 3, 4], [0, 3, 5, 4], [5, 3, 0, 4],
                      [0, 5, 1, 4], [0, 2, 3, 4, 0, 2, 5, 4]],
        melody_durs=[(2, 0.50), (4, 0.30), (3, 0.10), (8, 0.10)],
        comp="arp", bass="eighths", seventh=False, tempo_bias=0,
    ),
    "folk": dict(
        scales=[MAJOR, MIXOLYDIAN], melody_ins=STRING, comp_ins=GUITAR,
        bass_ins=BASS, counter_ins=WOODWIND,
        progressions=[[0, 3, 4, 0], [0, 4, 5, 3], [0, 0, 3, 4],
                      [0, 3, 0, 4], [0, 4, 0, 3, 5, 3, 4, 0]],
        melody_durs=[(4, 0.40), (8, 0.30), (2, 0.10), (6, 0.10), (12, 0.10)],
        comp="strum", bass="roots", seventh=False, tempo_bias=1,
    ),
    "funk": dict(
        scales=[DORIAN, MIXOLYDIAN], melody_ins=BRASS, comp_ins=GUITAR,
        bass_ins=BASS, counter_ins=WOODWIND,
        progressions=[[0, 0, 3, 3], [0, 3, 0, 4], [0, 0, 0, 0],
                      [0, 3, 4, 3], [0, 0, 3, 3, 0, 0, 4, 3]],
        melody_durs=[(2, 0.40), (1, 0.20), (3, 0.15), (4, 0.15), (6, 0.10)],
        comp="stabs", bass="sixteenth_syncopated", seventh=True, tempo_bias=0,
    ),
    "jazz": dict(
        scales=[MAJOR, DORIAN], melody_ins=WOODWIND, comp_ins=PIANO,
        bass_ins=BASS, counter_ins=BRASS,
        progressions=[[1, 4, 0, 0], [1, 4, 0, 5], [0, 5, 1, 4],
                      [2, 5, 1, 4], [0, 0, 3, 3, 1, 4, 0, 4]],
        melody_durs=[(2, 0.30), (4, 0.25), (3, 0.15), (6, 0.15), (8, 0.15)],
        comp="shell", bass="walking", seventh=True, tempo_bias=0,
    ),
    "pop": dict(
        scales=[MAJOR], melody_ins=PIANO, comp_ins=PIANO, bass_ins=BASS,
        counter_ins=STRING,
        progressions=[[0, 4, 5, 3], [0, 5, 3, 4], [3, 0, 4, 5],
                      [0, 3, 4, 4], [0, 4, 5, 3, 0, 4, 1, 4]],
        melody_durs=[(4, 0.40), (2, 0.25), (8, 0.20), (6, 0.10), (12, 0.05)],
        comp="block", bass="roots_fifths", seventh=False, tempo_bias=0,
    ),
    "rock": dict(
        scales=[MINOR, MIXOLYDIAN], melody_ins=GUITAR, comp_ins=GUITAR,
        bass_ins=BASS, counter_ins=STRING,
        progressions=[[0, 6, 3, 4], [0, 3, 4, 4], [0, 5, 6, 4],
                      [0, 6, 5, 4], [0, 0, 6, 6, 3, 3, 4, 4]],
        melody_durs=[(2, 0.40), (4, 0.35), (3, 0.10), (8, 0.15)],
        comp="power", bass="eighths", seventh=False, tempo_bias=-1,
    ),
}

Note = Tuple[int, int, int]  # (pitch, offset_step, dur_steps)


def _degree_pitch(scale: List[int], root: int, degree: int) -> int:
    """Absolute pitch for a (possibly out-of-octave) scale degree."""
    octave, idx = divmod(degree, len(scale))
    return root + 12 * octave + scale[idx]


def _chord_tones(scale, root, degree, seventh: bool) -> List[int]:
    tones = [_degree_pitch(scale, root, degree + off) for off in (0, 2, 4)]
    if seventh:
        tones.append(_degree_pitch(scale, root, degree + 6))
    return tones


# A chord slot is an int scale degree, or ('dom', target_degree): the
# secondary dominant V7/target — a major-minor seventh rooted a perfect
# fifth above the target's root, deliberately chromatic (v3 corpus).
Chord = object


def _chord_info(scale, root, ch, seventh: bool) -> Tuple[int, List[int]]:
    """(bass_root_pitch, chord_tones) for a diatonic or secondary-dominant
    chord slot."""
    if isinstance(ch, tuple):
        r = _degree_pitch(scale, root, ch[1]) + 7
        return r, [r, r + 4, r + 7, r + 10]
    return _degree_pitch(scale, root, ch), _chord_tones(scale, root, ch, seventh)


def _melody_degree(ch) -> int:
    """The degree melodies snap to: for a secondary dominant, its target
    (the melody anticipates the resolution)."""
    return ch[1] if isinstance(ch, tuple) else ch


def _melody_phrase(rng, scale, root, chords, n_bars, durs, lift: int = 0,
                   rest_p: float = 0.12) -> List[Note]:
    """Random-walk melody over the scale; chord tones favoured on strong beats.

    ``lift`` raises the register (in scale degrees) — used when melody and
    accompaniment share an instrument class, so their pitch ranges never
    overlap (same-pitch overlaps within one part are ambiguous in the
    piano-roll representation, as in the reference codec). ``rest_p`` is the
    per-slot rest probability (varies per phrase in the v2 corpus, so phrase
    density is itself a learnable trait).
    """
    dur_vals = np.array([d for d, _ in durs])
    dur_p = np.array([w for _, w in durs], dtype=float)
    dur_p /= dur_p.sum()
    notes: List[Note] = []
    deg = int(rng.integers(7, 15)) + lift  # melody register ~1-2 octaves up
    step = 0
    end = n_bars * STEPS_PER_BAR
    while step < end:
        bar = step // STEPS_PER_BAR
        chord_deg = _melody_degree(chords[bar % len(chords)])
        dur = int(rng.choice(dur_vals, p=dur_p))
        dur = min(dur, end - step)
        on_beat = step % SAMPLE_FREQ == 0
        closing = step + dur >= end  # final slot of the phrase
        if closing and rng.random() < 0.6:
            # cadence (v3): phrases tend to resolve to the chord root, held
            deg = chord_deg + 7 + lift
            dur = end - step
        elif on_beat and rng.random() < 0.6:
            # snap to the nearest chord tone (strong-beat consonance)
            choices = [chord_deg, chord_deg + 2, chord_deg + 4]
            deg = min((c + 7 + lift for c in choices),
                      key=lambda c: abs(c - deg))
        else:
            deg += int(rng.integers(-2, 3))
        deg = int(np.clip(deg, 5 + lift, min(20 + lift, 24)))
        if rng.random() > rest_p:
            pitch = int(np.clip(_degree_pitch(scale, root, deg), 24, 102))
            last_pitch = notes[-1][0] if notes else -1
            start = step
            if (on_beat and not closing and step > 0 and pitch != last_pitch
                    and rng.random() < 0.1):
                start = step - 1        # anticipation into the strong beat (v3)
            if dur >= 4 and not closing and rng.random() < 0.18:
                # passing-tone ornament (v3): approach the target through a
                # neighbouring scale degree in the first half of the slot
                half = dur // 2
                ndeg = deg + (1 if rng.random() < 0.5 else -1)
                npitch = int(np.clip(_degree_pitch(scale, root, ndeg), 24, 102))
                if npitch != pitch and npitch != last_pitch:
                    notes.append((npitch, start, half))
                    notes.append((pitch, step + half, dur - half))
                else:
                    notes.append((pitch, step, dur))
            else:
                notes.append((pitch, start, dur))
        step += dur
    return notes


def _counter_phrase(rng, scale, root, chords, n_bars, durs) -> List[Note]:
    """Counter-melody: the melody walk, an octave down, at half density
    (doubled durations, more rests) — a fourth voice that answers rather
    than doubles the lead."""
    slow = [(min(d * 2, 16), w) for d, w in durs]
    return _melody_phrase(rng, scale, root, chords, n_bars, slow,
                          lift=-5, rest_p=0.3)


def _comp_phrase(rng, scale, root, chords, n_bars, mode, seventh) -> List[Note]:
    notes: List[Note] = []
    for bar in range(n_bars):
        _, tones = _chord_info(scale, root, chords[bar % len(chords)], seventh)
        base = bar * STEPS_PER_BAR
        if mode == "block":          # whole- or two-half-bar block chords
            halves = (0, 8) if rng.random() < 0.5 else (0,)
            for half in halves:
                dur = 8 if len(halves) == 2 else 16  # never overlap same pitch
                for t in tones:
                    notes.append((t, base + half, dur))
        elif mode == "strum":        # chord on each beat
            for beat in range(4):
                for t in tones:
                    notes.append((t, base + beat * 4, 4))
        elif mode == "arp":          # 8th-note arpeggio
            order = tones + tones[-2:0:-1]
            for i in range(8):
                notes.append((order[i % len(order)], base + i * 2, 2))
        elif mode == "stabs":        # syncopated short hits
            for off in (0, 3, 6, 10):
                if rng.random() < 0.8:
                    for t in tones:
                        notes.append((t, base + off, 2))
        elif mode == "shell":        # jazz shell voicing, off-beat comping
            shell = [tones[0], tones[2 % len(tones)], tones[-1]]
            for off in (0, 6) if rng.random() < 0.6 else (2, 10):
                for t in shell:
                    notes.append((t, base + off, 6))
        elif mode == "power":        # root+fifth, driving 8ths
            for i in range(8):
                notes.append((tones[0], base + i * 2, 2))
                notes.append((tones[0] + 7, base + i * 2, 2))
    return notes


def _bass_phrase(rng, scale, root, chords, n_bars, mode) -> List[Note]:
    notes: List[Note] = []
    for bar in range(n_bars):
        base = bar * STEPS_PER_BAR
        rt, _ = _chord_info(scale, root, chords[bar % len(chords)], False)
        rt -= 24
        fifth = rt + 7
        if mode == "roots":
            notes.append((rt, base, 16))
        elif mode == "roots_fifths":
            notes.append((rt, base, 8))
            notes.append((fifth, base + 8, 8))
        elif mode == "eighths":
            for i in range(8):
                notes.append((rt if i % 4 != 3 else fifth, base + i * 2, 2))
        elif mode == "walking":      # quarter-note walk toward the next root
            nxt, _ = _chord_info(scale, root,
                                 chords[(bar + 1) % len(chords)], False)
            nxt -= 24
            walk = [rt, rt + (2 if nxt > rt else -2), fifth,
                    nxt + (1 if nxt < fifth else -1)]
            for i, p in enumerate(walk):
                notes.append((p, base + i * 4, 4))
        elif mode == "sixteenth_syncopated":
            for off in (0, 3, 6, 8, 11, 14):
                notes.append((rt if off % 8 != 6 else fifth, base + off,
                              2 if off in (0, 8) else 1))
    return notes


def generate_song(genre: str, seed: int) -> np.ndarray:
    """One synthetic song → npenc (instrument column = ACCEP_INS class ids).

    v2 generative process: 2-4 distinct phrases (each with its own chord
    progression, length and rest density), arranged by a per-section form
    grammar over 2-4 sections plus an optional reprise (32-160 bars total).
    Each section after the first may modulate the key (+2/-2/+5 semitones) —
    the SAME phrase seed then reappears transposed, so the model must track
    the current key rather than memorise absolute pitches. Half the songs
    carry a fourth part (counter-melody in its own instrument class).
    """
    style = GENRE_STYLES[genre]
    rng = np.random.default_rng(seed)
    scale = style["scales"][int(rng.integers(len(style["scales"])))]
    root = int(rng.integers(45, 57))  # key center A2..G#3

    progs = style["progressions"]
    n_phrases = int(rng.integers(2, 7))
    phrases = []
    for _ in range(n_phrases):
        prog: List = list(progs[int(rng.integers(len(progs)))])
        if rng.random() < 0.35 and len(prog) >= 4:
            # secondary dominant (v3): a mid-loop slot becomes V7 of the
            # chord that follows it — chromatic tension the key alone
            # cannot predict
            slot = int(rng.integers(1, len(prog) - 1))
            prog[slot] = ("dom", prog[slot + 1])
        phrases.append(dict(
            seed=int(rng.integers(0, 2**31)),
            prog=prog,
            bars=4 if len(prog) <= 4 else 8,   # 8-chord loops span 8 bars
            rest_p=float(rng.uniform(0.05, 0.25)),
        ))

    # Form grammar: each section arranges 4 phrase slots (AABA-biased), a
    # key offset, a texture, and (v3) possibly a solo chorus where the
    # counter instrument takes the melody; the song is the section list,
    # with the opening section reprised half the time.
    n_sections = int(rng.integers(2, 7))
    sections = []
    for s in range(n_sections):
        ids = rng.integers(0, n_phrases, size=4).tolist()
        if rng.random() < 0.6:
            a, b = ids[0], ids[1]
            ids = [a, a, b, a]
        offset = 0 if s == 0 else int(rng.choice([0, 2, -2, 5, 7, -3]))
        texture = ("full" if s == 0
                   else str(rng.choice(["full", "full", "sparse", "break"])))
        solo = s > 0 and rng.random() < 0.2
        sections.append((ids, offset, texture, solo))
    order = list(range(n_sections))
    if rng.random() < 0.5:
        order.append(0)  # reprise
    has_counter = rng.random() < 0.5

    parts: Dict[int, List[Note]] = {}
    bar0 = 0
    for sec_i in order:
        ids, offset, texture, solo = sections[sec_i]
        sroot = int(np.clip(root + offset, 40, 62))
        mel_ins = style["counter_ins"] if solo else style["melody_ins"]
        for ph in ids:
            P = phrases[ph]
            prng = np.random.default_rng(P["seed"])
            lift = 7 if mel_ins == style["comp_ins"] else 0
            mel = _melody_phrase(prng, scale, sroot, P["prog"], P["bars"],
                                 style["melody_durs"], lift=lift,
                                 rest_p=P["rest_p"])
            bass = _bass_phrase(prng, scale, sroot, P["prog"], P["bars"],
                                style["bass"])
            emit = [(mel_ins, mel), (style["bass_ins"], bass)]
            if texture != "break":     # 'break' drops the accompaniment (v3)
                comp = _comp_phrase(prng, scale, sroot, P["prog"], P["bars"],
                                    style["comp"], style["seventh"])
                emit.append((style["comp_ins"], comp))
            if has_counter and not solo and texture == "full":
                ctr = _counter_phrase(prng, scale, sroot, P["prog"],
                                      P["bars"], style["melody_durs"])
                emit.append((style["counter_ins"], ctr))
            shift = bar0 * STEPS_PER_BAR
            for cls, ph_notes in emit:
                parts.setdefault(cls, []).extend(
                    (p, off + shift, d) for p, off, d in ph_notes)
            bar0 += P["bars"]

    part_notes = []
    for cls in range(N_INS):
        arr = np.array(sorted(parts.get(cls, []), key=lambda n: n[1]),
                       dtype=np.int64).reshape(-1, 3)
        if len(arr):
            # keep inside is_valid_npenc's PIANO_RANGE [21, 108)
            arr[:, 0] = np.clip(arr[:, 0], 24, 102)
        part_notes.append(arr)
    # notes2chordarr expects (pitch, offset, dur) columns
    chordarr = notes2chordarr(part_notes, max_note_dur=MAX_NOTE_DUR)
    npenc = chordarr2npenc(chordarr)
    assert is_valid_npenc(npenc), f"synthetic song invalid (genre={genre}, seed={seed})"
    return npenc


def make_corpus(out_dir, songs_per_genre: int = 80, val_per_genre: int = 10,
                genres: Optional[List[str]] = None, base_seed: int = 0,
                verbose: bool = False) -> Dict[str, int]:
    """Write `out_dir/train/<genre>/*.npy` and `out_dir/valid/<genre>/*.npy`.

    Validation songs use disjoint seeds from the same generative process, so
    low validation perplexity measures in-distribution generalization, not
    recall of training files.
    """
    genres = genres or list(GENRE_STYLES)
    out_dir = Path(out_dir)
    counts = {"train": 0, "valid": 0}
    for g_i, genre in enumerate(genres):
        for split, n, seed0 in (("train", songs_per_genre, 0),
                                ("valid", val_per_genre, 1_000_000)):
            d = out_dir / split / genre
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                seed = base_seed + g_i * 10_000 + seed0 + i
                npenc = generate_song(genre, seed)
                # int16 keeps the committed corpus ~4× smaller; every reader
                # (npenc2idxenc, loaders) promotes to int64 on load
                np.save(d / f"synth_{seed:07d}.npy", npenc.astype(np.int16))
                counts[split] += 1
        if verbose:
            print(f"{genre}: {songs_per_genre} train + {val_per_genre} valid")
    return counts
