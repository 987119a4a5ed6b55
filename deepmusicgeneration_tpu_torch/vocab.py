"""Token vocabulary for the symbolic music framework.

Defines the exact token universe of the reference pipeline
(reference `core/encodings.py:5-67`, reference `core/vocab.py:8-86`):

* 12 special tokens ``[xxbos, xxpad, xxeos, xxmask, xxelec, xxfolk, xxfunk,
  xxjazz, xxpop, xxrock, xxni, xxsep]`` (SEP must be last, NI second last),
* 128 note tokens ``n0..n127``,
* 161 duration tokens ``d0..d160`` (``DUR_SIZE = 10*4*4 + 1``),
* 7 instrument tokens ``i0..i6`` (Piano/Guitar/Bass/Woodwind/Brass/String/Misc),
* 10 mean-tempo tokens ``mt0..mt9``,
* padding ``dummy{i}`` tokens appended ``len(itos) % 8`` times (reference quirk —
  318 % 8 == 6 extra tokens, total **324**, reproduced bit-for-bit).

The seq2seq variant (reference `deep_music_s2s.py:200,901-905`) drops the
six genre tokens and the tempo tokens AND comments the dummy-padding block out:
6 specials + 128 + 161 + 7 = **302** tokens exactly (no dummies).

Unlike the reference's pickled class, the vocabulary here is a frozen value
object derivable entirely from a layout name, so checkpoints only need to store
the layout string.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Constants (reference: core/encodings.py:9-67)
# ---------------------------------------------------------------------------

PIANO_RANGE = (21, 108)
NOTE_RANGE = (1, 127)
BPB = 4  # beats per bar
TIMESIG = f"{BPB}/4"
VALTSEP = -1   # npenc separator-row marker in the note column
VALTCONT = -2  # chordarr "continue holding" marker

SAMPLE_FREQ = 4                          # steps per quarter note
NOTE_SIZE = 128
DUR_SIZE = (10 * BPB * SAMPLE_FREQ) + 1  # 161
MAX_NOTE_DUR = 8 * BPB * SAMPLE_FREQ     # 128

BOS = "xxbos"
PAD = "xxpad"
EOS = "xxeos"
MASK = "xxmask"
SEP = "xxsep"
IN = "xxni"  # null instrument

ELECTRONIC = "xxelec"
FOLK = "xxfolk"
FUNK = "xxfunk"
JAZZ = "xxjazz"
POP = "xxpop"
ROCK = "xxrock"
GENRE_TOKS = [ELECTRONIC, FOLK, FUNK, JAZZ, POP, ROCK]

# Instrument classes accepted by the tokenizer (core/encodings.py:43-52)
ACCEP_INS: Dict[str, int] = {
    "Piano": 0,
    "Guitar": 1,
    "Bass": 2,
    "WoodwindInstrument": 3,
    "BrassInstrument": 4,
    "StringInstrument": 5,
    "Misc": 6,
}
ACCEP_INS_REV = {v: k for k, v in ACCEP_INS.items()}
N_INS = len(ACCEP_INS)

NOTE_TOKS = [f"n{i}" for i in range(NOTE_SIZE)]
DUR_TOKS = [f"d{i}" for i in range(DUR_SIZE)]
INS_TOKS = [f"i{i}" for i in range(N_INS)]

MTEMPO_SIZE = 10
MTEMPO_TOKS = [f"mt{i}" for i in range(MTEMPO_SIZE)]

# SEP must be last, IN second last (decode grammar depends on it).
SPECIAL_TOKS = [BOS, PAD, EOS, MASK, *GENRE_TOKS, IN, SEP]
S2S_SPECIAL_TOKS = [BOS, PAD, EOS, MASK, IN, SEP]

# npenc separator-row third column: offset such that adding ins_range[0]
# during index encoding lands exactly on the xxni token id
# (core/encodings.py:269-271).
SEP_INS_VAL = -2 - len(NOTE_TOKS) - len(DUR_TOKS)  # == -291


def _build_itos(specials: Sequence[str], with_tempo: bool,
                pad_dummies: bool = True) -> List[str]:
    itos = list(specials) + NOTE_TOKS + DUR_TOKS + INS_TOKS
    if with_tempo:
        itos = itos + MTEMPO_TOKS
    # Reference quirk (core/vocab.py:78-79): appends len(itos) % 8 dummies,
    # which does NOT round up to a multiple of 8 — reproduced exactly. The s2s
    # monolith comments this block out (deep_music_s2s.py:903-905), so its
    # layout gets no dummies.
    if pad_dummies and len(itos) % 8 != 0:
        itos = itos + [f"dummy{i}" for i in range(len(itos) % 8)]
    return itos


@dataclass(frozen=True)
class MusicVocab:
    """Bimap between token strings and ids, plus token-range predicates.

    Mirrors `core/vocab.py:8-86`; ranges are half-open ``[lo, hi)``.
    """

    itos: Tuple[str, ...]
    layout: str = "genre"
    stoi: Dict[str, int] = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "itos", tuple(self.itos))
        object.__setattr__(self, "stoi", {s: i for i, s in enumerate(self.itos)})

    # -- constructors -------------------------------------------------------
    @classmethod
    def create(cls) -> "MusicVocab":
        """The 324-token genre/remix vocabulary (core/vocab.py:71-80)."""
        return cls(tuple(_build_itos(SPECIAL_TOKS, with_tempo=True)), "genre")

    @classmethod
    def create_s2s(cls) -> "MusicVocab":
        """The 302-token seq2seq vocabulary (deep_music_s2s.py:200,901-905):
        6 specials + 128 notes + 161 durations + 7 instruments, NO dummy
        padding (the reference comments that block out)."""
        return cls(tuple(_build_itos(S2S_SPECIAL_TOKS, with_tempo=False,
                                     pad_dummies=False)), "s2s")

    @classmethod
    def from_layout(cls, layout: str) -> "MusicVocab":
        if layout == "genre":
            return cls.create()
        if layout == "s2s":
            return cls.create_s2s()
        raise ValueError(f"unknown vocab layout {layout!r}")

    # -- core mapping -------------------------------------------------------
    def numericalize(self, toks: Sequence[str]) -> List[int]:
        return [self.stoi[t] for t in toks]

    def textify(self, nums: Sequence[int], sep: str = " "):
        items = [self.itos[int(i)] for i in nums]
        return sep.join(items) if sep is not None else items

    def __len__(self) -> int:
        return len(self.itos)

    # -- special ids --------------------------------------------------------
    @property
    def bos_idx(self) -> int: return self.stoi[BOS]
    @property
    def pad_idx(self) -> int: return self.stoi[PAD]
    @property
    def eos_idx(self) -> int: return self.stoi[EOS]
    @property
    def mask_idx(self) -> int: return self.stoi[MASK]
    @property
    def sep_idx(self) -> int: return self.stoi[SEP]
    @property
    def ni_idx(self) -> int: return self.stoi[IN]

    @property
    def special_idxs(self) -> Tuple[int, ...]:
        specials = SPECIAL_TOKS if self.layout == "genre" else S2S_SPECIAL_TOKS
        return tuple(self.stoi[t] for t in specials)

    # -- ranges (half-open) -------------------------------------------------
    @property
    def note_range(self) -> Tuple[int, int]:
        return self.stoi[NOTE_TOKS[0]], self.stoi[NOTE_TOKS[-1]] + 1

    @property
    def dur_range(self) -> Tuple[int, int]:
        return self.stoi[DUR_TOKS[0]], self.stoi[DUR_TOKS[-1]] + 1

    @property
    def ins_range(self) -> Tuple[int, int]:
        return self.stoi[INS_TOKS[0]], self.stoi[INS_TOKS[-1]] + 1

    @property
    def npenc_range(self) -> Tuple[int, int]:
        # (xxni .. last instrument token], the id span that survives
        # idxenc→npenc round trips (core/vocab.py:40).
        return self.stoi[IN], self.stoi[INS_TOKS[-1]] + 1

    # -- predicates (reference semantics: is_note counts SEP, is_ins counts NI)
    def is_duration(self, idx: int) -> bool:
        lo, hi = self.dur_range
        return lo <= idx < hi

    def is_duration_or_pad(self, idx: int) -> bool:
        return idx == self.pad_idx or self.is_duration(idx)

    def is_note(self, idx: int) -> bool:
        lo, hi = self.note_range
        return idx == self.sep_idx or (lo <= idx < hi)

    def is_ins(self, idx: int) -> bool:
        lo, hi = self.ins_range
        return idx == self.ni_idx or (lo <= idx < hi)

    # -- vectorised class predicates (for the compiled decode path) --------
    def note_mask(self) -> np.ndarray:
        m = np.zeros(len(self), dtype=bool)
        m[self.note_range[0]:self.note_range[1]] = True
        return m

    def dur_mask(self) -> np.ndarray:
        m = np.zeros(len(self), dtype=bool)
        m[self.dur_range[0]:self.dur_range[1]] = True
        return m

    def ins_mask(self) -> np.ndarray:
        m = np.zeros(len(self), dtype=bool)
        m[self.ins_range[0]:self.ins_range[1]] = True
        return m

    # -- persistence --------------------------------------------------------
    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"layout": self.layout, "itos": list(self.itos)}, f)

    @classmethod
    def load(cls, path) -> "MusicVocab":
        with open(path) as f:
            d = json.load(f)
        return cls(tuple(d["itos"]), d.get("layout", "genre"))


def genre_prefix_token(genre: str) -> str:
    """Map a free-form genre string to its prefix token (primitives.py:224-233).

    Falls back to BOS when no known genre substring matches.
    """
    g = (genre or "").lower()
    if "elec" in g:
        return ELECTRONIC
    if "folk" in g:
        return FOLK
    if "funk" in g:
        return FUNK
    if "jazz" in g:
        return JAZZ
    if "pop" in g:
        return POP
    if "rock" in g:
        return ROCK
    return BOS
