"""Token-grammar constraint tables for on-device constrained sampling.

The reference enforces the token grammar with a per-step Python branch
(`filter_invalid_indexes`, deep_music_genre.py:1984-2018): after a duration
only instrument tokens may follow, after an instrument only notes/``xxsep``,
after anything else only durations; a ``last_xxsep`` flag forces the
instrument slot of a separator triplet to ``xxni`` and bans ``xxni``
elsewhere.

Here the whole state machine is precomputed into a boolean table
``allowed[(prev_class, last_xxsep)] → (vocab,)`` so the compiled decode loop
applies it with one gather + where — no host round trip, no data-dependent
control flow.

Classes (see :func:`prev_class_table`):
    0: previous token was a duration            → next is the instrument slot
    1: previous token was instrument/xxni/xxpad → next is a note or xxsep
    2: anything else (note, xxsep, specials)    → next is a duration

Temperature slots follow deep_music_genre.py:1913-1925: class 0 samples with
``temperatures[2]`` (instruments), class 1 with ``temperatures[0]`` (notes),
class 2 with ``temperatures[1]`` (durations).

Quirk preserved: tempo/dummy tokens are in none of the banned sets, exactly
as in the reference, so they remain grammatically legal everywhere.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..vocab import MusicVocab

CLASS_DUR = 0
CLASS_INS_PAD = 1
CLASS_OTHER = 2

# temperature slot per previous-token class (genre predict engine)
TEMP_SLOT_BY_CLASS = np.array([2, 0, 1], dtype=np.int32)


def prev_class_table(vocab: MusicVocab) -> np.ndarray:
    """(vocab,) int32: grammar class of each token id when it is `prev`."""
    V = len(vocab)
    cls = np.full(V, CLASS_OTHER, dtype=np.int32)
    lo, hi = vocab.dur_range
    cls[lo:hi] = CLASS_DUR
    ilo, ihi = vocab.ins_range
    cls[ilo:ihi] = CLASS_INS_PAD
    cls[vocab.ni_idx] = CLASS_INS_PAD
    cls[vocab.pad_idx] = CLASS_INS_PAD
    return cls


def allowed_table(vocab: MusicVocab, strict: bool = False) -> np.ndarray:
    """(3, 2, vocab) bool: allowed[prev_class, last_xxsep] next-token mask.

    Reproduces filter_invalid_indexes exactly (including the three-way
    special-token bans and the xxni/instrument exclusivity overlay).

    ``strict=True`` additionally bans the tempo/dummy tail tokens the
    reference never bans (its quirk): a trained model essentially never
    samples them, but with small/untrained models they corrupt the
    [note dur ins] triplet framing, so the compiled engines default to
    strict tables.
    """
    V = len(vocab)
    nlo, nhi = vocab.note_range
    dlo, dhi = vocab.dur_range
    ilo, ihi = vocab.ins_range
    specials = set(vocab.special_idxs)

    def base(prev_class: int) -> np.ndarray:
        ok = np.ones(V, dtype=bool)
        if prev_class == CLASS_DUR:
            ok[dlo:dhi] = False
            ok[nlo:nhi] = False
            for s in specials - {vocab.ni_idx}:
                ok[s] = False
        elif prev_class == CLASS_INS_PAD:
            ok[ilo:ihi] = False
            ok[dlo:dhi] = False
            for s in specials - {vocab.sep_idx}:
                ok[s] = False
        else:
            ok[nlo:nhi] = False
            ok[ilo:ihi] = False
            for s in specials:
                ok[s] = False
        return ok

    table = np.zeros((3, 2, V), dtype=bool)
    for c in range(3):
        for flag in (0, 1):
            ok = base(c).copy()
            if flag:
                ok[ilo:ihi] = False       # after xxsep: only xxni may fill the slot
            else:
                ok[vocab.ni_idx] = False  # otherwise xxni is banned
            if strict:
                ok[ihi:] = False          # mt*/dummy* tail
            table[c, flag] = ok
    return table


def allowed_ins_mask(vocab: MusicVocab, allowed_ins: Optional[Sequence[str]]) -> np.ndarray:
    """(vocab,) bool overlay banning instrument tokens outside the whitelist.

    ``allowed_ins`` holds ACCEP_INS class names (app_utils.py:128-137 maps UI
    names to classes before calling predict).
    """
    from ..vocab import ACCEP_INS

    ok = np.ones(len(vocab), dtype=bool)
    if allowed_ins:
        ilo, ihi = vocab.ins_range
        ok[ilo:ihi] = False
        for name in allowed_ins:
            if name.startswith("i") and name[1:].isdigit():
                cls_id = int(name[1:])
            else:
                cls_id = ACCEP_INS[name]
            ok[ilo + cls_id] = True
    return ok


def update_last_xxsep(prev_idx: int, last_xxsep: bool, vocab: MusicVocab) -> bool:
    """Reference flag-update rule (deep_music_genre.py:1901-1905)."""
    if prev_idx == vocab.sep_idx:
        return True
    if prev_idx == vocab.ni_idx:
        return False
    return last_xxsep


def filter_invalid_indexes(logits: np.ndarray, prev_idx: int, vocab: MusicVocab,
                           filter_value: float = -np.inf, last_xxsep: bool = False,
                           allowed_ins: Optional[Sequence[str]] = None) -> np.ndarray:
    """Host-side reference-compatible wrapper over the tables (for tests)."""
    cls = prev_class_table(vocab)[prev_idx]
    ok = allowed_table(vocab)[cls, int(last_xxsep)] & allowed_ins_mask(vocab, allowed_ins)
    out = logits.copy()
    out[~ok] = filter_value
    return out


def grammar_violations(idxenc, vocab: MusicVocab, prev_idx: Optional[int] = None,
                       last_xxsep: bool = False, strict: bool = False) -> int:
    """Count transitions that filter_invalid_indexes would have banned.

    Walks a *continuation* ``idxenc`` through the same state machine the
    compiled engines apply per step (class table + last_xxsep flag), given the
    token that precedes it. With ``prev_idx=None`` the first token seeds the
    state unchecked. Used to measure grammar-validity of samples generated
    WITHOUT the strict tables (the trained-model quality bar: the reference's
    non-strict rules never ban tempo/dummy tokens, so emitting none of them —
    and no other violation — must come from the model itself).
    """
    cls_tab = prev_class_table(vocab)
    tab = allowed_table(vocab, strict=strict)
    seq = [int(t) for t in np.asarray(idxenc).ravel()]
    if prev_idx is None:
        if not seq:
            return 0
        prev_idx, seq = seq[0], seq[1:]
    prev = int(prev_idx)
    bad = 0
    for t in seq:
        last_xxsep = update_last_xxsep(prev, last_xxsep, vocab)
        if not tab[cls_tab[prev], int(last_xxsep), t]:
            bad += 1
        prev = t
    return bad


def temp_slot_table(vocab: MusicVocab, mode: str = "genre") -> np.ndarray:
    """(vocab,) int32: temperature slot to use given the previous token.

    mode='genre' → 3 slots (deep_music_genre.py:1913-1925): prev duration →
    slot 2 (instrument temp), prev ins/xxni/xxpad → slot 0 (note temp),
    anything else → slot 1 (duration temp).

    mode='twotemp' → the remix/s2s rule (deep_music_remix.py:2514):
    ``temperatures[0] if is_duration_or_pad(prev) else temperatures[1]``.

    Note the remix/s2s monoliths reuse the same three-class
    filter_invalid_indexes (deep_music_remix.py:2394-2439); only the
    temperature rule differs.
    """
    V = len(vocab)
    cls = prev_class_table(vocab)
    if mode == "genre":
        return TEMP_SLOT_BY_CLASS[cls]
    if mode == "twotemp":
        slot = np.ones(V, dtype=np.int32)
        lo, hi = vocab.dur_range
        slot[lo:hi] = 0
        slot[vocab.pad_idx] = 0
        return slot
    raise ValueError(f"unknown temp slot mode {mode!r}")
