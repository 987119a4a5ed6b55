"""Token-level transforms (core/primitives.py:397-425).

All functions are pure; arrays are copied before mutation so they are safe to
use inside host data pipelines and, where noted, map 1:1 onto jit-able jnp
equivalents used by the training pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..vocab import MusicVocab
from .index import find_beat


def tfm_transpose(x: np.ndarray, value: int, vocab: MusicVocab) -> np.ndarray:
    """Shift note tokens by ``value`` semitones (primitives.py:399-402)."""
    x = np.asarray(x).copy()
    lo, hi = vocab.note_range
    sel = (x >= lo) & (x < hi)
    x[sel] += value
    # keep transposed tokens inside the note range (reference can overflow
    # into the duration range for extreme pitches; we clamp instead)
    x[sel] = np.clip(x[sel], lo, hi - 1)
    return x


def trim_to_beat(idxenc: np.ndarray, pos: np.ndarray, vocab: MusicVocab,
                 to_beat: Optional[float] = None, include_last_sep: bool = True) -> np.ndarray:
    from .index import beat2index
    if to_beat is None:
        return idxenc
    cutoff = beat2index(idxenc, pos, vocab, to_beat, include_last_sep=include_last_sep)
    return idxenc[:cutoff]


def trim_bw_beat(idxenc: np.ndarray, pos: np.ndarray, vocab: MusicVocab,
                 beat_low: Optional[float] = None, beat_high: Optional[float] = None,
                 include_last_sep: bool = True) -> np.ndarray:
    from .index import beat2index
    if beat_low is None or beat_high is None:
        return idxenc
    lo = beat2index(idxenc, pos, vocab, beat_low, include_last_sep=include_last_sep)
    hi = beat2index(idxenc, pos, vocab, beat_high, include_last_sep=include_last_sep)
    return idxenc[lo:hi]


def mask_input(xb: np.ndarray, mask_range: Tuple[int, int], replacement_idx: int) -> np.ndarray:
    xb = np.asarray(xb).copy()
    xb[(xb >= mask_range[0]) & (xb < mask_range[1])] = replacement_idx
    return xb


def mask_section(xb: np.ndarray, pos: np.ndarray, token_range: Tuple[int, int],
                 replacement_idx: int, section_range=None) -> np.ndarray:
    """Mask tokens of a range inside a beat window (primitives.py:414-425)."""
    xb = np.asarray(xb).copy()
    token_mask = (xb >= token_range[0]) & (xb < token_range[1])
    if section_range is None:
        section_range = (None, None)
    section_mask = np.zeros_like(xb, dtype=bool)
    start_idx = find_beat(pos, section_range[0]) if section_range[0] is not None else 0
    end_idx = find_beat(pos, section_range[1]) if section_range[1] is not None else xb.shape[0]
    section_mask[start_idx:end_idx] = True
    xb[token_mask & section_mask] = replacement_idx
    return xb


def pad_seq(seq: np.ndarray, bptt: int, value: int) -> np.ndarray:
    """Right-pad/truncate to exactly ``bptt`` (primitives.py:138-140)."""
    pad_len = max(bptt - seq.shape[0], 0)
    return np.pad(seq, (0, pad_len), "constant", constant_values=value)[:bptt]
