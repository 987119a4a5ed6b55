"""MusicItem / MultitrackItem value types.

Counterparts of `core/primitives.py:10-136` and
`deep_music_s2s.py:1605-1808`. A :class:`MusicItem` wraps a flat idxenc token
array plus its vocabulary, with lazily computed beat positions; everything it
returns is plain numpy ready to be padded/bucketed into fixed-shape device
tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..midi.score import Score, load_score
from ..vocab import ACCEP_INS, EOS, SAMPLE_FREQ, MusicVocab
from .decode import npenc2chordarr, npenc2midibytes, npenc_len, write_npenc_midi
from .encode import chordarr2npenc, notes2chordarr
from .index import (
    SEQType,
    idxenc2npenc,
    npenc2idxenc,
    position_enc,
    seq_prefix,
    sort_instruments,
)
from .transforms import (
    mask_section,
    pad_seq,
    tfm_transpose,
    trim_bw_beat,
    trim_to_beat,
)


def score_to_npenc(score: Score) -> Tuple[np.ndarray, Dict[int, str]]:
    """MIDI score → (npenc, ins_dict): the stream2chordarr→chordarr2npenc path."""
    parts = score.accepted_parts()
    chordarr = notes2chordarr([p.notes for p in parts])
    npenc = chordarr2npenc(chordarr)
    ins = {i: p.ins_class for i, p in enumerate(parts)}
    return npenc, ins


def midi_to_npenc(path_or_bytes) -> Tuple[np.ndarray, Dict[int, str]]:
    """MIDI → (npenc, ins_dict) through the pure-Python tokenizer.

    The JAX package's native C++ tokenizer is bit-identical to this path and
    is not used by the port.
    """
    return score_to_npenc(load_score(path_or_bytes))


class MusicItem:
    def __init__(self, data: np.ndarray, vocab: MusicVocab, ins=None,
                 position: Optional[np.ndarray] = None):
        self.data = np.asarray(data, dtype=np.int64)
        self.vocab = vocab
        self.ins = ins
        self._position = position

    def __len__(self):
        return len(self.data)

    def __repr__(self):
        head = self.vocab.textify(self.data[:12])
        return f"MusicItem({self.data.shape}): {head}..."

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_file(cls, midi_file, vocab: MusicVocab, genre: Optional[str] = None) -> "MusicItem":
        npenc, ins = midi_to_npenc(midi_file)
        return cls.from_npenc(npenc, vocab, ins=ins, genre=genre)

    @classmethod
    def from_score(cls, score: Score, vocab: MusicVocab, genre: Optional[str] = None) -> "MusicItem":
        npenc, ins = score_to_npenc(score)
        return cls.from_npenc(npenc, vocab, ins=ins, genre=genre)

    @classmethod
    def from_npenc(cls, npenc: np.ndarray, vocab: MusicVocab, ins=None,
                   genre: Optional[str] = None) -> "MusicItem":
        npenc = sort_instruments(npenc, vocab)
        seq_type = SEQType.Genre if genre is not None else SEQType.Sentence
        idx = npenc2idxenc(npenc, vocab, ins=ins, genre=genre, seq_type=seq_type)
        return cls(idx, vocab, ins=ins)

    @classmethod
    def from_idx(cls, item, vocab: MusicVocab) -> "MusicItem":
        idx, pos = item
        return cls(idx, vocab, position=pos)

    @classmethod
    def empty(cls, vocab: MusicVocab, seq_type: SEQType = SEQType.Sentence) -> "MusicItem":
        return cls(seq_prefix(seq_type, vocab), vocab)

    # -- converters ---------------------------------------------------------
    def to_idx(self):
        return self.data, self.position

    def to_text(self, sep: str = " ") -> str:
        return self.vocab.textify(self.data, sep)

    def to_npenc(self) -> np.ndarray:
        return idxenc2npenc(self.data, self.vocab)

    def to_chordarr(self) -> np.ndarray:
        return npenc2chordarr(self.to_npenc())

    def to_midi_bytes(self, bpm: float = 120.0, instr_list=None) -> bytes:
        return npenc2midibytes(self.to_npenc(), bpm=bpm, instr_list=instr_list)

    def write_midi(self, path, bpm: float = 120.0, instr_list=None) -> None:
        write_npenc_midi(self.to_npenc(), path, bpm=bpm, instr_list=instr_list)

    @property
    def position(self) -> np.ndarray:
        if self._position is None:
            self._position = position_enc(self.data, self.vocab)
        return self._position

    @property
    def new(self):
        vocab = self.vocab
        def make(data, position=None, ins=None):
            return type(self)(data, vocab, ins=ins if ins is not None else self.ins,
                              position=position)
        return make

    # -- transforms ---------------------------------------------------------
    def trim_to_beat(self, beat, include_last_sep: bool = False) -> "MusicItem":
        return self.new(trim_to_beat(self.data, self.position, self.vocab, beat, include_last_sep))

    def trim_bw_beat(self, beat_low, beat_high, include_last_sep: bool = False) -> "MusicItem":
        return self.new(trim_bw_beat(self.data, self.position, self.vocab,
                                     beat_low, beat_high, include_last_sep))

    def transpose(self, interval: int) -> "MusicItem":
        return self.new(tfm_transpose(self.data, interval, self.vocab), position=self._position)

    def append(self, item: "MusicItem") -> "MusicItem":
        return self.new(np.concatenate((self.data, item.data), axis=0))

    def mask_pitch(self, section=None) -> "MusicItem":
        return self.new(self.mask(self.vocab.note_range, section), position=self.position)

    def mask_duration(self, section=None, keep_position_enc: bool = True) -> "MusicItem":
        masked = self.mask(self.vocab.dur_range, section)
        if keep_position_enc:
            return self.new(masked, position=self.position)
        return self.new(masked)

    def mask(self, token_range, section_range=None) -> np.ndarray:
        return mask_section(self.data, self.position, token_range,
                            self.vocab.mask_idx, section_range=section_range)

    def pad_to(self, bptt: int) -> "MusicItem":
        data = pad_seq(self.data, bptt, self.vocab.pad_idx)
        pos = pad_seq(self.position, bptt, 0)
        return self.new(data, position=pos)

    def remove_eos(self) -> "MusicItem":
        if len(self.data) and self.data[-1] == self.vocab.eos_idx:
            return self.new(self.data[:-1])
        return self

    def set_genre(self, genre: Optional[str]) -> "MusicItem":
        """Overwrite/remove the leading genre token (app_utils.py:118-123)."""
        from ..vocab import genre_prefix_token, BOS
        data = self.data.copy()
        if genre is None:
            return self.new(data[1:])
        tok = genre_prefix_token(genre)
        data[0] = self.vocab.stoi[tok]
        return self.new(data)

    def to_individual_instrument(self, ins: str = "Piano") -> "MusicItem":
        """Project onto a single instrument class (deep_music_s2s.py:1235-1236)."""
        item = type(self)(filter_by_ins(self.data, self.vocab, ACCEP_INS[ins]),
                          self.vocab, ins=ins)
        return item


def filter_by_ins(idxenc: np.ndarray, vocab: MusicVocab, ins: int) -> np.ndarray:
    """Keep only one instrument class's rows (deep_music_s2s.py:1317-1334)."""
    npenc = idxenc2npenc(idxenc, vocab)
    drop = [v for v in ACCEP_INS.values() if v != ins]
    keep = ~np.isin(npenc[:, 2], drop)
    return npenc2idxenc(npenc[keep], vocab)


class MultitrackItem:
    """A pair of single-instrument items (deep_music_s2s.py:1605-1808)."""

    def __init__(self, first_instrument: MusicItem, second_instrument: MusicItem,
                 vocab: Optional[MusicVocab] = None):
        self.first_instrument = first_instrument
        self.second_instrument = second_instrument
        self.vocab = vocab or first_instrument.vocab
        self.cur_low_beat = 0  # stateful segment cursor (s2s:1613)

    @classmethod
    def from_file(cls, midi_file, vocab: MusicVocab,
                  first_ins: str = "Piano", second_ins: str = "Bass") -> "MultitrackItem":
        item = MusicItem.from_file(midi_file, vocab)
        return cls(item.to_individual_instrument(first_ins),
                   item.to_individual_instrument(second_ins), vocab)

    @classmethod
    def from_npenc(cls, npenc, vocab: MusicVocab,
                   first_ins: str = "Piano", second_ins: str = "Bass") -> "MultitrackItem":
        item = MusicItem.from_npenc(npenc, vocab)
        return cls(item.to_individual_instrument(first_ins),
                   item.to_individual_instrument(second_ins), vocab)

    @classmethod
    def from_idx(cls, item, vocab: MusicVocab) -> "MultitrackItem":
        f, s = item
        return cls(MusicItem.from_idx(f, vocab), MusicItem.from_idx(s, vocab), vocab)

    def to_idx(self):
        return self.first_instrument.to_idx(), self.second_instrument.to_idx()

    def to_chordarr(self) -> np.ndarray:
        return chordarr_from_multi_npenc(
            [self.first_instrument.to_npenc(), self.second_instrument.to_npenc()]
        )

    def to_midi_bytes(self, bpm: float = 120.0) -> bytes:
        from ..midi.score import chordarr_to_midifile
        from ..midi.smf import render_midi_bytes
        return render_midi_bytes(chordarr_to_midifile(self.to_chordarr(), bpm=bpm))

    def write_midi(self, path, bpm: float = 120.0) -> None:
        with open(path, "wb") as f:
            f.write(self.to_midi_bytes(bpm))

    def transpose(self, val):
        return MultitrackItem(self.first_instrument.transpose(val),
                              self.second_instrument.transpose(val), self.vocab)

    def pad_to(self, val):
        return MultitrackItem(self.first_instrument.pad_to(val),
                              self.second_instrument.pad_to(val), self.vocab)

    def trim_to_beat(self, beat):
        return MultitrackItem(self.first_instrument.trim_to_beat(beat),
                              self.second_instrument.trim_to_beat(beat), self.vocab)

    def trim_bw_beat(self, beat_low, beat_high):
        return MultitrackItem(self.first_instrument.trim_bw_beat(beat_low, beat_high),
                              self.second_instrument.trim_bw_beat(beat_low, beat_high),
                              self.vocab)

    def segment_to_parts(self, bptt: int = 512, beat_delta: int = 4,
                         sample_freq: int = SAMPLE_FREQ) -> "MultitrackItem":
        """Sliding-window segmenter (deep_music_s2s.py:1699-1786).

        Grows a [cur_low_beat, upper) beat window by ``beat_delta`` until
        either track reaches ``bptt`` tokens; skips windows in which either
        track has no notes; wraps to the song start at the end. The cursor
        mutates so successive calls stream successive segments.
        """
        note_lo, note_hi = self.vocab.note_range
        total_beats = int(self.first_instrument.position[-1] // sample_freq) if len(self.first_instrument) else 0

        for _attempt in range(max(total_beats // beat_delta + 2, 4)):
            low = self.cur_low_beat
            upper = low
            cur = self.trim_bw_beat(low, upper + beat_delta)
            wrapped = False
            while max(len(cur.first_instrument), len(cur.second_instrument)) < bptt:
                nxt_upper = upper + beat_delta
                if nxt_upper + beat_delta >= total_beats:
                    wrapped = True
                    break
                nxt = self.trim_bw_beat(low, nxt_upper + beat_delta)
                cur = nxt
                upper = nxt_upper
            upper = upper + beat_delta if upper == low else upper

            def _has_note(item: MusicItem) -> bool:
                d = item.data
                return bool(((d >= note_lo) & (d < note_hi)).any())

            seg = self.trim_bw_beat(low, upper)
            self.cur_low_beat = 0 if wrapped else upper
            if _has_note(seg.first_instrument) and _has_note(seg.second_instrument):
                return seg
            if wrapped and low == 0:
                # degenerate song: return whatever we have to avoid looping
                return seg
        return seg


def chordarr_from_multi_npenc(ps, note_size: int = 128) -> np.ndarray:
    """Merge per-instrument npencs into one roll (deep_music_s2s.py:1789-1808)."""
    from ..vocab import ACCEP_INS as _AI
    num_instruments = len(_AI)
    max_len = max(npenc_len(p) for p in ps)
    score_arr = np.zeros((max_len, num_instruments + 1, note_size))
    for npenc in ps:
        sub = npenc2chordarr(np.asarray(npenc))
        t, i, p = sub.shape
        score_arr[:t, :i, :] += sub
    return score_arr
