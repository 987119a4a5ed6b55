"""Host data pipeline: packed-bptt LM streams, BERT corruption, s2s batching.

A numpy copy of the JAX package's ``train/data.py``, so both packages give
identical batches for the same corpus and seed. :class:`LMStreamLoader`
rebuilds the reference's MusicPreloader
(deep_music_genre.py:1001-1136): it concatenates a ragged corpus into ``bs``
contiguous token streams of length ``bptt`` with y = x shifted by one,
epoch-shuffled through a circular index, with per-item random transposition
and stacked beat positions. Batches are int32 numpy dicts; the train step
moves them to the device.

The multitask model trains on :func:`mask_lm_tfm_pitchdur` (and the other
BERT corruption transforms, deep_music_remix.py:1208-1315) of those streams
and on :class:`S2SLoader`'s paired-track batches (deep_music_s2s.py:
1813-1960), as task dicts of int32 arrays.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..codec.index import position_enc
from ..codec.item import MultitrackItem
from ..codec.transforms import tfm_transpose
from ..vocab import MusicVocab


class CircularIndex:
    """Shuffled epoch wrap-around over the ragged corpus (genre:1004-1012)."""

    def __init__(self, length: int, rng: np.random.Generator):
        self.idx = np.arange(length)
        self.rng = rng

    def __getitem__(self, i):
        return self.idx[i % len(self.idx)]

    def __len__(self):
        return len(self.idx)

    def shuffle(self):
        self.rng.shuffle(self.idx)


class LMStreamLoader:
    """Packed contiguous LM batches with transpose augmentation."""

    def __init__(
        self,
        items: Sequence[np.ndarray],        # idxenc arrays
        vocab: MusicVocab,
        bs: int = 32,
        bptt: int = 512,
        shuffle: bool = True,
        transpose_range: Optional[Tuple[int, int]] = (0, 12),
        transpose_p: float = 0.5,
        encode_position: bool = True,
        seed: int = 0,
        y_offset: int = 1,
    ):
        assert len(items) > 0, "empty corpus"
        self.items = [np.asarray(it, dtype=np.int64) for it in items]
        self.vocab = vocab
        self.bs, self.bptt = bs, bptt
        self.shuffle = shuffle
        self.transpose_range, self.transpose_p = transpose_range, transpose_p
        self.encode_position = encode_position
        self.y_offset = y_offset
        self.rng = np.random.default_rng(seed)
        self.lengths = np.array([len(it) for it in self.items])
        self.total_toks = int(self.lengths.sum())
        self.idx = CircularIndex(len(self.items), self.rng)
        self.positions = [position_enc(it, vocab) for it in self.items]
        self._epoch_setup()

    def __len__(self):
        return int(math.ceil(self.total_toks / (self.bptt * self.bs)))

    def _epoch_setup(self):
        if self.shuffle:
            self.idx.shuffle()
        self.transpose_values = self._random_transpose_values()
        # starting (item, offset) cursor per stream, evenly spaced in tokens
        step = self.total_toks / self.bs
        self.ro = np.zeros(self.bs, dtype=np.int64)
        self.ri = np.zeros(self.bs, dtype=np.int64)
        ln_rag, count, i_rag = 0, 0, -1
        for i in range(self.bs):
            while ln_rag + count <= int(step * i):
                count += ln_rag
                i_rag += 1
                ln_rag = self.lengths[self.idx[i_rag]]
            self.ro[i] = i_rag
            self.ri[i] = int(step * i - count)

    def _random_transpose_values(self):
        if self.transpose_range is None:
            return None
        n = len(self.items)
        lo, hi = self.transpose_range
        vals = self.rng.integers(lo, hi, n) - hi // 2
        vals[self.rng.random(n) > self.transpose_p] = 0
        return vals

    def _item_stream(self, ix: int) -> np.ndarray:
        data = self.items[ix]
        if self.transpose_values is not None and self.transpose_values[ix]:
            data = tfm_transpose(data, int(self.transpose_values[ix]), self.vocab)
        if self.encode_position:
            return np.stack([data, self.positions[ix]], axis=1)
        return data[:, None]

    def _fill_row(self, j: int, row: np.ndarray):
        """Fill one stream row with contiguous tokens, overlap 1 (genre:1094-1125)."""
        need = row.shape[0]
        ibuf = 0
        ro, ri = int(self.ro[j]), int(self.ri[j])
        ro -= 1
        n = 0
        while ibuf < need:
            ro += 1
            ix = self.idx[ro]
            rag = self._item_stream(ix)
            if ibuf:
                ri = 0
            n = min(len(rag) - ri, need - ibuf)
            row[ibuf:ibuf + n] = rag[ri:ri + n]
            ibuf += n
        self.ro[j] = ro
        self.ri[j] = ri + n - 1  # overlap 1: restart at the last consumed token
        return row

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf = np.zeros((self.bs, self.bptt + self.y_offset, 2), dtype=np.int64)
        for _ in range(len(self)):
            for j in range(self.bs):
                self._fill_row(j, buf[j])
            batch = {
                "x": buf[:, : self.bptt, 0].astype(np.int32).copy(),
                "y": buf[:, self.y_offset: self.bptt + self.y_offset, 0].astype(np.int32).copy(),
            }
            if self.encode_position:
                batch["pos"] = buf[:, : self.bptt, 1].astype(np.int32).copy()
            yield batch
        self._epoch_setup()


# ---------------------------------------------------------------------------
# BERT corruption transforms (deep_music_remix.py:1208-1286)
# ---------------------------------------------------------------------------

def mask_tfm(x: np.ndarray, y: np.ndarray, mask_range: Tuple[int, int],
             mask_idx: int, pad_idx: int, p: float,
             rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Of the in-range positions: with prob p selected; of those 80% → mask,
    10% → random in-range token, 10% unchanged; unselected targets → pad."""
    x, y = x.copy(), y.copy()
    rand = rng.random(x.shape)
    rand[x < mask_range[0]] = 1.0
    rand[x >= mask_range[1]] = 1.0
    y[rand > p] = pad_idx
    x[rand <= p * 0.8] = mask_idx
    wrong = (rand > p * 0.8) & (rand <= p * 0.9)
    x[wrong] = rng.integers(mask_range[0], mask_range[1], int(wrong.sum()))
    return x, y


def mask_lm_tfm_pitchdur(batch: Dict[str, np.ndarray], vocab: MusicVocab,
                         rng: np.random.Generator, mask_p: float = 0.9) -> Tuple[dict, dict]:
    """Mask either the note range or the duration range, 50/50 per batch
    (remix:1228-1230), emitting the {'msk': ...} task dict."""
    mask_range = vocab.dur_range if rng.random() < 0.5 else vocab.note_range
    return mask_tfm_custom(batch, mask_range, vocab.mask_idx, vocab.pad_idx, mask_p, rng)


def mask_tfm_custom(batch: Dict[str, np.ndarray], mask_range, mask_idx, pad_idx,
                    mask_p, rng) -> Tuple[dict, dict]:
    y_lm = batch["y"]
    x_msk, y_msk = mask_tfm(y_lm, y_lm, mask_range, mask_idx, pad_idx, mask_p, rng)
    return {"msk": {"x": x_msk, "pos": batch.get("pos")}}, {"msk": y_msk}


def mask_lm_tfm(batch: Dict[str, np.ndarray], vocab: MusicVocab,
                rng: np.random.Generator, mask_p: float = 0.3) -> Tuple[dict, dict]:
    """Joint BERT + next-word batch (remix:1234-1259)."""
    x_lm, y_lm = batch["x"], batch["y"]
    pos = batch.get("pos")
    x_msk, y_msk = mask_tfm(y_lm, y_lm, mask_range_default(vocab), vocab.mask_idx,
                            vocab.pad_idx, mask_p, rng)
    x_dict = {"msk": {"x": x_msk, "pos": pos}, "lm": {"x": x_lm, "pos": pos}}
    return x_dict, {"msk": y_msk, "lm": y_lm}


def mask_range_default(vocab: MusicVocab) -> Tuple[int, int]:
    return vocab.npenc_range


def melody_chord_tfm(m, m_pos, c, c_pos) -> Tuple[dict, dict]:
    """Bidirectional s2s batch dicts (deep_music_s2s.py:1933-1960)."""
    y_m, x_m, m_pos_t = m[:, 1:], m[:, :-1], m_pos[:, :-1]
    y_c, x_c, c_pos_t = c[:, 1:], c[:, :-1], c_pos[:, :-1]
    x_dict = {
        "s2f": {"enc": x_c, "enc_pos": c_pos_t, "dec": x_m, "dec_pos": m_pos_t},
        "f2s": {"enc": x_m, "enc_pos": m_pos_t, "dec": x_c, "dec_pos": c_pos_t},
    }
    return x_dict, {"s2f": y_m, "f2s": y_c}


class S2SLoader:
    """Streams paired-track segments (S2SPreloader, s2s:1843-1888): each row
    a ``segment_to_parts`` window of one item, padded to bptt + 1, as
    :func:`melody_chord_tfm` batches."""

    def __init__(self, items: Sequence[MultitrackItem], vocab: MusicVocab,
                 bs: int = 8, bptt: int = 512, shuffle: bool = True, seed: int = 0):
        assert len(items) > 0
        self.items = list(items)
        self.vocab = vocab
        self.bs, self.bptt = bs, bptt
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return max(len(self.items) // self.bs, 1)

    def _get(self, k: int):
        seg = self.items[k % len(self.items)].segment_to_parts(bptt=self.bptt)
        seg = seg.pad_to(self.bptt + 1)
        f, s = seg.first_instrument, seg.second_instrument
        return f.data, f.position, s.data, s.position

    def __iter__(self):
        order = np.arange(len(self.items))
        if self.shuffle:
            self.rng.shuffle(order)
        for b in range(len(self)):
            rows = [self._get(order[(b * self.bs + j) % len(order)]) for j in range(self.bs)]
            m, m_pos, c, c_pos = (np.stack([r[i] for r in rows]).astype(np.int32)
                                  for i in range(4))
            yield melody_chord_tfm(m, m_pos, c, c_pos)
