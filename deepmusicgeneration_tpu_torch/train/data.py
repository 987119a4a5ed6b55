"""Host data pipeline: packed-bptt LM streams for the genre LM.

A numpy copy of the JAX package's ``train/data.py`` loaders for language
modelling, so both packages give identical batches for the same corpus and
seed. :class:`LMStreamLoader` rebuilds the reference's MusicPreloader
(deep_music_genre.py:1001-1136): it concatenates a ragged corpus into ``bs``
contiguous token streams of length ``bptt`` with y = x shifted by one,
epoch-shuffled through a circular index, with per-item random transposition
and stacked beat positions. Batches are int32 numpy dicts; the train step
moves them to the device.

The multitask loaders (the BERT corruption transforms, ``S2SLoader``) come
with multitask training (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..codec.index import position_enc
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
