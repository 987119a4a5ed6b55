"""Genre-LM learner: checkpoint load and prediction through the decode engine.

The inference half of the JAX package's ``MusicLearner``
(``train/learner.py:59-130``); training is still to port (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..codec.item import MusicItem
from ..decode.engine import GenerationEngine
from ..models.config import TXLConfig
from ..vocab import MusicVocab
from .checkpoint import load_checkpoint, params_from_numpy


class MusicLearner:
    """Holds (params, cfg, vocab) and the generation engine on one device."""

    def __init__(self, cfg: TXLConfig, vocab: MusicVocab, params: Dict,
                 device=None):
        """``device=None`` means the CUDA card; pass ``"cpu"`` explicitly."""
        self.cfg = cfg
        self.vocab = vocab
        self.params = params
        self.device = device
        self._engine = None

    @classmethod
    def load(cls, path: str, device=None) -> "MusicLearner":
        """Load a checkpoint directory written by the JAX package."""
        tree, cfg, vocab, _ = load_checkpoint(path)
        return cls(cfg, vocab, params=params_from_numpy(tree, cfg), device=device)

    @property
    def engine(self):
        if self._engine is None:
            self._engine = GenerationEngine(self.params, self.cfg, self.vocab,
                                            device=self.device)
        return self._engine

    def predict(self, item: MusicItem, n_words: int = 128,
                temperatures=(1.0, 1.0, 1.0), min_bars: int = 4,
                top_k: int = 30, top_p: float = 0.6, allowed_ins=None,
                greedy: bool = False, seed: int = 0,
                mem_len: Optional[int] = None):
        """Reference MusicLearner.predict contract: returns (pred, full)."""
        new = self.engine.generate(
            item.data, seed_pos=item.position, n_words=n_words,
            temperatures=temperatures, min_bars=min_bars, top_k=top_k,
            top_p=top_p, allowed_ins=allowed_ins, greedy=greedy, seed=seed,
            mem_len=mem_len)
        pred = MusicItem(new, self.vocab, ins=item.ins)
        return pred, item.append(pred)
