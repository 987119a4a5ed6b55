"""Reference-compatible application API, genre half (``app_utils.py``
work-alikes).

The same function names and signatures as the JAX package's
``app/app_utils.py`` (and the reference's), so an existing caller can switch
imports. The factory loads checkpoints written by the JAX package
(directory checkpoints: ``manifest.json`` + ``params.msgpack``). The
multitask factories (``createRemixModel``, ``createS2SModel``,
``predictMaskModel``) come with the multitask port (ROADMAP.md Queue 1,
item 12).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Optional

from ..tasks.generate import predict_nw_genre
from ..train.checkpoint import MANIFEST
from ..train.learner import MusicLearner

__all__ = ["createGenreContinuationModel", "predictNwGenreModel"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, MANIFEST))


def _demo(name: str) -> str:
    return os.path.join(_REPO_ROOT, "checkpoints", name)


@lru_cache(maxsize=4)
def createGenreContinuationModel(encode_position: bool = False,
                                 ckpt_path: str = "./checkpoints/lakh_genre_model",
                                 device=None) -> MusicLearner:
    """Genre/continuation model factory (app_utils.py:68-75).

    Fallback chain: the given checkpoint → the committed trained-at-scale
    checkpoint (synth_genre_model, the flagship config) → the committed demo
    checkpoint. The JAX package's last link, freshly initialised weights,
    needs a parameter initializer the port does not have yet: without a
    checkpoint this raises (ROADMAP.md Queue 1). ``device=None`` means the
    CUDA card; pass ``"cpu"`` explicitly.
    """
    if _exists(ckpt_path):
        return MusicLearner.load(ckpt_path, device=device)
    if not encode_position and _exists(_demo("synth_genre_model")):
        return MusicLearner.load(_demo("synth_genre_model"), device=device)
    if _exists(_demo("demo_genre_model")):
        return MusicLearner.load(_demo("demo_genre_model"), device=device)
    raise FileNotFoundError(
        f"no genre checkpoint at {ckpt_path!r} nor under checkpoints/; the "
        "fresh-initialised fallback is not ported yet (ROADMAP.md Queue 1)")


def predictNwGenreModel(genre_model_learner: MusicLearner, mid_file,
                        genre: str = " POP ", temperature_notes: float = 1.8,
                        temperature_duration: float = 1.8,
                        temperature_ins: float = 1.0, top_p: float = 0.3,
                        max_len: int = 512, cutoff_beat: float = 32,
                        mem_len: int = 512, allowed_ins: Optional[List[str]] = None,
                        output_bpm: float = 120, **kwargs):
    """Reference signature (app_utils.py:90-144)."""
    return predict_nw_genre(
        genre_model_learner, mid_file, genre=genre,
        temperature_notes=temperature_notes,
        temperature_duration=temperature_duration,
        temperature_ins=temperature_ins, top_p=top_p, max_len=max_len,
        cutoff_beat=cutoff_beat, mem_len=mem_len,
        allowed_ins=list(allowed_ins) if allowed_ins else None,
        output_bpm=output_bpm, **kwargs)
