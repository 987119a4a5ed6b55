"""Reference-compatible application API (``app_utils.py`` work-alikes).

The same function names and signatures as the JAX package's
``app/app_utils.py`` (and the reference's), so an existing caller can switch
imports. The factories load checkpoints written by the JAX package
(directory checkpoints: ``manifest.json`` + ``params.msgpack``) and take a
``device`` (None means the CUDA card).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Optional

from ..models.config import btp_phase1_config, multitask_config
from ..tasks.generate import predict_nw_genre
from ..tasks.remix import predict_mask_remix
from ..train.checkpoint import MANIFEST
from ..train.learner import (MultitaskLearner, MusicLearner, multitask_model_learner,
                             music_model_learner)
from ..vocab import MusicVocab

__all__ = ["createGenreContinuationModel", "createRemixModel", "createS2SModel",
           "predictNwGenreModel", "predictMaskModel"]

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
    checkpoint → fresh weights of the reference config (``init_txl``, seed
    0), as the JAX package's factory ends (with ``encode_position`` such a
    model cannot predict yet: the beat-position embedding is still to
    port). ``device=None`` means the CUDA card; pass ``"cpu"`` explicitly.
    """
    if _exists(ckpt_path):
        return MusicLearner.load(ckpt_path, device=device)
    if not encode_position and _exists(_demo("synth_genre_model")):
        return MusicLearner.load(_demo("synth_genre_model"), device=device)
    if _exists(_demo("demo_genre_model")):
        return MusicLearner.load(_demo("demo_genre_model"), device=device)
    cfg = btp_phase1_config().replace(encode_position=encode_position)
    return music_model_learner(cfg=cfg, device=device)


def _multitask(ckpt_path: str, device, vocab: MusicVocab) -> MultitaskLearner:
    """The given checkpoint → the committed 85M one (synth_multitask_model)
    → the committed demo one → fresh flagship weights (seed 0)."""
    for path in (ckpt_path, _demo("synth_multitask_model"), _demo("demo_multitask_model")):
        if _exists(path):
            return MultitaskLearner.load(path, device=device)
    return multitask_model_learner(cfg=multitask_config(len(vocab)), vocab=vocab,
                                   device=device)


@lru_cache(maxsize=4)
def createRemixModel(encode_position: bool = True,
                     ckpt_path: str = "./checkpoints/mask_music_model",
                     device=None) -> MultitaskLearner:
    """Mask-infill (remix) model factory (app_utils.py:77-79)."""
    return _multitask(ckpt_path, device, MusicVocab.create())


@lru_cache(maxsize=4)
def createS2SModel(encode_position: bool = False, ckpt_path: str = "./checkpoints/s2s_model",
                   device=None) -> MultitaskLearner:
    """Seq2seq (harmonize) model factory (app_utils.py:80-81); fresh weights
    use the seq2seq vocabulary."""
    return _multitask(ckpt_path, device, MusicVocab.create_s2s())


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


def predictMaskModel(mask_model_learner: MultitaskLearner, mid_file,
                     genre: str = " POP ", temperature_notes: float = 1.0,
                     temperature_duration: float = 1.0, top_p: float = 0.3,
                     cutoff_beat: float = 32, output_bpm: float = 120,
                     pred_type: str = "notes", mask_proportion: float = 0.6,
                     **kwargs):
    """Reference signature (app_utils.py:159-215)."""
    return predict_mask_remix(
        mask_model_learner, mid_file, genre=genre,
        temperature_notes=temperature_notes,
        temperature_duration=temperature_duration, top_p=top_p,
        cutoff_beat=cutoff_beat, output_bpm=output_bpm, pred_type=pred_type,
        mask_proportion=mask_proportion, **kwargs)
