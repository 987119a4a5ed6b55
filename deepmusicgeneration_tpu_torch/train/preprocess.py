"""Parallel corpus preprocessing.

A copy of the JAX package's ``train/preprocess.py`` over the port's codec
and its MIDI-only ``load_score``: the host-side equivalent of
``process_all``/``process_file`` (deep_music_genre.py:1725-1767) and the
dataset filter (core/data_processing.py:12-56). It tokenizes a MIDI corpus
into cached ``.npy`` npenc files with per-file timeouts, quarantining
failures into a ``discarded/`` directory, with concurrent.futures processes.
"""

from __future__ import annotations

import csv
import os
import shutil
from concurrent.futures import ProcessPoolExecutor, TimeoutError as FutTimeout
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..codec.item import MusicItem, score_to_npenc
from ..codec.validate import check_valid_ins, is_valid_npenc
from ..midi.score import load_score
from ..vocab import MusicVocab


def process_file(midi_path, out_dir, min_notes: int = 32) -> Optional[str]:
    """One MIDI → cached npenc .npy (genre:1743-1756). Returns the out path."""
    midi_path = Path(midi_path)
    score = load_score(midi_path)
    npenc, ins = score_to_npenc(score)
    if not is_valid_npenc(npenc, min_notes=min_notes):
        return None
    # remap part indices to class ids so caches are self-contained
    from ..codec.index import npins2vocabins
    npenc = npenc.copy()
    npenc[:, 2] = npins2vocabins(npenc[:, 2], ins)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / (midi_path.stem + ".npy")
    np.save(out, npenc)
    return str(out)


def _worker(args):
    midi_path, out_dir, min_notes = args
    try:
        return midi_path, process_file(midi_path, out_dir, min_notes), None
    except Exception as e:
        return midi_path, None, repr(e)


def process_all(midi_paths: Sequence, out_dir, timeout_s: float = 120.0,
                max_workers: Optional[int] = None, min_notes: int = 32,
                verbose: bool = False) -> List[str]:
    """Tokenize a corpus in parallel with per-file timeouts (genre:1725-1739).

    Workers use the *spawn* start method: forking a process that already
    runs threads (torch's among them) can deadlock the children on inherited
    mutexes.
    """
    import multiprocessing
    results = []
    args = [(str(p), str(out_dir), min_notes) for p in midi_paths]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=max_workers, mp_context=ctx) as ex:
        futures = {ex.submit(_worker, a): a[0] for a in args}
        for fut, path in futures.items():
            try:
                _, out, err = fut.result(timeout=timeout_s)
                if out:
                    results.append(out)
                elif verbose:
                    print(f"skipped {path}: {err or 'invalid npenc'}")
            except FutTimeout:
                if verbose:
                    print(f"timeout {path}")
            except Exception as e:
                if verbose:
                    print(f"error {path}: {e}")
    return results


def num_track_filter(npy_path, vocab: MusicVocab, num_ins_thresh: int = 2,
                     discard_dir: Optional[str] = None) -> bool:
    """fastai_num_track_filter (core/data_processing.py:12-56): tokenize the
    cache, require the round trip to work and ≥ num_ins_thresh distinct
    instrument classes; quarantine failures."""
    try:
        npenc = np.load(npy_path, allow_pickle=True)
        item = MusicItem.from_npenc(npenc, vocab)
        ok = check_valid_ins(item.data, vocab, num_ins_thresh)
    except Exception:
        ok = False
    if not ok and discard_dir is not None:
        os.makedirs(discard_dir, exist_ok=True)
        shutil.move(str(npy_path), os.path.join(discard_dir, os.path.basename(npy_path)))
    return ok


def load_corpus(npy_dir, vocab: MusicVocab, genre_from_dirname: bool = True,
                num_ins_thresh: int = 0, limit: Optional[int] = None
                ) -> List[np.ndarray]:
    """Build the idxenc training corpus from cached .npy files.

    Genre is read from each file's parent directory name, exactly like
    OpenNPFileProcessor (genre:982-986).
    """
    paths = sorted(Path(npy_dir).rglob("*.npy"))
    if limit:
        paths = paths[:limit]
    corpus = []
    for p in paths:
        try:
            npenc = np.load(p, allow_pickle=True)
            genre = p.parent.name.lower() if genre_from_dirname else None
            item = MusicItem.from_npenc(npenc, vocab, genre=genre)
            if num_ins_thresh and not check_valid_ins(item.data, vocab, num_ins_thresh):
                continue
            corpus.append(item.data)
        except Exception:
            continue
    return corpus


def arr2csv(arr: Iterable, out_path) -> None:
    """Metadata export (genre:1760-1767)."""
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)
        for row in arr:
            writer.writerow(row if isinstance(row, (list, tuple)) else [row])
