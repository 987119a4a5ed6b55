"""Static coalescing generation service.

Concurrent generation requests are queued on the host, coalesced into
device batches whose size is bucketed to a power of two (padding rows repeat
the first prompt), and decoded by one ``generate_batch`` call of the
learner's engine, so 5 to 8 requests run at B = 8 and 9 to 16 at B = 16:
the batched path (flash prefill, ``slab_ar_w8`` decode) on the card.

Usage::

    service = GenerationService(learner, max_batch=16)
    fut = service.submit(seed_idxenc, n_words=256, temperatures=(1.8, 1.8, 1.0))
    tokens = fut.result()      # concurrent.futures.Future
    service.close()

Requests sharing (n_words, temperatures, top_k, top_p, min_bars, greedy)
ride the same batch. The service runs on the engine's one device. The JAX
package's multi-chip branch (``mesh="auto"``, batches split over the chips)
is not carried; it belongs to the parallelism work (ROADMAP.md Queue 1,
item 14).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..decode.engine import expand_temperatures


@dataclass(frozen=True)
class _ReqKey:
    n_words: int
    temperatures: Tuple[float, ...]
    top_k: int
    top_p: float
    min_bars: int
    greedy: bool


@dataclass
class _Request:
    seed: np.ndarray
    key: _ReqKey
    seed_rng: int
    future: Future = field(default_factory=Future)


class GenerationService:
    """Coalesces concurrent generate() calls into device batches."""

    def __init__(self, learner, max_batch: int = 16, max_wait_s: float = 0.02):
        """``learner``: a ``MusicLearner``; its engine, and so its device,
        runs every batch. ``max_wait_s``: how long the first request of a
        batch waits for others to join it."""
        self.engine = learner.engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.batch_sizes: List[Tuple[int, int]] = []   # (requests, rows) per batch
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, seed_idxenc: np.ndarray, n_words: int = 256,
               temperatures=(1.0, 1.0, 1.0), top_k: int = 30,
               top_p: float = 0.6, min_bars: int = 4, greedy: bool = False,
               seed: int = 0) -> Future:
        """Queue one prompt; the future resolves to its new token ids."""
        if self._closed:
            raise RuntimeError("service closed")
        temperatures = expand_temperatures(temperatures)
        req = _Request(
            seed=np.asarray(seed_idxenc),
            key=_ReqKey(n_words, tuple(float(t) for t in temperatures),
                        top_k, float(top_p), min_bars, greedy),
            seed_rng=seed)
        self._q.put(req)
        return req.future

    def _collect(self) -> List[_Request]:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)
                break
            if nxt.key != first.key:
                self._q.put(nxt)  # different settings → next batch
                break
            batch.append(nxt)
        return batch

    @staticmethod
    def _bucket_batch(seeds):
        """Pad the seed list up to the next power-of-two size by repeating
        the first seed, so a few batch shapes serve every arrival pattern.
        Padded rows are decoded and dropped."""
        n = len(seeds)
        size = 1
        while size < n:
            size *= 2
        return seeds + [seeds[0]] * (size - n)

    def _loop(self):
        while True:
            batch = self._collect()
            if not batch:
                return
            k = batch[0].key
            seeds = self._bucket_batch([r.seed for r in batch])
            self.batch_sizes.append((len(batch), len(seeds)))
            try:
                toks, lengths = self.engine.generate_batch(
                    seeds, n_words=k.n_words, temperatures=k.temperatures,
                    min_bars=k.min_bars, top_k=k.top_k, top_p=k.top_p,
                    greedy=k.greedy, seed=batch[0].seed_rng)
            except Exception as e:  # the worker must outlive one failed batch
                for r in batch:
                    r.future.set_exception(e)
                continue
            for i, r in enumerate(batch):
                r.future.set_result(toks[i][: lengths[i]])

    def close(self):
        """Stop taking requests, finish the queued ones and join the worker."""
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError("generation service worker still running after 30 s")
