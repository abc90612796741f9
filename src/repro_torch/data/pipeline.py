"""Host-side data pipelines: synthetic token / recsys batch streams with
double-buffered prefetch and per-shard feeding for multi-host launches.

A copy of ``repro/data/pipeline.py`` (numpy only): the same seeds give the
same batches in both packages, as numpy arrays; the trainer moves them to
its device.

Everything is deterministic given (seed, step) so a restarted job resumes the
exact stream position from the checkpointed step — a fault-tolerance
requirement (no data skew/repeat after restart).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["TokenPipeline", "RecsysPipeline", "Prefetcher", "shard_batch"]


class TokenPipeline:
    """Synthetic LM token stream (Zipf unigram mix) with stateless indexing:
    batch(step) is a pure function of (seed, step)."""

    def __init__(
        self, vocab_size: int, batch: int, seq_len: int, seed: int = 0
    ) -> None:
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        tokens = np.minimum(z, self.vocab_size - 1).astype(np.int32)
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class RecsysPipeline:
    """Synthetic behavior-sequence batches for BST: item/category histories
    with Zipf-skewed item popularity (the heat skew GeoLayer exploits)."""

    def __init__(
        self,
        n_items: int,
        n_cats: int,
        batch: int,
        seq_len: int,
        seed: int = 0,
    ) -> None:
        self.n_items = n_items
        self.n_cats = n_cats
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        z = rng.zipf(1.2, size=(self.batch, self.seq_len + 1))
        items = np.minimum(z, self.n_items - 1).astype(np.int32)
        cats = (items % self.n_cats).astype(np.int32)
        clicks = (rng.random(self.batch) < 0.3).astype(np.float32)
        return {
            "hist_items": items[:, :-1],
            "hist_cats": cats[:, :-1],
            "target_item": items[:, -1],
            "target_cat": cats[:, -1],
            "label": clicks,
        }


class Prefetcher:
    """Double-buffered background prefetch of any ``batch_at(step)`` source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2) -> None:
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(s)
            self.q.put((s, batch))
            s += 1

    def next(self):
        return self.q.get()

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def shard_batch(
    batch: Dict[str, np.ndarray], shard_index: int, n_shards: int
) -> Dict[str, np.ndarray]:
    """Slice a global batch into this host's shard along axis 0."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // n_shards
        out[k] = v[shard_index * per : (shard_index + 1) * per]
    return out
