"""Sharded, step-resumable data pipeline.

The port's own copy of ``repro/data/loader.py`` (numpy only; the port
imports nothing of ``repro``): the same batches, byte for byte, from the
same seeds.

Design goals for the 1000+-node posture:

  * **Stateless indexing** — batch t is a pure function of (seed, step), so a
    restarted job resumes mid-epoch from the checkpointed step with zero
    pipeline state to save.
  * **Shard-aware** — each data-parallel host slices its rows from the global
    batch by its mesh coordinates; no host ever materializes the global batch.
  * **Prefetch** — a one-deep software pipeline (next batch is generated while
    the current step runs) mirrors real input pipelines; it is a
    correctness structure more than a throughput one.
"""

from __future__ import annotations

import threading
import queue
from typing import Callable, Iterator

import numpy as np

Array = np.ndarray


class ShardedLoader:
    """Deterministic per-step batch sampler over an in-memory array store."""

    def __init__(
        self,
        X: Array,
        y: Array,
        global_batch: int,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        assert global_batch % num_shards == 0, "global batch must split evenly"
        self.X, self.y = X, y
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards

    def batch_at(self, step: int) -> tuple[Array, Array]:
        """Pure function of step — the resumability contract."""
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.X.shape[0], size=self.global_batch)
        lo = self.shard_index * self.local_batch
        sel = idx[lo : lo + self.local_batch]
        return self.X[sel], self.y[sel]

    def iter_from(self, step: int) -> Iterator[tuple[Array, Array]]:
        while True:
            yield self.batch_at(step)
            step += 1


def prefetched(make_batch: Callable[[int], object], start_step: int, depth: int = 1):
    """Background-thread prefetch of ``make_batch(step)`` for step >= start."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            q.put(make_batch(step))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    return gen()


def lm_token_batches(
    vocab_size: int, batch: int, seq_len: int, seed: int = 0
) -> Callable[[int], dict[str, Array]]:
    """Synthetic-corpus LM batches: a fixed random "document" pool with
    Zipfian unigram statistics plus a copy-structure (spans repeat) so a
    transformer can actually reduce loss below unigram entropy.
    """
    rng = np.random.default_rng(seed)
    # Zipf-ish unigram distribution over the vocab.
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    pool = rng.choice(vocab_size, size=(256, seq_len + 1), p=probs).astype(np.int32)
    # Inject copy structure: second half of each doc repeats its first half.
    half = (seq_len + 1) // 2
    pool[:, half : 2 * half] = pool[:, :half]

    def make(step: int) -> dict[str, Array]:
        r = np.random.default_rng((seed, step))
        rows = r.integers(0, pool.shape[0], size=batch)
        docs = pool[rows]
        return {"tokens": docs[:, :-1], "labels": docs[:, 1:]}

    return make
