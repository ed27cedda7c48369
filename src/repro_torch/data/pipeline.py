"""Sharded, resumable, prefetching batch pipelines (NumPy, so the port's
batches equal the JAX package's bit for bit).

Design goals for the 1000-node posture:
  * determinism: batch t is a pure function of (seed, t) - any host can
    reproduce any step, which makes restart/elastic-rescale trivial;
  * shard-awareness: each host slices its (host_id / n_hosts) stripe of
    the global batch - no cross-host data shuffles;
  * resume: ``seek(step)`` fast-forwards without replaying data;
  * prefetch: a single background thread keeps ``depth`` batches ready
    (CPU-side; device transfer happens in the training loop).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np


@dataclass
class ShardInfo:
    host_id: int = 0
    n_hosts: int = 1


class DeterministicPipeline:
    """batch_fn(rng, step, lo, hi) -> dict of np arrays for rows [lo, hi)."""

    def __init__(self, batch_fn: Callable, global_batch: int, seed: int = 0,
                 shard: ShardInfo = ShardInfo()):
        if global_batch % shard.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.batch_fn = batch_fn
        self.global_batch = global_batch
        self.seed = seed
        self.shard = shard
        self.step = 0

    def seek(self, step: int):
        """Resume support: jump to any step in O(1)."""
        self.step = int(step)

    def next(self) -> dict:
        per_host = self.global_batch // self.shard.n_hosts
        lo = self.shard.host_id * per_host
        rng = np.random.default_rng((self.seed, self.step))
        out = self.batch_fn(rng, self.step, lo, lo + per_host)
        self.step += 1
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()


class Prefetcher:
    """Background-thread prefetch with clean shutdown."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self.q.put(item)
            finally:
                self.q.put(self._SENTINEL)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._SENTINEL:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


# ---------------------------------------------------------------------------
# Concrete batch functions
# ---------------------------------------------------------------------------


def lm_token_batch_fn(vocab: int, seq_len: int):
    """Synthetic zipf-ish token stream for LM substrate tests/examples."""

    def fn(rng: np.random.Generator, step: int, lo: int, hi: int) -> dict:
        n = hi - lo
        # zipf via inverse-CDF on a power law, clipped to vocab
        u = rng.random((n, seq_len + 1))
        toks = np.minimum((u ** -1.3).astype(np.int64), vocab - 1)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((n, seq_len), np.float32),
        }

    return fn


def recsys_ctr_batch_fn(world, users: np.ndarray):
    """Cascade CTR batches bound to a user split (see data.synthetic)."""
    from repro_torch.data.synthetic import ctr_batch

    def fn(rng: np.random.Generator, step: int, lo: int, hi: int) -> dict:
        return ctr_batch(world, users, rng, hi - lo)

    return fn
