"""Deterministic, shardable data pipelines (numpy only).

A copy of ``repro.data.pipeline`` (the port imports nothing of the JAX
package): every batch is a pure function of ``(seed, step, host_shard)``,
so restarts resume exactly and the two packages draw the same token
streams from the same seed, byte for byte.

Sources:
* ``ZipfLM``      -- Zipf-distributed token stream with planted bigram
                     structure (perplexity benchmarks have signal).
* ``HierarchicalLM`` -- tokens generated by a random branching process, so
                     long-range hierarchical dependencies exist (the
                     inductive bias the paper targets).
* ``file_corpus`` -- memory-mapped token file (np.uint16) for real data.

``Prefetcher`` synthesises the next batches on a host thread.
"""
from __future__ import annotations

import dataclasses
import threading
import queue
from typing import Dict

import numpy as np


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


@dataclasses.dataclass
class ZipfLM:
    vocab_size: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    alpha: float = 1.2
    host_id: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        r = _rng(self.seed, step, self.host_id)
        B, S, V = self.batch_per_host, self.seq_len, self.vocab_size
        ranks = r.zipf(self.alpha, size=(B, S)).astype(np.int64)
        base = np.minimum(ranks, V - 1).astype(np.int32)
        # plant deterministic bigram structure: x[t] depends on x[t-1]
        mix = r.random((B, S)) < 0.35
        shifted = (np.roll(base, 1, axis=1) * 7919 + 13) % V
        tokens = np.where(mix, shifted.astype(np.int32), base)
        return {"tokens": tokens}


@dataclasses.dataclass
class HierarchicalLM:
    """Binary branching process: a root symbol expands recursively; child
    distributions depend on the parent, so mutual information decays
    slowly with distance (hierarchical structure for H1D to exploit)."""
    vocab_size: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    host_id: int = 0
    levels: int = 8

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        r = _rng(self.seed, step, self.host_id)
        B, S, V = self.batch_per_host, self.seq_len, self.vocab_size
        n0 = max(1, S >> self.levels)
        sym = r.integers(0, V, size=(B, n0), dtype=np.int64)
        while sym.shape[1] < S:
            left = (sym * 2654435761 + 1) % V
            right = (sym * 40503 + int(r.integers(0, 17))) % V
            noise = r.integers(0, V, size=left.shape, dtype=np.int64)
            keep = r.random(left.shape) < 0.9
            left = np.where(keep, left, noise)
            sym = np.stack([left, right], axis=-1).reshape(B, -1)
        return {"tokens": sym[:, :S].astype(np.int32)}


def file_corpus(path: str, vocab_size: int, seq_len: int,
                batch_per_host: int, seed: int = 0, host_id: int = 0):
    """Memory-mapped flat token file; random crops per (seed, step)."""
    data = np.memmap(path, dtype=np.uint16, mode="r")

    class _File:
        def batch(self, step: int):
            r = _rng(seed, step, host_id)
            starts = r.integers(0, len(data) - seq_len - 1,
                                size=batch_per_host)
            toks = np.stack([data[s:s + seq_len] for s in starts])
            return {"tokens": np.minimum(toks, vocab_size - 1)
                    .astype(np.int32)}

    return _File()


class Prefetcher:
    """Host-side prefetch thread: overlaps next-batch synthesis with the
    device step (straggler mitigation lever #1 -- data is never on the
    critical path)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            b = self.source.batch(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(b, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
