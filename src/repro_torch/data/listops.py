"""Synthetic ListOps generator (LRA Table-1 proxy, offline-compatible).

A numpy copy of ``repro.data.listops`` (the port imports nothing of the
JAX package): for the same ``(seed, step, host_id)`` both packages give
the same tokens, labels and mask.

ListOps (Nangia & Bowman 2018) is the LRA task where H-Transformer-1D
gains the most (+12.3 over the best prior xformer): nested prefix
expressions over MIN/MAX/MED/SM (sum mod 10) whose answer requires
hierarchical reasoning over long contexts.  Random trees,
depth/length-controlled, right-padded to ``seq_len`` with a 0/1 mask.

Vocabulary: PAD=0, digits 1..10, ops 11..14, close 15.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

PAD = 0
DIGIT0 = 1           # digit d -> DIGIT0 + d
OPS = {"MIN": 11, "MAX": 12, "MED": 13, "SM": 14}
CLOSE = 15
VOCAB = 16
NUM_CLASSES = 10


def _sample_tree(r: np.random.Generator, depth: int, breadth: int):
    """Returns (tokens, value)."""
    if depth == 0 or r.random() < 0.3:
        d = int(r.integers(0, 10))
        return [DIGIT0 + d], d
    op_name = ("MIN", "MAX", "MED", "SM")[int(r.integers(0, 4))]
    n = int(r.integers(2, breadth + 1))
    toks: List[int] = [OPS[op_name]]
    vals = []
    for _ in range(n):
        t, v = _sample_tree(r, depth - 1, breadth)
        toks.extend(t)
        vals.append(v)
    toks.append(CLOSE)
    if op_name == "MIN":
        val = min(vals)
    elif op_name == "MAX":
        val = max(vals)
    elif op_name == "MED":
        val = int(np.median(vals))
    else:
        val = sum(vals) % 10
    return toks, val


@dataclasses.dataclass
class ListOps:
    seq_len: int = 512
    batch_per_host: int = 32
    seed: int = 0
    host_id: int = 0
    max_depth: int = 6
    breadth: int = 4

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        r = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S = self.batch_per_host, self.seq_len
        toks = np.zeros((B, S), np.int32)
        labels = np.zeros((B,), np.int32)
        mask = np.zeros((B, S), np.float32)
        for b in range(B):
            while True:
                t, v = _sample_tree(r, self.max_depth, self.breadth)
                if len(t) <= S:
                    break
            toks[b, :len(t)] = t
            mask[b, :len(t)] = 1.0
            labels[b] = v
        return {"tokens": toks, "label": labels, "mask": mask}
