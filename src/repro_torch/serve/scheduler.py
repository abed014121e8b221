"""Continuous-batching scheduler for the serving engine.

A copy of the numpy-only ``repro.serve.scheduler`` (the port imports
nothing of the JAX package).

Replaces the rigid "admit whatever shares the head-of-queue's bucket"
FIFO loop with a per-tick plan:

* **token budget** -- each tick spends at most ``token_budget`` tokens
  of model work: one per active (decoding or prompt-feeding) slot plus
  the prefill-chunk length of every admission.  ``None`` = unlimited,
  which reproduces the legacy admission behavior exactly (the dense
  parity oracle's schedule).
* **chunked prefill** -- prompts longer than ``prefill_chunk`` are
  admitted on their first ``prefill_chunk`` tokens only; the remainder
  streams through the regular batched DECODE ticks (the slot is in a
  "feeding" state: its next input token comes from the prompt and the
  logits are discarded until the prompt is exhausted), so one huge
  prompt no longer stalls every running decode for a full-prompt
  prefill.
* **lookahead** -- a bounded skip-ahead window: when the head of the
  queue does not fit (budget or page availability), up to ``lookahead``
  later requests may be admitted first.  FIFO order is preserved inside
  the window scan, so starvation is bounded by the window size.
* **preemption** -- when the paged pool is exhausted mid-tick the
  engine asks :func:`choose_victim` for a slot to release; the victim is
  requeued at the HEAD of the queue (recompute-on-resume) per
  :class:`QueueEntry`'s resume fields.

The scheduler is pure host-side bookkeeping: it never touches device
state and knows nothing about the model.  The engine supplies callbacks
for bucketing and admission feasibility (the paged pool's availability
probe; always-true for the dense path).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class QueueEntry:
    """One queued unit of work.  ``prompt`` is the ADMITTED prompt (may
    be tail-truncated by the engine's overflow policy, or extended with
    already-generated tokens on preemption-resume).  ``resume_token``,
    when set, is the already-sampled next input token: at re-admission
    the engine discards the prefill's sampled token (it would re-sample
    and, for non-greedy requests, diverge) and feeds this one instead."""
    req: Any
    prompt: np.ndarray
    resume_token: Optional[int] = None
    # preemption mode 'swap': host-side page snapshot + resume state
    # ({'pos', 'tok', 'feed', 'pages'}); restored bit-exact without any
    # recompute (serve/paged_cache.snapshot_slot / restore_slot)
    restore: Optional[dict] = None


@dataclasses.dataclass
class AdmitGroup:
    """One batched prefill call: entries whose prefill chunks share a
    padded-length bucket."""
    entries: List[QueueEntry]
    chunks: List[np.ndarray]       # per entry: prompt[:chunk_len]
    bucket: int                    # shared padded chunk length


class ContinuousBatchingScheduler:
    def __init__(self, *, token_budget: Optional[int] = None,
                 lookahead: int = 0, prefill_chunk: Optional[int] = None):
        if token_budget is not None and token_budget < 1:
            raise ValueError("token_budget must be >= 1 or None")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 or None")
        self.token_budget = token_budget
        self.lookahead = int(lookahead)
        self.prefill_chunk = prefill_chunk

    def chunk_len(self, S: int) -> int:
        if self.prefill_chunk is None:
            return S
        return min(S, self.prefill_chunk)

    def plan(self, queue: List[QueueEntry], free_slots: int, n_active: int,
             bucket_len: Callable[[int], int],
             can_admit: Callable[[QueueEntry], bool],
             ) -> Tuple[List[AdmitGroup], List[QueueEntry]]:
        """Plan this tick's admissions.

        Returns ``(groups, remaining_queue)``.  Each group is one
        batched prefill; the union of group entries is removed from the
        queue.  With ``token_budget=None``, ``lookahead=0`` and no
        chunking this reduces exactly to the legacy loop: pop the head,
        pull consecutive same-bucket entries up to the free-slot count,
        repeat."""
        queue = list(queue)
        budget = (np.inf if self.token_budget is None
                  else max(self.token_budget - n_active, 0))
        groups: List[AdmitGroup] = []

        def fits(entry: QueueEntry, is_first_pick: bool) -> bool:
            cost = self.chunk_len(len(entry.prompt))
            if cost > budget:
                # anti-starvation: an otherwise idle engine always
                # admits its first pick, however long the chunk
                if not (is_first_pick and n_active == 0 and not groups):
                    return False
            return can_admit(entry)

        while free_slots > 0 and queue:
            window = min(len(queue), self.lookahead + 1)
            pick = next((j for j in range(window)
                         if fits(queue[j], is_first_pick=True)), None)
            if pick is None:
                break
            head = queue.pop(pick)
            chunk = self.chunk_len(len(head.prompt))
            Lb = bucket_len(chunk)
            group = AdmitGroup(entries=[head],
                               chunks=[head.prompt[:chunk]], bucket=Lb)
            budget -= chunk
            free_slots -= 1
            j = 0
            while j < min(len(queue), self.lookahead + 1) and free_slots > 0:
                e = queue[j]
                c = self.chunk_len(len(e.prompt))
                if bucket_len(c) == Lb and fits(e, is_first_pick=False):
                    queue.pop(j)
                    group.entries.append(e)
                    group.chunks.append(e.prompt[:c])
                    budget -= c
                    free_slots -= 1
                elif self.lookahead == 0:
                    break          # legacy semantics: consecutive only
                else:
                    j += 1
            groups.append(group)
            if budget <= 0:
                break
        return groups, queue

    # ------------------------------------------------------------------
    @staticmethod
    def choose_victim(admit_serial: Dict[int, int],
                      exclude: Sequence[int] = ()) -> Optional[int]:
        """Preemption victim: the most recently admitted active slot
        (LIFO -- oldest work keeps its pages, so total recompute waste
        is bounded), excluding ``exclude`` (e.g. the slot currently
        being provisioned when it is the only one left)."""
        cands = [(serial, s) for s, serial in admit_serial.items()
                 if s not in exclude]
        if not cands:
            return None
        return max(cands)[1]
