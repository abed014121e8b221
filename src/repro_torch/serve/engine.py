"""Batched serving engine on dense cache slots: continuous batching over
prefill + single-token decode with hierarchical KV caches.

Port of ``repro.serve.engine.ServeEngine`` for dense slots and greedy
decoding, with the reference's semantics:

* admission is planned per tick by the continuous-batching scheduler
  (``serve/scheduler.py``: token budget, chunked prefill, lookahead);
* prompts are right-padded to power-of-two length buckets (capped at
  ``max_len``) and every planned request of one bucket is prefilled in
  one batched call whose row count is padded to a power of two;
* a slot owns ``Hkv`` consecutive rows of every cache array; admission
  writes the prefilled rows of a group in one pass;
* prompts longer than ``max_len - 1`` are rejected or tail-truncated at
  ``submit`` (``overflow``);
* generation ends at ``max_new_tokens``, a full cache, or a stop token
  (kept in ``out_tokens``);
* finished and idle slots are frozen (their position stops advancing),
  so their cache writes stay in range;
* per-tick bookkeeping reads a host-side numpy mirror of the positions.

Everything runs under ``torch.inference_mode()``.  Paged pools, int8
pages, sampling, sequence parallelism and telemetry are later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import hierarchy as hc
from ..models import ModelConfig, get_model
from .scheduler import ContinuousBatchingScheduler, QueueEntry


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    stop_tokens: Optional[Sequence[int]] = None
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    """``overflow`` policy for prompts longer than ``max_len - 1``:
    ``'error'`` rejects at ``submit()``; ``'truncate'`` keeps the LAST
    ``max_len - 1`` prompt tokens.  The engine runs on the device of
    ``params``."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 512, greedy: bool = True,
                 overflow: str = "error", paged: bool = False,
                 cache_dtype: Optional[str] = None, mesh=None,
                 token_budget: Optional[int] = None, lookahead: int = 0,
                 prefill_chunk: Optional[int] = None):
        if not greedy:
            raise NotImplementedError("sampling is not ported yet; the "
                                      "engine decodes greedily")
        if paged or mesh is not None:
            raise NotImplementedError("paged and sequence-parallel serving "
                                      "are not ported yet")
        if (cache_dtype or cfg.cache_dtype) != "fp32":
            raise NotImplementedError("int8 cache pages are not ported yet")
        if overflow not in ("error", "truncate"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        if cfg.attention != "h1d" or cfg.causal_mode != "fine-q":
            raise NotImplementedError(
                "the ported engine serves h1d fine-q attention")
        self.cfg = cfg
        self.params = params
        self.overflow = overflow
        self.fns = get_model(cfg)
        self.slots = slots
        self.max_len = max_len
        self.Lmax = hc.padded_length(max_len, cfg.nr)
        self.device = params["embed"]["w"].device
        self.sched = ContinuousBatchingScheduler(
            token_budget=token_budget, lookahead=lookahead,
            prefill_chunk=prefill_chunk)
        with torch.inference_mode():
            self.caches = self.fns.init_caches(params, cfg, slots, max_len)
            self.tokens = torch.zeros((slots,), dtype=torch.int32,
                                      device=self.device)
            self.pos = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)
        # host mirror of ``pos``: the done checks read positions every
        # tick without a device sync per slot
        self.pos_host = np.zeros((slots,), np.int64)
        self.active = np.zeros((slots,), bool)
        self.req: List[Optional[Request]] = [None] * slots
        # chunked prefill: prompt tokens still to stream through decode
        # ticks per slot (their logits are discarded)
        self.feed: List[List[int]] = [[] for _ in range(slots)]
        self.queue: List[QueueEntry] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Queue a request; prompts longer than ``max_len - 1`` are
        rejected or tail-truncated per ``overflow``."""
        prompt = np.asarray(req.prompt, np.int32)
        limit = self.max_len - 1
        if prompt.shape[0] > limit:
            if self.overflow == "truncate":
                prompt = prompt[-limit:]
            else:
                raise ValueError(
                    f"prompt length {prompt.shape[0]} > max_len - 1 = "
                    f"{limit}; shorten the prompt or construct the engine "
                    f"with overflow='truncate'")
        req.out_tokens = []
        self.queue.append(QueueEntry(req=req, prompt=prompt))

    def _bucket_len(self, S: int) -> int:
        """Padded prompt length: next power of two capped at max_len."""
        return max(S, min(1 << max(S - 1, 0).bit_length(), self.max_len))

    def _stopped(self, req: Request, tok: int) -> bool:
        return bool(req.stop_tokens) and tok in req.stop_tokens

    # -- admission -----------------------------------------------------
    def _admit(self):
        free = [s for s in range(self.slots) if not self.active[s]]
        if not free or not self.queue:
            return
        groups, self.queue = self.sched.plan(
            self.queue, len(free), int(self.active.sum()), self._bucket_len,
            lambda e: True)
        for group in groups:
            self._admit_group(group, free)

    def _admit_group(self, group, free: List[int]):
        """One batched prefill of a bucket group; row count padded to a
        power of two (dummy rows discarded)."""
        g = len(group.entries)
        gp = 1 << (g - 1).bit_length()
        prompts = np.zeros((gp, group.bucket), np.int32)
        ns = np.ones((gp,), np.int32)        # dummy rows: true_len 1
        for i, chunk in enumerate(group.chunks):
            prompts[i, :len(chunk)] = chunk
            ns[i] = len(chunk)
        batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
        logits, caches, _ = self.fns.prefill(
            self.params, self.cfg, batch, self.max_len,
            true_len=torch.as_tensor(ns, device=self.device))
        dst = free[:g]
        del free[:g]
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()

        # slot s owns rows [s*r, (s+1)*r) of every cache array, r = Hkv
        r = self.cfg.num_kv_heads
        rows = torch.as_tensor(
            np.concatenate([np.arange(s * r, (s + 1) * r) for s in dst]),
            device=self.device)
        for full, one in zip(self.caches, caches):
            for fa, oa in zip((full.k, full.v, *full.ck, *full.cv),
                              (one.k, one.v, *one.ck, *one.cv)):
                fa.index_copy_(0, rows, oa[:g * r])

        slot_w: List[int] = []
        tok_w: List[int] = []
        pos_w: List[int] = []
        for i, entry in enumerate(group.entries):
            s = dst[i]
            req = entry.req
            chunk_n = int(ns[i])
            self.pos_host[s] = chunk_n
            slot_w.append(s)
            pos_w.append(chunk_n)
            remainder = list(entry.prompt[chunk_n:].tolist())
            if remainder:
                # chunked prefill: the next input is known, the sampled
                # token is dropped and the tail streams through decode
                tok_w.append(remainder[0])
                self.feed[s] = remainder[1:]
                self.req[s] = req
                self.active[s] = True
                continue
            tok_w.append(int(nxt[i]))
            self.feed[s] = []
            self.req[s] = req
            req.out_tokens.append(int(nxt[i]))
            # the first token may already end the request: the slot then
            # never activates, so max_new_tokens is a hard cap
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or chunk_n >= self.max_len - 1
                    or self._stopped(req, int(nxt[i])))
            if done:
                self._release(s)
            else:
                self.active[s] = True
        idx = torch.as_tensor(slot_w, dtype=torch.long, device=self.device)
        self.tokens[idx] = torch.as_tensor(tok_w, dtype=torch.int32,
                                           device=self.device)
        self.pos[idx] = torch.as_tensor(pos_w, dtype=torch.int32,
                                        device=self.device)

    def _release(self, s: int):
        self.active[s] = False
        self.req[s] = None
        self.feed[s] = []

    # -- tick ----------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick: admit + one decode step for all slots.
        Returns the number of active slots."""
        self._admit()
        if not self.active.any():
            return 0
        logits, self.caches = self.fns.decode_step(
            self.params, self.cfg, self.caches, self.tokens, self.pos)
        nxt = logits.argmax(-1).to(torch.int32)
        self.tokens = nxt
        # freeze finished and idle slots: only slots active for THIS
        # decode advance, so an idle slot's writes never leave the cache
        act = self.active.astype(np.int32)
        self.pos = self.pos + torch.as_tensor(act, device=self.device)
        self.pos_host += act
        nxt_host = nxt.cpu().numpy()
        feed_idx: List[int] = []
        feed_tok: List[int] = []
        for s in range(self.slots):
            if not self.active[s]:
                continue
            if self.feed[s]:
                feed_idx.append(s)
                feed_tok.append(self.feed[s].pop(0))
                continue
            req = self.req[s]
            req.out_tokens.append(int(nxt_host[s]))
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or int(self.pos_host[s]) >= self.max_len - 1
                    or self._stopped(req, int(nxt_host[s])))
            if done:
                self._release(s)
        if feed_idx:
            self.tokens[torch.as_tensor(feed_idx, device=self.device)] = (
                torch.as_tensor(feed_tok, dtype=torch.int32,
                                device=self.device))
        return int(self.active.sum())

    def run(self) -> None:
        while self.queue or self.active.any():
            self.step()
