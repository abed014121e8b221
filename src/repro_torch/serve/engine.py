"""Batched serving engine: continuous batching over prefill +
single-token decode with hierarchical KV caches (or, for
``attention='full'``, dense ones), on dense cache slots or a paged page
pool.

Port of ``repro.serve.engine.ServeEngine``, with the reference's
semantics:

* admission is planned per tick by the continuous-batching scheduler
  (``serve/scheduler.py``: token budget, chunked prefill, lookahead);
* prompts are right-padded to power-of-two length buckets (capped at
  ``max_len``) and every planned request of one bucket is prefilled in
  one batched call whose row count is padded to a power of two; a
  ``causal_mode='coarse-q'`` model is served unbucketed (its prefill
  runs the coarse-q operator, its decode the fine-q decode), and so is a
  sliding-window model (gemma3: its local layers keep a rolling cache
  of one row per slot beside the global layers' hierarchical caches);
* ``greedy=False`` samples each token as ``argmax(logits + g)`` with
  Gumbel noise ``g`` (what ``jax.random.categorical`` computes), drawn
  from one seeded generator per request (:meth:`ServeEngine._noise`);
* on dense slots a slot owns ``Hkv`` consecutive rows of every
  hierarchical cache array and row ``s`` of a full or local layer's
  ``{"k", "v", "pos"}`` cache and of an SSM layer's state (mamba2,
  zamba2: ``models.ssm.SSMState``, whose idle slots advance every tick
  until admission overwrites them, as in the reference); admission
  writes the prefilled rows of a group in one pass;
* ``paged=True`` serves from the paged pool (``serve/paged_cache.py``):
  device memory is bounded by ``pool_pages``, not ``slots * max_len``;
  prompt-prefix pages are shared across requests with copy-on-write,
  and pool exhaustion preempts the newest request (requeued; ``swap``
  snapshots restore it bit-exact, ``recompute`` re-prefills) instead of
  failing.  ``cache_dtype='int8'`` stores the pages as int8 with per-row
  scales (``quant_levels``: levels ``[0, n)``, -1 = all).  The dense
  slot path stays as the oracle;
* ``mesh=`` (``launch.mesh.make_mesh((d,), ("data",))``) serves with
  the hierarchical caches split along their sequence axis over the
  mesh's ``d`` shards (``parallel/sp_attention.py``): each h1d layer's
  cache is one slab per shard, prefill runs the band kernels per shard
  with a halo exchange (a local layer's window band too, where its
  padded prompt keeps a whole window per shard), and every decode tick
  runs the partial attend and update kernels per shard, merged across
  shards; the tick's shard geometry is built once on the host and
  copied to the card in one transfer shared by every layer.  A local
  layer's rolling cache and an SSM layer's state stay whole, as the
  reference keeps them on every shard; a stack with no hierarchical
  cache (mamba2) builds no geometry.  On a rank mesh (one shard a
  process, ``parallel/group.py``) every rank runs this same engine loop
  on the same requests (SPMD), holding only its own shard of each slot's
  hierarchical caches; the merged logits, and so the tokens, are the
  same on every rank (``REPRO_RANK_CHECK=1`` all-gathers each sampled
  batch and asserts it);
* prompts longer than ``max_len - 1`` are rejected or tail-truncated at
  ``submit`` (``overflow``);
* generation ends at ``max_new_tokens``, a full cache, or a stop token
  (kept in ``out_tokens``);
* finished and idle slots are frozen (their position stops advancing),
  so their cache writes stay in range;
* per-tick bookkeeping reads a host-side numpy mirror of the positions;
  a paged tick builds its two page tables once on the host and copies
  them to the card in one non-blocking transfer shared by every layer.

Everything runs under ``torch.inference_mode()``.  The encoder-decoder
family is refused, as the reference refuses it (its prefill needs each
request's frames; ``models/encdec.py``'s prefill and decode step serve
it directly).

Telemetry (``repro_torch.obs``, behind ``obs.enabled()``) as the
reference records it: ``serve.requests`` at submit; TTFT
(``serve.ttft_s``), inter-token latency (``serve.itl_s``) and request
latency (``serve.request_latency_s``), keyed by request so that they
survive preemption; per tick ``serve.ticks``, ``serve.queue_depth``,
``serve.active_slots``, ``serve.token_budget_util``, ``pool.occupancy``
and the pool's counters as deltas (``pool.*``); ``serve.admissions``,
``serve.preemptions``, ``serve.restores``; the spans ``serve.tick``,
``serve.admit``, ``serve.prepare`` and ``serve.decode`` (the layers'
dispatch: eager launches return before the device runs them, and the
tick ends in the host's read of the sampled tokens).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import hierarchy as hc
from ..kernels.tuning import canonical_impl
from ..models import ModelConfig, get_model
from ..models.ssm import SSMState
from ..parallel import group as grp
from ..parallel import sp_attention as sp
from . import paged_cache as pc
from .scheduler import ContinuousBatchingScheduler, QueueEntry


#: the reference engine's refusal of the encoder-decoder family
ENCDEC_REFUSAL = ("ServeEngine targets decoder-only families; enc-dec "
                  "serving goes through launch/serve.py with per-request "
                  "encoder runs")


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
    ``params``.

    ``paged=True`` serves from per-layer pools of ``pool_pages`` nr-row
    pages (default: the dense-equivalent ``slots * max_len / nr``) plus
    proportionally sized coarse-level pools; it requires a uniform h1d
    attention stack and is host-local (``mesh`` must be None).
    ``prefix_sharing`` maps bit-identical prompt-prefix pages once
    across requests, copy-on-write.  ``preempt_mode`` is ``'swap'``
    (snapshot the victim's pages to host memory) or ``'recompute'``.
    ``cache_dtype`` (default ``cfg.cache_dtype``) is ``'fp32'`` or
    ``'int8'`` (requires ``paged=True``); ``quant_levels`` (default
    ``cfg.cache_quant_levels``) limits int8 to levels ``[0, n)``.
    ``token_budget`` / ``lookahead`` / ``prefill_chunk`` tune the
    scheduler for either path.

    ``mesh`` (an ``SPMesh`` on the engine's device, whose axis must be
    ``sp_axis``) enables sequence-parallel serving: the hierarchical
    slot caches are split along their sequence axis over the mesh's
    ``d`` shards (rolling caches and SSM states stay whole) and prefill
    and decode run inside ``sp_scope(mesh)``; on a rank mesh each rank
    runs the engine on the same requests and holds its own shard.  Requires
    ``attention='h1d'`` and a padded ``max_len`` that is a multiple of
    ``d * nr`` (one level-0 block per shard), as the reference does, for
    every family it serves (dense, MoE, VLM, sliding-window, SSM,
    hybrid); a 1-way mesh serves as without one.

    ``greedy=False`` samples; ``seed`` seeds the noise (see
    :meth:`_noise`)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 512, greedy: bool = True, seed: int = 0,
                 overflow: str = "error", mesh=None, sp_axis: str = "data",
                 paged: bool = False,
                 pool_pages: Optional[int] = None, prefix_sharing: bool = True,
                 token_budget: Optional[int] = None, lookahead: int = 0,
                 prefill_chunk: Optional[int] = None,
                 preempt_mode: str = "swap",
                 cache_dtype: Optional[str] = None,
                 quant_levels: Optional[int] = None):
        # a typo'd decode_impl fails here, as the reference's engine does;
        # a valid one selects nothing (the tensors' device does)
        canonical_impl(cfg.decode_impl)
        if preempt_mode not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt_mode {preempt_mode!r}")
        if cache_dtype is None:
            cache_dtype = cfg.cache_dtype
        if cache_dtype not in ("fp32", "int8"):
            raise ValueError(f"unknown cache_dtype {cache_dtype!r}")
        if quant_levels is None:
            quant_levels = cfg.cache_quant_levels
        if cache_dtype == "int8" and not paged:
            raise ValueError("cache_dtype='int8' requires paged=True: the "
                             "dense slab cache has no per-page scale "
                             "side-band")
        if cfg.family == "encdec":
            raise NotImplementedError(ENCDEC_REFUSAL)
        if overflow not in ("error", "truncate"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        if paged:
            if mesh is not None:
                raise ValueError("paged serving is host-local: the page "
                                 "tables are host state; use either "
                                 "paged=True or mesh=, not both")
            if (cfg.attention != "h1d" or cfg.sliding_window > 0
                    or cfg.global_every > 0
                    or cfg.family not in ("dense", "moe", "vlm")):
                raise ValueError(
                    "paged serving requires a uniform h1d attention stack "
                    f"(family={cfg.family!r}, attention={cfg.attention!r}, "
                    f"sliding_window={cfg.sliding_window}, "
                    f"global_every={cfg.global_every})")
        if mesh is not None and mesh.axis != sp_axis:
            raise ValueError(f"the mesh shards over axis {mesh.axis!r}, the "
                             f"engine over sp_axis={sp_axis!r}")
        sp_d = mesh.d if mesh is not None else 1
        if sp_d > 1:
            if cfg.attention != "h1d":
                raise ValueError(
                    "SP serving shards the hierarchical cache's sequence "
                    f"axis; attention={cfg.attention!r} has no such cache")
            Lp = hc.padded_length(max_len, cfg.nr)
            if not sp.sp_shardable(Lp, sp_d, cfg.nr):
                raise ValueError(
                    f"SP serving: padded max_len {Lp} cannot keep one "
                    f"nr={cfg.nr} block per shard on a {sp_d}-way "
                    f"'{sp_axis}' axis; use fewer shards or a longer "
                    f"max_len")
        self.greedy = greedy
        self.seed = seed
        # one noise generator per request in flight, keyed by id(req)
        self._streams: Dict[int, torch.Generator] = {}
        # prompt length bucketing pads a prompt with real (weight-1)
        # tokens; off (the reference's rules) for the recurrent families
        # (ssm, hybrid), whose prefill scan over the pads would corrupt the
        # state, and for a sliding window, whose
        # rolling cache keeps the LAST 2 * window rows so pads would evict
        # real in-window keys, and for h1d coarse-q, whose coarse QUERIES
        # average the pad embeddings across cluster boundaries and shift
        # the logits at the true last token; on for full attention, whose
        # pads sit past the true length in causal order and in cache
        # slots each overwritten before its position comes up
        self._bucket = (cfg.family not in ("ssm", "hybrid")
                        and cfg.sliding_window == 0
                        and (cfg.attention != "h1d"
                             or cfg.causal_mode == "fine-q"))
        self.cache_dtype = cache_dtype
        self.quant_levels = quant_levels
        self.cfg = cfg
        self.params = params
        self.overflow = overflow
        self.fns = get_model(cfg)
        self.slots = slots
        self.max_len = max_len
        self.Lmax = hc.padded_length(max_len, cfg.nr)
        self.device = params["embed"]["w"].device
        self.mesh = mesh
        self.sp_d = sp_d
        if sp_d > 1 and mesh.device != self.device:
            raise ValueError(f"the mesh's shards sit on {mesh.device}, "
                             f"the parameters on {self.device}")
        # SPMD debug check: every rank samples the same tokens
        self._rank_check = (sp_d > 1 and mesh.group is not None
                            and bool(os.environ.get("REPRO_RANK_CHECK")))
        self.sched = ContinuousBatchingScheduler(
            token_budget=token_budget, lookahead=lookahead,
            prefill_chunk=prefill_chunk)
        self.paged = paged
        self.pool = None
        with torch.inference_mode():
            if paged:
                if pool_pages is None:       # dense-equivalent
                    pool_pages = slots * (self.Lmax // cfg.nr)
                self.pool = pc.PagePool(
                    slots=slots, max_len=max_len, nr=cfg.nr,
                    pool_pages=pool_pages,
                    quant_levels=(quant_levels if cache_dtype == "int8"
                                  else 0))
                self.prefix_sharing = prefix_sharing
                self.preempt_mode = preempt_mode
                self.caches = pc.init_paged_caches(cfg, self.pool,
                                                   device=self.device)
            else:
                self.caches = self.fns.init_caches(params, cfg, slots,
                                                   max_len)
                if sp_d > 1:
                    self.caches = sp.shard_caches(self.caches, mesh,
                                                  cfg.nr)
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
        # admission prompt per slot (preemption rebuilds the resume
        # prompt from it) and admission serial (preemption victim order)
        self._admitted: List[Optional[np.ndarray]] = [None] * slots
        self._admit_serial: Dict[int, int] = {}
        self._serial = 0
        self.preemptions = 0
        self.queue: List[QueueEntry] = []
        # telemetry bookkeeping: submit and last-token wall-clock marks
        # keyed by id(req) (TTFT, inter-token latency), this tick's
        # admitted prefill tokens (token-budget use) and the pool counters
        # last mirrored into obs (as deltas); written only while
        # obs.enabled()
        self._t_submit: Dict[int, float] = {}
        self._t_last: Dict[int, float] = {}
        self._tick_prefill_tokens = 0
        self._pool_seen: Dict[str, int] = {}

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
        if obs.enabled():
            self._t_submit[id(req)] = time.perf_counter()
            obs.counter("serve.requests").inc()

    # -- telemetry -----------------------------------------------------
    def _note_token(self, req: Request) -> None:
        """TTFT on a request's first generated token, inter-token latency
        on every later one."""
        now = time.perf_counter()
        rid = id(req)
        if len(req.out_tokens) == 1:
            t0 = self._t_submit.get(rid)
            if t0 is not None:
                obs.histogram("serve.ttft_s").observe(now - t0)
        else:
            last = self._t_last.get(rid)
            if last is not None:
                obs.histogram("serve.itl_s").observe(now - last)
        self._t_last[rid] = now

    def _note_finish(self, req: Request) -> None:
        obs.counter("serve.finished").inc()
        rid = id(req)
        self._t_last.pop(rid, None)
        t0 = self._t_submit.pop(rid, None)
        if t0 is not None:
            obs.histogram("serve.request_latency_s").observe(
                time.perf_counter() - t0)

    def _tick_obs(self, n_active: int) -> None:
        """Per-tick gauges and counters (telemetry on only)."""
        obs.counter("serve.ticks").inc()
        obs.gauge("serve.queue_depth").set(len(self.queue))
        obs.gauge("serve.active_slots").set(n_active)
        budget = self.sched.token_budget
        if budget:
            used = self._tick_prefill_tokens + n_active
            obs.gauge("serve.token_budget_util").set(used / budget)
        self._tick_prefill_tokens = 0
        if self.paged:
            obs.gauge("pool.occupancy").set(self.pool.occupancy())
            for k, v in self.pool.stats.snapshot().items():
                delta = v - self._pool_seen.get(k, 0)
                if delta:
                    obs.counter(f"pool.{k}").inc(delta)
                    self._pool_seen[k] = v

    def _bucket_len(self, S: int) -> int:
        """Padded prompt length: next power of two capped at max_len
        (``S`` itself when bucketing is off for the config)."""
        if not self._bucket:
            return S
        return max(S, min(1 << max(S - 1, 0).bit_length(), self.max_len))

    # -- sampling ------------------------------------------------------
    def _noise(self, rows: List[int], reqs: List[Optional[Request]],
               vocab: int, tick: bool) -> torch.Tensor:
        """Gumbel noise ``(len(rows), vocab)`` float32 for one sampling
        call: a prefill group (``tick=False``; ``rows`` are the
        destination slots, then ``slots, slots+1, ...`` for the pad rows,
        as the reference folds its per-row keys) or a decode tick
        (``tick=True``; ``rows`` are all the slots).  ``reqs[i]`` is the
        request whose token row ``i`` samples, or None where the token is
        dropped (pad rows, idle slots, chunked-prefill feeds): those rows
        get zeros.

        Each request draws from its own generator, seeded from
        ``(seed, uid)`` and advanced by ``vocab`` uniforms per sampled
        token, so its tokens depend on neither its slot, nor the other
        requests, nor the pad rows of its bucket.  Requests with the same
        uid share a stream.  (A test replaces this method to hand in the
        reference's own draws.)"""
        g = torch.zeros((len(rows), vocab), dtype=torch.float32,
                        device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        for i, req in enumerate(reqs):
            if req is None:
                continue
            gen = self._streams.get(id(req))
            if gen is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(np.random.SeedSequence(
                    [self.seed, req.uid]).generate_state(1, np.uint64)[0]))
                self._streams[id(req)] = gen
            u = torch.rand(vocab, generator=gen, device=self.device)
            g[i] = -torch.log(-torch.log(u.clamp_(min=tiny)))
        return g

    def _sample(self, logits, rows, reqs, tick: bool) -> torch.Tensor:
        """Next tokens (int32) of ``logits`` (R, V): the argmax, or with
        ``greedy=False`` the argmax of ``logits + g`` (``_noise``)."""
        if not self.greedy:
            logits = logits.float() + self._noise(rows, reqs,
                                                  logits.shape[-1], tick)
        tok = logits.argmax(-1).to(torch.int32)
        if self._rank_check:
            every = grp.all_gather(tok[None], self.mesh.group, 0, "slice")
            if not bool((every == tok).all()):
                raise AssertionError(
                    f"REPRO_RANK_CHECK: the ranks sampled different tokens: "
                    f"{every.tolist()}")
        return tok

    def _finish(self, s: int) -> None:
        """Release slot ``s`` whose request is done, with its noise."""
        self._streams.pop(id(self.req[s]), None)
        self._release(s)

    def _stopped(self, req: Request, tok: int) -> bool:
        return bool(req.stop_tokens) and tok in req.stop_tokens

    def _set_slots(self, slots: List[int], tok: List[int], pos: List[int]):
        """Scatter tokens and positions of ``slots`` on the device."""
        if not slots:
            return
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self.tokens[idx] = torch.as_tensor(tok, dtype=torch.int32,
                                           device=self.device)
        self.pos[idx] = torch.as_tensor(pos, dtype=torch.int32,
                                        device=self.device)

    def _activate(self, s: int):
        self.active[s] = True
        self._serial += 1
        self._admit_serial[s] = self._serial

    # -- admission -----------------------------------------------------
    def _can_admit_fn(self) -> Callable[[QueueEntry], bool]:
        """Admission feasibility for the scheduler.  The paged probe
        commits its per-level net page need on success, so entries
        planned earlier in the SAME tick count against later ones."""
        if not self.paged:
            return lambda e: True
        planned = [0] * self.pool.M

        def can(e: QueueEntry) -> bool:
            chunk = e.prompt[:self.sched.chunk_len(len(e.prompt))]
            need = self.pool.net_need(np.asarray(chunk, np.int32),
                                      share=self.prefix_sharing)
            if all(need[l] + planned[l] <= self.pool.available(l)
                   for l in range(self.pool.M)):
                for l in range(self.pool.M):
                    planned[l] += need[l]
                return True
            return False

        return can

    def _admit(self):
        """Plan this tick's admissions and run one batched prefill per
        planned bucket group.  Swap-preempted entries restore first (no
        prefill; their pages scatter straight back), scanned over the
        same lookahead window."""
        free = [s for s in range(self.slots) if not self.active[s]]
        if not free or not self.queue:
            return
        j = 0
        while free and j < min(len(self.queue), self.sched.lookahead + 1):
            entry = self.queue[j]
            if entry.restore is not None and self._try_restore(entry,
                                                               free[0]):
                free.pop(0)
                self.queue.pop(j)
            else:
                j += 1
        if not free or not self.queue:
            return
        can = self._can_admit_fn()
        groups, self.queue = self.sched.plan(
            self.queue, len(free), int(self.active.sum()), self._bucket_len,
            lambda e: e.restore is None and can(e))
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
        with sp.sp_scope(self.mesh):
            logits, caches, _ = self.fns.prefill(
                self.params, self.cfg, batch, self.max_len,
                true_len=torch.as_tensor(ns, device=self.device))
        dst = free[:g]
        del free[:g]

        kept = [True] * g
        if self.paged:
            kept = self._paged_admit_writes(group, dst, caches)
            if not any(kept):
                return
        # a row's token is sampled where it is kept and ends the prompt
        # (a chunked or resumed prompt drops it); pad rows past the slots
        rows = dst + list(range(self.slots, self.slots + gp - g))
        takers = [e.req if kept[i] and len(e.prompt) == ns[i]
                  and e.resume_token is None else None
                  for i, e in enumerate(group.entries)] + [None] * (gp - g)
        nxt = self._sample(logits, rows, takers, tick=False).cpu().numpy()

        if not self.paged:
            # slot s owns rows [s*r, (s+1)*r) of every hierarchical cache
            # array and row s of a full or local layer's dense or rolling
            # cache, whose every slot (pos -1 where empty) the prefill's
            # overwrites, and of an SSM layer's state (h and conv)
            r = self.cfg.num_kv_heads
            slots = torch.as_tensor(dst, device=self.device)
            rows = None
            for full, one in zip(self.caches, caches):
                if isinstance(full, dict):
                    for key, fa in full.items():
                        fa.index_copy_(0, slots, one[key][:g])
                    continue
                if isinstance(full, SSMState):
                    for fa, oa in zip(full, one):
                        fa.index_copy_(0, slots, oa[:g])
                    continue
                if rows is None:
                    rows = torch.as_tensor(
                        np.concatenate([np.arange(s * r, (s + 1) * r)
                                        for s in dst]), device=self.device)
                if self.sp_d > 1:      # one slice per shard and level
                    sp.scatter_rows(full, one, rows, self.mesh)
                    continue
                for fa, oa in zip((full.k, full.v, *full.ck, *full.cv),
                                  (one.k, one.v, *one.ck, *one.cv)):
                    fa.index_copy_(0, rows, oa[:g * r])

        slot_w: List[int] = []
        tok_w: List[int] = []
        pos_w: List[int] = []
        for i, entry in enumerate(group.entries):
            if not kept[i]:
                continue
            s = dst[i]
            req = entry.req
            chunk_n = int(ns[i])
            if obs.enabled():
                obs.counter("serve.admissions").inc()
                self._tick_prefill_tokens += chunk_n
            self.pos_host[s] = chunk_n
            self._admitted[s] = entry.prompt
            slot_w.append(s)
            pos_w.append(chunk_n)
            remainder = list(entry.prompt[chunk_n:].tolist())
            if entry.resume_token is not None:
                # preemption-resume: the next input was sampled before
                # the preemption -- never re-sample it
                remainder.append(int(entry.resume_token))
            if remainder:
                # chunked prefill (or resume): the next input is known,
                # the sampled token is dropped and the tail streams
                # through the decode ticks
                tok_w.append(remainder[0])
                self.feed[s] = remainder[1:]
                self.req[s] = req
                self._activate(s)
                continue
            tok_w.append(int(nxt[i]))
            self.feed[s] = []
            self.req[s] = req
            req.out_tokens.append(int(nxt[i]))
            if obs.enabled():
                self._note_token(req)
            # the first token may already end the request: the slot then
            # never activates, so max_new_tokens is a hard cap
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or chunk_n >= self.max_len - 1
                    or self._stopped(req, int(nxt[i])))
            if done:
                if obs.enabled():
                    self._note_finish(req)
                self._finish(s)
            else:
                self._activate(s)
        self._set_slots(slot_w, tok_w, pos_w)

    def _paged_admit_writes(self, group, dst, caches) -> List[bool]:
        """Map pool pages for every entry (prefix-sharing aware) and
        scatter the freshly prefilled blocks into the registry-missed
        pages.  An entry the pool cannot hold is unwound and requeued at
        the head.  Returns the per-entry kept mask."""
        writes = []
        kept = [False] * len(group.entries)
        failed = []
        for i, (entry, chunk) in enumerate(zip(group.entries,
                                               group.chunks)):
            s = dst[i]
            try:
                w = self.pool.admit(s, np.asarray(chunk, np.int32),
                                    share=self.prefix_sharing)
                writes.append((i, w))
                kept[i] = True
            except pc.PoolExhausted:
                self.pool.release_slot(s)
                failed.append(entry)
        # requeue unwound entries as a block, preserving arrival order
        self.queue[:0] = failed
        if writes:
            pc.scatter_prefill(self.caches, caches, writes,
                               self.cfg.num_kv_heads, self.cfg.nr)
        return kept

    # -- release / preemption ------------------------------------------
    def _release(self, s: int):
        """Finish a slot: free its pages, clear bookkeeping."""
        self.active[s] = False
        self.req[s] = None
        self.feed[s] = []
        self._admitted[s] = None
        self._admit_serial.pop(s, None)
        if self.paged:
            self.pool.release_slot(s)

    def _preempt(self, victim: int):
        """Evict a running request from its slot (pool pressure) and
        requeue it at the HEAD.  ``swap`` snapshots its pages to host
        memory and restores them bit-exact at re-admission; ``recompute``
        folds the generated tokens into a resume prompt and re-prefills
        (the recomputed cache matches the decode-built one to ~1e-6, so
        greedy continuations may drift at argmax near-ties); the already
        sampled next input rides along as ``resume_token``."""
        req = self.req[victim]
        base = self._admitted[victim]
        if self.preempt_mode == "swap":
            snap = pc.snapshot_slot(self.caches, self.pool, victim,
                                    self.cfg.num_kv_heads)
            entry = QueueEntry(
                req=req, prompt=base,
                restore={"pos": int(self.pos_host[victim]),
                         "tok": int(self.tokens[victim]),
                         "feed": list(self.feed[victim]), "pages": snap})
        elif req.out_tokens:
            prompt = np.concatenate(
                [base, np.asarray(req.out_tokens[:-1], np.int32)])
            entry = QueueEntry(req=req, prompt=prompt.astype(np.int32),
                               resume_token=int(req.out_tokens[-1]))
        else:
            # recompute mode, still prefilling: redo the whole prompt
            entry = QueueEntry(req=req, prompt=base)
        self.queue.insert(0, entry)
        self._release(victim)
        self.preemptions += 1
        obs.counter("serve.preemptions").inc()

    def _try_restore(self, entry: QueueEntry, s: int) -> bool:
        """Swap-in a preempted entry into free slot ``s``; False when
        the pool cannot hold its pages yet."""
        snap = entry.restore["pages"]
        need = {l: len(entry_l[0]) for l, entry_l in snap.items()}
        if any(n > self.pool.available(l) for l, n in need.items()):
            return False
        try:
            pc.restore_slot(self.caches, self.pool, s, snap,
                            self.cfg.num_kv_heads)
        except pc.PoolExhausted:       # estimate raced; unwind
            self.pool.release_slot(s)
            return False
        self.req[s] = entry.req
        self._admitted[s] = entry.prompt
        self.feed[s] = list(entry.restore["feed"])
        self.pos_host[s] = entry.restore["pos"]
        self._set_slots([s], [int(entry.restore["tok"])],
                        [int(entry.restore["pos"])])
        self._activate(s)
        obs.counter("serve.restores").inc()
        return True

    def _paged_prepare(self):
        """Allocate / copy-on-write this tick's write-set pages for every
        active slot, preempting the newest request on pool exhaustion."""
        copies: Dict[int, List[Tuple[int, int]]] = {}

        def flush():
            # preemption snapshots read the pools: pending copies
            # (possibly the victim's own) must land first
            nonlocal copies
            if copies:
                pc.apply_copies(self.caches, copies, self.cfg.num_kv_heads)
                copies = {}

        order = sorted((serial, s) for s, serial in
                       self._admit_serial.items())
        for _, s in order:
            if not self.active[s]:
                continue
            while True:
                try:
                    self.pool.prepare_tick(s, int(self.pos_host[s]), copies)
                    break
                except pc.PoolExhausted:
                    victim = self.sched.choose_victim(self._admit_serial)
                    if victim == s and len(self._admit_serial) == 1:
                        raise RuntimeError(
                            "page pool exhausted with a single active "
                            "request; increase pool_pages") from None
                    flush()
                    self._preempt(victim)
                    if victim == s:    # newest == self: requeued, move on
                        break
        flush()

    # -- tick ----------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick: admit + one decode step for all slots.
        Returns the number of active slots."""
        with obs.span("serve.tick", tid=obs.TRACK_SERVE):
            n = self._step()
        if obs.enabled():
            self._tick_obs(n)
        return n

    def _step(self) -> int:
        with obs.span("serve.admit", tid=obs.TRACK_SERVE):
            self._admit()
        if not self.active.any():
            return 0
        if self.paged:
            with obs.span("serve.prepare", tid=obs.TRACK_SERVE):
                self._paged_prepare()
            if not self.active.any():        # everything preempted
                return 0
            tabs = pc.tables_to_device(
                *self.pool.build_tables(self.pos_host, self.active,
                                        self.cfg.num_kv_heads), self.device)
            with obs.span("serve.decode", tid=obs.TRACK_SERVE):
                logits, self.caches = self.fns.decode_step(
                    self.params, self.cfg, self.caches, self.tokens,
                    self.pos, page_tables=tabs)
        elif self.sp_d > 1:
            # every row of a slot decodes its position; the geometry of
            # this tick serves every sharded layer (none: every cache is
            # whole, as an SSM stack's, and no table is built)
            tabs = None
            if any(isinstance(c, sp.SPCache) for c in self.caches):
                tabs = sp.sp_tables(
                    np.repeat(self.pos_host, self.cfg.num_kv_heads),
                    nr=self.cfg.nr, Lmax=self.Lmax, d=self.sp_d,
                    device=self.device)
            with obs.span("serve.decode", tid=obs.TRACK_SERVE), \
                    sp.sp_scope(self.mesh):
                logits, self.caches = self.fns.decode_step(
                    self.params, self.cfg, self.caches, self.tokens,
                    self.pos, sp_tables=tabs)
        else:
            with obs.span("serve.decode", tid=obs.TRACK_SERVE):
                logits, self.caches = self.fns.decode_step(
                    self.params, self.cfg, self.caches, self.tokens,
                    self.pos)
        nxt = self._sample(
            logits, list(range(self.slots)),
            [self.req[s] if self.active[s] and not self.feed[s] else None
             for s in range(self.slots)], tick=True)
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
            if obs.enabled():
                self._note_token(req)
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or int(self.pos_host[s]) >= self.max_len - 1
                    or self._stopped(req, int(nxt_host[s])))
            if done:
                if obs.enabled():
                    self._note_finish(req)
                self._finish(s)
        if feed_idx:
            self.tokens[torch.as_tensor(feed_idx, device=self.device)] = (
                torch.as_tensor(feed_tok, dtype=torch.int32,
                                device=self.device))
        return int(self.active.sum())

    def run(self) -> None:
        while self.queue or self.active.any():
            self.step()
