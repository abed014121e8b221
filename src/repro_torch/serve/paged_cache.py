"""Paged hierarchical KV-cache pool: block-pool memory management for the
H-Matrix cache layout.

Port of ``repro.serve.paged_cache``.  The host allocator is the
reference's numpy and Python, copied line for line, with its opt-in
``REPRO_POOL_CHECK=1`` hook (:meth:`PagePool._maybe_check`), which runs
the port's own model checker's invariants (``analysis/pool_model.py``)
after every mutating op; the device side is PyTorch and updates the
pools in place.

The dense serving cache pins ``Lmax`` rows (plus the coarse pyramid)
per slot, so device memory -- not FLOPs -- caps concurrency.  This
module carves every level of the hierarchical cache into PAGES of
``nr`` level-l rows and manages them with:

* a host-side allocator (:class:`PagePool`): per-level free lists,
  per-request page tables, refcounts;
* hierarchical prefix sharing: a page's content is a pure function of
  the token prefix up to the end of its span (clamped to the prompt),
  so a registry keyed by ``(level, block, clamped_len, prefix_hash)``
  lets requests with a common prompt prefix map the SAME physical pages
  -- including each shared subtree's ancestor rows;
* copy-on-write: pages are copied lazily on the first divergent write
  (the per-tick ancestor update touches exactly one page per level --
  the one whose span contains ``t``);
* eviction: pages whose refcount drops to zero but that remain in the
  prefix registry park on an LRU list and are reclaimed on demand;
* preemption hooks: when the pool is exhausted the engine releases a
  victim's pages via :func:`PagePool.release_slot` and requeues it.

Two logical pages per level are reserved: ``ZERO`` (page 0, never
written -- fresh decode pages are initialized by copying it, which keeps
paged pools bit-identical to the zero-initialized dense cache) and
``TRASH`` (page 1 -- inactive engine rows point their update tables at
it, making their in-kernel writes inert without any extra masking).

Physical layout: a logical page covers all ``Hkv`` kv-head rows of its
request, so the device pools have ``num_pages * Hkv`` pool rows and
logical page ``p`` owns rows ``[p*Hkv, (p+1)*Hkv)``; the tick tables
handed to the kernels are already physical (``page * Hkv + head``).
The decode caches are a per-layer list (the port has no stacked
layers), and every function here takes and returns that list.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import h1d_decode as hd
from ..core import hierarchy as hc
from ..core import quantization as qz


class PoolExhausted(RuntimeError):
    """Raised by the allocator when a level's free list and evictable
    list are both empty; the engine answers with preemption."""

    def __init__(self, level: int):
        super().__init__(f"page pool exhausted at level {level}")
        self.level = level


ZERO = 0      # reserved all-zeros page (never written)
TRASH = 1     # reserved write sink for inactive engine rows


@dataclasses.dataclass
class PoolStats:
    """Monotonic pool counters.  ``prefix_hits``/``prefix_misses``
    count LOOKUPS against the prefix registry during prefix-sharing
    admissions (one per page span); ``shared_maps`` counts the hit
    mappings (equal to ``prefix_hits`` in practice)."""
    cow_copies: int = 0
    evictions: int = 0
    shared_maps: int = 0
    fresh_pages: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def prefix_hit_rate(self) -> float:
        """Registry hit rate over prefix-sharing admissions (0.0 when
        no sharing-eligible lookup has happened)."""
        lookups = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / lookups if lookups else 0.0


class PagePool:
    """Host-side allocator for the paged hierarchical cache.

    All bookkeeping is numpy/Python -- the device only ever sees the
    zeroed pools, batched page copies, prefill scatters, and the small
    per-tick indirection tables.
    """

    def __init__(self, *, slots: int, max_len: int, nr: int,
                 pool_pages: int, coarse_pages: Optional[Sequence[int]] = None,
                 quant_levels: int = 0):
        self.nr = nr
        self.Lp = hc.padded_length(max_len, nr)
        self.M = max(hc.num_levels(self.Lp, nr), 1)   # levels incl. fine
        self.slots = slots
        # dtype identity per level: levels < quant_levels store int8
        # pages with per-row scales.  The tag is part of the prefix
        # registry keys: it is part of a page's content identity.
        if quant_levels < 0:
            quant_levels = self.M
        self.quant_levels = min(quant_levels, self.M)
        self.quant = [l < self.quant_levels for l in range(self.M)]
        self.level_dtypes = ["int8:rowscale" if q else "f32"
                             for q in self.quant]
        # logical blocks per level: level l rows (Lp >> l) in nr-row pages
        self.nblocks = [(self.Lp >> l) // nr for l in range(self.M)]
        if pool_pages < 1:
            raise ValueError("pool_pages must be >= 1")
        sizes = [min(pool_pages, slots * self.nblocks[0])]
        for l in range(1, self.M):
            if coarse_pages is not None:
                sizes.append(coarse_pages[l - 1])
            else:
                # capacity proportional to the fine pool but never below
                # one page per slot (every request needs >= 1 page per
                # level regardless of its length)
                sizes.append(min(max(slots, pool_pages >> l),
                                 slots * self.nblocks[l]))
        self.num_pages = [s + 2 for s in sizes]          # + ZERO/TRASH
        self.free: List[List[int]] = [
            list(range(n - 1, 1, -1)) for n in self.num_pages]
        self.refcount = [np.zeros(n, np.int32) for n in self.num_pages]
        self.table = [np.full((slots, nb), -1, np.int32)
                      for nb in self.nblocks]
        # prefix-sharing registry: key -> (level, page); the reverse map
        # tells a writer whether its exclusively-owned page is still
        # advertised (and must be unregistered before mutation)
        self.registry: Dict[tuple, Tuple[int, int]] = {}
        self.key_of: Dict[Tuple[int, int], tuple] = {}
        # refcount-0 pages kept alive only by the registry, LRU order
        self.evictable: "OrderedDict[Tuple[int, int], None]" = OrderedDict()
        self.stats = PoolStats()

    # -- capacity ------------------------------------------------------
    def usable(self, l: int) -> int:
        return self.num_pages[l] - 2

    def used(self, l: int) -> int:
        ev = sum(1 for (ll, _) in self.evictable if ll == l)
        return self.usable(l) - len(self.free[l]) - ev

    def available(self, l: int) -> int:
        """Pages obtainable without preemption (free + evictable)."""
        return self.usable(l) - self.used(l)

    def occupancy(self) -> float:
        tot = sum(self.usable(l) for l in range(self.M))
        return sum(self.used(l) for l in range(self.M)) / max(tot, 1)

    def pages_needed(self, S: int) -> List[int]:
        """Per-level page count covering an S-token prompt."""
        return [max(1, -(-S // (self.nr << l))) for l in range(self.M)]

    def net_need(self, tokens: np.ndarray, *,
                 share: bool = True) -> List[int]:
        """Per-level page need for this prompt, net of prefix-registry
        hits (pages an admission would actually have to allocate)."""
        if not share:
            return self.pages_needed(len(tokens))
        return [sum(1 for key in keys if key not in self.registry)
                for keys in self._span_keys(tokens)]

    def can_admit(self, tokens: np.ndarray, *, share: bool = True) -> bool:
        """Conservative availability probe: needed-minus-shared per
        level against free + evictable."""
        return all(nn <= self.available(l) for l, nn in
                   enumerate(self.net_need(tokens, share=share)))

    # -- registry / refcount internals ---------------------------------
    def _span_keys(self, tokens: np.ndarray) -> List[List[tuple]]:
        """Registry keys for every (level, block) the prompt covers:
        ``(l, dtype_tag, blk, clamped_len, digest)``, the digest a
        CHAINED sha1 over the prefix bytes (each level hashes the prompt
        once; a cryptographic digest makes a cross-prompt collision a
        non-event).  ``dtype_tag`` is the level's storage format: a
        page's bytes are a function of the prefix AND the format."""
        S = len(tokens)
        out: List[List[tuple]] = []
        for l, need in enumerate(self.pages_needed(S)):
            span = self.nr << l
            tag = self.level_dtypes[l]
            h = hashlib.sha1()
            keys = []
            for blk in range(need):
                n = min((blk + 1) * span, S)
                h.update(tokens[blk * span:n].tobytes())
                keys.append((l, tag, blk, n, h.copy().digest()))
            out.append(keys)
        return out

    def _alloc(self, l: int) -> int:
        if self.free[l]:
            return self.free[l].pop()
        for key2 in self.evictable:            # LRU: oldest first
            if key2[0] == l:
                self._unregister(l, key2[1])
                self.evictable.pop(key2)
                self.stats.evictions += 1
                return key2[1]
        raise PoolExhausted(l)

    def _unregister(self, l: int, page: int) -> None:
        key = self.key_of.pop((l, page), None)
        if key is not None:
            self.registry.pop(key, None)

    def _map(self, slot: int, l: int, blk: int, page: int) -> None:
        self.table[l][slot, blk] = page
        if self.refcount[l][page] == 0:
            self.evictable.pop((l, page), None)
        self.refcount[l][page] += 1

    def _decref(self, l: int, page: int) -> None:
        self.refcount[l][page] -= 1
        if self.refcount[l][page] < 0:
            raise AssertionError(f"negative refcount at level {l} page "
                                 f"{page}")
        if self.refcount[l][page] == 0:
            if (l, page) in self.key_of:
                self.evictable[(l, page)] = None       # park, reclaimable
            else:
                self.free[l].append(page)

    def _maybe_check(self, *, slot: Optional[int] = None,
                     t: Optional[int] = None) -> None:
        """Opt-in runtime invariant mode (``REPRO_POOL_CHECK=1``): run
        the model checker's invariant functions after a mutating op, so
        serving and ``analysis/pool_model.py`` share ONE invariant
        definition.  ``slot``/``t`` additionally run the tick write-set
        postconditions.  Raises ``AssertionError`` on a violation."""
        if not os.environ.get("REPRO_POOL_CHECK"):
            return
        from ..analysis import pool_model
        vs = pool_model.check_pool_invariants(self)
        if slot is not None and t is not None:
            vs += pool_model.check_tick_postconditions(self, slot, t)
        if vs:
            raise AssertionError(
                "REPRO_POOL_CHECK: pool invariant violated:\n"
                + "\n".join(f"  [{v.kind}] {v.operand}: {v.detail}"
                            for v in vs))

    # -- request lifecycle ---------------------------------------------
    def admit(self, slot: int, tokens: np.ndarray, *,
              share: bool = True) -> Dict[int, List[Tuple[int, int]]]:
        """Map pages covering the prompt into ``slot``'s tables.

        Returns per level the ``(block, page)`` pairs that MISSED the
        prefix registry -- the engine scatters the dense prefill output
        into exactly those pages (registry hits reuse the existing
        physical page, content already bit-identical).

        TRANSACTIONAL: on :class:`PoolExhausted` every map AND every
        registration this call made is rolled back before re-raising (a
        stale key would serve never-written pages to the next prompt
        that hashes to it).
        """
        if (self.table[0][slot] >= 0).any():
            raise AssertionError("slot not released")
        span_keys = self._span_keys(tokens) if share else None
        writes: Dict[int, List[Tuple[int, int]]] = {}
        placed: List[Tuple[int, int, int, Optional[tuple]]] = []
        try:
            for l, need in enumerate(self.pages_needed(len(tokens))):
                wl = []
                for blk in range(need):
                    key = span_keys[l][blk] if share else None
                    hit = self.registry.get(key) if share else None
                    if hit is not None:
                        self._map(slot, l, blk, hit[1])
                        placed.append((l, blk, hit[1], None))
                        self.stats.shared_maps += 1
                        self.stats.prefix_hits += 1
                    else:
                        p = self._alloc(l)
                        self._map(slot, l, blk, p)
                        self.stats.fresh_pages += 1
                        if share:
                            self.stats.prefix_misses += 1
                        wl.append((blk, p))
                        placed.append((l, blk, p, key))
                        if share:
                            self.registry[key] = (l, p)
                            self.key_of[(l, p)] = key
                writes[l] = wl
        except PoolExhausted:
            for l, blk, p, key in placed:
                if key is not None:
                    self._unregister(l, p)
                self.table[l][slot, blk] = -1
                self._decref(l, p)
            self._maybe_check()
            raise
        self._maybe_check()
        return writes

    def release_slot(self, slot: int) -> None:
        """Drop all of a slot's mappings (finish or preemption).
        Registered pages survive on the evictable LRU for future prefix
        hits; private pages return to the free lists."""
        for l in range(self.M):
            row = self.table[l][slot]
            for blk in np.nonzero(row >= 0)[0]:
                self._decref(l, int(row[blk]))
            row[:] = -1
        self._maybe_check()

    def admit_snapshot(self, slot: int,
                       blocks: Dict[int, Sequence[int]],
                       ) -> Dict[int, List[Tuple[int, int]]]:
        """Re-map a preempted slot's snapshotted blocks onto fresh
        PRIVATE pages (no registry sharing -- see :func:`restore_slot`).
        Returns per level the ``(block, page)`` pairs in block order.
        Raises :class:`PoolExhausted` with the partial mapping LEFT IN
        PLACE -- the caller unwinds with :func:`release_slot`."""
        out: Dict[int, List[Tuple[int, int]]] = {}
        for l, blks in blocks.items():
            pairs = []
            for b in blks:
                p = self._alloc(l)
                self._map(slot, l, int(b), p)
                pairs.append((int(b), p))
            out[l] = pairs
        self._maybe_check()
        return out

    def prepare_tick(self, slot: int, t: int,
                     copies: Dict[int, List[Tuple[int, int]]]) -> None:
        """Make the write-set of position ``t`` (one page per level: the
        page whose span contains ``t``) present and private.

        Fresh pages are zero-initialized by a ZERO-page copy; shared
        pages are copied on write; exclusively-owned pages still
        advertised in the prefix registry are unregistered (their
        content is about to change).  Device copies accumulate into
        ``copies`` (level -> list of (src_page, dst_page)) so a retry
        after :class:`PoolExhausted` + preemption never loses copies
        already scheduled."""
        for l in range(self.M):
            blk = t // (self.nr << l)
            p = int(self.table[l][slot, blk])
            if p < 0:
                np_ = self._alloc(l)
                self._map(slot, l, blk, np_)
                self.stats.fresh_pages += 1
                copies.setdefault(l, []).append((ZERO, np_))
            elif self.refcount[l][p] > 1:
                np_ = self._alloc(l)
                copies.setdefault(l, []).append((p, np_))
                self.table[l][slot, blk] = -1
                self._decref(l, p)
                self._map(slot, l, blk, np_)
                self.stats.cow_copies += 1
            elif (l, p) in self.key_of:
                self._unregister(l, p)
        self._maybe_check(slot=slot, t=t)

    # -- per-tick device tables ----------------------------------------
    def build_tables(self, pos: np.ndarray, active: np.ndarray,
                     Hkv: int) -> Tuple[np.ndarray, np.ndarray]:
        """Physical indirection tables for one decode tick, on the host:
        ``(attend (R, 2 + levels), update (R, 1 + levels))`` int32 (see
        ``core.h1d_decode.PageTables``; :func:`tables_to_device` moves
        them to the card).

        ``pos``: (slots,) host positions; ``active``: (slots,) bool.
        Inactive rows point at TRASH everywhere (attend output is
        discarded, update writes are inert)."""
        nr, M = self.nr, self.M
        R = self.slots * Hkv
        nbands = 2 + (M - 1)
        attend = np.full((R, nbands), TRASH * Hkv, np.int32)
        update = np.full((R, M), TRASH * Hkv, np.int32)
        heads = np.arange(Hkv, dtype=np.int32)
        for s in range(self.slots):
            rows = slice(s * Hkv, (s + 1) * Hkv)
            attend[rows] += heads[:, None]
            update[rows] += heads[:, None]
            if not active[s]:
                continue
            t = int(pos[s])
            b0 = t // nr
            pages = np.empty((nbands,), np.int32)
            pages[0] = self.table[0][s, b0]
            pages[1] = self.table[0][s, b0 - 1] if b0 >= 1 else TRASH
            for l in range(1, M):
                Il = t // (nr << l)
                pages[1 + l] = (self.table[l][s, Il - 1] if Il >= 1
                                else TRASH)
            upages = np.array(
                [self.table[l][s, t // (nr << l)] for l in range(M)],
                np.int32)
            if not ((pages >= 0).all() and (upages >= 0).all()):
                raise AssertionError(f"unmapped page for slot {s} at t={t}: "
                                     f"{pages} {upages}")
            attend[rows] = pages[None, :] * Hkv + heads[:, None]
            update[rows] = upages[None, :] * Hkv + heads[:, None]
        return attend, update


def tables_to_device(attend: np.ndarray, update: np.ndarray,
                     device) -> hd.PageTables:
    """One tick's tables on ``device`` in ONE host-to-device copy: both
    go through a single pinned staging buffer copied with
    ``non_blocking=True`` (PyTorch's pinned-memory allocator keeps the
    buffer alive until the copy has run), so no layer of the tick pays a
    synchronizing copy of its own.  All layers share the result."""
    dev = torch.device(device)
    buf = torch.from_numpy(np.concatenate([attend.ravel(), update.ravel()]))
    if dev.type == "cuda":
        buf = buf.pin_memory().to(dev, non_blocking=True)
    n = attend.size
    return hd.PageTables(attend=buf[:n].view(attend.shape),
                         update=buf[n:].view(update.shape))


# ---------------------------------------------------------------------------
# device-side pool construction and data movement
# ---------------------------------------------------------------------------

def init_paged_caches(cfg, pool: PagePool, device=None) -> list:
    """Model-level paged caches mirroring ``lm_init_decode_caches``: one
    pool per layer (a :class:`~repro_torch.core.h1d_decode.PagedH1DCache`,
    or a ``QuantPagedH1DCache`` when ``pool`` has int8 levels, the split
    read off ``pool.quant``), on ``device`` (default ``cuda``; ``meta``
    sizes a pool by its bytes without allocating it)."""
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    rows = [n * Hkv for n in pool.num_pages]
    if any(pool.quant):
        return [hd.init_quant_paged_pool(rows, pool.nr, Dh, Dh,
                                         dtype=cfg.torch_dtype,
                                         quant=tuple(pool.quant),
                                         device=device)
                for _ in range(cfg.num_layers)]
    return [hd.init_paged_pool(rows, pool.nr, Dh, Dh, dtype=cfg.torch_dtype,
                               device=device)
            for _ in range(cfg.num_layers)]


def _page_rows(pages, Hkv: int) -> np.ndarray:
    """Physical pool rows of logical ``pages`` (all ``Hkv`` heads each)."""
    pages = np.asarray(pages, np.int64)
    return (pages[:, None] * Hkv + np.arange(Hkv)[None, :]).ravel()


def _to_device(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Index arrays on ``device`` in one copy, split back per array."""
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.int64) for a in arrays])).to(device)
    return list(torch.split(flat, [len(a) for a in arrays]))


def apply_copies(caches, copies: Dict[int, List[Tuple[int, int]]],
                 Hkv: int):
    """Batched page copies (copy-on-write and zero-init), in place: for
    each level, one gather of the source rows into a new tensor, then one
    ``index_copy_`` into the destinations (sources may overlap
    destinations; the gather reads every source first, as the
    reference's functional update does).  ``copies`` maps level ->
    [(src_page, dst_page)].  Scales of int8 levels travel with their
    payload.

    A mid-tick preemption can free a page that already has a pending
    copy and hand it to a later allocation, which schedules its own copy
    to the SAME destination: only the LAST copy per destination is kept
    (duplicate indices in ``index_copy_`` are nondeterministic on CUDA,
    and the stale copy targeted a page its owner no longer holds)."""
    if not copies:
        return caches
    lvls = sorted(copies)
    src_dst = []
    for l in lvls:
        last = {d: s for s, d in copies[l]}          # last writer per dst
        src_dst += [_page_rows(list(last.values()), Hkv),
                    _page_rows(list(last.keys()), Hkv)]
    idx = _to_device(src_dst, caches[0].k.device)
    for c in caches:
        levels = hd.pool_levels(c)
        for i, l in enumerate(lvls):
            src, dst = idx[2 * i], idx[2 * i + 1]
            for arr in levels[l]:
                if arr is not None:
                    arr.index_copy_(0, dst, arr.index_select(0, src))
    return caches


def scatter_prefill(caches, dense_caches,
                    writes: List[Tuple[int, Dict[int, List[Tuple[int, int]]]]],
                    Hkv: int, nr: int):
    """Copy freshly prefilled cache blocks into their allocated pages, in
    place.  ``dense_caches``: the group prefill's per-layer
    ``H1DCache`` (rows ``gp * Hkv``); ``writes``: per admitted request
    ``(dense_row_index, level -> [(block, page)])`` as returned by
    :func:`PagePool.admit`.  int8 levels store the blocks quantized with
    fresh per-row scales (the absmax rule the decode kernel applies to
    its rewrites, so a prefix-shared page and a decode-rebuilt page of
    the same tokens carry identical scales)."""
    idx: Dict[int, Tuple[list, list, list]] = {}
    for i, per_level_writes in writes:
        for l, pairs in per_level_writes.items():
            rows, blks, dst = idx.setdefault(l, ([], [], []))
            for blk, page in pairs:
                for h in range(Hkv):
                    rows.append(i * Hkv + h)
                    blks.append(blk)
                    dst.append(page * Hkv + h)
    lvls = sorted(l for l, v in idx.items() if v[0])
    if not lvls:
        return caches
    dev = caches[0].k.device
    flat = _to_device([a for l in lvls for a in idx[l]], dev)
    for pool_c, dense_c in zip(caches, dense_caches):
        dlv = [(dense_c.k, dense_c.v)] + list(zip(dense_c.ck, dense_c.cv))
        levels = hd.pool_levels(pool_c)
        for i, l in enumerate(lvls):
            rows, blks, dst = flat[3 * i:3 * i + 3]
            k, v, ksc, vsc = levels[l]
            for arr, sc, dense in ((k, ksc, dlv[l][0]), (v, vsc, dlv[l][1])):
                Rr, Ll, D = dense.shape
                vals = dense.reshape(Rr, Ll // nr, nr, D)[rows, blks]
                if sc is not None:
                    vals, s = qz.quantize_int8(vals, axis=-1)
                    sc.index_copy_(0, dst, s[..., 0])
                arr.index_copy_(0, dst, vals.to(arr.dtype))
    return caches


def snapshot_slot(caches, pool: PagePool, slot: int,
                  Hkv: int) -> Dict[int, tuple]:
    """Swap-out a slot's mapped pages to host memory (preemption mode
    'swap'): per level ``(blocks, k_content, v_content, k_scales,
    v_scales)`` as numpy arrays with the layers on the leading axis and
    all ``Hkv`` page rows per block -- enough to restore the slot
    bit-exact later.  int8 levels carry the raw payload and its per-row
    scales; fp32 levels carry ``None`` scales.  The copy to the host
    synchronizes with the card; preemption is rare."""
    snap: Dict[int, tuple] = {}
    for l in range(pool.M):
        blks = np.nonzero(pool.table[l][slot] >= 0)[0]
        if len(blks) == 0:
            continue
        rows = torch.from_numpy(_page_rows(pool.table[l][slot, blks], Hkv)
                                ).to(caches[0].k.device)
        per_layer = [hd.pool_levels(c)[l] for c in caches]

        def take(i):
            if per_layer[0][i] is None:
                return None
            return torch.stack([lv[i].index_select(0, rows)
                                for lv in per_layer]).cpu().numpy()

        snap[l] = (blks.astype(np.int64), take(0), take(1), take(2), take(3))
    return snap


def restore_slot(caches, pool: PagePool, slot: int, snap, Hkv: int):
    """Swap-in a preempted slot: allocate private pages for every
    snapshotted block (no registry sharing -- decode-written content is
    only ~1e-6-equal to a prefill of the same tokens, and restore must be
    bit-exact), map them, and scatter the saved bytes back, in place.
    Raises :class:`PoolExhausted` (the caller unwinds with
    ``release_slot``).

    The snapshot's per-level dtype must MATCH the pool's: a snapshot
    taken under another ``cache_dtype``/``quant_levels`` is another wire
    format, so a mismatch raises ``ValueError``."""
    first = caches[0]
    lvl_dtype = [a.dtype for a in (first.k, *first.ck)]
    for l, entry in snap.items():
        got = torch.from_numpy(entry[1][:0]).dtype
        if got != lvl_dtype[l]:
            raise ValueError(
                f"snapshot level-{l} dtype {got} cannot restore into a "
                f"{lvl_dtype[l]} pool -- cache_dtype/quant_levels changed "
                "between snapshot and restore")
    placed = pool.admit_snapshot(slot, {l: e[0] for l, e in snap.items()})
    lvls = sorted(placed)
    dst = dict(zip(lvls, _to_device(
        [_page_rows([p for _, p in placed[l]], Hkv) for l in lvls],
        first.k.device)))
    for li, c in enumerate(caches):
        levels = hd.pool_levels(c)
        for l in lvls:
            for arr, saved in zip(levels[l], snap[l][1:]):
                if arr is not None:
                    arr.index_copy_(0, dst[l], torch.from_numpy(
                        saved[li]).to(arr.device))
    return caches


def gather_slot_cache(caches, pool: PagePool, slot: int, Hkv: int) -> list:
    """Reconstruct a slot's DENSE per-layer ``H1DCache`` from its page
    tables (unmapped blocks read as zeros, the dense engine's initial
    state), on the host.  int8 levels are DEQUANTIZED to f32 -- the
    quantized pool's lossy view (exact for zero rows, one rounding step
    otherwise).  Used by the parity tests."""
    nr, Lp = pool.nr, pool.Lp
    out = []
    for c in caches:
        dense = []
        for l, (k, v, ksc, vsc) in enumerate(hd.pool_levels(c)):
            if ksc is not None:
                k = qz.dequantize_int8(k, ksc[..., None])
                v = qz.dequantize_int8(v, vsc[..., None])
            k, v = k.cpu(), v.cpu()
            Ll = Lp >> l
            dk = torch.zeros((Hkv, Ll, k.shape[-1]), dtype=k.dtype)
            dv = torch.zeros((Hkv, Ll, v.shape[-1]), dtype=v.dtype)
            for blk in np.nonzero(pool.table[l][slot] >= 0)[0]:
                page = int(pool.table[l][slot, blk])
                rows = slice(page * Hkv, (page + 1) * Hkv)
                cols = slice(blk * nr, (blk + 1) * nr)
                dk[:, cols] = k[rows]
                dv[:, cols] = v[rows]
            dense.append((dk, dv))
        out.append(hd.H1DCache(k=dense[0][0], v=dense[0][1],
                               ck=tuple(d[0] for d in dense[1:]),
                               cv=tuple(d[1] for d in dense[1:])))
    return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def pool_bytes(caches) -> int:
    """Total device bytes of the caches (all layers, levels and scale
    arrays); works on ``meta`` tensors, so a pool can be sized without
    allocating it."""
    return sum(t.numel() * t.element_size() for t in _tensors(caches))
