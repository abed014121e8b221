"""Bounded exhaustive model checker for the paged KV pool.

Port of ``repro.analysis.pool_model``, function for function, driving
the port's own ``serve/paged_cache.PagePool`` (whose host allocator is
the reference's, copied line for line): under the same budget it visits
the same states and transitions as the reference's checker.

``serve/paged_cache.py``'s :class:`PagePool` is a pure host-side state
machine (free lists, refcounts, page tables, prefix registry, LRU), so
its whole reachable state space on a SMALL geometry can be enumerated:
this module drives the REAL allocator -- not a re-implementation --
through every interleaving of the serving engine's mutating operations
{admit, decode-write (prepare_tick), COW, evict, preempt-snapshot,
restore, finish} from a small prompt set, asserting after every
transition:

* **refcount conservation** -- ``refcount[l][p]`` equals the number of
  page-table references, reserved pages stay at zero, and every
  refcount-0 page is on exactly one of the free / evictable lists
  (kind ``refcount-leak``);
* **no use-after-free** -- no duplicate or referenced page on a free
  list, no table entry outside the pool (kind ``use-after-free``);
* **no aliasing outside the registry** -- a page mapped by more than
  one (slot, block) must be advertised in the prefix registry, and the
  decode write-set page after ``prepare_tick`` is exclusively owned
  (kind ``shared-alias``);
* **ZERO/TRASH immutability** -- reserved pages never appear in a slot
  table and never land in a tick's write set (kinds ``shared-alias`` /
  ``use-after-free``);
* **transactional-admit rollback identity** -- a failed admit leaves
  the pool fingerprint bit-identical (registry divergence is
  ``zombie-registry``, anything else ``refcount-leak``);
* **registry liveness** -- ``registry``/``key_of`` stay a bijection
  onto live registered pages (kind ``zombie-registry``).

Every counterexample is a replayable :class:`Op` schedule, greedily
minimized (delta-debugging over a lenient replayer that skips
inapplicable ops) and JSON-serializable -- the regression suite feeds
minimized schedules through the real :class:`PagePool` via
:func:`replay_schedule`.  ``REPRO_POOL_CHECK=1`` makes the pool itself
call :func:`check_pool_invariants` after every mutating op, so serving
and this checker share ONE invariant definition.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import Counter, OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .violation import Violation

POOL_KINDS = ("refcount-leak", "use-after-free", "shared-alias",
              "zombie-registry")

#: default model geometry: 2 slots over a deliberately tight pool so
#: COW, eviction and exhaustion are all reachable within a few ops
DEFAULT_GEOMETRY = dict(slots=2, max_len=16, nr=4, pool_pages=4)


def default_pool():
    from ..serve.paged_cache import PagePool
    return PagePool(**DEFAULT_GEOMETRY)


def default_prompts() -> Tuple[np.ndarray, ...]:
    """Three prompts: two sharing an 8-token prefix (registry hits +
    COW on divergence), one short enough to leave a partial frontier
    page (COW on the first decode write)."""
    return (np.arange(8, dtype=np.int32),
            np.concatenate([np.arange(8, dtype=np.int32),
                            np.arange(100, 104, dtype=np.int32)]),
            np.arange(50, 56, dtype=np.int32))


# ---------------------------------------------------------------------------
# invariants (shared with PagePool's REPRO_POOL_CHECK hook)
# ---------------------------------------------------------------------------

def check_pool_invariants(pool, family: str = "pool") -> List[Violation]:
    """Structural invariants of a :class:`PagePool`.  Pure reads; safe
    to call from inside the pool's own mutating ops."""
    from ..serve.paged_cache import TRASH, ZERO
    out: List[Violation] = []
    for l in range(pool.M):
        n = pool.num_pages[l]
        lv = f"L{l}"
        free = pool.free[l]
        fs = set(free)
        if len(fs) != len(free):
            dup = [p for p in fs if free.count(p) > 1]
            out.append(Violation(family, lv, "use-after-free",
                                 f"page {dup[0]} on the free list "
                                 f"{free.count(dup[0])} times"))
        for p in sorted(fs):
            if p < 2 or p >= n:
                out.append(Violation(family, lv, "use-after-free",
                                     f"free list holds invalid page {p} "
                                     f"(pool has pages 2..{n - 1})"))
        tab = pool.table[l]
        vals = tab[tab >= 0]
        if vals.size and int(vals.max()) >= n:
            out.append(Violation(family, lv, "use-after-free",
                                 f"slot table maps nonexistent page "
                                 f"{int(vals.max())}"))
            vals = vals[vals < n]
        if np.isin(vals, (ZERO, TRASH)).any():
            out.append(Violation(family, lv, "shared-alias",
                                 "slot table maps a reserved ZERO/TRASH "
                                 "page -- a tick would mutate it"))
        counts = np.bincount(vals, minlength=n)
        rc = pool.refcount[l]
        if int(rc[ZERO]) or int(rc[TRASH]):
            out.append(Violation(family, lv, "refcount-leak",
                                 f"reserved pages carry refcounts "
                                 f"(ZERO={int(rc[ZERO])}, "
                                 f"TRASH={int(rc[TRASH])})"))
        evs = {p for (ll, p) in pool.evictable if ll == l}
        for p in range(2, n):
            r, c = int(rc[p]), int(counts[p])
            reg = (l, p) in pool.key_of
            inf, ine = p in fs, p in evs
            if r != c:
                out.append(Violation(
                    family, f"{lv} p{p}", "refcount-leak",
                    f"refcount {r} != {c} page-table references"))
            if inf and r > 0:
                out.append(Violation(
                    family, f"{lv} p{p}", "use-after-free",
                    f"page on the free list while still referenced "
                    f"(rc={r}) -- the next alloc would hand out live "
                    f"KV"))
            if ine and r > 0:
                out.append(Violation(
                    family, f"{lv} p{p}", "refcount-leak",
                    f"page parked on the evictable LRU while still "
                    f"referenced (rc={r})"))
            if inf and ine:
                out.append(Violation(
                    family, f"{lv} p{p}", "use-after-free",
                    "page on BOTH the free list and the evictable LRU "
                    "-- it can be handed out twice"))
            if r == 0 and not inf and not ine:
                out.append(Violation(
                    family, f"{lv} p{p}", "refcount-leak",
                    "page leaked: refcount 0 but on neither the free "
                    "list nor the evictable LRU"))
            if inf and reg:
                out.append(Violation(
                    family, f"{lv} p{p}", "zombie-registry",
                    "prefix registry still advertises a FREED page -- "
                    "the next registry hit would serve recycled KV"))
            if ine and not reg:
                out.append(Violation(
                    family, f"{lv} p{p}", "zombie-registry",
                    "unregistered page parked on the evictable LRU -- "
                    "nothing can ever reclaim or re-hit it"))
            if r > 1 and not reg:
                out.append(Violation(
                    family, f"{lv} p{p}", "shared-alias",
                    f"page mapped by {r} (slot, block) references "
                    f"outside the sharing registry"))
    for key, (l, p) in pool.registry.items():
        if key[0] != l:
            out.append(Violation(family, f"L{l} p{p}", "zombie-registry",
                                 f"registry key level {key[0]} != "
                                 f"mapped level {l}"))
        elif p < 2 or p >= pool.num_pages[l]:
            out.append(Violation(family, f"L{l} p{p}", "zombie-registry",
                                 "registry entry points at an invalid "
                                 "page"))
        elif pool.key_of.get((l, p)) != key:
            out.append(Violation(family, f"L{l} p{p}", "zombie-registry",
                                 "registry -> key_of is not a bijection "
                                 "(stale forward entry)"))
    for (l, p), key in pool.key_of.items():
        if pool.registry.get(key) != (l, p):
            out.append(Violation(family, f"L{l} p{p}", "zombie-registry",
                                 "key_of -> registry is not a bijection "
                                 "(stale reverse entry)"))
    return out


def check_tick_postconditions(pool, slot: int, t: int,
                              family: str = "pool") -> List[Violation]:
    """After ``prepare_tick(slot, t)`` succeeds, position ``t``'s
    write-set page at every level must be present, private, and
    unadvertised -- the decode kernel mutates it in place."""
    from ..serve.paged_cache import TRASH, ZERO
    out: List[Violation] = []
    for l in range(pool.M):
        blk = t // (pool.nr << l)
        p = int(pool.table[l][slot, blk])
        lv = f"L{l} t{t}"
        if p < 0:
            out.append(Violation(family, lv, "use-after-free",
                                 "write-set page unmapped after "
                                 "prepare_tick -- the kernel would "
                                 "write nowhere"))
            continue
        if p in (ZERO, TRASH):
            out.append(Violation(family, lv, "shared-alias",
                                 f"tick would write reserved page {p} "
                                 f"(ZERO/TRASH immutability)"))
            continue
        if int(pool.refcount[l][p]) > 1:
            out.append(Violation(
                family, lv, "shared-alias",
                f"tick writes page {p} still shared by "
                f"{int(pool.refcount[l][p])} references (missing "
                f"copy-on-write)"))
        if (l, p) in pool.key_of:
            out.append(Violation(
                family, lv, "zombie-registry",
                f"tick writes page {p} still advertised in the prefix "
                f"registry -- future hits would read post-divergence "
                f"content"))
    return out


# ---------------------------------------------------------------------------
# pool cloning + canonical fingerprints
# ---------------------------------------------------------------------------

def clone_pool(pool):
    """Cheap deep-enough copy of a :class:`PagePool` (or a mutated test
    subclass -- ``copy.copy`` preserves the class)."""
    new = copy.copy(pool)
    new.free = [list(f) for f in pool.free]
    new.refcount = [r.copy() for r in pool.refcount]
    new.table = [t.copy() for t in pool.table]
    new.registry = dict(pool.registry)
    new.key_of = dict(pool.key_of)
    new.evictable = OrderedDict(pool.evictable)
    new.stats = dataclasses.replace(pool.stats)
    return new


def pool_fingerprint(pool) -> tuple:
    """Canonical hashable pool state.  Free lists are SORTED (page
    allocation order is not behaviour the invariants care about);
    evictable keeps its order (LRU order IS behaviour)."""
    return (
        tuple(tuple(sorted(f)) for f in pool.free),
        tuple(tuple(int(x) for x in r) for r in pool.refcount),
        tuple(tuple(int(x) for x in t.ravel()) for t in pool.table),
        tuple(sorted(pool.registry.items())),
        tuple(pool.evictable.keys()),
    )


def _check_rollback(fp0: tuple, fp1: tuple, where: str) -> List[Violation]:
    """Transactional-admit identity, modulo the two things a failed
    admit is ALLOWED to change:

    * the evictable LRU *recency* of parked pages its registry hits
      touched (eviction order is a heuristic, not a safety property);
    * registry entries dropped by evictions it performed before running
      out -- an evicted page may have been reused by an earlier level
      of the same admit, so re-registering the old key would advertise
      garbage; the entry is gone and its page moves evictable -> free.

    Everything else -- tables, refcounts, no new/changed registry
    entries, free/evictable membership beyond the evicted set -- must
    be bit-identical."""
    out: List[Violation] = []
    if fp1[1] != fp0[1] or fp1[2] != fp0[2]:
        out.append(Violation(
            "pool", where, "refcount-leak",
            "failed admit left refcounts/page-tables changed "
            "(transactional-admit identity)"))
        return out
    reg0, reg1 = dict(fp0[3]), dict(fp1[3])
    added = set(reg1) - set(reg0)
    moved = {k for k in set(reg0) & set(reg1) if reg0[k] != reg1[k]}
    if added or moved:
        out.append(Violation(
            "pool", where, "zombie-registry",
            "failed admit left registrations behind -- a stale key "
            "would serve garbage to the next prompt hashing to it"))
        return out
    evicted = {reg0[k] for k in set(reg0) - set(reg1)}
    free0 = {(l, p) for l, f in enumerate(fp0[0]) for p in f}
    free1 = {(l, p) for l, f in enumerate(fp1[0]) for p in f}
    ev0, ev1 = set(fp0[4]), set(fp1[4])
    if (free1 - free0 != evicted or not free0 <= free1
            or ev0 - ev1 != evicted or not ev1 <= ev0):
        out.append(Violation(
            "pool", where, "refcount-leak",
            "failed admit changed free/evictable membership beyond "
            "the entries its evictions legally dropped"))
    return out


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Op:
    """One engine-level operation: ``admit`` (arg = prompt index),
    ``tick`` (one decode write at the slot's current position),
    ``finish`` (release), ``snapshot`` (preempt: record blocks +
    release), ``restore`` (arg = parked-snapshot index)."""
    op: str
    slot: int = 0
    arg: int = 0


def schedule_to_json(schedule: Sequence[Op]) -> List[dict]:
    return [dataclasses.asdict(op) for op in schedule]


def schedule_from_json(data: Sequence[dict]) -> List[Op]:
    return [Op(**d) for d in data]


class _Model:
    """The explorer's state: a real pool + the engine-side bookkeeping
    (which slots are live at which position, parked snapshots)."""

    def __init__(self, pool, prompts, snap_cap: int = 1):
        self.pool = pool
        self.prompts = prompts
        self.snap_cap = snap_cap
        self.live: Dict[int, List[int]] = {}     # slot -> [prompt, pos]
        self.snaps: List[Tuple[int, int, Dict[int, List[int]]]] = []
        self.path: Tuple[Op, ...] = ()

    def clone(self) -> "_Model":
        m = _Model(clone_pool(self.pool), self.prompts, self.snap_cap)
        m.live = {s: list(v) for s, v in self.live.items()}
        m.snaps = [(p, t, {l: list(b) for l, b in blocks.items()})
                   for p, t, blocks in self.snaps]
        m.path = self.path
        return m

    def fingerprint(self) -> tuple:
        return (pool_fingerprint(self.pool),
                tuple(sorted((s, tuple(v)) for s, v in self.live.items())),
                tuple((p, t, tuple((l, tuple(b))
                                   for l, b in sorted(blocks.items())))
                      for p, t, blocks in self.snaps))

    def successors(self) -> List[Op]:
        ops = []
        for s in range(self.pool.slots):
            if s in self.live:
                if self.live[s][1] < self.pool.Lp:
                    ops.append(Op("tick", s))
                ops.append(Op("finish", s))
                if len(self.snaps) < self.snap_cap:
                    ops.append(Op("snapshot", s))
            else:
                for i in range(len(self.prompts)):
                    ops.append(Op("admit", s, i))
                for j in range(len(self.snaps)):
                    ops.append(Op("restore", s, j))
        return ops

    def apply(self, op: Op) -> Tuple[bool, List[Violation]]:
        """Apply one op to the REAL pool.  Returns ``(applied,
        violations)``; inapplicable ops (lenient replay) return
        ``(False, [])`` without touching state."""
        from ..serve.paged_cache import PoolExhausted
        pool = self.pool
        vs: List[Violation] = []
        where = f"{op.op} slot{op.slot}"
        if op.op == "admit":
            if op.slot in self.live or not (0 <= op.slot < pool.slots) \
                    or not (0 <= op.arg < len(self.prompts)):
                return False, []
            fp0 = pool_fingerprint(pool)
            try:
                pool.admit(op.slot, self.prompts[op.arg])
                self.live[op.slot] = [op.arg,
                                      len(self.prompts[op.arg])]
            except PoolExhausted:
                vs.extend(_check_rollback(fp0, pool_fingerprint(pool),
                                          where))
        elif op.op == "tick":
            st = self.live.get(op.slot)
            if st is None or st[1] >= pool.Lp:
                return False, []
            t = st[1]
            try:
                pool.prepare_tick(op.slot, t, {})
                st[1] += 1
                vs.extend(check_tick_postconditions(pool, op.slot, t))
            except PoolExhausted:
                pass           # legal partial state: the engine retries
        elif op.op == "finish":
            if op.slot not in self.live:
                return False, []
            pool.release_slot(op.slot)
            del self.live[op.slot]
        elif op.op == "snapshot":
            st = self.live.get(op.slot)
            if st is None or len(self.snaps) >= self.snap_cap:
                return False, []
            blocks = {
                l: [int(b) for b in
                    np.nonzero(pool.table[l][op.slot] >= 0)[0]]
                for l in range(pool.M)}
            pool.release_slot(op.slot)
            self.snaps.append((st[0], st[1], blocks))
            del self.live[op.slot]
        elif op.op == "restore":
            if op.slot in self.live or not (0 <= op.slot < pool.slots) \
                    or not (0 <= op.arg < len(self.snaps)):
                return False, []
            p, t, blocks = self.snaps[op.arg]
            try:
                pool.admit_snapshot(op.slot, blocks)
                self.live[op.slot] = [p, t]
                self.snaps.pop(op.arg)
            except PoolExhausted:
                pool.release_slot(op.slot)   # documented caller unwind
        else:
            return False, []
        vs.extend(check_pool_invariants(pool))
        return True, vs


# ---------------------------------------------------------------------------
# exploration, replay, minimization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PoolCheckResult:
    states: int
    transitions: int
    coverage: Dict[str, int]
    violations: List[Violation]
    counterexample: Optional[List[Op]] = None


def explore(*, pool_factory: Callable = default_pool,
            prompts: Optional[Sequence[np.ndarray]] = None,
            max_states: int = 12000, snap_cap: int = 1,
            ) -> PoolCheckResult:
    """Breadth-first enumeration of the pool's reachable states up to
    ``max_states`` distinct canonical fingerprints.  Stops at the FIRST
    invariant violation and returns its schedule (already minimized by
    :func:`minimize_schedule` when one is found)."""
    prompts = tuple(prompts) if prompts is not None else default_prompts()
    root = _Model(pool_factory(), prompts, snap_cap)
    seen = {root.fingerprint()}
    queue = deque([root])
    cov: Counter = Counter()
    states, transitions = 1, 0
    while queue and states < max_states:
        m = queue.popleft()
        for op in m.successors():
            m2 = m.clone()
            s0 = dataclasses.replace(m2.pool.stats)
            applied, vs = m2.apply(op)
            if not applied:
                continue
            transitions += 1
            cov[op.op] += 1
            s1 = m2.pool.stats
            cov["cow_copies"] += s1.cow_copies - s0.cow_copies
            cov["evictions"] += s1.evictions - s0.evictions
            cov["shared_maps"] += s1.shared_maps - s0.shared_maps
            cov["fresh_pages"] += s1.fresh_pages - s0.fresh_pages
            if vs:
                ce = list(m.path) + [op]
                ce = minimize_schedule(ce, pool_factory=pool_factory,
                                       prompts=prompts,
                                       kinds={v.kind for v in vs},
                                       snap_cap=snap_cap)
                return PoolCheckResult(states, transitions, dict(cov),
                                       vs, ce)
            fp = m2.fingerprint()
            if fp in seen:
                continue
            seen.add(fp)
            states += 1
            m2.path = m.path + (op,)
            queue.append(m2)
    return PoolCheckResult(states, transitions, dict(cov), [])


def replay_schedule(schedule: Sequence[Op], *,
                    pool_factory: Callable = default_pool,
                    prompts: Optional[Sequence[np.ndarray]] = None,
                    snap_cap: int = 1,
                    ) -> Tuple[List[Violation], "object"]:
    """Feed a schedule through the REAL pool, leniently (inapplicable
    ops are skipped -- this is what makes delta-debugging sound).
    Returns ``(violations, pool)``; stops at the first violating op."""
    prompts = tuple(prompts) if prompts is not None else default_prompts()
    m = _Model(pool_factory(), prompts, snap_cap)
    for op in schedule:
        _, vs = m.apply(op)
        if vs:
            return vs, m.pool
    return [], m.pool


def minimize_schedule(schedule: Sequence[Op], *,
                      pool_factory: Callable = default_pool,
                      prompts: Optional[Sequence[np.ndarray]] = None,
                      kinds: Optional[set] = None,
                      snap_cap: int = 1) -> List[Op]:
    """Greedy delta-debugging: repeatedly drop ops (latest first) while
    the replay still produces a violation of one of ``kinds`` (any kind
    if None).  The result replays through :func:`replay_schedule`."""
    def fails(sched):
        vs, _ = replay_schedule(sched, pool_factory=pool_factory,
                                prompts=prompts, snap_cap=snap_cap)
        return any(kinds is None or v.kind in kinds for v in vs)

    cur = list(schedule)
    if not fails(cur):
        return cur            # non-deterministic repro: keep as-is
    changed = True
    while changed:
        changed = False
        for i in reversed(range(len(cur))):
            cand = cur[:i] + cur[i + 1:]
            if fails(cand):
                cur = cand
                changed = True
    return cur


def run_pool(*, max_states: int = 12000,
             ) -> Tuple[Dict[str, object], List[Violation]]:
    """The CLI's entry: explore the default geometry with the real pool.
    Returns ``(stats, violations)`` shaped like ``dist.run_dist``."""
    res = explore(max_states=max_states)
    stats: Dict[str, object] = {
        "states": res.states, "transitions": res.transitions,
        "coverage": res.coverage,
    }
    if res.counterexample is not None:
        stats["counterexample"] = schedule_to_json(res.counterexample)
    return stats, res.violations
