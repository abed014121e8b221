"""The port's page-pool model checker (``repro_torch.analysis.pool_model``),
as ``tests/test_pool_model.py`` holds the reference's: the port's real
``PagePool`` verifies clean over an exhaustive bounded exploration that
visits as many states and transitions as the reference's over the
reference's pool; each violation kind (refcount-leak, use-after-free,
shared-alias, zombie-registry) is caught by a seeded allocator mutation
(a ``PagePool`` subclass breaking one rule) with a minimized
counterexample that replays through the real pool.  The pool's opt-in
``REPRO_POOL_CHECK=1`` hook: paged serving passes under it, and a pool
corrupted by hand raises ``AssertionError``."""
import inspect
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.analysis import pool_model as jpm  # noqa: E402
from repro_torch.analysis import check  # noqa: E402
from repro_torch.analysis import pool_model as pm  # noqa: E402
from repro_torch.analysis.violation import Violation  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_cache import (PagePool, PoolExhausted,  # noqa: E402
                                           ZERO)


def _geom():
    return dict(pm.DEFAULT_GEOMETRY)


# ---------------------------------------------------------------------------
# seeded allocator mutations (each breaks exactly one rule)
# ---------------------------------------------------------------------------

class NoUnregister(PagePool):
    """Eviction / copy on write forget to drop the registry entry."""

    def _unregister(self, l, page):
        pass


class LosePage(PagePool):
    """Unregistered refcount-0 pages silently leak (never freed)."""

    def _decref(self, l, page):
        self.refcount[l][page] -= 1
        if self.refcount[l][page] == 0 and (l, page) in self.key_of:
            self.evictable[(l, page)] = None


class EagerFree(PagePool):
    """Pages returned to the free list while still mapped elsewhere."""

    def _decref(self, l, page):
        super()._decref(l, page)
        if self.refcount[l][page] > 0:
            self.free[l].append(page)


class NoCow(PagePool):
    """Decode writes land on still-shared pages (no copy on write)."""

    def prepare_tick(self, slot, t, copies):
        for l in range(self.M):
            blk = t // (self.nr << l)
            p = int(self.table[l][slot, blk])
            if p < 0:
                np_ = self._alloc(l)
                self._map(slot, l, blk, np_)
                copies.setdefault(l, []).append((ZERO, np_))
            elif (l, p) in self.key_of and self.refcount[l][p] == 1:
                self._unregister(l, p)


MUTANTS = [
    (NoUnregister, "zombie-registry"),
    (LosePage, "refcount-leak"),
    (EagerFree, "use-after-free"),
    (NoCow, "shared-alias"),
]


# ---------------------------------------------------------------------------
# the real pool is clean
# ---------------------------------------------------------------------------

def test_real_pool_explores_clean():
    res = pm.explore(max_states=2500)
    assert res.violations == []
    assert res.counterexample is None
    assert res.states >= 2500              # state space larger than cap
    for op in ("admit", "tick", "finish", "snapshot", "restore"):
        assert res.coverage.get(op, 0) > 0, op
    for path in ("cow_copies", "evictions", "shared_maps", "fresh_pages"):
        assert res.coverage.get(path, 0) > 0, path


def test_ci_exploration_meets_state_floor():
    """``run_pool`` (``check --pool``) explores at least 10^4 distinct
    states by default, the reference's default."""
    sig = inspect.signature(pm.run_pool)
    assert sig.parameters["max_states"].default >= 10 ** 4
    assert sig.parameters["max_states"].default == inspect.signature(
        jpm.run_pool).parameters["max_states"].default


def test_run_pool_visits_what_the_reference_visits():
    """Under one budget the port's checker on the port's pool visits the
    states, transitions and coverage of the reference's on the
    reference's pool (one allocator, copied line for line)."""
    got, vs = pm.run_pool(max_states=3000)
    want, jvs = jpm.run_pool(max_states=3000)
    assert vs == [] and jvs == []
    assert (got["states"], got["transitions"]) == (want["states"],
                                                   want["transitions"])
    assert got["coverage"] == want["coverage"]


# ---------------------------------------------------------------------------
# every pool kind is catchable, with replayable minimized schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,kind", MUTANTS,
                         ids=[c.__name__ for c, _ in MUTANTS])
def test_mutation_caught_and_counterexample_replays(cls, kind):
    res = pm.explore(pool_factory=lambda: cls(**_geom()),
                     max_states=4000)
    kinds = {v.kind for v in res.violations}
    assert kind in kinds, kinds
    assert kinds <= set(pm.POOL_KINDS)
    ce = res.counterexample
    assert ce, "no counterexample schedule returned"
    assert len(ce) <= 4                    # minimization ran
    vs, _ = pm.replay_schedule(ce, pool_factory=lambda: cls(**_geom()))
    assert vs and {v.kind for v in vs} <= kinds
    vs_clean, _ = pm.replay_schedule(ce)
    assert vs_clean == []
    wire = json.loads(json.dumps(pm.schedule_to_json(ce)))
    assert pm.schedule_from_json(wire) == ce


def test_all_pool_kinds_are_catchable():
    caught = set()
    for cls, _ in MUTANTS:
        res = pm.explore(pool_factory=lambda cls=cls: cls(**_geom()),
                         max_states=4000)
        caught |= {v.kind for v in res.violations}
    assert caught == set(pm.POOL_KINDS) == set(jpm.POOL_KINDS)


# ---------------------------------------------------------------------------
# invariant functions flag hand-corrupted pools
# ---------------------------------------------------------------------------

def _admitted_pool():
    pool = PagePool(**_geom())
    pool.admit(0, pm.default_prompts()[0])
    assert pm.check_pool_invariants(pool) == []
    return pool


@pytest.mark.parametrize("corrupt,kind", [
    ("freed_while_mapped", "use-after-free"),
    ("refcount_drift", "refcount-leak"),
    ("unregistered_alias", "shared-alias"),
    ("stale_registry", "zombie-registry")])
def test_invariants_flag_corrupted_pools(corrupt, kind):
    pool = _admitted_pool()
    p = int(pool.table[0][0, 0])
    if corrupt == "freed_while_mapped":
        pool.free[0].append(p)
    elif corrupt == "refcount_drift":
        pool.refcount[0][p] += 1
    elif corrupt == "unregistered_alias":
        pool.table[0][1, 0] = p            # alias without registry bump
        pool.refcount[0][p] += 1
        pool._unregister(0, p)
    else:
        pool.registry[("bogus",)] = (0, 99)
    assert kind in {v.kind for v in pm.check_pool_invariants(pool)}


def test_tick_postconditions_flag_shared_write_set():
    pool = PagePool(**_geom())
    toks = pm.default_prompts()[2]         # 6 tokens: partial fine page
    pool.admit(0, toks)
    pool.admit(1, toks)                    # frontier page now shared
    t = len(toks)                          # t=6 lands IN the shared page
    vs = pm.check_tick_postconditions(pool, 0, t)
    assert "shared-alias" in {v.kind for v in vs}
    pool.prepare_tick(0, t, {})            # the real copy on write fixes it
    assert pm.check_tick_postconditions(pool, 0, t) == []
    assert pm.check_pool_invariants(pool) == []


def test_failed_admit_rolls_back_identically():
    pool = PagePool(slots=2, max_len=64, nr=8, pool_pages=4)
    fp0 = pm.pool_fingerprint(pool)
    with pytest.raises(PoolExhausted):
        pool.admit(0, np.arange(40, dtype=np.int32))   # needs 5 > 4
    assert pm._check_rollback(fp0, pm.pool_fingerprint(pool),
                              "admit slot0") == []


def test_admit_snapshot_maps_private_pages_and_unwinds():
    """The restore path's allocator entry point: private, unregistered
    pages in block order; on exhaustion the partial mapping stays for the
    caller to release."""
    pool = PagePool(**_geom())
    toks = pm.default_prompts()[1]
    pool.admit(0, toks)
    blocks = {l: [int(b) for b in np.nonzero(pool.table[l][0] >= 0)[0]]
              for l in range(pool.M)}
    pool.release_slot(0)
    placed = pool.admit_snapshot(1, blocks)
    for l, pairs in placed.items():
        assert [b for b, _ in pairs] == blocks[l]
        for b, p in pairs:
            assert int(pool.table[l][1, b]) == p
            assert int(pool.refcount[l][p]) == 1
            assert (l, p) not in pool.key_of
    assert pm.check_pool_invariants(pool) == []
    small = PagePool(slots=1, max_len=16, nr=4, pool_pages=2)
    with pytest.raises(PoolExhausted):
        small.admit_snapshot(0, {0: [0, 1, 2]})
    assert (small.table[0][0] >= 0).any()
    small.release_slot(0)
    assert pm.check_pool_invariants(small) == []
    assert small.occupancy() == 0.0


def test_violation_records_and_the_pool_report(tmp_path, capsys):
    """The checkers report the port's ``Violation`` (the reference's
    fields); ``check --pool`` writes the reference's report schema."""
    pool = _admitted_pool()
    pool.refcount[0][int(pool.table[0][0, 0])] += 1
    vs = pm.check_pool_invariants(pool)
    assert vs and all(isinstance(v, Violation) for v in vs)
    assert all(v.family == "pool" for v in vs)
    path = tmp_path / "r.json"
    assert check.main(["--pool", "--pool-states", "400", "--json",
                       str(path)]) == 0
    out = capsys.readouterr().out
    assert "pool:" in out and "dist:" not in out
    rep = json.loads(path.read_text())
    assert set(rep) == {"sections", "contracts", "families", "violations",
                        "dist", "pool", "ok", "runtime_s"}
    assert rep["sections"] == ["pool"] and rep["dist"] is None
    assert rep["pool"]["states"] >= 400
    assert rep["pool"]["transitions"] > rep["pool"]["states"] // 2
    assert "counterexample" not in rep["pool"]


# ---------------------------------------------------------------------------
# REPRO_POOL_CHECK=1
# ---------------------------------------------------------------------------

def test_pool_check_hook_serves_and_catches(monkeypatch):
    """With the hook on, the port's paged engine serves the smoke LM
    through admissions, ticks, copies on write and releases, its pool
    checked after every op; a pool corrupted by hand raises at its next
    op; with the hook off nothing is checked."""
    cfg = get_smoke_config("h1d-lm-53m")
    params = get_model(cfg).init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (3, 9, 0)]
    monkeypatch.setenv("REPRO_POOL_CHECK", "1")
    calls = []
    real = pm.check_pool_invariants

    def counted(pool, *a, **kw):
        calls.append(1)
        return real(pool, *a, **kw)
    monkeypatch.setattr(pm, "check_pool_invariants", counted)
    eng = ServeEngine(cfg, params, slots=2, max_len=64, paged=True,
                      pool_pages=12)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert len(calls) > 10
    assert eng.pool.stats.prefix_hits > 0
    pool = PagePool(**_geom())
    pool.admit(0, pm.default_prompts()[0])
    pool.refcount[0][int(pool.table[0][0, 0])] += 1
    with pytest.raises(AssertionError, match="REPRO_POOL_CHECK"):
        pool.release_slot(1)
    monkeypatch.delenv("REPRO_POOL_CHECK")
    n = len(calls)
    pool.release_slot(1)
    assert len(calls) == n
