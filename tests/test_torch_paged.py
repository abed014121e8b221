"""Port parity of paged and int8 serving: the plain versions of the four
paged decode kernels against the JAX reference, and the ported paged
engine against the JAX engine, step by step.

Tolerances.  Attention within 1e-5 (fp32 softmax over dot products
summed in another order); the ancestor updates bit-exact on pages and
scales (the same fp32 adds, exact halvings, and the int8 rounding of
``core/quantization.py``).  The page tables here give every cache row
its own write pages, so no two rows write one target; the engine's
TRASH rows, which several inactive rows share, never reach an output.

The engine tests run the reference's ``_workload`` schedules from
``tests/test_paged.py`` on the ``h1d-lm-53m`` smoke config through both
engines in lockstep: after every ``step()`` the generated tokens and
the host pool state (tables, refcounts, free lists, counters,
preemptions) are equal, and the port's model checker
(``repro_torch.analysis.pool_model``) finds no violated invariant in
the port's pool.  So that a near-tie fails loudly
instead of flaking, every generated token's top-2 logit margin is
checked to exceed 1e-3 on the port's teacher-forced logits."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.analysis import pool_model  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import h1d_decode as jhd  # noqa: E402
from repro.core import quantization as jqz  # noqa: E402
from repro.kernels import h1d_decode_kernel as jdk  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import h1d_decode as thd  # noqa: E402
from repro_torch.core import hierarchy as hc  # noqa: E402
from repro_torch.core import quantization as tqz  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as tdk  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402
from test_paged import _workload  # noqa: E402

ATOL = 1e-5
MARGIN = 1e-3
ARCH = "h1d-lm-53m"

# quantized levels per pattern: every level, the fine level only
# (quant_levels=1), none (an int8-typed pool whose levels are all fp32)
QUANT = {"all": lambda M: (True,) * M,
         "ql1": lambda M: (True,) + (False,) * (M - 1),
         "none": lambda M: (False,) * M}


# ---------------------------------------------------------------------------
# kernel plain versions against the JAX reference
# ---------------------------------------------------------------------------

def _positions(Lmax, nr, seed):
    """Mask edge cases (block and span boundaries, quadrant flips, the
    first and last positions) plus random ones."""
    M = hc.num_levels(Lmax, nr)
    span = nr << max(M - 1, 1)
    ts = {0, 1, nr - 1, nr, 2 * nr - 1, span - 1, span,
          span + span // 2 - 1, span + span // 2, Lmax - 1}
    ts |= set(np.random.default_rng(seed).integers(0, Lmax, 6).tolist())
    return np.array(sorted(t % Lmax for t in ts), np.int32)


def _pools(M, nr, D, Dv, npages, quant, seed):
    """Random numpy pools: (k, v, ksc, vsc) per level.  ``quant`` None
    for an fp32 pool, else per-level int8 flags (int8 payloads with
    positive per-row scales; fp32 levels carry all-ones scales)."""
    rng = np.random.default_rng(seed)
    out = []
    for l in range(M):
        if quant is not None and quant[l]:
            k = rng.integers(-127, 128, (npages, nr, D)).astype(np.int8)
            v = rng.integers(-127, 128, (npages, nr, Dv)).astype(np.int8)
            ksc = (rng.random((npages, nr)) * 0.05 + 1e-3).astype(np.float32)
            vsc = (rng.random((npages, nr)) * 0.05 * 2 ** l
                   + 1e-3).astype(np.float32)
        else:
            k = rng.standard_normal((npages, nr, D)).astype(np.float32)
            v = (rng.standard_normal((npages, nr, Dv))
                 * 2 ** l).astype(np.float32)
            ksc = vsc = np.ones((npages, nr), np.float32)
        out.append((k, v, ksc, vsc))
    return out


def _jax_pool(levels, quant):
    k, v = jnp.asarray(levels[0][0]), jnp.asarray(levels[0][1])
    ck = tuple(jnp.asarray(x[0]) for x in levels[1:])
    cv = tuple(jnp.asarray(x[1]) for x in levels[1:])
    if quant is None:
        return jhd.PagedH1DCache(k=k, v=v, ck=ck, cv=cv)
    return jhd.QuantPagedH1DCache(
        k=k, v=v, ck=ck, cv=cv, ksc=jnp.asarray(levels[0][2]),
        vsc=jnp.asarray(levels[0][3]),
        cksc=tuple(jnp.asarray(x[2]) for x in levels[1:]),
        cvsc=tuple(jnp.asarray(x[3]) for x in levels[1:]))


def _torch_pool(levels, quant):
    def t(a):
        return torch.from_numpy(np.array(a, copy=True))
    k, v = t(levels[0][0]), t(levels[0][1])
    ck = tuple(t(x[0]) for x in levels[1:])
    cv = tuple(t(x[1]) for x in levels[1:])
    if quant is None:
        return thd.PagedH1DCache(k=k, v=v, ck=ck, cv=cv)
    return thd.QuantPagedH1DCache(
        k=k, v=v, ck=ck, cv=cv, ksc=t(levels[0][2]), vsc=t(levels[0][3]),
        cksc=tuple(t(x[2]) for x in levels[1:]),
        cvsc=tuple(t(x[3]) for x in levels[1:]))


def _tables(ts, M, npages, seed):
    """Random read pages per band; write pages distinct across rows at
    every level (each row's pages private, as after copy-on-write)."""
    rng = np.random.default_rng(seed)
    R = len(ts)
    bidx = rng.integers(0, npages, (R, 1 + M)).astype(np.int32)
    utab = np.stack([rng.permutation(npages)[:R] for _ in range(M)],
                    axis=1).astype(np.int32)
    return bidx, utab


def _assert_pools_equal(jpool, tpool):
    for a, b in zip(jax.tree.leaves(jpool), jax.tree.leaves(
            list(tpool._asdict().values()))):
        assert b.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[a.dtype]
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


SWEEP = [(256, 16, 1), (128, 8, 4), (512, 16, 2), (64, 4, 2)]


@pytest.mark.parametrize("quant", [None, "all", "ql1", "none"])
@pytest.mark.parametrize("Lmax,nr,G", SWEEP)
def test_paged_attend_plain_matches_jax(Lmax, nr, G, quant):
    M = hc.num_levels(Lmax, nr)
    flags = None if quant is None else QUANT[quant](M)
    ts = _positions(Lmax, nr, seed=Lmax + G)
    R, D, Dv, npages = len(ts), 16, 24, 3 * len(ts)
    levels = _pools(M, nr, D, Dv, npages, flags, seed=nr)
    bidx, _ = _tables(ts, M, npages, seed=G)
    q = np.random.default_rng(3).standard_normal((R, G, D)).astype(np.float32)
    want = jhd.decode_attend_paged(_jax_pool(levels, flags), jnp.asarray(q),
                                   jnp.asarray(ts), jnp.asarray(bidx), nr=nr)
    tpool = _torch_pool(levels, flags)
    kernels.reset_counts()
    got = thd.decode_attend_paged(tpool, torch.from_numpy(q),
                                  torch.from_numpy(ts),
                                  torch.from_numpy(bidx), nr=nr)
    plain = (tdk.decode_attend_paged_ref if quant is None
             else tdk.decode_attend_paged_quant_ref)
    assert plain.calls == 1
    assert got.dtype == torch.float32 and got.shape == (R, G, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("quant", [None, "all", "ql1", "none"])
@pytest.mark.parametrize("Lmax,nr", [(256, 16), (128, 8), (64, 4)])
def test_paged_update_plain_bit_exact(Lmax, nr, quant):
    """Three chained appends (later ones read the pairs earlier ones
    wrote): pages and scales bit-exact against the JAX oracle."""
    M = hc.num_levels(Lmax, nr)
    flags = None if quant is None else QUANT[quant](M)
    ts = _positions(Lmax, nr, seed=nr)
    R, D, Dv, npages = len(ts), 16, 8, 2 * len(ts) + 3
    levels = _pools(M, nr, D, Dv, npages, flags, seed=Lmax)
    jpool, tpool = _jax_pool(levels, flags), _torch_pool(levels, flags)
    rng = np.random.default_rng(7)
    for step in range(3):
        tt = np.minimum(ts + step, Lmax - 1).astype(np.int32)
        _, utab = _tables(tt, M, npages, seed=step)
        kn = rng.standard_normal((R, D)).astype(np.float32)
        vn = rng.standard_normal((R, Dv)).astype(np.float32)
        jpool = jhd.update_cache_paged(jpool, jnp.asarray(kn),
                                       jnp.asarray(vn), jnp.asarray(tt),
                                       jnp.asarray(utab))
        out = thd.update_cache_paged(tpool, torch.from_numpy(kn),
                                     torch.from_numpy(vn),
                                     torch.from_numpy(tt),
                                     torch.from_numpy(utab))
        assert out is tpool                       # in place
        _assert_pools_equal(jpool, tpool)


def _small_case(quant, seed=0):
    Lmax, nr, G, D = 64, 8, 2, 16
    M = hc.num_levels(Lmax, nr)
    flags = None if quant is None else QUANT[quant](M)
    ts = _positions(Lmax, nr, seed=seed)
    npages = 2 * len(ts) + 1
    levels = _pools(M, nr, D, D, npages, flags, seed=seed)
    bidx, utab = _tables(ts, M, npages, seed=seed)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(ts), G, D)).astype(np.float32)
    kn = rng.standard_normal((len(ts), D)).astype(np.float32)
    vn = rng.standard_normal((len(ts), D)).astype(np.float32)
    return nr, flags, levels, ts, bidx, utab, q, kn, vn


@pytest.mark.parametrize("quant", [None, "ql1"])
def test_paged_attend_plain_matches_pallas_interpret(quant):
    """One small case through the Pallas kernel itself (interpret mode):
    #7 for the fp32 pool, #8 for a mixed int8 pool."""
    nr, flags, levels, ts, bidx, _, q, _, _ = _small_case(quant, seed=1)
    fn = jdk.decode_attend_paged if quant is None \
        else jdk.decode_attend_paged_quant
    want = fn(_jax_pool(levels, flags), jnp.asarray(q), jnp.asarray(ts),
              jnp.asarray(bidx), nr=nr, interpret=True)
    got = thd.decode_attend_paged(_torch_pool(levels, flags),
                                  torch.from_numpy(q), torch.from_numpy(ts),
                                  torch.from_numpy(bidx), nr=nr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("quant", [None, "ql1"])
def test_paged_update_plain_matches_pallas_interpret(quant):
    """#9 and #10 through the Pallas kernel (interpret mode): bit-exact."""
    nr, flags, levels, ts, _, utab, _, kn, vn = _small_case(quant, seed=2)
    fn = jdk.update_cache_paged if quant is None \
        else jdk.update_cache_paged_quant
    want = fn(_jax_pool(levels, flags), jnp.asarray(kn), jnp.asarray(vn),
              jnp.asarray(ts), jnp.asarray(utab), interpret=True)
    tpool = _torch_pool(levels, flags)
    thd.update_cache_paged(tpool, torch.from_numpy(kn), torch.from_numpy(vn),
                           torch.from_numpy(ts), torch.from_numpy(utab))
    _assert_pools_equal(want, tpool)


@pytest.mark.parametrize("axis", [-1, None])
def test_quantize_idempotent_and_matches_jax(axis):
    """quantize -> dequantize -> quantize keeps the int8 payload bit for
    bit, so repeated sibling-pair rewrites cannot walk the cache; the
    port's rounding equals the reference's on payload and scale."""
    x = np.random.default_rng(20).standard_normal((64, 16)).astype(
        np.float32)
    q, s = tqz.quantize_int8(torch.from_numpy(x), axis=axis)
    jq, js = jqz.quantize_int8(jnp.asarray(x), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for _ in range(4):
        q2, s2 = tqz.quantize_int8(tqz.dequantize_int8(q, s), axis=axis)
        assert torch.equal(q2, q)
        np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=2e-7)
        q, s = q2, s2


def test_mixed_pool_fp32_levels_keep_scales():
    """quant_levels=1: the coarse levels stay fp32 and their all-ones
    scale arrays are neither read nor written; the int8 level gets
    fresh scales."""
    nr, flags, levels, ts, _, utab, _, kn, vn = _small_case("ql1", seed=3)
    tpool = _torch_pool(levels, flags)
    thd.update_cache_paged(tpool, torch.from_numpy(kn), torch.from_numpy(vn),
                           torch.from_numpy(ts), torch.from_numpy(utab))
    assert thd.quant_level_flags(tpool) == flags
    for sc in (*tpool.cksc, *tpool.cvsc):
        assert torch.equal(sc, torch.ones_like(sc))
    for arr in (*tpool.ck, *tpool.cv):
        assert arr.dtype == torch.float32
    rows = torch.from_numpy(utab[:, 0]).long()
    assert not torch.equal(tpool.ksc[rows], torch.from_numpy(
        levels[0][2][utab[:, 0]]))


# ---------------------------------------------------------------------------
# host pool and device data movement
# ---------------------------------------------------------------------------

def _twin_pools(quant_levels, seed=0):
    """The reference's and the port's PagePool after the same admissions
    (two slots, shared prefix), with the same random page content."""
    nr, Hkv, D = 8, 2, 4
    toks = np.arange(20, dtype=np.int32)
    pools = [mod.PagePool(slots=2, max_len=64, nr=nr, pool_pages=12,
                          quant_levels=quant_levels) for mod in (jpc, tpc)]
    for p in pools:
        p.admit(0, toks)
        p.admit(1, np.concatenate([toks[:17], toks[:5]]))
    jp = pools[0]
    flags = None if not any(jp.quant) else tuple(jp.quant)
    # per-level pool sizes differ: draw each level at its own size
    levels = [_pools(1, nr, D, D, n * Hkv, None if flags is None
                     else flags[l:l + 1], seed + l)[0]
              for l, n in enumerate(jp.num_pages)]
    return pools, levels, flags, Hkv


@pytest.mark.parametrize("quant_levels", [0, -1, 1])
def test_gather_slot_cache_matches_jax(quant_levels):
    (jp, tp), levels, flags, Hkv = _twin_pools(quant_levels)
    for a, b in zip(jp.table, tp.table):
        np.testing.assert_array_equal(a, b)
    want = jpc.gather_slot_cache([_jax_pool(levels, flags)], jp, 1, Hkv,
                                 stacked=False)[0]
    got = tpc.gather_slot_cache([_torch_pool(levels, flags)], tp, 1, Hkv)[0]
    for a, b in zip(jax.tree.leaves(want), [got.k, got.v, *got.ck,
                                            *got.cv]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("quant_levels", [0, -1])
def test_snapshot_restore_roundtrip_and_dtype_guard(quant_levels):
    """Swap-out then swap-in into a fresh pool restores payloads (and the
    scales of int8 levels) bit for bit; restoring into a pool of another
    cache dtype raises ValueError."""
    (_, tp), levels, flags, Hkv = _twin_pools(quant_levels, seed=4)
    caches = [_torch_pool(levels, flags)]
    snap = tpc.snapshot_slot(caches, tp, 1, Hkv)
    assert (snap[0][3] is not None) == (flags is not None)
    fresh = tpc.PagePool(slots=2, max_len=64, nr=tp.nr, pool_pages=12,
                         quant_levels=quant_levels)
    fresh.admit(0, np.arange(9, dtype=np.int32))      # other pages taken
    blank = [_torch_pool([tuple(np.zeros_like(a) for a in lv)
                          for lv in levels], flags)]
    tpc.restore_slot(blank, fresh, 1, snap, Hkv)
    src = tpc.gather_slot_cache(caches, tp, 1, Hkv)[0]
    dst = tpc.gather_slot_cache(blank, fresh, 1, Hkv)[0]
    for a, b in zip(src, dst):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    for l in snap:                         # raw payloads and scales too
        sp = [int(p) for p in tp.table[l][1] if p >= 0]
        dp = [int(p) for p in fresh.table[l][1] if p >= 0]
        for a, b in zip(thd.pool_levels(caches[0])[l],
                        thd.pool_levels(blank[0])[l]):
            if a is not None:
                assert torch.equal(a.view(-1, Hkv, *a.shape[1:])[sp],
                                   b.view(-1, Hkv, *b.shape[1:])[dp])
    other = tpc.PagePool(slots=2, max_len=64, nr=tp.nr, pool_pages=12,
                         quant_levels=-1 - quant_levels)
    oflags = None if not any(other.quant) else tuple(other.quant)
    wrong = [_torch_pool([tuple(np.zeros(a.shape, np.int8 if oflags
                                         else np.float32)
                                if i < 2 else np.ones(a.shape, np.float32)
                                for i, a in enumerate(lv))
                          for lv in levels], oflags)]
    with pytest.raises(ValueError, match="dtype"):
        tpc.restore_slot(wrong, other, 1, snap, Hkv)


def test_apply_copies_last_writer_and_overlap():
    """Copies read every source before writing (a destination may be
    another copy's source), and a destination written twice keeps the
    last copy, as the reference's functional update does."""
    levels = _pools(2, 4, 3, 3, 6, None, seed=5)
    copies = {0: [(2, 3), (3, 4), (5, 3)], 1: [(0, 2)]}
    want = jpc.apply_copies([_jax_pool(levels, None)], copies, 1,
                            stacked=False)[0]
    got = tpc.apply_copies([_torch_pool(levels, None)], copies, 1)[0]
    _assert_pools_equal(want, got)


# ---------------------------------------------------------------------------
# the paged engine against the JAX engine, step by step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """Smoke-config weights from key 9: every greedy token of these
    schedules has a top-2 margin above MARGIN (the random smoke model's
    logits are nearly flat, and key 2 of test_torch_serve.py ties within
    2.3e-4 on the eviction schedule)."""
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(9), cfg)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def _pool_state(pool):
    return dict(table=[t.tolist() for t in pool.table],
                refcount=[r.tolist() for r in pool.refcount],
                free=[list(f) for f in pool.free],
                evictable=list(pool.evictable),
                stats=pool.stats.snapshot())


def _lockstep(smoke, wl, compare_content=False, **kw):
    """Both engines over the same requests, one ``step()`` each at a time:
    equal tokens and equal host pool state after every tick, and no pool
    invariant of the reference's model checker violated."""
    cfg, params, tcfg, tparams = smoke
    jeng = JaxEngine(cfg, params, max_len=64, paged=True, **kw)
    teng = ServeEngine(tcfg, tparams, max_len=64, paged=True, **kw)
    jreqs = [JaxRequest(uid=i, prompt=p.copy(), max_new_tokens=m)
             for i, (p, m) in enumerate(wl)]
    treqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=m)
             for i, (p, m) in enumerate(wl)]
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    kernels.reset_counts()
    ticks = 0
    while jeng.queue or jeng.active.any():
        jeng.step()
        teng.step()
        ticks += 1
        assert [r.out_tokens for r in treqs] == \
            [r.out_tokens for r in jreqs], ticks
        assert _pool_state(teng.pool) == _pool_state(jeng.pool), ticks
        assert teng.preemptions == jeng.preemptions
        assert teng.active.tolist() == jeng.active.tolist()
        assert not pool_model.check_pool_invariants(teng.pool)
        if compare_content:
            for s in np.nonzero(teng.active)[0]:
                want = jpc.gather_slot_cache(jeng.caches, jeng.pool, int(s),
                                             cfg.num_kv_heads, jeng._stacked)
                got = tpc.gather_slot_cache(teng.caches, teng.pool, int(s),
                                            tcfg.num_kv_heads)
                for li, g in enumerate(got):
                    w = jax.tree.map(lambda a: np.asarray(a)[li], want)
                    for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(
                            [g.k, g.v, *g.ck, *g.cv])):
                        np.testing.assert_allclose(b.numpy(), a, atol=1e-5,
                                                   rtol=1e-5)
    assert not teng.queue and not teng.active.any()
    assert teng.pool.occupancy() == 0.0       # every page released
    return teng, [list(r.out_tokens) for r in treqs]


def _check_margins(smoke, wl, outs):
    """Teacher-forced top-2 margins of every generated token exceed
    MARGIN, and the greedy tokens are the forward's argmax."""
    _, _, tcfg, tparams = smoke
    fwd = get_model(tcfg).forward
    for (p, _), out in zip(wl, outs):
        seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
        logits, _ = fwd(tparams, tcfg, torch.from_numpy(seq[None]).long())
        lg = logits[0, len(p) - 1:]
        top2 = lg.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > MARGIN, (
            f"near-tie (top-2 margin {margin:.2e}): greedy equality would "
            f"be luck; change the seed")
        assert lg.argmax(-1).tolist() == out


def _dense(smoke, wl, slots):
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, slots=slots, max_len=64)
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(wl)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.out_tokens) for r in reqs]


def _shared_prompts(vocab):
    p = (np.arange(30) * 3 % vocab).astype(np.int32)
    return [(p.copy(), 4) for _ in range(3)]


def test_prefix_sharing_and_cow_lockstep(smoke):
    """Identical prompts share pages (frontier pages and coarse ancestors
    included) and copy them on the first divergent write."""
    wl = _shared_prompts(smoke[0].vocab_size)
    teng, out = _lockstep(smoke, wl, slots=3, pool_pages=24)
    assert teng.pool.stats.shared_maps > 0
    assert teng.pool.stats.cow_copies > 0
    assert out == _dense(smoke, wl, 3)
    _check_margins(smoke, wl, out)


def test_eviction_lockstep(smoke):
    wl = _workload(5, 8, smoke[0])
    teng, out = _lockstep(smoke, wl, slots=3, pool_pages=10)
    assert teng.pool.stats.evictions > 0
    _check_margins(smoke, wl, out)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preemption_lockstep(smoke, mode):
    """Pool exhaustion mid-decode preempts the newest request; swap
    restores its pages bit-exact, recompute re-prefills."""
    wl = _workload(7, 10, smoke[0])
    teng, out = _lockstep(smoke, wl, compare_content=mode == "swap",
                          slots=4, pool_pages=8, lookahead=4,
                          preempt_mode=mode)
    assert teng.preemptions > 0, "schedule no longer exercises preemption"
    _check_margins(smoke, wl, out)
    if mode == "swap":
        assert out == _dense(smoke, wl, 2)


def test_chunked_prefill_lockstep(smoke):
    wl = _workload(13, 6, smoke[0])
    _, out = _lockstep(smoke, wl, slots=3, pool_pages=16, prefill_chunk=6,
                       token_budget=24)
    _check_margins(smoke, wl, out)


def _match_rate(out, ref):
    assert [len(a) for a in out] == [len(b) for b in ref]
    tot = sum(len(b) for b in ref)
    return sum(x == y for a, b in zip(out, ref) for x, y in zip(a, b)) / tot


@pytest.mark.parametrize("quant_levels", [-1, 2])
def test_int8_lockstep(smoke, quant_levels):
    """int8 pages (every level, or levels 0 and 1): the JAX int8 engine's
    tokens and pool state step by step, on a schedule with prefix sharing
    and eviction, and >= 0.99 of the dense fp32 engine's tokens."""
    wl = _workload(5, 8, smoke[0])
    teng, out = _lockstep(smoke, wl, slots=3, pool_pages=10,
                          cache_dtype="int8", quant_levels=quant_levels)
    assert teng.pool.stats.evictions > 0 and teng.pool.stats.shared_maps > 0
    n_int8 = len(teng.pool.quant) if quant_levels < 0 else quant_levels
    assert thd.quant_level_flags(teng.caches[0]) == tuple(
        l < n_int8 for l in range(teng.pool.M))
    assert _match_rate(out, _dense(smoke, wl, 3)) >= 0.99
