"""The framework-independent rows of ``BENCH_serve.json``, reproduced by
the port on the CPU.

``benchmarks/bench_serve.py`` serves the same Poisson workload (one
shared 64-token prefix plus unique tails) from a dense engine, a paged
fp32 engine and a paged int8 engine at one fixed cache budget: the
dense engine's bytes.  Its page counts, prefix-sharing counters and
peak concurrencies depend on the allocator and the scheduler alone, not
on the framework, so the port must give the reference's numbers.  The
model is the reference's ``llama3.2-1b`` smoke config (an h1d dense
decoder) with the reference's weights; the pools are sized by the
port's ``pool_bytes``."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:              # ``benchmarks`` is not installed
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_serve as bs  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import paged_cache as pc  # noqa: E402


def _drive(eng, workload):
    """The tick loop of ``bench_serve._drive``: arrivals by tick, one
    ``step()`` per tick.  Returns (peak concurrency, tokens per
    request)."""
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (_, p, m) in enumerate(workload)]
    arrivals = [a for a, _, _ in workload]
    pending = list(range(len(reqs)))
    tick = peak = 0
    while pending or eng.queue or eng.active.any():
        while pending and arrivals[pending[0]] <= tick:
            eng.submit(reqs[pending.pop(0)])
        eng.step()
        peak = max(peak, int(eng.active.sum()))
        tick += 1
    return peak, [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def bench():
    jcfg = jax_smoke(bs.ARCH)
    params, _ = jax_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    wl = bs._workload(jcfg, 12, 64)

    def build(paged, pool_pages=None, cache_dtype=None, slots=None):
        slots = slots or (bs.PAGED_SLOTS if paged else bs.DENSE_SLOTS)
        kw = dict(slots=slots, max_len=bs.MAX_LEN)
        if paged:
            kw.update(paged=True, pool_pages=pool_pages, lookahead=4,
                      cache_dtype=cache_dtype)
        return ServeEngine(cfg, tparams, **kw)

    def paged_bytes(pages, quant_levels=0):
        pool = pc.PagePool(slots=bs.PAGED_SLOTS, max_len=bs.MAX_LEN,
                           nr=cfg.nr, pool_pages=pages,
                           quant_levels=quant_levels)
        return pc.pool_bytes(pc.init_paged_caches(cfg, pool, device="meta"))

    dense = build(False)
    budget = pc.pool_bytes(dense.caches)

    def fit_pages(quant_levels=0, start=1):
        pages = start
        while paged_bytes(pages + 1, quant_levels) <= budget:
            pages += 1
        return pages

    fp32_pages = fit_pages()
    int8_pages = fit_pages(-1, start=fp32_pages)
    out = dict(budget=budget, fp32_pages=fp32_pages, int8_pages=int8_pages,
               fp32_bytes=paged_bytes(fp32_pages),
               int8_bytes=paged_bytes(int8_pages, -1))
    out["dense"] = _drive(dense, wl)
    paged = build(True, fp32_pages)
    out["paged"] = _drive(paged, wl) + (paged,)
    quant = build(True, int8_pages, "int8", bs.INT8_SLOTS)
    out["int8"] = _drive(quant, wl) + (quant,)
    return out


def test_fixed_budget_pages_match_bench(bench):
    """245,760 B of cache hold 24 fp32 pages or 99 int8 pages."""
    assert bench["budget"] == 245760
    assert (bench["fp32_pages"], bench["int8_pages"]) == (24, 99)
    assert bench["fp32_bytes"] <= 245760 and bench["int8_bytes"] <= 245760


@pytest.mark.parametrize("engine", ["paged", "int8"])
def test_prefix_sharing_counts_match_bench(bench, engine):
    """shared=165, hits=165, misses=63 (hit rate 0.724), no copy on
    write, eviction or preemption."""
    st = bench[engine][2].pool.stats
    assert (st.shared_maps, st.prefix_hits, st.prefix_misses) == \
        (165, 165, 63)
    assert round(st.prefix_hit_rate(), 3) == 0.724
    assert (st.cow_copies, st.evictions, bench[engine][2].preemptions) == \
        (0, 0, 0)


def test_peak_concurrency_and_tokens_match_bench(bench):
    """Peak concurrency 2 (dense), 6 (paged fp32), 12 (paged int8); the
    paged engine's tokens are the dense engine's, and int8 matches at
    least 0.99 of them."""
    assert (bench["dense"][0], bench["paged"][0], bench["int8"][0]) == \
        (2, 6, 12)
    dense, paged, int8 = (bench[k][1] for k in ("dense", "paged", "int8"))
    assert paged == dense
    tot = sum(len(d) for d in dense)
    hit = sum(x == y for a, b in zip(int8, dense) for x, y in zip(a, b))
    assert hit / tot >= 0.99
