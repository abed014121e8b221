"""Port parity of the int8 page pool with bf16 levels beside its int8
ones: a bf16 config served from a paged int8 pool with ``quant_levels``
below the level count (``--paged --cache-dtype int8 --quant-levels 1``).

* The plain update (#10's CPU path and its card oracle) against the
  reference's Pallas ``update_cache_paged_quant`` in interpret mode and
  its jnp path, bit for bit on every page and scale over chained
  appends: one unrounded f32 carry chain through every level, each
  stored bf16 row rounded once, the int8 levels requantized with fresh
  per-row scales in place.
* The plain attend (#8) on the same pools within 1e-5 of the Pallas
  attend in interpret mode.
* The bf16 smoke engines of llama3.2-1b and yi-6b on such a pool give
  the JAX engine's greedy tokens, and the serving CLI runs it.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import h1d_decode as jhd  # noqa: E402
from repro.kernels import h1d_decode_kernel as jdk  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import h1d_decode as thd  # noqa: E402
from repro_torch.core import hierarchy as hc  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as tdk  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

BF16 = torch.bfloat16
ATOL = 1e-5
# int8 levels per pattern: the fine level (quant_levels=1), the first two,
# none (an int8-typed pool whose levels are all bf16)
QUANT = {"ql1": 1, "ql2": 2, "none": 0}


def _pools(M, nr, D, Dv, npages, nq, seed):
    """Random numpy levels (k, v, ksc, vsc): the first ``nq`` int8 with
    positive per-row scales, the rest f32 values that both packages round
    to bf16 (values scaled by 2^l, as a sum grows up the hierarchy)."""
    rng = np.random.default_rng(seed)
    out = []
    for l in range(M):
        if l < nq:
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


def _jax_pool(levels):
    def d(a):
        return jnp.asarray(a, a.dtype if a.dtype == np.int8 else jnp.bfloat16)
    return jhd.QuantPagedH1DCache(
        k=d(levels[0][0]), v=d(levels[0][1]),
        ck=tuple(d(x[0]) for x in levels[1:]),
        cv=tuple(d(x[1]) for x in levels[1:]),
        ksc=jnp.asarray(levels[0][2]), vsc=jnp.asarray(levels[0][3]),
        cksc=tuple(jnp.asarray(x[2]) for x in levels[1:]),
        cvsc=tuple(jnp.asarray(x[3]) for x in levels[1:]))


def _torch_pool(levels):
    def d(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t if a.dtype == np.int8 else t.to(BF16)
    return thd.QuantPagedH1DCache(
        k=d(levels[0][0]), v=d(levels[0][1]),
        ck=tuple(d(x[0]) for x in levels[1:]),
        cv=tuple(d(x[1]) for x in levels[1:]),
        ksc=torch.from_numpy(levels[0][2].copy()),
        vsc=torch.from_numpy(levels[0][3].copy()),
        cksc=tuple(torch.from_numpy(x[2].copy()) for x in levels[1:]),
        cvsc=tuple(torch.from_numpy(x[3].copy()) for x in levels[1:]))


def _bits(a):
    """Exact bits of a leaf of either package as numpy (bf16 widened to
    f32, which is exact)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == BF16 else a).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32)
                      if a.dtype == jnp.bfloat16 else a)


def _assert_pools_equal(jpool, tpool):
    for a, b in zip(jax.tree.leaves(jpool), jax.tree.leaves(
            [tpool.k, tpool.v, list(tpool.ck), list(tpool.cv), tpool.ksc,
             tpool.vsc, list(tpool.cksc), list(tpool.cvsc)])):
        assert str(a.dtype).replace("bfloat16", "bf") == str(
            b.dtype).replace("torch.", "").replace("bfloat16", "bf")
        np.testing.assert_array_equal(_bits(b), _bits(a))


# traced once a shape: the chained ticks reuse the program
_pallas_update = jax.jit(functools.partial(jdk.update_cache_paged_quant,
                                           interpret=True))
_jnp_update = jax.jit(jhd._update_cache_paged_quant_jnp)


def _case(Lmax, nr, D, Dv, pattern, seed):
    M = hc.num_levels(Lmax, nr)
    rng = np.random.default_rng(seed)
    R = 6
    npages = 2 * R + 2
    levels = _pools(M, nr, D, Dv, npages, QUANT[pattern], seed)
    return M, R, npages, levels, rng


@pytest.mark.parametrize("pattern", list(QUANT))
@pytest.mark.parametrize("Lmax,nr,D,Dv", [(128, 8, 16, 16), (256, 16, 16, 8),
                                          (64, 4, 8, 24)])
def test_plain_update_matches_pallas_interpret(Lmax, nr, D, Dv, pattern):
    """Four chained appends of bf16 rows (later ones read the pairs the
    earlier ones wrote): the plain update bit for bit against the
    reference's Pallas kernel in interpret mode, and against its jnp
    path, on every page and scale; each row's write pages private."""
    M, R, npages, levels, rng = _case(Lmax, nr, D, Dv, pattern, Lmax + nr)
    jpool, npool = _jax_pool(levels), _jax_pool(levels)
    tpool = _torch_pool(levels)
    ts = rng.integers(0, Lmax - 4, R).astype(np.int32)
    ts[:2] = (0, Lmax - 4)
    for step in range(4):
        t = ts + step
        utab = np.stack([rng.permutation(npages)[:R] for _ in range(M)],
                        1).astype(np.int32)
        kn = rng.standard_normal((R, D)).astype(np.float32)
        vn = rng.standard_normal((R, Dv)).astype(np.float32)
        jk, jv = jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16)
        jpool = _pallas_update(jpool, jk, jv, jnp.asarray(t),
                               jnp.asarray(utab))
        npool = _jnp_update(npool, jk, jv, jnp.asarray(t), jnp.asarray(utab))
        out = thd.update_cache_paged(tpool, torch.from_numpy(kn).to(BF16),
                                     torch.from_numpy(vn).to(BF16),
                                     torch.from_numpy(t),
                                     torch.from_numpy(utab))
        assert out is tpool
        _assert_pools_equal(jpool, tpool)
        _assert_pools_equal(npool, tpool)
    assert tpool.k.dtype == (torch.int8 if QUANT[pattern] else BF16)
    assert tpool.ck[-1].dtype == BF16


@pytest.mark.parametrize("pattern", list(QUANT))
def test_plain_attend_matches_pallas_interpret(pattern):
    """#8's plain version on the mixed pool within 1e-5 of the Pallas
    attend in interpret mode (bf16 q, widened on both sides)."""
    Lmax, nr, G, D = 128, 8, 2, 16
    M, R, npages, levels, rng = _case(Lmax, nr, D, D, pattern, 11)
    t = rng.integers(0, Lmax, R).astype(np.int32)
    t[:3] = (0, nr, Lmax - 1)
    bidx = rng.integers(0, npages, (R, 1 + M)).astype(np.int32)
    q = rng.standard_normal((R, G, D)).astype(np.float32)
    want = jdk.decode_attend_paged_quant(
        _jax_pool(levels), jnp.asarray(q, jnp.bfloat16), jnp.asarray(t),
        jnp.asarray(bidx), nr=nr, interpret=True)
    got = thd.decode_attend_paged(
        _torch_pool(levels), torch.from_numpy(q).to(BF16),
        torch.from_numpy(t), torch.from_numpy(bidx), nr=nr)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=ATOL)


def _smoke_pair(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    params, _ = jax_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return jcfg, params, tcfg, tparams


@pytest.mark.parametrize("arch", ["llama3.2-1b", "yi-6b"])
def test_bf16_engine_on_an_int8_pool_matches_jax(arch):
    """The bf16 smoke engine with ``paged=True, cache_dtype='int8',
    quant_levels=1`` (level 0 int8, the rest bf16) gives the JAX engine's
    greedy tokens, through the plain #8 and #10."""
    jcfg, params, tcfg, tparams = _smoke_pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 30)]
    kw = dict(max_len=64, slots=2, paged=True, cache_dtype="int8",
              quant_levels=1)
    jeng = JaxEngine(jcfg, params, **kw)
    teng = ServeEngine(tcfg, tparams, **kw)
    assert [a.dtype for a in (teng.caches[0].k, *teng.caches[0].ck)] == \
        [torch.int8] + [BF16] * (teng.pool.M - 1)
    jreqs = [JaxRequest(uid=i, prompt=p.copy(), max_new_tokens=6)
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=6)
             for i, p in enumerate(prompts)]
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    calls = tdk.update_cache_paged_quant_ref.calls
    jeng.run()
    teng.run()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert tdk.update_cache_paged_quant_ref.calls > calls


def test_serve_cli_takes_a_bf16_config_on_an_int8_pool(monkeypatch, capsys):
    """``launch.serve --paged --cache-dtype int8 --quant-levels 1`` on
    llama3.2-1b's smoke config in its published bf16."""
    monkeypatch.setattr(serve_cli, "get_smoke_config", lambda a: (
        dataclasses.replace(get_smoke_config(a), dtype="bfloat16")))
    reqs = serve_cli.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                           "cpu", "--requests", "3", "--slots", "2",
                           "--new-tokens", "4", "--max-len", "64",
                           "--paged", "--cache-dtype", "int8",
                           "--quant-levels", "1"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "bfloat16" in out and "paged (int8)" in out
