"""Port parity: sequence-parallel (SP) serving (``repro_torch.parallel``)
against the JAX reference on the CPU.

The port runs its shards in one process (a loop over the shards of an
``SPMesh``, collectives as tensor ops); the reference runs
``shard_map`` on fabricated host devices.  Each is held to what the
reference's own SP tests hold it to: the plain partial kernels #11 and
#12 against ``repro.kernels.h1d_decode_kernel``'s partial kernels in
interpret mode on every shard's slab (attend within 1e-5 scaled by
max(1, |ref|), updates and carries bit-exact: copies, pairwise adds and
exact halvings); the SP decode tick against the reference's
single-device decode (attend 1e-5, update bit-exact); the SP operator
against the single-device ``h1d_attention`` within 2e-5 (fp32 with
another summation order across the halo merge); and greedy engine
tokens identical to the JAX engine's, guarded by top-2 margins above
1e-3 as in ``test_torch_serve.py``."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.h1d_attention import h1d_attention as jh1d  # noqa: E402
from repro.core import h1d_decode as jhd  # noqa: E402
from repro.kernels import h1d_decode_kernel as jdk  # noqa: E402
from repro.kernels.ops import band_attention as jband  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.parallel import sp_attention as jsp  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import h1d_decode as thd  # noqa: E402
from repro_torch.core.h1d_attention import h1d_attention  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as tdk  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.parallel import sp_attention as sp  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

TOL = 1e-5
OP_TOL = 2e-5
MARGIN = 1e-3
# the reference's DECODE_SCRIPT shapes and positions (t == Lmax is out of
# range: parity with the single-device kernel's clamping)
B, G, LMAX, D, NR = 6, 2, 256, 16, 16
TS = np.array([0, 15, 16, 130, 255, 256], np.int32)


def _mesh(d):
    return make_mesh((d,), ("data",), device="cpu")


def _tables(ts, d):
    return sp.sp_tables(ts, nr=NR, Lmax=LMAX, d=d, device="cpu")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= tol, err


@pytest.fixture(scope="module")
def caches():
    """The same prefilled cache on both sides, plus q, k_new, v_new."""
    rng = np.random.default_rng(1)
    k = rng.standard_normal((B, LMAX, D)).astype(np.float32)
    v = rng.standard_normal((B, LMAX, D)).astype(np.float32)
    q = rng.standard_normal((B, G, D)).astype(np.float32)
    kn = rng.standard_normal((B, D)).astype(np.float32)
    vn = rng.standard_normal((B, D)).astype(np.float32)
    jc = jax.jit(functools.partial(jhd.prefill_cache, Lmax=LMAX, nr=NR))(k, v)
    return jc, (k, v), q, kn, vn


def _torch_cache(kv):
    k, v = kv
    return thd.prefill_cache(torch.from_numpy(k), torch.from_numpy(v), LMAX,
                             NR)


def _leaves(c):
    return [c.k, c.v, *c.ck, *c.cv]


def _jax_slab(jc, s, d, nsh, levels=None):
    """Shard ``s``'s slab of the reference cache: the sharded levels' 1/d
    rows, the replicated levels whole (``levels`` keeps the first n)."""
    def part(a, l):
        a = np.asarray(a)
        if l >= nsh:
            return a
        n = a.shape[1] // d
        return a[:, s * n:(s + 1) * n]
    nlev = 1 + len(jc.ck) if levels is None else levels
    ks = [part(a, l) for l, a in enumerate([jc.k, *jc.ck][:nlev])]
    vs = [part(a, l) for l, a in enumerate([jc.v, *jc.cv][:nlev])]
    return jhd.H1DCache(k=ks[0], v=vs[0], ck=tuple(ks[1:]),
                        cv=tuple(vs[1:]))


# ---------------------------------------------------------------------------
# shard geometry and cache layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
def test_band_geometry_matches_reference(d):
    nsh = sp.sp_sharded_levels(LMAX, NR, d)
    M = thd.hc.num_levels(LMAX, NR)
    tabs = sp.sp_tables(TS, nr=NR, Lmax=LMAX, d=d, device="cpu")
    Lloc = LMAX // d
    for s in range(d):
        bidx, own = jsp._band_geometry(jnp.asarray(TS), jnp.int32(s), NR,
                                       LMAX, d, nsh, M - 1)
        np.testing.assert_array_equal(tabs.bidx[s].numpy(), np.asarray(bidx))
        np.testing.assert_array_equal(tabs.owned[s].numpy(), np.asarray(own))
        np.testing.assert_array_equal(
            tabs.t_loc[s].numpy(),
            np.asarray(jsp.sp_update_local_t(jnp.asarray(TS), s, Lloc)))
        owner = np.asarray(jsp.sp_update_owner(jnp.asarray(TS), Lloc, d))
        np.testing.assert_array_equal(tabs.upd_owned[s].numpy(),
                                      (owner == s).astype(np.int32))
    np.testing.assert_array_equal(tabs.t_deep.numpy(), TS >> nsh)
    # every band is owned by exactly one shard
    assert (tabs.owned.sum(0) == 1).all()
    assert (tabs.upd_owned.sum(0) == 1).all()


def test_sharded_levels_and_cache_layout(caches):
    assert sp.sp_sharded_levels(256, 16, 4) == 3   # fine + 2 coarse
    assert sp.sp_sharded_levels(64, 16, 4) == 1    # fine only
    assert sp.sp_sharded_levels(32, 16, 4) == 0    # too short to shard
    _, kv, *_ = caches
    tc = _torch_cache(kv)
    for d in (2, 4):
        sc = sp.shard_cache(tc, _mesh(d), NR)
        nsh = sp.sp_sharded_levels(LMAX, NR, d)
        for sh in sc.shards:
            for l, a in enumerate([sh.k, *sh.ck]):
                full = LMAX >> l
                assert a.shape[1] == (full // d if l < nsh else full)
                assert a.is_contiguous()
        back = sp.unshard_cache(sc)
        for a, b in zip(_leaves(back), _leaves(tc)):
            assert torch.equal(a, b)
        # replicated levels are copies, never shared storage
        assert (sc.shards[0].ck[-1].data_ptr()
                != sc.shards[1].ck[-1].data_ptr())
    with pytest.raises(ValueError, match="fewer shards"):
        sp.shard_cache(thd.prefill_cache(torch.zeros(1, 32, D),
                                         torch.zeros(1, 32, D), 32, NR),
                       _mesh(4), NR)
    with pytest.raises(ValueError, match="fewer shards"):
        sp._validate_sp_shape(32, 8, 16, "test")   # L/d = 4 < nr


# ---------------------------------------------------------------------------
# plain kernels #11 and #12 against the reference's partial kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
def test_decode_attend_partial_plain_matches_jax(caches, d):
    jc, kv, q, *_ = caches
    sc = sp.shard_cache(_torch_cache(kv), _mesh(d), NR)
    nsh = sp.sp_sharded_levels(LMAX, NR, d)
    tabs = sp.sp_tables(TS, nr=NR, Lmax=LMAX, d=d, device="cpu")
    qt, tt = torch.from_numpy(q), torch.from_numpy(TS)
    for s in range(d):
        want = jdk.decode_attend_partial(
            _jax_slab(jc, s, d, nsh), q, TS, np.asarray(tabs.bidx[s]),
            np.asarray(tabs.owned[s]), nr=NR, t_hi=LMAX - 1, interpret=True)
        got = tdk.decode_attend_partial_ref(sc.shards[s], qt, tt,
                                            tabs.bidx[s], tabs.owned[s],
                                            nr=NR)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    # a row whose bands are all unowned: num = den = 0, m = -1e30, no NaN
    num, den, m = tdk.decode_attend_partial_ref(
        sc.shards[0], qt, tt, tabs.bidx[0], torch.zeros_like(tabs.owned[0]),
        nr=NR)
    assert (num == 0).all() and (den == 0).all() and (m == -1e30).all()


@pytest.mark.parametrize("d", [2, 4])
def test_update_cache_partial_plain_matches_jax(caches, d):
    jc, kv, _, kn, vn = caches
    sc = sp.shard_cache(_torch_cache(kv), _mesh(d), NR)
    nsh = sp.sp_sharded_levels(LMAX, NR, d)
    tabs = sp.sp_tables(TS, nr=NR, Lmax=LMAX, d=d, device="cpu")
    for s in range(d):
        own = np.asarray(tabs.upd_owned[s])
        want, wk, wv = jdk.update_cache_partial(
            _jax_slab(jc, s, d, nsh, levels=nsh), kn, vn,
            np.asarray(tabs.t_loc[s]), own, t_hi=LMAX, interpret=True)
        sh = sc.shards[s]
        slab = thd.H1DCache(sh.k, sh.v, sh.ck[:nsh - 1], sh.cv[:nsh - 1])
        _, ck, cv = tdk.update_cache_partial_ref(
            slab, torch.from_numpy(kn), torch.from_numpy(vn), tabs.t_loc[s],
            tabs.upd_owned[s])
        for a, b in zip(_leaves(slab), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        rows = own != 0
        assert rows.any() or s < d - 1
        np.testing.assert_array_equal(ck.numpy()[rows], np.asarray(wk)[rows])
        np.testing.assert_array_equal(cv.numpy()[rows], np.asarray(wv)[rows])
        assert torch.isfinite(ck).all() and torch.isfinite(cv).all()


# ---------------------------------------------------------------------------
# the SP decode tick against the single-device reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
def test_sp_decode_matches_single_device(caches, d):
    jc, kv, q, kn, vn = caches
    mesh = _mesh(d)
    sc = sp.shard_cache(_torch_cache(kv), mesh, NR)
    qt, tt = torch.from_numpy(q), torch.from_numpy(TS)
    tabs = _tables(TS, d)
    with sp.sp_scope(mesh):
        got = thd.decode_attend(sc, qt, tt, nr=NR, tables=tabs)
    # the single-device kernel (interpret mode): at the out-of-range
    # t == Lmax the reference's jnp path clamps its slices otherwise
    _close(got.numpy(), jhd.decode_attend(jc, q, TS, nr=NR,
                                          impl="pallas_interpret"))
    # the out-of-range row is owned by the last shard, so the deep levels
    # take its carry, never zeros
    want = jhd.update_cache(jc, kn, vn, TS, impl="pallas_interpret")
    with sp.sp_scope(mesh):
        out = thd.update_cache(sc, torch.from_numpy(kn), torch.from_numpy(vn),
                               tt, tables=tabs)
    assert out is sc
    for a, b in zip(_leaves(sp.unshard_cache(sc)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sp_uniform_decode_matches_single_device(caches):
    """The scalar-t (B=1) entry points under a 4-way scope, at t = 130."""
    jc, kv, q, kn, vn = caches
    mesh = _mesh(4)
    sc = sp.shard_cache(_torch_cache(kv), mesh, NR)
    t = 130
    want_c = jhd.update_cache_uniform(jc, kn, vn, jnp.int32(t))
    want_z = jhd.decode_attend_uniform(want_c, q, jnp.int32(t), nr=NR)
    tabs = _tables(np.full(B, t), 4)
    with sp.sp_scope(mesh):
        thd.update_cache_uniform(sc, torch.from_numpy(kn),
                                 torch.from_numpy(vn), torch.tensor(t),
                                 tables=tabs)
        got = thd.decode_attend_uniform(sc, torch.from_numpy(q),
                                        torch.tensor(t), nr=NR, tables=tabs)
    _close(got.numpy(), want_z)
    for a, b in zip(_leaves(sp.unshard_cache(sc)), jax.tree.leaves(want_c)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sp_decode_takes_the_partial_kernels(caches):
    """Under a mesh, the tick calls the plain versions of #11 and #12
    (CPU tensors) and #6 on the deep levels, never #5."""
    _, kv, q, kn, vn = caches
    mesh = _mesh(4)
    sc = sp.shard_cache(_torch_cache(kv), mesh, NR)
    tabs = _tables(TS, 4)
    kernels.reset_counts()
    with sp.sp_scope(mesh):
        thd.update_cache(sc, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(TS), tables=tabs)
        thd.decode_attend(sc, torch.from_numpy(q), torch.from_numpy(TS),
                          nr=NR, tables=tabs)
    calls = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}
    assert calls["decode_attend_partial"] == 4
    assert calls["update_cache_partial"] == 4
    assert calls["update_cache_fused"] == 4      # nsh = 3 < 4 levels
    assert calls["decode_attend_fused"] == 0
    assert all(k.launches == 0 for k, _ in kernels.KERNELS.values())


def test_sp_cache_needs_its_scope(caches):
    _, kv, q, *_ = caches
    sc = sp.shard_cache(_torch_cache(kv), _mesh(2), NR)
    args = (sc, torch.from_numpy(q), torch.from_numpy(TS))
    with pytest.raises(ValueError, match="sp_scope"):
        thd.decode_attend(*args, nr=NR, tables=_tables(TS, 2))
    with sp.sp_scope(_mesh(4)), pytest.raises(ValueError, match="sp_scope"):
        thd.decode_attend(*args, nr=NR, tables=_tables(TS, 2))
    # the tick's shard geometry is an argument, never rebuilt per layer
    with sp.sp_scope(_mesh(2)), pytest.raises(ValueError, match="tables"):
        thd.decode_attend(*args, nr=NR)


# ---------------------------------------------------------------------------
# prefill: the SP operator and one banded level
# ---------------------------------------------------------------------------

def _operands(L, seed, Bq=2, Gq=2, Dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bq, Gq, L, Dh)).astype(np.float32)
    k = rng.standard_normal((Bq, L, Dh)).astype(np.float32)
    v = rng.standard_normal((Bq, L, Dh)).astype(np.float32)
    w = np.ones((Bq, L), np.float32)
    w[:, -37:] = 0.0                                  # padded tail
    return q, k, v, w


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("causal,causal_mode", [(True, "fine-q"),
                                                (True, "coarse-q"),
                                                (False, "fine-q")])
def test_sp_h1d_attention_matches_jax(d, causal, causal_mode):
    """L=256, nr=16: at d=4 the local slab (64) keeps levels 0-2 and
    level 3 goes through the gathered deep path; at d=2 all are local."""
    L = 256
    q, k, v, w = _operands(L, seed=d)
    want = jh1d(q, k, v, nr=NR, causal=causal,
                causal_mode=causal_mode, kv_weight=w)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    mesh = _mesh(d)
    sp.DISPATCHES.clear()
    got = sp.sp_h1d_attention(tq, tk, tv, mesh=mesh, nr=NR, causal=causal,
                              causal_mode=causal_mode, kv_weight=tw)
    _close(got.numpy(), want, OP_TOL)
    # the same through the scoped dispatch of h1d_attention
    with sp.sp_scope(mesh):
        scoped = h1d_attention(tq, tk, tv, nr=NR, causal=causal,
                               causal_mode=causal_mode, kv_weight=tw)
    assert sp.DISPATCHES["h1d_attention"] == 2
    assert torch.equal(scoped, got)


@pytest.mark.parametrize("d,mode,ratio", [
    (4, "l0_bidir", 1), (4, "l0_causal", 1), (4, "coarse_bidir", 1),
    (4, "coarse_causal", 1), (4, "sub", 2), (2, "l0_bidir", 1),
    (1, "l0_causal", 1)])
def test_sp_band_attention_matches_jax(d, mode, ratio):
    """Every mode at d=4, the bidirectional halo pair again at d=2, and a
    1-way mesh (one shard, zero halos)."""
    L = 128
    q, k, v, w = _operands(L, seed=7)
    Lk = L // ratio
    k, v, w = k[:, :Lk], v[:, :Lk], w[:, :Lk]
    want = jband(q, k, v, w, nr=NR, mode=mode, ratio=ratio)
    got = sp.sp_band_attention(*map(torch.from_numpy, (q, k, v, w)), nr=NR,
                               mode=mode, ratio=ratio, mesh=_mesh(d))
    for g, x in zip(got, want):
        _close(g.numpy(), x)


def test_sp_prefill_takes_gradients():
    """The SP operator and one SP level are differentiable: at L 64 over
    2 shards their gradients of q, k, v and the key weights match the
    unsharded port's within 1e-5 of ``1 + max`` (the reference's SP
    gradient bound; ``test_torch_sp_train.py`` holds them to JAX)."""
    arrays = _operands(64, seed=3)

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = fn(*ts)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(sum(o.square().sum() for o in out), ts)

    def close(got, want):
        for g, x in zip(got, want):
            assert (g - x).abs().max() <= TOL * (1 + x.abs().max())

    kw = dict(nr=NR, causal=True)
    close(grads(lambda q, k, v, w: sp.sp_h1d_attention(
              q, k, v, mesh=_mesh(2), kv_weight=w, **kw)),
          grads(lambda q, k, v, w: h1d_attention(q, k, v, kv_weight=w,
                                                 **kw)))
    close(grads(lambda *a: sp.sp_band_attention(*a, nr=NR, mode="l0_causal",
                                                mesh=_mesh(2))),
          grads(lambda *a: kernels.band_attention(*a, nr=NR,
                                                  mode="l0_causal")))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ARCH = "h1d-lm-53m"
PROMPT_LENS = [5, 12, 30, 9, 17, 40]


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(2), cfg)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    return cfg, params, tcfg, tparams, prompts


def _serve(engine, make_req, prompts, n_new=6):
    reqs = [make_req(uid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("d,slots", [(2, 3), (4, 1)])
def test_sp_engine_greedy_tokens_match(smoke, d, slots):
    """slots=3 (a non-power-of-two slot count) at d=2; slots=1 (the
    uniform decode path) at d=4, where the deep levels take the carry.
    Tokens identical to JAX's single-device engine and to the port's
    engine without a mesh."""
    cfg, params, tcfg, tparams, prompts = smoke
    want = _serve(JaxEngine(cfg, params, slots=slots, max_len=64),
                  JaxRequest, prompts)
    dense = _serve(ServeEngine(tcfg, tparams, slots=slots, max_len=64),
                   Request, prompts)
    kernels.reset_counts()
    sp.DISPATCHES.clear()
    got = _serve(ServeEngine(tcfg, tparams, slots=slots, max_len=64,
                             mesh=_mesh(d)), Request, prompts)
    assert got == want and dense == want
    calls = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}
    assert calls["decode_attend_partial"] > 0
    assert calls["update_cache_partial"] > 0
    assert calls["decode_attend_fused"] == 0
    assert sp.DISPATCHES["h1d_attention"] > 0      # SP prefill ran
    # the greedy equality is no tie-break luck
    fwd = get_model(tcfg).forward
    for p, out in zip(prompts, got):
        seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
        logits, _ = fwd(tparams, tcfg, torch.from_numpy(seq[None]).long())
        top2 = logits[0, len(p) - 1:].topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def test_sp_engine_guards(smoke):
    _, _, tcfg, tparams, _ = smoke
    with pytest.raises(ValueError, match="shard"):
        ServeEngine(tcfg, tparams, slots=1, max_len=16, mesh=_mesh(4))
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, tparams, slots=1, max_len=64, mesh=_mesh(2),
                    paged=True)
    # the mesh's own axis is the engine's sp_axis, never ignored
    with pytest.raises(ValueError, match="axis"):
        ServeEngine(tcfg, tparams, slots=1, max_len=64, mesh=_mesh(2),
                    sp_axis="model")
    # the shards sit on the engine's device
    with pytest.raises(ValueError, match="shards sit on meta"):
        ServeEngine(tcfg, tparams, slots=1, max_len=64,
                    mesh=make_mesh((2,), ("data",), device="meta"))
    # a 1-way mesh serves as without one
    eng = ServeEngine(tcfg, tparams, slots=1, max_len=64, mesh=_mesh(1))
    assert isinstance(eng.caches[0], thd.H1DCache)


def test_sp_scope_inert_without_a_real_mesh():
    with sp.sp_scope(None):
        assert sp.sp_ctx() is None
    with sp.sp_scope(_mesh(1)):
        assert sp.sp_ctx() is None
    mesh = _mesh(2)
    with sp.sp_scope(mesh):
        assert sp.sp_ctx() is mesh
        with sp._local_region():
            assert sp.sp_ctx() is None
        assert sp.sp_ctx() is mesh
    assert sp.sp_ctx() is None


def test_make_mesh_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((2,), ("data",))
    mesh = make_mesh((2,), ("data",), device="cpu")
    assert (mesh.axis, mesh.d) == ("data", 2)
    with pytest.raises(NotImplementedError):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(NotImplementedError):
        sp.SPMesh("data", (torch.device("cpu"), torch.device("meta")))
