"""Port parity: sequence-parallel (SP) serving of the sliding-window,
SSM and hybrid smoke configs (``gemma3-4b-smoke``, ``mamba2-smoke``,
``zamba2-smoke``) against the JAX package on the CPU.

Under a mesh the port shards only the hierarchical caches (the global
layers' of gemma3, the shared block's of zamba2); a local layer's
rolling cache and an SSM layer's state stay whole, as the reference
keeps them on every shard, and mamba2 (no hierarchical cache) builds no
shard geometry.  Held to:

* greedy tokens identical to JAX's single-device ``ServeEngine`` and to
  the port's engine without a mesh, every token's top-2 margin on the
  port's teacher-forced logits above 1e-3 (``test_torch_sp.py``'s
  guard), at d = 2 and d = 4 (max_len 96 pads to 128: one nr-row block
  per shard at both);
* the caches against the mesh-free engine's after every tick, sharded
  ones through ``unshard_caches``: bit for bit up to and including the
  first layer whose input has passed through an SP attention (every
  layer for mamba2); past it within 1e-4 absolute, the tolerance the
  family tests hold caches to (the SP operator sums across the halo
  merge in another order, 2e-5 on its output);
* the local layer's band under ``sp_scope`` (``sp_band_attention`` at
  nr = window = 16) against the reference's ``_local_attention`` within
  2e-5 absolute, 1e-4 relative (the SP operator's tolerance);
* the hybrid's decode step under ``sp_scope`` (the shared block on the
  partial kernels' plain versions, its SSM layers ignoring the tables)
  against JAX's decode step: logits 2e-5, SSM states 1e-5 of their
  largest entry, hierarchical caches 1e-4."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.h1d_decode import H1DCache  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402
from repro_torch.parallel import sp_attention as sp  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import ENCDEC_REFUSAL  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("gemma3-4b", "zamba2-1.2b", "mamba2-1.3b")
MAX_LEN, SLOTS, NEW = 96, 2, 5
# gemma's window 16 at d = 2: 30 and 61 pad to 32 and 64 (a whole window
# a shard: the SP band), 37 to 48 (one launch); 61 at d = 4 too
PROMPT_LENS = (30, 61, 37, 13)
OP_TOL = dict(atol=2e-5, rtol=1e-4)
MARGIN = 1e-3
CACHE_ATOL, LOGIT_TOL, STATE_TOL = 1e-4, 2e-5, 1e-5


def _mesh(d):
    return make_mesh((d,), ("data",), device="cpu")


@functools.lru_cache(maxsize=None)
def _smoke(arch):
    cfg = jax_smoke(arch)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(5), cfg)
    tcfg = get_smoke_config(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def _prompts(vocab):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, make_req, prompts):
    reqs = [make_req(uid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [list(r.out_tokens) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    cfg, params, _, _ = _smoke(arch)
    return _serve(JaxEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN),
                  JaxRequest, _prompts(cfg.vocab_size))


def _margin(tcfg, tparams, prompts, outs):
    """The smallest top-2 margin of the port's teacher-forced logits over
    every generated token."""
    fwd = get_model(tcfg).forward
    worst = float("inf")
    for p, out in zip(prompts, outs):
        seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
        logits, _ = fwd(tparams, tcfg, torch.from_numpy(seq[None]).long())
        top2 = logits[0, len(p) - 1:].topk(2, dim=-1).values
        worst = min(worst, float((top2[:, 0] - top2[:, 1]).min()))
    return worst


# ---------------------------------------------------------------------------
# engine tokens against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_engine_tokens_match_jax(arch, d, monkeypatch):
    """Tokens of the SP engine equal JAX's single-device engine's and the
    mesh-free port engine's.  gemma and zamba2 decode on the partial
    kernels' plain versions (never #5's); gemma's local layers take the
    SP band at nr = window where a padded prompt keeps a whole window a
    shard; mamba2 shards nothing and calls no kernel."""
    _, _, tcfg, tparams = _smoke(arch)
    prompts = _prompts(tcfg.vocab_size)
    want = _jax_tokens(arch)
    dense = _serve(ServeEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN),
                   Request, prompts)
    windows = []
    real = sp.sp_band_attention

    def spy(*a, nr, **kw):
        windows.append(nr)
        return real(*a, nr=nr, **kw)
    monkeypatch.setattr(sp, "sp_band_attention", spy)
    kernels.reset_counts()
    sp.DISPATCHES.clear()
    eng = ServeEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                      mesh=_mesh(d))
    got = _serve(eng, Request, prompts)
    assert got == want and dense == want
    calls = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}
    assert all(k.launches == 0 for k, _ in kernels.KERNELS.values())
    sharded = [c for c in eng.caches if isinstance(c, sp.SPCache)]
    if arch == "mamba2-1.3b":
        assert not sharded and not any(calls.values())
        assert all(isinstance(c, SSMState) for c in eng.caches)
        assert not sp.DISPATCHES
    else:
        assert sharded and all(len(c.shards) == d for c in sharded)
        assert calls["decode_attend_partial"] > 0
        assert calls["update_cache_partial"] > 0
        assert calls["decode_attend_fused"] == 0
        assert sp.DISPATCHES["h1d_attention"] > 0       # SP prefill ran
    if arch == "gemma3-4b":
        assert tcfg.sliding_window in windows            # the local band
    assert _margin(tcfg, tparams, prompts, got) > MARGIN


# ---------------------------------------------------------------------------
# caches against the mesh-free engine
# ---------------------------------------------------------------------------

def _first_sp_input(tcfg, caches):
    """Index of the first cache whose layer's input has passed through an
    attention run under SP: the layer after the first hierarchical cache
    (a local layer's band may run under SP too, so for a windowed stack
    the layer after the first local one)."""
    for i, c in enumerate(caches):
        if isinstance(c, (sp.SPCache, dict)):
            return i + 1
    return len(caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_engine_caches_match_mesh_free(arch):
    """The SP and mesh-free engines in lockstep, one tick at a time, on
    the same requests: after every tick each layer's cache (sharded ones
    through ``unshard_caches``) equals the mesh-free one's bit for bit up
    to the first layer fed by an SP attention, within CACHE_ATOL past
    it; rolling caches' positions and SSM states' shapes and dtypes
    identical; the slots' positions equal."""
    _, _, tcfg, tparams = _smoke(arch)
    prompts = _prompts(tcfg.vocab_size)
    engines = [ServeEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                           mesh=m) for m in (None, _mesh(2))]
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=NEW))
    exact_upto = _first_sp_input(tcfg, engines[1].caches)
    ticks = 0
    while engines[0].queue or engines[0].active.any():
        for eng in engines:
            eng.step()
        ticks += 1
        ref, sharded = engines
        assert (ref.pos_host == sharded.pos_host).all()
        got = sp.unshard_caches(sharded.caches)
        assert [type(c) for c in got] == [type(c) for c in ref.caches]
        for i, (a, b) in enumerate(zip(got, ref.caches)):
            if isinstance(a, dict):
                assert torch.equal(a["pos"], b["pos"])
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                assert x.shape == y.shape and x.dtype == y.dtype
                if i < exact_upto:
                    assert torch.equal(x, y), (i, ticks)
                else:
                    assert float((x - y).abs().max()) <= CACHE_ATOL, (i,
                                                                       ticks)
    assert ticks > NEW
    if arch == "mamba2-1.3b":
        assert exact_upto == len(engines[1].caches)     # all bit for bit


def test_shard_caches_keep_other_caches_whole():
    """``shard_caches`` shards the hierarchical caches of a mixed list and
    hands back the same rolling-cache dicts and SSM states;
    ``unshard_caches`` inverts it bit for bit; the one-cache functions
    refuse any other cache."""
    _, _, tcfg, tparams = _smoke("gemma3-4b")
    caches = get_model(tcfg).init_caches(tparams, tcfg, SLOTS, MAX_LEN)
    for c in caches:
        for a in tree_leaves(c):
            if a.is_floating_point():
                a.normal_()
    mixed = sp.shard_caches(caches, _mesh(2), tcfg.nr)
    assert [type(c) for c in mixed].count(dict) == 4
    for a, b in zip(mixed, caches):
        if isinstance(b, dict):
            assert a is b
        else:
            assert isinstance(a, sp.SPCache)
    back = sp.unshard_caches(mixed)
    for a, b in zip(tree_leaves(back), tree_leaves(caches)):
        assert torch.equal(a, b)
    state = SSMState(torch.zeros(2, 1), torch.zeros(2, 1))
    assert sp.shard_caches([state], _mesh(2), 8)[0] is state
    with pytest.raises(TypeError, match="H1DCache"):
        sp.shard_cache(caches[0], _mesh(2), tcfg.nr)
    with pytest.raises(TypeError, match="SPCache"):
        sp.unshard_cache(caches[2])


# ---------------------------------------------------------------------------
# gemma's local band under SP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,L", [(2, 32), (2, 61), (4, 64), (2, 128)])
def test_sp_local_band_matches_jax(d, L, monkeypatch):
    """The port's ``_local_attention`` at window 16 inside a d-way
    ``sp_scope`` (one ``sp_band_attention`` in ``l0_causal`` at nr 16:
    the band per shard and the neighbour's last window as the halo)
    against the reference's ``_local_attention`` on one device: G = 2,
    a zero-weight tail on one row (61 pads to 64)."""
    seen = []
    real = sp.sp_band_attention

    def spy(*a, **kw):
        seen.append((kw["nr"], kw["mode"]))
        return real(*a, **kw)
    monkeypatch.setattr(sp, "sp_band_attention", spy)
    rng = np.random.default_rng(L + d)
    q = rng.standard_normal((2, L, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, L, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, L, 2, 16)).astype(np.float32)
    w = np.ones((2, L), np.float32)
    w[1, L - 9:] = 0.0
    want = jax.jit(functools.partial(jattn._local_attention, window=16,
                                     causal=True, impl="jnp"))(
        q, k, v, kv_weight=w)
    with sp.sp_scope(_mesh(d)):
        got = tattn._local_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), 16, True,
            torch.from_numpy(w))
    assert seen == [(16, "l0_causal")]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ---------------------------------------------------------------------------
# the hybrid's decode step under sp_scope
# ---------------------------------------------------------------------------

def test_hybrid_sp_decode_step_matches_jax():
    """zamba2-smoke: a dense 37-token prefill of two rows (JAX and the
    port), the shared block's caches sharded 2 ways, then 3 greedy decode
    steps inside ``sp_scope`` with the tick's tables: logits, every SSM
    state and the unsharded hierarchical caches against JAX's decode
    steps; the SSM layers' states are the same objects' types as the
    mesh-free step's, and only the shared block's caches are sharded."""
    cfg, params, tcfg, tp = _smoke("zamba2-1.2b")
    Lmax, S = 64, 37
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, S)).astype(np.int32)
    jf, tf = jax_model(cfg), get_model(tcfg)
    jl, jc, jpos = jax.jit(functools.partial(jf.prefill, cfg=cfg,
                                             Lmax=Lmax))(
        params, batch={"tokens": tok})
    _, tc, _ = tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)}, Lmax)
    mesh = _mesh(2)
    tc = sp.shard_caches(tc, mesh, tcfg.nr)
    assert [isinstance(c, sp.SPCache) for c in tc] == [
        False, False, False, True, False, False, False, True]
    step = jax.jit(functools.partial(jf.decode_step, cfg=cfg))
    pos = np.asarray(jpos).astype(np.int32)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = step(params, caches=jc, token=nxt, t=pos)
        tabs = sp.sp_tables(np.repeat(pos, tcfg.num_kv_heads), nr=tcfg.nr,
                            Lmax=Lmax, d=2, device="cpu")
        with sp.sp_scope(mesh):
            tl, tc = tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos), sp_tables=tabs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        for g, w in zip(sp.unshard_caches(tc), jc):
            if isinstance(g, SSMState):
                for a, b in zip(g, w):
                    b = np.asarray(b)
                    scale = max(float(np.abs(b).max()), 1e-30)
                    assert float(np.abs(a.numpy() - b).max()) <= \
                        STATE_TOL * scale
                continue
            assert isinstance(g, H1DCache)
            for a, b in zip([g.k, g.v, *g.ck, *g.cv], jax.tree.leaves(w)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=CACHE_ATOL)
        pos = pos + 1


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def test_sp_refusals_kept():
    """Paged serving of a sliding-window config is refused with the
    reference's text, with or without a mesh; paged with a mesh is
    refused; the encoder-decoder is refused with the reference engine's
    text; SP of a full-attention stack raises as in the reference."""
    _, _, tcfg, tparams = _smoke("gemma3-4b")
    with pytest.raises(ValueError, match="uniform h1d"):
        ServeEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN, paged=True)
    with pytest.raises(ValueError, match="paged=True or mesh="):
        ServeEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN, paged=True,
                    mesh=_mesh(2))
    ecfg = get_smoke_config("seamless-m4t-medium")
    with pytest.raises(NotImplementedError) as e:
        ServeEngine(ecfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                    mesh=_mesh(2))
    assert str(e.value) == ENCDEC_REFUSAL
    fcfg = dataclasses.replace(tcfg, attention="full")
    with pytest.raises(ValueError, match="no such cache"):
        ServeEngine(fcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                    mesh=_mesh(2))
