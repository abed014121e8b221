"""Port parity of the serving engine: the ported ``ServeEngine`` gives the
JAX engine's greedy tokens on the ``h1d-lm-53m`` smoke config, in the
fine-q and the coarse-q mode, on dense slots, the paged pool and
sequence-parallel shards, and its sampled tokens when it is handed the
reference's own Gumbel draws.

Tokens are compared exactly.  So that a near-tie (two logits closer than
the 1e-4 model tolerance) fails loudly instead of flaking, every
generated token's top-2 margin is checked to exceed 1e-3 on the port's
teacher-forced logits (plus the noise, where the engine samples)."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.parallel import sp_attention as sp  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402

ARCH = "h1d-lm-53m"
MARGIN = 1e-3
PROMPT_LENS = [5, 12, 30, 9, 17, 40]


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(2), cfg)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, make_req, prompts, n_new, **kw):
    reqs = [make_req(uid=i, prompt=p, max_new_tokens=n_new, **kw)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [list(r.out_tokens) for r in reqs]


def _check_margins(tcfg, tparams, prompts, outs):
    fwd = get_model(tcfg).forward
    for p, out in zip(prompts, outs):
        seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
        logits, _ = fwd(tparams, tcfg, torch.from_numpy(seq[None]).long())
        lg = logits[0, len(p) - 1:]
        top2 = lg.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > MARGIN, (
            f"near-tie (top-2 margin {margin:.2e}): greedy equality would "
            f"be luck; change the seed")
        assert lg.argmax(-1).tolist() == out


@pytest.mark.parametrize("slots,chunk", [(2, None), (3, 8)])
def test_engine_greedy_tokens_match_jax(smoke, slots, chunk):
    """Mixed prompt lengths (one shorter than nr, several buckets, more
    requests than slots); with ``prefill_chunk`` the long prompts stream
    their tail through the decode ticks."""
    cfg, params, tcfg, tparams = smoke
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxEngine(cfg, params, slots=slots, max_len=64,
                            prefill_chunk=chunk),
                  JaxRequest, prompts, 6)
    got = _serve(ServeEngine(tcfg, tparams, slots=slots, max_len=64,
                             prefill_chunk=chunk),
                 Request, prompts, 6)
    assert got == want
    _check_margins(tcfg, tparams, prompts, got)


def test_stop_tokens_cap_and_cache_full(smoke):
    cfg, params, tcfg, tparams = smoke
    prompts = _prompts(cfg.vocab_size, seed=1)[:3]
    free = _serve(ServeEngine(tcfg, tparams, slots=2, max_len=64), Request,
                  prompts, 5)
    stop = free[1][2]
    got = _serve(ServeEngine(tcfg, tparams, slots=2, max_len=64), Request,
                 prompts, 5, stop_tokens=[stop])
    for f, g in zip(free, got):
        cut = f.index(stop) + 1 if stop in f else len(f)
        assert g == f[:cut]
    assert [len(o) for o in _serve(
        ServeEngine(tcfg, tparams, slots=2, max_len=64), Request, prompts,
        1)] == [1, 1, 1]
    # a 60-token prompt in a 64-row cache stops when the cache is full
    long = np.arange(60, dtype=np.int32) % cfg.vocab_size
    out = _serve(ServeEngine(tcfg, tparams, slots=1, max_len=64), Request,
                 [long], 50)
    assert len(out[0]) == 64 - 1 - 60 + 1


def test_overflow_policy_and_frozen_idle_slots(smoke):
    cfg, params, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, slots=3, max_len=32)
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.zeros(40, np.int32)))
    eng = ServeEngine(tcfg, tparams, slots=3, max_len=32,
                      overflow="truncate")
    r = Request(uid=0, prompt=np.arange(40, dtype=np.int32),
                max_new_tokens=3)
    eng.submit(r)
    eng.run()
    assert len(r.out_tokens) == 1          # 31 prompt rows: cache full
    assert eng.pos_host.tolist() == eng.pos.tolist()
    assert eng.pos_host.max() <= 31        # idle slots stayed frozen


def test_sampling_engine_serves(smoke):
    """``greedy=False`` with a seed constructs and serves every request
    to its cap with in-vocabulary tokens, a second engine of the same
    seed gives the same tokens and another seed other tokens."""
    cfg, params, tcfg, tparams = smoke
    prompts = _prompts(cfg.vocab_size)

    def sample(seed):
        eng = ServeEngine(tcfg, tparams, slots=2, max_len=64, greedy=False,
                          seed=seed)
        assert (eng.greedy, eng.seed) == (False, seed)
        out = _serve(eng, Request, prompts, 5)
        assert not eng._streams            # every stream was released
        return out
    a = sample(5)
    assert [len(o) for o in a] == [5] * len(prompts)
    assert all(0 <= t < cfg.vocab_size for o in a for t in o)
    assert sample(5) == a
    assert sample(6) != a


@pytest.mark.parametrize("kw,match", [
    (dict(cache_dtype="int8"), "requires paged=True"),
    (dict(paged=True, preempt_mode="evict"), "unknown preempt_mode"),
    (dict(paged=True, mesh=SimpleNamespace(shape={"data": 1})),
     "host-local"),
    (dict(paged=True, cache_dtype="bf16"), "unknown cache_dtype")])
def test_paged_option_validation_matches_reference(smoke, kw, match):
    """The paged options fail with the reference engine's ValueErrors."""
    cfg, params, tcfg, tparams = smoke
    for engine, p, c in ((JaxEngine, params, cfg),
                         (ServeEngine, tparams, tcfg)):
        with pytest.raises(ValueError, match=match):
            engine(c, p, slots=2, max_len=64, **kw)


@pytest.mark.parametrize("budget,lookahead,chunk", [
    (None, 0, None), (12, 2, 4), (6, 0, 8)])
def test_scheduler_copy_plans_like_reference(budget, lookahead, chunk):
    rng = np.random.default_rng(budget or 0)
    queue = [np.zeros(int(n), np.int32) for n in rng.integers(1, 20, 9)]
    plans = []
    for mod in (jsched, tsched):
        s = mod.ContinuousBatchingScheduler(
            token_budget=budget, lookahead=lookahead, prefill_chunk=chunk)
        q = [mod.QueueEntry(req=i, prompt=p) for i, p in enumerate(queue)]
        groups, rest = s.plan(q, 4, 1, lambda n: 1 << max(n - 1, 0)
                              .bit_length(), lambda e: e.req != 3)
        plans.append(([([e.req for e in g.entries], g.bucket)
                       for g in groups], [e.req for e in rest]))
    assert plans[0] == plans[1]


# ---------------------------------------------------------------------------
# coarse-q serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coarse(smoke):
    """The smoke weights under ``causal_mode='coarse-q'`` on both sides."""
    cfg, params, tcfg, tparams = smoke
    return (dataclasses.replace(cfg, causal_mode="coarse-q"), params,
            dataclasses.replace(tcfg, causal_mode="coarse-q"), tparams)


def _replay(tcfg, tparams, prompt, out, chunk=None):
    """The logits the engine took each generated token from, replayed on
    one row: prefill of the prompt (its first ``chunk`` tokens, the rest
    fed through decode steps as chunked prefill does), then one decode
    step per generated token but the last."""
    fns = get_model(tcfg)
    n0 = len(prompt) if chunk is None else min(chunk, len(prompt))
    seq = np.concatenate([prompt, np.asarray(out[:-1], np.int32)])
    tok = torch.from_numpy(seq[None]).long()
    with torch.inference_mode():
        lg, caches, pos = fns.prefill(tparams, tcfg, {"tokens": tok[:, :n0]},
                                      64)
        steps = [lg]
        for i in range(n0, len(seq)):
            lg, caches = fns.decode_step(tparams, tcfg, caches, tok[:, i], pos)
            pos = pos + 1
            steps.append(lg)
    return torch.cat(steps)[len(prompt) - n0:]


@pytest.mark.parametrize("kw", [dict(slots=2), dict(slots=3, prefill_chunk=8),
                                dict(slots=2, paged=True)],
                         ids=["dense", "chunked", "paged"])
def test_coarse_q_engine_tokens_match_jax(coarse, kw):
    """The JAX engine serves coarse-q on dense slots and the paged pool
    alike (unbucketed prompts, coarse-q prefill, fine-q decode); the
    port's tokens equal its, and each is the argmax of the replayed
    logits by more than the margin."""
    cfg, params, tcfg, tparams = coarse
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxEngine(cfg, params, max_len=64, **kw), JaxRequest,
                  prompts, 6)
    eng = ServeEngine(tcfg, tparams, max_len=64, **kw)
    assert eng._bucket_len(5) == 5
    got = _serve(eng, Request, prompts, 6)
    assert got == want
    for p, out in zip(prompts, got):
        lg = _replay(tcfg, tparams, p, out, kw.get("prefill_chunk"))
        top2 = lg.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
        assert lg.argmax(-1).tolist() == out


def test_sp_coarse_q_engine_tokens_match_jax(coarse):
    """A 2-way sequence-parallel engine on a coarse-q config gives the
    JAX engine's tokens (the reference's SP engine serves it as its
    single-device engine does); its long prompts prefill sharded."""
    cfg, params, tcfg, tparams = coarse
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxEngine(cfg, params, slots=3, max_len=64), JaxRequest,
                  prompts, 6)
    sp.DISPATCHES.clear()
    got = _serve(ServeEngine(tcfg, tparams, slots=3, max_len=64,
                             mesh=make_mesh((2,), ("data",), device="cpu")),
                 Request, prompts, 6)
    assert got == want
    assert sp.DISPATCHES["h1d_attention"] > 0
    assert sp.DISPATCHES["decode_attend"] > 0
    for p, out in zip(prompts, got):
        top2 = _replay(tcfg, tparams, p, out).topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


# ---------------------------------------------------------------------------
# sampled decoding
# ---------------------------------------------------------------------------

def _jax_noise(eng, seed, margins):
    """Hand ``eng`` the reference engine's Gumbel draws: one split of the
    key per prefill call and per tick, per-row keys folded in by
    destination row at prefill (``repro/serve/engine.py``'s
    ``_admit_group`` and ``_step``); and record the top-2 margin of
    ``logits + noise`` of every sampled row."""
    key = [jax.random.PRNGKey(seed)]
    drawn = {}

    def noise(rows, reqs, vocab, tick):
        key[0], k = jax.random.split(key[0])
        if tick:
            g = jax.random.gumbel(k, (len(rows), vocab))
        else:
            keys = jax.vmap(jax.random.fold_in, (None, 0))(
                k, jnp.asarray(rows, jnp.int32))
            g = jax.vmap(lambda r: jax.random.gumbel(r, (vocab,)))(keys)
        drawn["g"] = torch.from_numpy(np.array(g))
        return drawn["g"]

    sample = eng._sample

    def guarded(logits, rows, reqs, tick):
        out = sample(logits, rows, reqs, tick)
        top2 = (logits.float() + drawn["g"]).topk(2, dim=-1).values
        margins.extend(float(top2[i, 0] - top2[i, 1])
                       for i, r in enumerate(reqs) if r is not None)
        return out

    eng._noise, eng._sample = noise, guarded
    return eng


@pytest.mark.parametrize("kw", [
    dict(slots=2), dict(slots=3, prefill_chunk=8), dict(slots=2, paged=True),
    dict(slots=3, mesh=2), dict(slots=2, coarse=True)],
    ids=["dense", "chunked", "paged", "sp", "coarse-q"])
def test_sampled_tokens_match_jax_through_noise_hook(smoke, coarse, kw):
    """``greedy=False, seed=3`` against the JAX engine of the same seed,
    the port's noise replaced by the reference's draws: identical
    tokens, each sampled by more than the margin."""
    kw = dict(kw)
    cfg, params, tcfg, tparams = coarse if kw.pop("coarse", 0) else smoke
    d = kw.pop("mesh", 1)
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxEngine(cfg, params, max_len=64, greedy=False, seed=3,
                            **kw), JaxRequest, prompts, 6)
    mesh = make_mesh((d,), ("data",), device="cpu") if d > 1 else None
    margins = []
    eng = _jax_noise(ServeEngine(tcfg, tparams, max_len=64, greedy=False,
                                 seed=3, mesh=mesh, **kw), 3, margins)
    assert _serve(eng, Request, prompts, 6) == want
    assert len(margins) == 6 * len(prompts)
    assert min(margins) > MARGIN
    greedy = _serve(JaxEngine(cfg, params, max_len=64, **kw), JaxRequest,
                    prompts, 6)
    assert greedy != want


def test_port_sampling_is_deterministic_and_invariant(smoke):
    """The port's own noise: the same seed gives the same tokens, and a
    request's tokens do not depend on the slot count, on the requests
    batched with it (its bucket's pad rows), on serving it alone, or on
    the paged pool."""
    cfg, params, tcfg, tparams = smoke
    prompts = _prompts(cfg.vocab_size)

    def sample(**kw):
        return _serve(ServeEngine(tcfg, tparams, max_len=64, greedy=False,
                                  seed=9, **kw), Request, prompts, 6)
    ref = sample(slots=2)
    assert sample(slots=2) == ref
    assert sample(slots=1) == ref
    assert sample(slots=3) == ref
    assert sample(slots=8) == ref
    assert sample(slots=2, paged=True) == ref
    for i, p in enumerate(prompts):
        eng = ServeEngine(tcfg, tparams, max_len=64, slots=4, greedy=False,
                          seed=9)
        r = Request(uid=i, prompt=p, max_new_tokens=6)
        eng.submit(r)
        eng.run()
        assert r.out_tokens == ref[i]
