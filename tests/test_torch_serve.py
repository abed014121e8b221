"""Port parity of the serving engine: the ported ``ServeEngine`` gives the
JAX engine's greedy tokens on the ``h1d-lm-53m`` smoke config.

Greedy tokens are compared exactly.  So that a near-tie (two logits
closer than the 1e-4 model tolerance) fails loudly instead of flaking,
every generated token's top-2 logit margin is checked to exceed 1e-3 on
the port's teacher-forced logits."""
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
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


def test_unported_engine_options_raise(smoke):
    """Sampling is a later slice.  (Sequence-parallel serving is ported:
    ``tests/test_torch_sp.py``; a mesh over several devices is refused
    by ``SPMesh`` itself.)"""
    cfg, params, tcfg, tparams = smoke
    with pytest.raises(NotImplementedError):
        ServeEngine(tcfg, tparams, greedy=False)


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
