"""Port parity: sequence parallelism and the GPipe pipeline one shard a
process, over a gloo process group on the CPU (``parallel/group.py``).

Two worlds start once each, of 2 and 4 ranks (``_torch_ranks_worker.py``
is one rank; the ranks rendezvous through a file in the test's temporary
directory, so parallel test workers never share a port).  Each rank
bundles every check's rank side; this process computes the JAX
reference on the same numpy inputs and holds the ranks to it:

* the SP operator (causal fine-q and coarse-q, bidirectional) and
  ``sp_band_attention`` in every mode: within 2e-5 of the single-device
  JAX ``h1d_attention`` / ``band_attention``, and at d = 2 bit-identical
  to the one-process mesh on the same inputs in the same rank;
* the gradients of q, k, v and ``kv_weight`` through the operator:
  within 1e-4 of ``jax.grad`` (scaled by ``1 + max|ref|``);
* the decode tick: attend within 1e-5 of the single-device kernel in
  interpret mode, the cache after the update bit-exact;
* the smoke LM's greedy tokens: identical to the JAX engine's on every
  rank (the engine's own ``REPRO_RANK_CHECK`` also gathers every sampled
  batch), and the serving CLI's to the one-process ``--sp-data`` CLI's;
* two SP train steps through the training CLI: losses within 1e-6 of the
  one-process ``--sp --mesh N`` run's, parameters bit-identical across
  ranks;
* ``pipeline_apply`` at S = 2 and 4: within 1e-5 of the reference's
  ``pipeline_apply`` (a subprocess on fabricated host devices), its
  gradients within 1e-6 of the sequential application's;
* the backend rule, and the refusals (a DATAxMODEL or one-axis mesh
  whose size is not the world's, distinct devices in one process).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import h1d_decode as jhd  # noqa: E402
from repro.core.h1d_attention import h1d_attention as jh1d  # noqa: E402
from repro.kernels.ops import band_attention as jband  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.parallel import group as grp  # noqa: E402
from repro_torch.parallel import sp_attention as sp  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
OP_TOL = 2e-5
GRAD_TOL = 1e-4
TOL = 1e-5
LOSS_TOL = 1e-6
PIPE_TOL = 1e-5
PIPE_GRAD_TOL = 1e-6
MODES = [(True, "fine-q"), (True, "coarse-q"), (False, "fine-q")]
BAND_MODES = [("l0_bidir", 1), ("l0_causal", 1), ("coarse_bidir", 1),
              ("coarse_causal", 1), ("sub", 2)]
ARCH = "h1d-lm-53m"
PROMPT_LENS = [5, 12, 30, 9, 17, 40]
# the decode tick: test_torch_sp.py's shapes and positions
DB, DG, LMAX, DD, DNR = 6, 2, 256, 16, 16
TS = np.array([0, 15, 16, 130, 255, 256], np.int32)
# the pipeline: test_torch_pipeline.py's stage, 8 microbatches
M, BM, PD = 8, 2, 16


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / (1.0 + np.abs(want).max()))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= tol, err


def _operands(L, seed, Dh=16, pad=37):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 2, L, Dh)).astype(np.float32)
    k = rng.standard_normal((2, L, Dh)).astype(np.float32)
    v = rng.standard_normal((2, L, Dh)).astype(np.float32)
    w = np.ones((2, L), np.float32)
    w[:, -pad:] = 0.0
    cot = rng.standard_normal((2, 2, L, Dh)).astype(np.float32)
    return q, k, v, w, cot


def _decode_inputs():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((DB, LMAX, DD)).astype(np.float32),
            rng.standard_normal((DB, LMAX, DD)).astype(np.float32),
            rng.standard_normal((DB, DG, DD)).astype(np.float32),
            rng.standard_normal((DB, DD)).astype(np.float32),
            rng.standard_normal((DB, DD)).astype(np.float32))


def _pipe_inputs(S):
    rng = np.random.default_rng(S)
    return ((rng.standard_normal((S, PD, PD)) * 0.3).astype(np.float32),
            (rng.standard_normal((S, PD)) * 0.1).astype(np.float32),
            rng.standard_normal((M, BM, PD)).astype(np.float32),
            rng.standard_normal((M, BM, PD)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _smoke():
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(2), cfg)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    return cfg, params, tcfg, tparams, prompts


def _inputs(d):
    """Every rank's inputs, as torch tensors from numpy seeds."""
    t = torch.from_numpy
    _, _, tcfg, tparams, prompts = _smoke()
    op = {m: tuple(map(t, _operands(256, seed=d)[:4])) for m in MODES}
    band = {}
    for mode, ratio in BAND_MODES:
        q, k, v, w, _ = _operands(128, seed=7)
        Lk = 128 // ratio
        band[(mode, ratio)] = (t(q), t(k[:, :Lk]), t(v[:, :Lk]),
                               t(w[:, :Lk]))
    grad = {m: tuple(map(t, _operands(64, seed=64, pad=9))) for m in MODES}
    k, v, q, kn, vn = map(t, _decode_inputs())
    return dict(op=op, op_nr=16, band=band, grad=grad, grad_nr=8,
                decode=(k, v, q, kn, vn, TS), lmax=LMAX, decode_nr=DNR,
                engine=(tcfg, tparams, prompts), slots=3 if d == 2 else 1,
                pipe=tuple(map(t, _pipe_inputs(d))))


def _start(d, path):
    """Start the ``d`` ranks of a world; returns their processes."""
    os.makedirs(path, exist_ok=True)
    torch.save(_inputs(d), os.path.join(path, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    worker = os.path.join(ROOT, "tests", "_torch_ranks_worker.py")
    return [subprocess.Popen(
        [sys.executable, worker, path, str(r), str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(d)]


def _finish(procs, path):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    return dict(
        path=path, log=logs[0],
        ranks=[torch.load(os.path.join(path, f"rank{r}.pt"),
                          weights_only=False) for r in range(len(procs))])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started together; the JAX side is computed while they
    run."""
    root = tmp_path_factory.mktemp("ranks")
    procs = {d: _start(d, str(root / f"w{d}")) for d in (2, 4)}
    try:
        refs = _jax_refs()
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
        raise
    out = {d: _finish(ps, str(root / f"w{d}")) for d, ps in procs.items()}
    out["refs"] = refs
    return out


def _jax_refs():
    refs = {}
    for d in (2, 4):
        q, k, v, w, _ = _operands(256, seed=d)
        for causal, cm in MODES:
            refs[("op", d, (causal, cm))] = np.asarray(jh1d(
                q, k, v, nr=16, causal=causal, causal_mode=cm, kv_weight=w))
    q, k, v, w, _ = _operands(128, seed=7)
    for mode, ratio in BAND_MODES:
        Lk = 128 // ratio
        refs[("band", (mode, ratio))] = [np.asarray(a) for a in jband(
            q, k[:, :Lk], v[:, :Lk], w[:, :Lk], nr=16, mode=mode,
            ratio=ratio)]
    q, k, v, w, cot = _operands(64, seed=64, pad=9)
    for causal, cm in MODES:
        kw = dict(nr=8, causal=causal, causal_mode=cm)
        refs[("grad", (causal, cm))] = jax.jit(jax.grad(
            lambda *a, kw=kw: (jh1d(*a[:3], kv_weight=a[3], **kw)
                               * cot).sum(), argnums=(0, 1, 2, 3)))(
            q, k, v, w)
    k, v, q, kn, vn = _decode_inputs()
    jc = jax.jit(functools.partial(jhd.prefill_cache, Lmax=LMAX, nr=DNR))(
        k, v)
    refs["attend"] = np.asarray(jhd.decode_attend(
        jc, q, TS, nr=DNR, impl="pallas_interpret"))
    refs["updated"] = [np.asarray(a) for a in jax.tree.leaves(
        jhd.update_cache(jc, kn, vn, TS, impl="pallas_interpret"))]
    cfg, params, *_, prompts = _smoke()
    for slots in (3, 1):
        eng = JaxEngine(cfg, params, slots=slots, max_len=64)
        reqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        refs[("tokens", slots)] = [list(r.out_tokens) for r in reqs]
    return refs


# ---------------------------------------------------------------------------
# the backend rule and the refusals (no world needed)
# ---------------------------------------------------------------------------

def test_backend_rule(monkeypatch):
    assert grp.BACKENDS == {"own": "nccl", "shared": "gloo", "cpu": "gloo"}
    dev, where = grp.placement("cpu", 3)
    assert (dev, where, grp.BACKENDS[where]) == (torch.device("cpu"), "cpu",
                                                 "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert grp.placement(None, 1) == (torch.device("cuda", 1), "own")
    assert grp.placement("cuda", 0) == (torch.device("cuda", 0), "own")
    assert grp.placement("cuda:0", 1) == (torch.device("cuda", 0), "shared")
    with pytest.raises(ValueError, match="cuda:N"):
        grp.placement(None, 2)          # a third rank on two cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grp.placement(None, 0)


def test_one_process_mesh_refuses_distinct_devices():
    with pytest.raises(NotImplementedError, match="one shard a process"):
        sp.SPMesh("data", (torch.device("cpu"), torch.device("meta")))
    assert grp.current() is None and not grp.launched()


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
def test_world_backend_printed(worlds, d):
    w = worlds[d]
    assert all((r["backend"], r["placement"]) == ("gloo", "cpu")
               for r in w["ranks"])
    assert (f"[ranks] {d} ranks on {', '.join(['cpu'] * d)}: backend gloo "
            f"(the ranks run on the CPU)") in w["log"]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_sp_operator_matches_jax(worlds, d, mode):
    """Every rank returns the whole output (gathered), within 2e-5 of
    the single-device reference; at d = 2 bit-identical to the
    one-process mesh, and equal to the scoped ``h1d_attention``."""
    want = worlds["refs"][("op", d, mode)]
    for r in worlds[d]["ranks"]:
        _close(r[("op", mode)].numpy(), want, OP_TOL)
        assert r[("op_scoped", mode)]
        if d == 2:
            assert r[("op_same", mode)]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", BAND_MODES)
def test_sp_band_attention_matches_jax(worlds, d, mode):
    want = worlds["refs"][("band", mode)]
    for r in worlds[d]["ranks"]:
        for g, x in zip(r[("band", mode)], want):
            _close(g.numpy(), x, OP_TOL)
        if d == 2:
            assert r[("band_same", mode)]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_sp_operator_grads_match_jax(worlds, d, mode):
    """L 64, nr 8: at d = 4 a level takes the gathered deep path, whose
    backward sums the coarse KV's gradient over ranks (rule 3 of
    ``parallel/group.py``); every rank holds the whole gradient of q, k,
    v and the key weights (rule 1)."""
    want = worlds["refs"][("grad", mode)]
    for r in worlds[d]["ranks"]:
        for name, g, x in zip("qkvw", r[("grad", mode)], want):
            assert _rel(g, x) <= GRAD_TOL, (name, _rel(g, x))
        assert r[("grad_gap", mode)] <= TOL


@pytest.mark.parametrize("d", [2, 4])
def test_sp_decode_tick_matches_jax(worlds, d):
    """Attend within 1e-5 of the single-device kernel, the cache after
    the update (all-gathered) bit-exact; each rank ran #11 and #12 once
    on its own slab, and #6 on its copy of the deep levels."""
    refs = worlds["refs"]
    for r in worlds[d]["ranks"]:
        _close(r["attend"].numpy(), refs["attend"], TOL)
        for a, b in zip(r["updated"], refs["updated"]):
            np.testing.assert_array_equal(a.numpy(), b)
        calls = r["decode_calls"]
        assert calls["decode_attend_partial"] == 1
        assert calls["update_cache_partial"] == 1
        assert calls["update_cache_fused"] == int(
            sp.sp_sharded_levels(LMAX, DNR, d) < 4)
        assert calls["decode_attend_fused"] == 0


@pytest.mark.parametrize("d", [2, 4])
def test_sp_engine_tokens_match_jax(worlds, d):
    slots = 3 if d == 2 else 1
    want = worlds["refs"][("tokens", slots)]
    for r in worlds[d]["ranks"]:
        assert r["tokens"] == want
        assert r["engine_calls"]["decode_attend_partial"] > 0
        assert r["engine_calls"]["decode_attend_fused"] == 0
        assert r["engine_dispatches"]["h1d_attention"] > 0


def _cli_report(w, kind, rank):
    with open(os.path.join(w["path"], f"cli.{kind}.{rank}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("d", [2, 4])
def test_serve_cli_on_ranks(worlds, d):
    """The serving CLI's tokens on every rank equal the one-process
    ``--sp-data`` CLI's; each rank's report counts its partial launches
    (plain versions here) and its collectives."""
    w = worlds[d]
    reqs = serve_cli.main(["--smoke", "--device", "cpu", "--sp-data", str(d),
                           "--requests", "3", "--slots", "2", "--new-tokens",
                           "4", "--max-len", "64"])
    want = [list(r.out_tokens) for r in reqs]
    assert len(want) == 3 and all(len(t) == 4 for t in want)
    for rank in range(d):
        rep = _cli_report(w, "serve", rank)
        assert (rep["rank"], rep["world"], rep["backend"]) == (rank, d,
                                                               "gloo")
        assert rep["tokens"] == want
        assert rep["launches"]["plain:decode_attend_partial"] > 0
        assert rep["collectives"]["calls"]["pmax"] > 0
        assert rep["collectives"]["calls"]["psum"] > 0
        assert len(rep["steps"]) > 0
        assert all(s["comm_ms"] <= s["ms"] for s in rep["steps"])


@pytest.mark.parametrize("d", [2, 4])
def test_train_cli_on_ranks(worlds, d, tmp_path, monkeypatch):
    """Two SP steps on every rank: losses within 1e-6 of the one-process
    ``--sp --mesh d`` CLI's, parameters bit-identical across ranks."""
    seen = {}

    def spy(*a, **kw):
        state, metrics = train(*a, **kw)
        seen.update(metrics)
        return state, metrics
    train = train_cli.train
    monkeypatch.setattr(train_cli, "train", spy)
    train_cli.main(["--smoke", "--device", "cpu", "--sp", "--mesh", str(d),
                    "--steps", "2", "--ckpt-dir", str(tmp_path)])
    want = [h["loss"] for h in seen["history"]]
    reps = [_cli_report(worlds[d], "train", r) for r in range(d)]
    assert len(want) == 2
    for rep in reps:
        got = [h["loss"] for h in rep["history"]]
        assert np.abs(np.subtract(got, want)).max() <= LOSS_TOL, (got, want)
        assert rep["params"] == reps[0]["params"]
        assert rep["launches"]["plain:band_attention_bwd"] > 0


REF_PIPELINE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.launch.mesh import use_mesh
    from repro.parallel import pipeline_apply

    def stage_fn(params, h):
        W, b = params
        return jax.numpy.tanh(h @ W + b)

    for S in (2, 4):
        d = np.load(sys.argv[1] + f"/in{S}.npz")
        mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))
        with use_mesh(mesh):
            out = pipeline_apply(stage_fn, (d["Ws"], d["bs"]), d["x"],
                                 mesh=mesh, axis="stage")
        np.save(sys.argv[1] + f"/out{S}.npy", np.asarray(out))
""")


@pytest.fixture(scope="module")
def ref_pipeline(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipe")
    for S in (2, 4):
        Ws, bs, x, _ = _pipe_inputs(S)
        np.savez(path / f"in{S}.npz", Ws=Ws, bs=bs, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_PIPELINE, str(path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return {S: np.load(path / f"out{S}.npy") for S in (2, 4)}


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_on_ranks(worlds, ref_pipeline, S):
    """Rank s holds stage s: outputs within 1e-5 of the reference's
    ``pipeline_apply`` on every rank; x's gradient whole on every rank
    and stage s's in row s on rank s, within 1e-6 of the sequential
    application's."""
    Ws, bs, x, cot = (torch.from_numpy(a) for a in _pipe_inputs(S))
    leaves = [t.clone().requires_grad_(True) for t in (Ws, bs, x)]
    h = leaves[2]
    for s in range(S):
        h = torch.tanh(h @ leaves[0][s] + leaves[1][s])
    (h * cot).sum().backward()
    for s, r in enumerate(worlds[S]["ranks"]):
        assert float(np.abs(r["pipe"].numpy() - ref_pipeline[S]).max()) \
            <= PIPE_TOL
        assert float((r["pipe"] - h.detach()).abs().max()) <= PIPE_TOL
        gW, gb, gx = r["pipe_grads"]
        assert float((gx - leaves[2].grad).abs().max()) <= PIPE_GRAD_TOL
        for got, want in ((gW, leaves[0].grad), (gb, leaves[1].grad)):
            assert float((got[s] - want[s]).abs().max()) <= PIPE_GRAD_TOL
            others = [o for o in range(S) if o != s]
            assert not got[others].any()


@pytest.mark.parametrize("d", [2, 4])
def test_rank_refusals(worlds, d):
    """Inside a group: a DATAxMODEL mesh or a one-axis mesh of another
    size than the world raises ValueError."""
    for r in worlds[d]["ranks"]:
        a, b = r["refusals"]
        assert "DATAxMODEL" in a
        assert f"in a group of {d} ranks" in b
