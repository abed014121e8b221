"""Port parity: training over a ``DATAxMODEL`` mesh, one shard a
process, over gloo process groups on the CPU (``parallel/tensor.py``).

Four worlds start once each and run side by side: 1x2, 2x1 and 2x2 on
the ``h1d-lm-53m`` smoke config (4 heads, 4 kv heads, d_ff 128, a vocab
of 512: every leaf splits over M = 2), and a GQA variant (4 q heads over
2 kv heads) at 1x4, whose ``wkv`` stays whole (2 kv heads over 4 ranks)
and whose ranks each take the one kv head their q head reads.
``_torch_tp_worker.py`` is one rank; the ranks rendezvous through a file
in the test's temporary directory.  This process computes the JAX
reference and the one-process runs meanwhile, and holds the ranks to
them:

* the first step's loss within 2e-5 of the JAX ``make_train_step`` on
  the same numpy weights and batch (whose ``loss_mask`` differs by data
  slice, so an average of per-rank means would miss), and the gathered
  gradients within 1e-4 of each leaf's largest JAX entry; their global
  norm and int8 compression on the shards equal to the whole leaves';
* three steps through the training CLI (``train.loop.train`` for the
  GQA config) within 1e-4 relative of the one-process run's losses, the
  gathered parameters bit-identical on every rank;
* checkpoints move across meshes: every world restores the one-process
  run's step-2 checkpoint and the 1x2 and 2x2 worlds each other's, and
  this process restores every world's on the 1x1 mesh, each third step
  within 1e-4 relative of the one-process run's;
* the fused ``wkv`` split in contiguous column blocks instead of by head
  misses the reference's loss;
* on the 2x1 world, the other families over the data axis alone (the
  MoE decoder, whose load-balancing loss couples the batch's rows, and
  the encoder-decoder, whose loss is a mean): loss, metrics and summed
  gradients against one process on the same weights and batch;
* the collectives by axis, and the refusals (``--sp`` with a model
  axis, a microbatch the data axis does not divide, the families tensor
  parallelism does not run, a mesh of another size than the world, a
  two-axis mesh outside a group).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import ZipfLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_model, transformer  # noqa: E402
from repro_torch.models.encdec import stub_frames  # noqa: E402
from repro_torch.optim import (global_norm, init_error_feedback,  # noqa: E402
                               int8_compress)
from repro_torch.parallel import group as grp  # noqa: E402
from repro_torch.parallel import tensor  # noqa: E402
from repro_torch.parallel.sharding import shard_params  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "h1d-lm-53m"
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-4
B, S = 4, 128
WORLDS = {"1x2": "smoke", "2x1": "smoke", "2x2": "smoke", "1x4": "gqa"}
# each CLI world restores another's checkpoint: 1x2 and 2x2 both ways
OTHER = {"1x2": "2x2", "2x2": "1x2"}
# the other families the 2x1 world trains over its data axis
FAMILIES = {"moe": "qwen2-moe-a2.7b", "encdec": "seamless-m4t-medium"}


def _configs(kind):
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    if kind == "gqa":
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=2,
                                   name=f"{tcfg.name}-gqa")
    return jcfg, tcfg


def _batch():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, :40] = 0.0           # the data slices hold different counts
    mask[3, 58:] = 0.0
    return {"tokens": tokens, "loss_mask": mask}


@functools.lru_cache(maxsize=None)
def _weights(kind):
    jcfg, tcfg = _configs(kind)
    jtc = jloop.TrainConfig(attn_impl="jnp", total_steps=3, warmup=10,
                            ckpt_every=0)
    jstate, _ = jloop.init_state(jax.random.PRNGKey(5), jcfg, jtc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                              device="cpu")
    return jcfg, jtc, jstate, tcfg, tparams


def _jax_ref(kind):
    """The first step's loss (``make_train_step``) and gradients."""
    jcfg, jtc, jstate, tcfg, _ = _weights(kind)
    batch = jax.tree.map(jnp.asarray, _batch())
    _, m = jax.jit(jloop.make_train_step(jcfg, jtc))(jstate, batch)
    cfg = jloop.resolve_model_config(jcfg, jtc)
    from repro.models import get_model as jax_model
    g = jax.jit(jax.grad(lambda p: jax_model(cfg).loss(p, cfg, batch)[0]))(
        jstate.params)
    return float(m["loss"]), params_from_jax(jax.tree.map(np.asarray, g),
                                             tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _family_job(kind):
    """(config, weights from the port's init, batch) of a FAMILIES
    job: rows whose loss masks (frame weights) differ."""
    cfg = get_smoke_config(FAMILIES[kind])
    params = get_model(cfg).init(cfg, seed=11, device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 32))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    if kind == "encdec":
        frames, fw = stub_frames(cfg, B, 48, seed=6, true_len=(48, 30, 41, 17))
        batch.update(frames=torch.from_numpy(frames),
                     frame_weight=torch.from_numpy(fw))
    else:
        mask = torch.ones(tokens.shape)
        mask[1, :20] = 0.0
        batch["loss_mask"] = mask
    return cfg, params, batch


def _one_process(kind):
    """(loss, metrics, gradients) of a FAMILIES job in this process."""
    cfg, params, batch = _family_job(kind)
    loss, metrics, grads = loop.loss_and_grads(get_model(cfg), cfg, params,
                                               batch)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _cli(mesh, *argv):
    seen = {}

    def spy(*a, **kw):
        state, metrics = train(*a, **kw)
        seen.update(metrics)
        return state, metrics
    train = train_cli.train
    train_cli.train = spy
    try:
        train_cli.main(["--smoke", "--device", "cpu", "--mesh", mesh,
                        "--batch", str(B), "--seq", str(S)] + list(argv))
    finally:
        train_cli.train = train
    return [h["loss"] for h in seen["history"]]


def _start(mesh, kind, path, root):
    os.makedirs(path, exist_ok=True)
    _, tcfg = _configs(kind)
    job = dict(mesh=mesh, cfg=tcfg, params=_weights(kind)[4],
               batch={k: torch.from_numpy(v) for k, v in _batch().items()},
               B=B, S=S, cli=kind == "smoke",
               ckpt_out=os.path.join(root, f"ck_{mesh}"),
               ckpt_one=os.path.join(root, "ck_one"),
               ckpt_other=(os.path.join(root, f"ck_{OTHER[mesh]}")
                           if mesh in OTHER else None),
               families=({k: _family_job(k) for k in FAMILIES}
                         if mesh == "2x1" else {}))
    torch.save(job, os.path.join(path, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    worker = os.path.join(ROOT, "tests", "_torch_tp_worker.py")
    n = int(mesh[0]) * int(mesh[2])
    return [subprocess.Popen([sys.executable, worker, path, str(r), str(n)],
                             env=env, cwd=path, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _finish(procs, path):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    return dict(path=path, ranks=[torch.load(
        os.path.join(path, f"rank{r}.pt"), weights_only=False)
        for r in range(len(procs))])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The one-process run's step-2 checkpoint first, then every world
    at once; the references are computed while they run."""
    root = str(tmp_path_factory.mktemp("tp"))
    _cli("1", "--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
         os.path.join(root, "ck_one"))
    procs = {m: _start(m, k, os.path.join(root, f"w{m}"), root)
             for m, k in WORLDS.items()}
    try:
        refs = {k: _jax_ref(k) for k in ("smoke", "gqa")}
        refs["steps"] = _cli("1", "--steps", "3", "--ckpt-dir",
                             os.path.join(root, "ck_none"))
        _, tcfg = _configs("gqa")
        data = ZipfLM(vocab_size=tcfg.vocab_size, seq_len=S,
                      batch_per_host=B, seed=0)
        tc = TrainConfig(total_steps=3, warmup=10, ckpt_every=0,
                         ckpt_dir=os.path.join(root, "ck_gqa"))
        _, m = loop.train(tcfg, tc, data, 3, device="cpu",
                          log=lambda *a: None)
        refs["gqa_steps"] = [h["loss"] for h in m["history"]]
        refs["families"] = {k: _one_process(k) for k in FAMILIES}
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
        raise
    out = {m: _finish(ps, os.path.join(root, f"w{m}"))
           for m, ps in procs.items()}
    out["refs"], out["root"] = refs, root
    return out


def _report(w, name, rank):
    with open(os.path.join(w["path"], f"cli.{name}.{rank}.json")) as f:
        return json.load(f)


def _rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= rtol * np.abs(want)).all(), (got, want)


# ---------------------------------------------------------------------------
# the worlds against the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(WORLDS))
def test_first_step_loss_matches_jax(worlds, mesh):
    want = worlds["refs"][WORLDS[mesh]][0]
    for r in worlds[mesh]["ranks"]:
        assert abs(r["loss"] - want) <= LOSS_TOL, (r["loss"], want)


@pytest.mark.parametrize("mesh", list(WORLDS))
def test_gathered_grads_match_jax(worlds, mesh):
    """Every leaf, gathered from the shards and summed over the data
    axis, within 1e-4 of its largest JAX entry, on every rank."""
    want = dict(tree_flatten_with_paths(worlds["refs"][WORLDS[mesh]][1]))
    for r in worlds[mesh]["ranks"]:
        got = tree_flatten_with_paths(r["grads"])
        assert [p for p, _ in got] == list(want)
        for path, g in got:
            w = want[path].numpy()
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), (path, err)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_gradient_buckets_give_the_same_sum(worlds, mesh):
    """The data axis' gradient sum in buckets of 3000 entries (the
    smoke's larger leaves each reduced alone, in place) equals the one
    bucket's bit for bit."""
    for r in worlds[mesh]["ranks"]:
        assert r["buckets_equal"]


@pytest.mark.parametrize("mesh", list(WORLDS))
def test_norm_and_int8_on_shards_are_the_whole_leaves(worlds, mesh):
    """On the shards, the clip's global norm is the whole tree's (the
    split leaves' squares summed over the model axis, the replicated
    ones counted once) and the int8 compressor takes each split leaf's
    whole scale: its gathered output equals one process's compression
    of the gathered gradients bit for bit."""
    for r in worlds[mesh]["ranks"]:
        want = float(global_norm(r["grads"]))
        assert abs(r["norm"] - want) <= 1e-6 * want
        whole, _ = int8_compress(r["grads"],
                                 init_error_feedback(r["grads"]))
        for (path, a), (_, b) in zip(tree_flatten_with_paths(r["int8"]),
                                     tree_flatten_with_paths(whole)):
            assert torch.equal(a, b), path


@pytest.mark.parametrize("mesh", list(WORLDS))
def test_shards_are_the_specs(worlds, mesh):
    """Each rank holds 1/M of every split leaf (the smoke's every weight
    matrix and the embedding; at 1x4 the GQA's wkv whole)."""
    D, M = int(mesh[0]), int(mesh[2])
    _, tcfg = _configs(WORLDS[mesh])
    whole = [tuple(t.shape) for _, t in tree_flatten_with_paths(
        _weights(WORLDS[mesh])[4])]
    specs = _specs(tcfg, M)
    for r in worlds[mesh]["ranks"]:
        assert r["coords"] in {(d, m) for d in range(D) for m in range(M)}
        for shape, full, spec in zip(r["shapes"], whole, specs):
            want = tuple(n // M if ax == "model" else n
                         for n, ax in zip(full, spec))
            assert shape == want
    if WORLDS[mesh] == "gqa":
        wkv = [s for p, s in zip(_paths(tcfg), specs) if "wkv" in p]
        assert wkv and all(s == (None, None) for s in wkv)


def _specs(cfg, M):
    return loop.param_specs(cfg, tensor.RankMesh((1, M), torch.device("cpu")))


def _paths(cfg):
    return [p for p, _ in tree_flatten_with_paths(
        transformer.lm_init(cfg, device="meta"))]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_contiguous_wkv_split_misses_the_reference(worlds, mesh):
    """A contiguous split of wkv's 2 hkv hd columns gives rank 0 all of k
    and rank 1 all of v: its loss leaves the check by far."""
    want = worlds["refs"]["smoke"][0]
    for r in worlds[mesh]["ranks"]:
        assert abs(r["contig_loss"] - want) > 100 * LOSS_TOL


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_data_axis_families_match_one_process(worlds, kind):
    """On 2x1, the MoE decoder and the encoder-decoder: the loss and the
    metrics reported (the whole batch's nll, the MoE aux loss over every
    rank's rows) within 2e-5 of one process, the gradients summed over
    the data axis within 1e-4 of each leaf's largest, on both ranks.  A
    rank's own aux or a mean over its own rows, summed over the axis,
    would count them twice."""
    want_loss, want_metrics, want_grads = worlds["refs"]["families"][kind]
    want = dict(tree_flatten_with_paths(want_grads))
    for r in worlds["2x1"]["ranks"]:
        got = r["families"][kind]
        assert abs(got["loss"] - want_loss) <= LOSS_TOL, (got, want_loss)
        assert set(got["metrics"]) == set(want_metrics)
        for k, v in want_metrics.items():
            assert abs(got["metrics"][k] - v) <= LOSS_TOL * max(1.0, abs(v)), k
        flat = tree_flatten_with_paths(got["grads"])
        assert [p for p, _ in flat] == list(want)
        for path, g in flat:
            w = want[path].numpy()
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), (path, err)


# ---------------------------------------------------------------------------
# three steps and the checkpoints against the one-process runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(WORLDS))
def test_three_steps_match_one_process(worlds, mesh):
    """Losses within 1e-4 relative of the one-process run; the gathered
    parameters bit-identical on every rank (the data ranks end each step
    with the same shards)."""
    w = worlds[mesh]
    if WORLDS[mesh] == "gqa":
        for r in w["ranks"]:
            _rel_close(r["losses"], worlds["refs"]["gqa_steps"], STEP_RTOL)
        return
    reps = [_report(w, "steps", r) for r in range(len(w["ranks"]))]
    for rep in reps:
        _rel_close([h["loss"] for h in rep["history"]],
                   worlds["refs"]["steps"], STEP_RTOL)
        assert rep["params"] == reps[0]["params"]


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
def test_checkpoints_move_across_meshes(worlds, mesh):
    """The one-process run's checkpoint resumes on the world (and the
    1x2 and 2x2 worlds' on each other); the world's own resumes on the
    1x1 mesh here: each third step within 1e-4 relative of the
    one-process run's."""
    w, third = worlds[mesh], worlds["refs"]["steps"][2]
    names = ["restore_one"] + (["restore_other"] if mesh in OTHER else [])
    for name in names:
        for r in range(len(w["ranks"])):
            got = [h["loss"] for h in _report(w, name, r)["history"]]
            assert len(got) == 1
            _rel_close(got, [third], STEP_RTOL)
    got = _cli("1x1", "--steps", "3", "--ckpt-dir",
               os.path.join(worlds["root"], f"ck_{mesh}"))
    _rel_close(got, [third], STEP_RTOL)


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
def test_collectives_counted_by_axis(worlds, mesh):
    """The report counts the model row's collectives under ``model``
    and the data column's under ``data``, nothing over the world, and
    not the gathers of the step-3 checkpoint (every smoke leaf splits,
    so a step gathers none)."""
    D, M = int(mesh[0]), int(mesh[2])
    w = worlds[mesh]
    for r in range(len(w["ranks"])):
        comm = _report(w, "steps", r)["collectives"]
        axes = comm["by_axis"]
        assert set(axes) == {a for a, n in (("data", D), ("model", M))
                             if n > 1}
        assert all(row["calls"] > 0 and row["bytes"] > 0
                   for row in axes.values())
        assert not [op for op in comm["calls"] if "all_gather" in op]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
def test_refusals_in_a_world(worlds, mesh):
    D, M = int(mesh[0]), int(mesh[2])
    for r in worlds[mesh]["ranks"]:
        got = r["refusals"]
        assert got["size"][0] == "ValueError"
        assert "DATAxMODEL" in got["size"][1]
        if D > 1:
            assert got["batch"][0] == "ValueError"
            assert "microbatch" in got["batch"][1]
        if M > 1:
            assert got["sp"][0] == "NotImplementedError"
            assert "A.14" in got["sp"][1]
            assert got["family"][0] == "NotImplementedError"
            assert "A.14" in got["family"][1]


def test_two_axis_mesh_outside_a_group():
    """Outside a group only the 1x1 mesh stands; any other names
    torchrun.  The CLI refuses ``--sp`` with a model axis first."""
    assert grp.current() is None
    one = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert (one.shape, one.data, one.model, one.coords) == ((1, 1), None,
                                                            None, (0, 0))
    for shape in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(NotImplementedError, match="torchrun"):
            make_mesh(shape, ("data", "model"), device="cpu")
    with pytest.raises(NotImplementedError, match="A.14"):
        train_cli.main(["--smoke", "--device", "cpu", "--sp", "--mesh",
                        "1x2", "--steps", "1"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b",
                                  "zamba2-1.2b", "seamless-m4t-medium",
                                  "llava-next-34b", "arctic-480b"])
def test_other_families_refused_before_any_weight(arch, monkeypatch):
    """Under a model axis of 2, every family but the dense decoder is
    refused, naming ROADMAP A.14, before a weight is drawn; M = 1 takes
    them."""
    cfg = get_smoke_config(arch)

    def drawn(*a, **kw):
        raise AssertionError("a weight was drawn")
    monkeypatch.setattr(loop, "init_state", drawn)
    mesh = tensor.RankMesh((1, 2), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="A.14"):
        loop.train(cfg, TrainConfig(), None, 1, mesh=mesh)
    tensor.check_family(get_config(arch), 1)
    for name in ("h1d-lm-53m", "yi-6b", "llama3.2-1b", "gemma3-4b"):
        tensor.check_family(get_config(name), 2)


def _fake_mesh(D, M, d, m):
    def g(axis, rank, size):
        return (grp.RankGroup(rank=rank, world=size,
                              device=torch.device("cpu"), placement="cpu",
                              axis=axis) if size > 1 else None)
    return tensor.RankMesh((D, M), torch.device("cpu"), data=g("data", d, D),
                           model=g("model", m, M))


@pytest.mark.parametrize("m", [0, 1])
def test_wkv_shard_is_split_by_head(m):
    """Rank m's wkv holds the k columns of its kv heads, then the v
    columns of the same heads; every other split leaf its contiguous
    block (wq's columns, wo's rows, the embedding's vocabulary rows)."""
    cfg = get_smoke_config(ARCH)
    params, specs = transformer.lm_init(cfg, seed=0, device="cpu", tp=2,
                                        specs=True)
    mine = shard_params(params, specs, _fake_mesh(1, 2, 0, m))
    hd, hkv = cfg.head_dim, cfg.num_kv_heads
    half = hkv // 2 * hd
    for lp, whole in zip(mine["layers"], params["layers"]):
        w = whole["attn"]["wkv"]["w"]
        k, v = w[:, :hkv * hd], w[:, hkv * hd:]
        want = torch.cat([k[:, m * half:(m + 1) * half],
                          v[:, m * half:(m + 1) * half]], 1)
        assert torch.equal(lp["attn"]["wkv"]["w"], want)
        assert not torch.equal(lp["attn"]["wkv"]["w"],
                               torch.chunk(w, 2, -1)[m])
        assert torch.equal(lp["attn"]["wq"]["w"],
                           torch.chunk(whole["attn"]["wq"]["w"], 2, 1)[m])
        assert torch.equal(lp["attn"]["wo"]["w"],
                           torch.chunk(whole["attn"]["wo"]["w"], 2, 0)[m])
        assert torch.equal(lp["ln1"]["g"], whole["ln1"]["g"])
    assert torch.equal(mine["embed"]["w"],
                       torch.chunk(params["embed"]["w"], 2, 0)[m])


@pytest.mark.parametrize("d", [0, 1])
def test_data_rows_of_every_microbatch(d):
    """Data rank d takes its rows of each microbatch: with 2
    microbatches of 4 rows over 2 data ranks, rank d holds rows 2d, 2d +
    1 of the first and 4 + 2d, 4 + 2d + 1 of the second."""
    rows = torch.arange(8)[:, None].expand(8, 3)
    got = tensor.data_rows({"tokens": rows}, _fake_mesh(2, 1, d, 0), 2)
    assert got["tokens"][:, 0].tolist() == [2 * d, 2 * d + 1, 4 + 2 * d,
                                            4 + 2 * d + 1]
    with pytest.raises(ValueError, match="microbatch"):
        tensor.data_rows({"tokens": rows[:6]}, _fake_mesh(2, 1, d, 0), 2)
    assert tensor.data_rows({"tokens": rows}, None, 2)["tokens"] is rows
