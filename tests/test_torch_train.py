"""Port parity of the training slice against the JAX reference: data
streams, optimizers, the loss, five AdamW steps of the paper LM's smoke
config from the same converted weights, gradient accumulation,
checkpoints, the watchdog and the training CLI.

Tolerances: first-step gradients within 1e-4 of each leaf's largest
|reference| entry, and per-step losses 1e-4 absolute, both fp32 over two
layers and a tied head that differ only in summation order (the
gradients at init are far below 1, so the gradient bound is relative to
the leaf: an absolute 1e-4 would pass a dropped term); optimizer updates
1e-6 relative (the same elementwise fp32 arithmetic); data streams and
checkpoint round trips exact."""
import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro import data as jdata  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import quantization as qz  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,  # noqa: E402
                              tree_unflatten_like)

ARCH = "h1d-lm-53m"
ATOL = 1e-4
GRAD_RTOL = 1e-4
STEPS = 5
#: reference TrainConfig fields the port leaves out: the JAX attention's
#: backend and tile overrides (the port picks its kernels by device)
JAX_ONLY_TRAIN_FIELDS = ("attn_impl", "attn_tq")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("ZipfLM", dict(vocab_size=512, seq_len=64, batch_per_host=4, seed=3)),
    ("ZipfLM", dict(vocab_size=100, seq_len=32, batch_per_host=2, seed=1,
                    host_id=1)),
    ("HierarchicalLM", dict(vocab_size=64, seq_len=256, batch_per_host=8,
                            seed=0)),
])
def test_data_streams_equal_reference(name, kw):
    """The port's copy draws the reference's stream byte for byte."""
    a, b = getattr(tdata, name)(**kw), getattr(jdata, name)(**kw)
    for step in (0, 1, 7):
        x, y = a.batch(step)["tokens"], b.batch(step)["tokens"]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert not np.array_equal(a.batch(3)["tokens"], a.batch(4)["tokens"])


def test_file_corpus_equals_reference(tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(5000, dtype=np.uint16).tofile(path)
    a = tdata.file_corpus(str(path), 300, 16, 3, seed=2)
    b = jdata.file_corpus(str(path), 300, 16, 3, seed=2)
    assert a.batch(5)["tokens"].tobytes() == b.batch(5)["tokens"].tobytes()


def test_prefetcher_orders_batches():
    src = tdata.ZipfLM(vocab_size=50, seq_len=16, batch_per_host=2, seed=7)
    pre = tdata.Prefetcher(src, start_step=5)
    try:
        b5, b6 = pre.next(), pre.next()
    finally:
        pre.close()
    assert not pre._thread.is_alive()
    np.testing.assert_array_equal(b5["tokens"], src.batch(5)["tokens"])
    np.testing.assert_array_equal(b6["tokens"], src.batch(6)["tokens"])


# ---------------------------------------------------------------------------
# optimizers and compression
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"g": rng.standard_normal((5,)).astype(np.float32)}],
            "b": rng.standard_normal((3, 2, 4)).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_trees(got, want, **tol):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    """Three updates from the same parameters and gradients give the
    reference's updates and states."""
    sched = (jopt.cosine_schedule, topt.cosine_schedule)
    make = {"adamw": lambda s, m: m.adamw(s(1e-2, 2, 10), weight_decay=0.1,
                                          clip_norm=1.0),
            "adafactor": lambda s, m: m.adafactor(s(1e-2, 2, 10))}[name]
    jo, to = make(sched[0], jopt), make(sched[1], topt)
    params = _tree(0)
    jp, tp = params, _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for i in range(3):
        g = _tree(10 + i)
        ju, js = jupdate(g, js, jp)
        tu, ts = to.update(_to_torch(g), ts, tp)
        _close_trees(tu, ju, rtol=1e-6, atol=1e-9)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    _close_trees(tp, jp, rtol=1e-6, atol=1e-9)
    assert int(ts.step) == int(js.step) == 3


def _quad_problem(seed=0, dim=8):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((dim, dim))
    A = torch.tensor(A @ A.T / dim + np.eye(dim), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(dim), dtype=torch.float32)

    def loss_and_grad(p):
        x = p["x"].detach().requires_grad_(True)
        loss = 0.5 * x @ A @ x - b @ x
        return float(loss.detach()), {"x": torch.autograd.grad(loss, x)[0]}

    return loss_and_grad, {"x": torch.zeros(dim)}


@pytest.mark.parametrize("make_opt", [
    lambda: topt.adamw(lambda s: 0.05, weight_decay=0.0),
    lambda: topt.adafactor(lambda s: 0.5),
], ids=["adamw", "adafactor"])
def test_optimizer_converges_on_quadratic(make_opt):
    loss_and_grad, params = _quad_problem()
    opt = make_opt()
    state = opt.init(params)
    l0, _ = loss_and_grad(params)
    for _ in range(300):
        _, g = loss_and_grad(params)
        upd, state = opt.update(g, state, params)
        params = topt.apply_updates(params, upd)
    assert loss_and_grad(params)[0] < l0 - 0.5


def test_adamw_weight_decay_shrinks_every_leaf():
    """Decay applies to every leaf, a norm's gain included."""
    opt = topt.adamw(lambda s: 0.01, weight_decay=0.5)
    params = {"w": torch.ones(4), "norm": {"g": torch.ones(3)}}
    state = opt.init(params)
    zeros = {"w": torch.zeros(4), "norm": {"g": torch.zeros(3)}}
    for _ in range(50):
        upd, state = opt.update(zeros, state, params)
        params = topt.apply_updates(params, upd)
    assert float(params["w"].abs().max()) < 1.0
    assert float(params["norm"]["g"].abs().max()) < 1.0


def test_clip_by_global_norm():
    g = {"a": torch.full((3,), 10.0), "b": torch.full((4,), -10.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    assert abs(float(topt.global_norm(clipped)) - 1.0) < 1e-5
    small = {"a": torch.full((3,), 1e-3), "b": torch.full((4,), 1e-3)}
    same, _ = topt.clip_by_global_norm(small, 1.0)
    torch.testing.assert_close(same["a"], small["a"])


@pytest.mark.parametrize("kind", ["cosine_schedule", "linear_schedule"])
def test_schedules_match_reference(kind):
    js = getattr(jopt, kind)(3e-4, warmup=10, total=100)
    ts = getattr(topt, kind)(3e-4, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(ts(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(js(step)), rel=1e-6, abs=1e-12)
    assert float(ts(0)) == 0.0


def test_int8_rounding_matches_reference():
    """Round half to even, scale = absmax * (1/127) as a multiply, clip
    at +-127; the compressor uses this very function."""
    from repro.core import quantization as jqz
    assert comp.quantize_int8 is qz.quantize_int8
    x = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    q, s = qz.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and float(s) == pytest.approx(1.0, rel=1e-6)
    np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2])
    assert int(qz.quantize_int8(torch.tensor([1000.0, -1e-30]))[0][0]) == 127
    rng = np.random.default_rng(2)
    for axis in (None, -1):
        row = rng.standard_normal((3, 16)).astype(np.float32) * 3
        jq, js = jqz.quantize_int8(row, axis=axis)
        tq, ts = qz.quantize_int8(torch.from_numpy(row), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_compression_error_feedback_unbiased_over_time():
    g_true = {"w": torch.from_numpy(
        np.random.default_rng(0).standard_normal(256).astype(np.float32))}
    ef = topt.init_error_feedback(g_true)
    total = torch.zeros(256)
    for _ in range(50):
        gc, ef = topt.int8_compress(g_true, ef)
        total = total + gc["w"]
    want = 50 * g_true["w"]
    assert float((total - want).norm() / want.norm()) < 0.02
    assert float(ef.residual["w"].abs().max()) < 0.1


@pytest.mark.parametrize("kind", ["int8_compress", "topk_compress"])
def test_compression_matches_reference(kind):
    g = _tree(4)
    jef, tef = jopt.init_error_feedback(g), topt.init_error_feedback(
        _to_torch(g))
    for i in range(3):
        jg, jef = getattr(jopt, kind)(g, jef)
        tg, tef = getattr(topt, kind)(_to_torch(g), tef)
        _close_trees(tg, jg, rtol=1e-6, atol=1e-7)
        _close_trees(tef.residual, jef.residual, rtol=1e-6, atol=1e-7)


def test_topk_compression_sparsity_and_feedback():
    g = {"w": torch.from_numpy(
        np.random.default_rng(1).standard_normal(1000).astype(np.float32))}
    gc, ef = topt.topk_compress(g, topt.init_error_feedback(g), frac=0.05)
    assert int((gc["w"] != 0).sum()) <= 55
    torch.testing.assert_close(gc["w"] + ef.residual["w"], g["w"])


def test_compressed_sgd_still_converges():
    loss_and_grad, params = _quad_problem(seed=3)
    ef = topt.init_error_feedback(params)
    for _ in range(400):
        _, g = loss_and_grad(params)
        gc, ef = topt.int8_compress(g, ef)
        params = {"x": params["x"] - 0.05 * gc["x"]}
    assert float(topt.global_norm(loss_and_grad(params)[1])) < 0.05


# ---------------------------------------------------------------------------
# the model's loss and five AdamW steps against the reference
# ---------------------------------------------------------------------------

def test_train_config_mirrors_reference():
    """Same fields, order and defaults as the reference's TrainConfig,
    less the JAX-only ones named above."""
    ref = dataclasses.fields(jloop.TrainConfig)
    assert set(JAX_ONLY_TRAIN_FIELDS) <= {f.name for f in ref}
    got = [(f.name, f.default) for f in dataclasses.fields(tloop.TrainConfig)]
    assert got == [(f.name, f.default) for f in ref
                   if f.name not in JAX_ONLY_TRAIN_FIELDS]


def _tc(**kw):
    return dict(peak_lr=1e-3, warmup=2, total_steps=10, ckpt_every=0, **kw)


@pytest.fixture(scope="module")
def parity():
    """Both packages from the same JAX init of the smoke config: the
    first step's loss and gradients, then STEPS AdamW steps on the same
    ZipfLM batches (the JAX step jitted with attn_impl='jnp')."""
    cfg = jax_smoke(ARCH)
    jtc = jloop.TrainConfig(attn_impl="jnp", **_tc())
    jstate, _ = jloop.init_state(jax.random.PRNGKey(0), cfg, jtc)
    tcfg = get_smoke_config(ARCH)
    ttc = tloop.TrainConfig(**_tc())
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                             device="cpu")
    opt = tloop.make_optimizer(ttc)
    tstate = tloop.TrainState(torch.zeros((), dtype=torch.int32), params,
                              opt.init(params), None)
    data = tdata.ZipfLM(vocab_size=cfg.vocab_size, seq_len=64,
                        batch_per_host=4, seed=0)

    jcfg = jloop.resolve_model_config(cfg, jtc)
    jloss = jax_model(jcfg).loss
    batch0 = data.batch(0)
    jgrad = jax.jit(jax.grad(lambda p, b: jloss(p, jcfg, b)[0]))(
        jstate.params, jax.tree.map(jnp.asarray, batch0))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    tl, _ = get_model(tcfg).loss(tree_unflatten_like(params, leaves), tcfg,
                                 tloop.batch_to_device(batch0, "cpu"))
    tgrad = tree_unflatten_like(params,
                                list(torch.autograd.grad(tl, leaves)))

    jstep = jax.jit(jloop.make_train_step(cfg, jtc))
    tstep = tloop.make_train_step(tcfg, ttc)
    losses = []
    kernels.reset_counts()
    for i in range(STEPS):
        b = data.batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, tloop.batch_to_device(b, "cpu"))
        losses.append((float(jm["loss"]), float(tm["loss"])))
    calls = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}
    jg = params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg, device="cpu")
    return dict(jgrad=jg, tgrad=tgrad, losses=losses, calls=calls,
                jstate=jstate, tstate=tstate)


def test_first_step_grads_match_reference(parity):
    """Each leaf within GRAD_RTOL of its own largest |reference| entry."""
    paths = []
    got = tree_flatten_with_paths(parity["tgrad"])
    want = dict(tree_flatten_with_paths(parity["jgrad"]))
    for path, g in got:
        w = want[path].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=path)
        paths.append(path)
    assert "embed/w" in paths and len(paths) == len(want)


@pytest.mark.parametrize("step", range(STEPS))
def test_adamw_losses_match_reference(parity, step):
    jl, tl = parity["losses"][step]
    assert np.isfinite(tl) and abs(jl - tl) <= ATOL, (step, jl, tl)


def test_training_ran_the_band_backward(parity):
    """Every step went through both band levels' plain backward (the CPU
    path of the backward kernels), and the loss fell."""
    calls = parity["calls"]
    # per step and layer: level 0 once, the sub levels ratio 2 and 4
    assert calls["band_attention_fwd"] == calls["band_attention_bwd"] \
        == STEPS * 2
    assert calls["band_attention_sub_fwd"] == \
        calls["band_attention_sub_bwd"] == STEPS * 2 * 2
    assert parity["losses"][-1][1] < parity["losses"][0][1]
    assert int(parity["tstate"].step) == STEPS


def test_grad_accum_matches_large_batch():
    cfg = get_smoke_config(ARCH)
    data = tdata.ZipfLM(vocab_size=cfg.vocab_size, seq_len=32,
                        batch_per_host=8, seed=1)
    batch = tloop.batch_to_device(data.batch(0), "cpu")
    out = []
    for n in (1, 4):
        tc = tloop.TrainConfig(grad_accum=n, **_tc())
        state = tloop.init_state(cfg, tc, seed=0, device="cpu")
        out.append(tloop.make_train_step(cfg, tc)(state, batch)[0])
    for a, b in zip(tree_leaves(out[0].params), tree_leaves(out[1].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                   rtol=5e-3)


def test_compressed_training_step_runs():
    cfg = get_smoke_config(ARCH)
    tc = tloop.TrainConfig(compress_grads="int8", **_tc())
    state = tloop.init_state(cfg, tc, device="cpu")
    assert state.ef_state is not None
    data = tdata.ZipfLM(vocab_size=cfg.vocab_size, seq_len=32,
                        batch_per_host=4, seed=3)
    state, m = tloop.make_train_step(cfg, tc)(
        state, tloop.batch_to_device(data.batch(0), "cpu"))
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1


def test_topk_compression_in_the_step_raises():
    """The step applies only int8 compression: 'topk' must not quietly
    train uncompressed."""
    tc = tloop.TrainConfig(compress_grads="topk", **_tc())
    with pytest.raises(NotImplementedError):
        tloop.make_train_step(get_smoke_config(ARCH), tc)


def test_tokens_per_s_over_the_steps_after_the_first():
    hist = [{"end_s": 10.0}, {"end_s": 10.5}, {"end_s": 12.0}]
    assert tloop.tokens_per_s(hist, 1000) == pytest.approx(1000.0)
    assert tloop.tokens_per_s(hist[:1], 1000) is None


def test_loss_mask_and_metrics():
    """lm_loss against the reference with a loss mask: loss, nll, ntok."""
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(1), cfg)
    tcfg = get_smoke_config(ARCH)
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    mask = (rng.random((2, 20)) < 0.7).astype(np.float32)
    jl, jm = jax.jit(lambda p, b: jax_model(cfg).loss(p, cfg, b))(
        params, {"tokens": tok, "loss_mask": mask})
    tl, tm = get_model(tcfg).loss(tp, tcfg, {
        "tokens": torch.from_numpy(tok), "loss_mask": torch.from_numpy(mask)})
    assert abs(float(tl) - float(jl)) <= ATOL
    assert abs(float(tm["nll"]) - float(jm["nll"])) <= ATOL
    assert float(tm["ntok"]) == float(jm["ntok"])


# ---------------------------------------------------------------------------
# loop, watchdog, checkpoints, CLI
# ---------------------------------------------------------------------------

def test_watchdog_flags_stragglers():
    wd = tloop.Watchdog(factor=3.0)
    for _ in range(10):
        wd.observe(0.1)
    assert wd.observe(1.0) is True
    assert wd.alarms == 1
    assert wd.observe(0.1) is False


def _ckpt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": torch.from_numpy(
                rng.standard_normal((4, 8)).astype(np.float32)),
                      "b": torch.arange(3.0)},
            "step_list": [torch.ones(2), torch.zeros(5, dtype=torch.int32)]}


def _zeros_like(tree):
    return jax.tree.map(torch.zeros_like, tree)


def test_checkpoint_roundtrip_and_reference_manifest(tmp_path):
    tree = _ckpt_tree()
    ckpt.save(str(tmp_path / "t"), 7, tree)
    assert ckpt.latest_step(str(tmp_path / "t")) == 7
    out = ckpt.restore(str(tmp_path / "t"), 7, _zeros_like(tree))
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference writes the same manifest for the same tree
    jckpt.save(str(tmp_path / "j"), 7,
               jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree))
    mt, mj = (json.loads((tmp_path / d / "step_00000007" / "manifest.json")
                         .read_text()) for d in ("t", "j"))
    assert mt == mj


def test_train_state_restores_from_checkpoint(tmp_path):
    cfg = get_smoke_config(ARCH)
    tc = tloop.TrainConfig(ckpt_dir=str(tmp_path), **_tc())
    state = tloop.init_state(cfg, tc, seed=1, device="cpu")
    ckpt.save(str(tmp_path), 3, state)
    fresh = tloop.init_state(cfg, tc, seed=2, device="cpu")
    got = ckpt.restore(str(tmp_path), 3, fresh, device="cpu")
    assert type(got) is tloop.TrainState and got.ef_state is None
    for a, b in zip(tree_leaves(state), tree_leaves(got)):
        assert torch.equal(a, b)


def test_incomplete_checkpoint_ignored(tmp_path):
    ckpt.save(str(tmp_path), 5, _ckpt_tree())
    bad = tmp_path / "step_00000009.tmp"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    (tmp_path / "step_00000010").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_async_checkpointer_and_gc(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = _ckpt_tree()
    for s in (1, 2, 3, 4):
        saver.save(s, tree)
    saver.wait()
    steps = sorted(os.listdir(str(tmp_path)))
    assert "step_00000003" in steps and "step_00000004" in steps
    assert "step_00000001" not in steps


def test_overwrite_same_step(tmp_path):
    t1 = _ckpt_tree(seed=2)
    t2 = jax.tree.map(lambda x: x + 1, t1)
    ckpt.save(str(tmp_path), 3, t1)
    ckpt.save(str(tmp_path), 3, t2)
    out = ckpt.restore(str(tmp_path), 3, _zeros_like(t1))
    assert torch.equal(out["layer"]["b"], t2["layer"]["b"])


def test_train_resumes_from_checkpoint(tmp_path):
    """train() checkpoints, and a second call resumes from the last
    complete step instead of starting over."""
    cfg = get_smoke_config(ARCH)
    tc = tloop.TrainConfig(**dict(_tc(), ckpt_every=2,
                                  ckpt_dir=str(tmp_path)))
    data = tdata.ZipfLM(vocab_size=cfg.vocab_size, seq_len=32,
                        batch_per_host=2, seed=4)
    logs = []
    state, m = tloop.train(cfg, tc, data, 4, device="cpu", log=logs.append)
    assert [h["step"] for h in m["history"]] == [0, 1, 2, 3]
    ends = [h["end_s"] for h in m["history"]]
    assert ends == sorted(ends) and tloop.tokens_per_s(m["history"], 64) > 0
    assert ckpt.latest_step(str(tmp_path)) == 4
    state2, m2 = tloop.train(cfg, tc, data, 5, device="cpu",
                             log=logs.append)
    assert any("resumed from step 4" in s for s in logs)
    assert [h["step"] for h in m2["history"]] == [4]
    assert int(state2.step) == 5


def test_train_entry_points_need_a_card_by_default():
    cfg = get_smoke_config(ARCH)
    data = tdata.ZipfLM(vocab_size=cfg.vocab_size, seq_len=16,
                        batch_per_host=2, seed=0)
    from repro_torch.launch import train as cli
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError):
            tloop.train(cfg, tloop.TrainConfig(**_tc()), data, 1)
        with pytest.raises(RuntimeError):
            cli.main(["--smoke", "--steps", "1"])


def test_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as cli
    state = cli.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "32", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "3"])
    assert int(state.step) == 3
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert "[train] done" in capsys.readouterr().out
