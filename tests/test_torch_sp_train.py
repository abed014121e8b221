"""Port parity: sequence-parallel (SP) training on the CPU.

The SP operator (``parallel.sp_attention``) runs each shard's levels
through the autograd Functions of ``kernels.ops.band_attention`` and the
halo exchange, edge terms, row merges and gathered deep levels as plain
tensor ops, so autograd differentiates the whole sharded forward.

Held to: the gradient of q, k, v and ``kv_weight`` within 1e-4 of
``jax.grad`` of the reference's single-device ``h1d_attention`` (scaled
by ``1 + max|ref|``, the metric of the reference's own SP gradient test,
``tests/test_sp_attention.py``), and within 1e-5 of the port's unsharded
gradient (that test's bound); ``sp_band_attention``'s gradient in every
band mode within 1e-4 of ``jax.vjp`` of the reference's
``band_attention``; one AdamW step of the smoke LM under a d-way mesh
within 1e-5 of the unsharded step's parameters; and the training CLI's
``--sp --mesh N``."""
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core.h1d_attention import h1d_attention as jh1d  # noqa: E402
from repro.kernels.ops import band_attention as jband  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.h1d_attention import h1d_attention  # noqa: E402
from repro_torch.data import ZipfLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.parallel import sp_attention as sp  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

JAX_TOL = 1e-4
PORT_TOL = 1e-5
ARCH = "h1d-lm-53m"
MODES = [(True, "fine-q"), (True, "coarse-q"), (False, "fine-q")]


def _mesh(d):
    return make_mesh((d,), ("data",), device="cpu")


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / (1.0 + np.abs(want).max()))


def _operands(L, seed, Dh=16):
    """q (2, 2, L, Dh), k, v (2, L, Dh), key weights with a padded tail
    and a cotangent of the output."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 2, L, Dh)).astype(np.float32)
    k = rng.standard_normal((2, L, Dh)).astype(np.float32)
    v = rng.standard_normal((2, L, Dh)).astype(np.float32)
    w = np.ones((2, L), np.float32)
    w[:, -(L // 7):] = 0.0
    cot = rng.standard_normal((2, 2, L, Dh)).astype(np.float32)
    return q, k, v, w, cot


def _port_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum(), ts)


# ---------------------------------------------------------------------------
# the whole operator
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_grads(L, nr, causal, causal_mode):
    """``jax.grad`` of the reference's single-device operator on
    ``_operands(L, seed=L)``, w.r.t. q, k, v and the key weights (shared
    by both shard counts)."""
    q, k, v, w, cot = _operands(L, seed=L)
    kw = dict(nr=nr, causal=causal, causal_mode=causal_mode)
    return jax.jit(jax.grad(
        lambda *a: (jh1d(*a[:3], kv_weight=a[3], **kw) * cot).sum(),
        argnums=(0, 1, 2, 3)))(q, k, v, w)


@pytest.mark.parametrize("L,nr", [(64, 8), (256, 16)])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("causal,causal_mode", MODES)
def test_sp_h1d_attention_grads(L, nr, d, causal, causal_mode):
    """The reference test's L 64, nr 8 and L 256, nr 16.  At d = 4 both
    leave a level to the gathered deep path (local slabs of 16 and 64
    rows); at d = 2 L 256 runs every level locally."""
    q, k, v, w, cot = _operands(L, seed=L)
    kw = dict(nr=nr, causal=causal, causal_mode=causal_mode)
    want = _jax_grads(L, nr, causal, causal_mode)
    mesh = _mesh(d)
    n_local = sp.sp_n_shallow(sp.hc.num_levels(L, nr), L // d, nr)
    assert (n_local < sp.hc.num_levels(L, nr)) == (d == 4)

    dense_out, dense = _port_grads(
        lambda *a: h1d_attention(*a[:3], kv_weight=a[3], **kw),
        (q, k, v, w), cot)
    out, direct = _port_grads(
        lambda *a: sp.sp_h1d_attention(*a[:3], mesh=mesh, kv_weight=a[3],
                                       **kw), (q, k, v, w), cot)
    sp.DISPATCHES.clear()
    with sp.sp_scope(mesh):
        scoped_out, scoped = _port_grads(
            lambda *a: h1d_attention(*a[:3], kv_weight=a[3], **kw),
            (q, k, v, w), cot)
    assert sp.DISPATCHES["h1d_attention"] == 1
    assert torch.equal(scoped_out, out)
    for name, g, s, x, y in zip("qkvw", direct, scoped, want, dense):
        assert torch.equal(g, s), name
        assert _rel(g, x) <= JAX_TOL, (name, _rel(g, x))
        assert _rel(g, y) <= PORT_TOL, (name, _rel(g, y))
    assert _rel(out, dense_out) <= PORT_TOL


@pytest.mark.parametrize("d,mode,ratio", [
    (4, "l0_bidir", 1), (4, "l0_causal", 1), (4, "coarse_bidir", 1),
    (4, "coarse_causal", 1), (4, "sub", 2), (2, "l0_bidir", 1),
    (1, "l0_causal", 1)])
def test_sp_band_attention_grads(d, mode, ratio):
    """One level under SP at ``test_torch_sp.py``'s
    ``test_sp_band_attention_matches_jax`` parameters, with cotangents
    on all three outputs (y, dn and m)."""
    L, nr = 128, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 2, L, 16)).astype(np.float32)
    Lk = L // ratio
    k = rng.standard_normal((2, Lk, 16)).astype(np.float32)
    v = rng.standard_normal((2, Lk, 16)).astype(np.float32)
    w = np.ones((2, Lk), np.float32)
    w[:, -(37 // ratio):] = 0.0
    cots = [rng.standard_normal((2, 2, L, 16)).astype(np.float32),
            rng.standard_normal((2, 2, L)).astype(np.float32),
            rng.standard_normal((2, 2, L)).astype(np.float32)]
    kw = dict(nr=nr, mode=mode, ratio=ratio)
    _, vjp = jax.vjp(lambda *a: jband(*a, **kw), q, k, v, w)
    want = vjp(tuple(cots))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, w)]
    outs = sp.sp_band_attention(*ts, mesh=_mesh(d), **kw)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    got = torch.autograd.grad(loss, ts)
    for name, g, x in zip("qkvw", got, want):
        assert _rel(g, x) <= JAX_TOL, (name, _rel(g, x))


# ---------------------------------------------------------------------------
# training under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
def test_sp_train_step_matches_unsharded(d, tmp_path):
    """One AdamW step of the smoke LM (L 128, nr 8) through ``train(...,
    mesh=)``: every layer's attention ran sharded, the plain band
    backward ran per shard, and the parameters after the step are within
    1e-5 of the unsharded step's."""
    cfg = get_smoke_config(ARCH)
    tc = tloop.TrainConfig(ckpt_dir=str(tmp_path), ckpt_every=0, warmup=0,
                           total_steps=10)
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=128, batch_per_host=2,
                  seed=0)
    quiet = dict(device="cpu", log=lambda *_: None)
    dense, m_dense = tloop.train(cfg, tc, data, 1, **quiet)
    sp.DISPATCHES.clear()
    kernels.reset_counts()
    sharded, m_sp = tloop.train(cfg, tc, data, 1, mesh=_mesh(d), **quiet)
    assert sp.DISPATCHES["h1d_attention"] == cfg.num_layers
    bwd = kernels.band_attention_bwd_ref.calls
    sub_bwd = kernels.band_attention_sub_bwd_ref.calls
    # level 0 and every local sub level, once per shard and layer
    n_local = sp.sp_n_shallow(sp.hc.num_levels(128, cfg.nr), 128 // d,
                              cfg.nr)
    assert bwd == d * cfg.num_layers
    assert sub_bwd == d * cfg.num_layers * (n_local - 1)
    assert abs(float(m_sp["loss"]) - float(m_dense["loss"])) <= PORT_TOL
    init = dict(tree_flatten_with_paths(
        tloop.init_state(cfg, tc, device="cpu").params))
    for (path, a), (_, b) in zip(tree_flatten_with_paths(sharded.params),
                                 tree_flatten_with_paths(dense.params)):
        assert float((a - b).abs().max()) <= PORT_TOL, path
        assert not torch.equal(b, init[path]) or path.endswith("/g"), path


def test_train_cli_sp(tmp_path, capsys):
    sp.DISPATCHES.clear()
    state = train_cli.main(["--smoke", "--device", "cpu", "--sp", "--mesh",
                            "2", "--steps", "2", "--ckpt-dir",
                            str(tmp_path)])
    out = capsys.readouterr().out
    assert int(state.step) == 2
    assert "mesh 2 x 'data' (sp)" in out
    loss = float(out.split("last loss ")[1].split(",")[0])
    assert math.isfinite(loss)
    # 2 steps x 2 layers of the smoke LM, every one sharded
    assert sp.DISPATCHES["h1d_attention"] == 4


@pytest.mark.parametrize("argv,err", [
    (["--sp"], SystemExit), (["--sp", "--mesh", "1"], SystemExit),
    (["--mesh", "2"], SystemExit),
    (["--sp", "--mesh", "2x2"], NotImplementedError)])
def test_train_cli_mesh_guards(argv, err, tmp_path):
    """``--sp`` needs a mesh of more than one shard, a mesh needs
    ``--sp``, and ``--sp`` with a model axis raises (ROADMAP A.14)."""
    with pytest.raises(err):
        train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)] + argv)
