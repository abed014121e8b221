"""The optimizers' in-place update (``Optimizer.update_``) and the train
step built on it: against the JAX package over three steps (AdamW with
its global-norm clipping active, and Adafactor; fp32 and bf16
parameters), bit for bit against the port's own functional ``update``
then ``apply_updates`` (AdamW's large leaves in row chunks too), the
tensors it writes kept in place, and ``make_train_step`` -- which now
consumes its state -- against the reference's step and against a
functional step.

The reference's update runs eagerly here: under ``jax.jit`` XLA drops
the bf16 rounding of the clipped gradient (``g * scale`` in bf16, then
widened), which the reference's expressions ask for and the port keeps.
Tolerances: fp32 moments and parameters 1e-6 relative, and 1e-6 of the
leaf's largest entry absolute (the same elementwise fp32 arithmetic; the
global norm sums in another order, and a moment's terms of both signs
can cancel); a bf16 parameter within one bf16 ulp (2**-7 of its
magnitude), where an f32 update one ulp away from the reference's can
round the other way; losses 1e-4 absolute, as
``tests/test_torch_train.py``; the port's in-place against its
functional update exactly."""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro import optim as jopt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                              tree_unflatten_like)

# the module (the package re-exports its ``adamw`` function under the name)
tadamw = importlib.import_module("repro_torch.optim.adamw")

ARCH = "h1d-lm-53m"
ATOL = 1e-4
F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tree(seed, scale=1.0):
    """A parameter-shaped tree: a matrix, a stacked 3-D leaf, a vector
    in a list and a scalar; at scale 1 its global norm is ~8, so a clip
    at 1.0 is active."""
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((9, 7))).astype(np.float32),
            "layers": [{"g": (scale * rng.standard_normal((7,))).astype(
                np.float32)}],
            "b": (scale * rng.standard_normal((3, 2, 4))).astype(np.float32),
            "s": np.float32(scale * rng.standard_normal())}


def _jax_tree(tree, jdtype):
    return jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree)


def _torch_tree(tree, tdtype):
    """The same values as ``_jax_tree`` (fp32 widened back exactly from
    the JAX leaves, so bf16 rounding is the JAX package's)."""
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdtype), tree)


def _make(name, mod):
    sched = mod.cosine_schedule(1e-2, 2, 10)
    if name == "adamw":
        return mod.adamw(sched, weight_decay=0.1, clip_norm=1.0)
    return mod.adafactor(sched)


def _close(got, want, rtol):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol,
                                   atol=F32_RTOL * float(np.abs(b).max()))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_in_place_steps_match_reference(name, dtype):
    """Three in-place updates against the reference's update then
    ``apply_updates`` from the same parameters and gradients: the
    parameters (in their dtype) and the f32 moments."""
    jd, td = DTYPES[dtype]
    jo, to = _make(name, jopt), _make(name, topt)
    jp, tp = _jax_tree(_tree(0), jd), _torch_tree(_jax_tree(_tree(0), jd),
                                                  td)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = _jax_tree(_tree(10 + i, scale=3.0), jd)
        ju, js = jo.update(g, js, jp)
        jp = jopt.apply_updates(jp, ju)
        ts = to.update_(_torch_tree(g, td), ts, tp)
        assert {p.dtype for p in tree_leaves(tp)} == {td}
        _close(tp, jp, BF16_RTOL if dtype == "bfloat16" else F32_RTOL)
        _close(ts[1:], js[1:], F32_RTOL)
    assert int(ts.step) == int(js.step) == 3


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_in_place_update_is_bit_equal_to_functional(monkeypatch, name,
                                                    dtype, chunk):
    """Three steps of ``update_`` against ``update`` then
    ``apply_updates`` on clones of the same state: parameters and moments
    the same bits.  ``chunk`` lowers ``CHUNK_ELEMS`` to 5, so AdamW takes
    its 63- and 24-entry leaves in row chunks (a short last one too)."""
    if chunk is not None:
        monkeypatch.setattr(tadamw, "CHUNK_ELEMS", chunk)
        assert len(tadamw._row_chunks(torch.zeros(9, 7))) == 9
        assert len(tadamw._row_chunks(torch.zeros(3, 2, 4))) == 3
    _, td = DTYPES[dtype]
    opt = _make(name, topt)
    p_in = _torch_tree(_tree(1), td)
    s_in = opt.init(p_in)
    p_fn, s_fn = _clone(p_in), _clone(s_in)
    for i in range(3):
        g = _torch_tree(_tree(20 + i, scale=3.0), td)
        u, s_fn = opt.update(_clone(g), s_fn, p_fn)
        p_fn = topt.apply_updates(p_fn, u)
        s_in = opt.update_(g, s_in, p_in)
    for a, b in zip(tree_leaves((p_in, s_in)), tree_leaves((p_fn, s_fn))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_in_place_update_keeps_every_tensor(name):
    """Parameters and moments keep their storage; the gradients are
    clipped in place (AdamW) and nothing else is returned but the
    state."""
    opt = _make(name, topt)
    params = _torch_tree(_tree(2), torch.float32)
    state = opt.init(params)
    ptrs = [t.data_ptr() for t in tree_leaves((params, state[1:]))]
    g = _torch_tree(_tree(3, scale=3.0), torch.float32)
    norm = float(topt.global_norm(g))
    new = opt.update_(g, state, params)
    assert [t.data_ptr() for t in tree_leaves((params, new[1:]))] == ptrs
    assert int(new.step) == 1 and int(state.step) == 0
    if name == "adamw":
        assert norm > 1.0
        assert abs(float(topt.global_norm(g)) - 1.0) < 1e-5


def test_clip_by_global_norm_in_place_equals_functional():
    g = _torch_tree(_tree(4, scale=5.0), torch.bfloat16)
    want, wn = topt.clip_by_global_norm(_clone(g), 1.0)
    got, gn = topt.clip_by_global_norm_(g, 1.0)
    assert got is g and torch.equal(gn, wn)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_row_chunks_cover_a_leaf_once():
    big = torch.zeros((tadamw.CHUNK_ELEMS // 1000 * 3 + 7, 1000))
    idx = tadamw._row_chunks(big)
    rows = [r for sl in idx for r in range(big.shape[0])[sl]]
    assert rows == list(range(big.shape[0])) and len(idx) == 4
    assert tadamw._row_chunks(torch.zeros(())) == (...,)
    assert tadamw._row_chunks(torch.zeros(10, 10)) == (...,)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _tc(**kw):
    return dict(peak_lr=1e-3, warmup=2, total_steps=10, ckpt_every=0, **kw)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """Three AdamW steps of the smoke LM from the same converted weights,
    whole and in two microbatches: the reference's losses, and the
    port's parameters and moments written in place (the step returns the
    tensors it was handed).  (Adafactor's sign-like steps on near-zero
    gradient entries carry ulp differences into the loss past 1e-4
    within three steps, so its step is held to the port's functional
    step, bit for bit, below, and its update to the reference's above.)"""
    cfg = jax_smoke(ARCH)
    jtc = jloop.TrainConfig(attn_impl="jnp", grad_accum=accum, **_tc())
    jstate, _ = jloop.init_state(jax.random.PRNGKey(1), cfg, jtc)
    tcfg = get_smoke_config(ARCH)
    ttc = tloop.TrainConfig(grad_accum=accum, **_tc())
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                             device="cpu")
    opt = tloop.make_optimizer(ttc)
    tstate = tloop.TrainState(torch.zeros((), dtype=torch.int32), params,
                              opt.init(params), None)
    ptrs = [t.data_ptr() for t in tree_leaves((tstate.params,
                                               tstate.opt_state[1:]))]
    data = tdata.ZipfLM(vocab_size=cfg.vocab_size, seq_len=48,
                        batch_per_host=2, seed=2)
    jstep = jax.jit(jloop.make_train_step(cfg, jtc))
    tstep = tloop.make_train_step(tcfg, ttc)
    for i in range(3):
        b = data.batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, tloop.batch_to_device(b, "cpu"))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= ATOL, i
    assert [t.data_ptr() for t in tree_leaves(
        (tstate.params, tstate.opt_state[1:]))] == ptrs
    assert int(tstate.step) == 3


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_equals_a_functional_step(optimizer):
    """The in-place step (two microbatches) against the same step written
    with the functional update on a clone of the state: parameters,
    moments and losses the same bits over two steps."""
    cfg = get_smoke_config(ARCH)
    tc = tloop.TrainConfig(grad_accum=2, optimizer=optimizer, **_tc())
    state = tloop.init_state(cfg, tc, seed=3, device="cpu")
    ref = tloop.TrainState(state.step.clone(), _clone(state.params),
                           _clone(state.opt_state), None)
    opt = tloop.make_optimizer(tc)
    step = tloop.make_train_step(cfg, tc)
    data = tdata.ZipfLM(vocab_size=cfg.vocab_size, seq_len=32,
                        batch_per_host=4, seed=5)
    loss_fn = get_model(cfg).loss
    for i in range(2):
        batch = tloop.batch_to_device(data.batch(i), "cpu")
        state, m = step(state, batch)
        # the functional step: the mean gradient of the two microbatches
        # (f32 sums, as the step takes them), update, apply_updates
        gsum, lsum = None, 0.0
        for half in (slice(0, 2), slice(2, 4)):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(ref.params)]
            loss, _ = loss_fn(tree_unflatten_like(ref.params, leaves), cfg,
                              {k: v[half] for k, v in batch.items()})
            g = [x.float() for x in torch.autograd.grad(loss, leaves)]
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
            lsum = lsum + loss.detach()
        grads = tree_unflatten_like(ref.params, [a / 2 for a in gsum])
        upd, opt_state = opt.update(grads, ref.opt_state, ref.params)
        ref = tloop.TrainState(ref.step + 1,
                               topt.apply_updates(ref.params, upd),
                               opt_state, None)
        assert torch.equal(m["loss"], lsum / 2), i
    for a, b in zip(tree_leaves((state.params, state.opt_state)),
                    tree_leaves((ref.params, ref.opt_state))):
        assert torch.equal(a, b)


def test_async_checkpoint_keeps_the_saved_values(tmp_path):
    """``AsyncCheckpointer`` copies every leaf before its thread writes,
    a CPU one too: a step that updates the state in place right after a
    save leaves the checkpoint at the saved values."""
    from repro_torch.train import checkpoint as ckpt
    params = _torch_tree(_tree(6), torch.float32)
    want = _clone(params)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(1, params)
    for p in tree_leaves(params):
        p.add_(1.0)
    saver.wait()
    got = ckpt.restore(str(tmp_path), 1, params)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
