"""Port parity of the bidirectional and coarse-q slice: the band modes
``l0_bidir``, ``coarse_bidir`` and ``coarse_causal`` (forward and
backward, the CPU path of the kernel wrappers), the encoder and coarse-q
branches of ``core.h1d_attention``, the LRA encoder classifier
(``h1d-lra-encoder``), the coarse-q LM loss and the ListOps data, each
against the JAX reference on the same numpy inputs and weights.

Tolerances: forward atol 2e-5 / rtol 1e-4 and band gradients atol 1e-4
/ rtol 1e-3 (the reference's own kernel-vs-oracle bounds; both sides
are fp32 and differ in summation order); parameter gradients within
1e-4 of each leaf's largest |reference| entry; losses within 1e-4;
ListOps batches identical."""
import functools
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import listops as jlistops  # noqa: E402
from repro.kernels import h1d_block as jhb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import classifier as jcls  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import hierarchy as thc  # noqa: E402
from repro_torch.data import ListOps  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import h1d_block as thb  # noqa: E402
from repro_torch.kernels import h1d_block_bwd as thbb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import (classifier_init, classifier_logits,  # noqa: E402
                                classifier_loss, get_model)
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,  # noqa: E402
                              tree_unflatten_like)

jatt = importlib.import_module("repro.core.h1d_attention")
tatt = importlib.import_module("repro_torch.core.h1d_attention")

TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_RTOL = 1e-4
LOSS_ATOL = 1e-4
NEW_MODES = ("l0_bidir", "coarse_bidir", "coarse_causal")
ENCODER = "h1d-lra-encoder"
LM = "h1d-lm-53m"
NUM_CLASSES = jlistops.NUM_CLASSES


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _inputs(B, G, L, d, seed, pad):
    """Seeded band operands; row 0 right-padded over its last ``pad``
    keys, ``v`` pre-weighted as ``h1d_attention`` hands it over."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G, L, d)).astype(np.float32) / np.sqrt(d)
    k = rng.standard_normal((B, L, d)).astype(np.float32)
    w = np.ones((B, L), np.float32)
    w[0, L - pad:] = 0.0
    v = rng.standard_normal((B, L, d)).astype(np.float32) * w[..., None]
    return rng, (q, k, v, w)


def _close(ref, got, tol=TOL):
    for name, a, b in zip(("y", "dn", "m"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# band levels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", NEW_MODES)
@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("G", [1, 2])
def test_band_modes_match_blocked_jnp(mode, L, G):
    """``ops.band_attention`` on CPU tensors (the plain forward) against
    ``ops._blocked_jnp``, nr 8, one row right-padded."""
    _, (q, k, v, w) = _inputs(3, G, L, 16, seed=L + G, pad=L // 3)
    ref = jax.jit(functools.partial(jops._blocked_jnp, nr=8, mode=mode))(
        q, k, v, w)
    kernels.reset_counts()
    _close(ref, tops.band_attention(*_t(q, k, v, w), nr=8, mode=mode))
    assert thb.band_attention_fwd_ref.calls == 1


@pytest.mark.parametrize("mode", NEW_MODES)
def test_band_modes_match_pallas_interpret(mode):
    """The TPU kernel body itself, in interpret mode, against the port's
    plain forward: one case per mode."""
    _, (q, k, v, w) = _inputs(2, 2, 128, 16, seed=5, pad=50)
    ref = jax.jit(functools.partial(jhb.band_attention_fwd, nr=8, mode=mode,
                                    tq=64, interpret=True))(q, k, v, w)
    _close(ref, thb.band_attention_fwd(*_t(q, k, v, w), nr=8, mode=mode))


# (mode, L, nr, G, pad)
BWD_CASES = [(m, L, nr, G, pad) for m in NEW_MODES
             for L, nr, G, pad in ((64, 8, 1, 13), (256, 8, 2, 100))]


@pytest.mark.parametrize("mode,L,nr,G,pad", BWD_CASES)
def test_band_mode_grads_match_jax(mode, L, nr, G, pad):
    """(dq, dk, dv, dw) of one level under random cotangents on all of
    (y, dn, m), against ``jax.vjp`` of ``ops._blocked_jnp``; the plain
    backward ran."""
    rng, args = _inputs(2, G, L, 16, seed=3 * L + G, pad=pad)
    fn = jax.jit(functools.partial(jops._blocked_jnp, nr=nr, mode=mode))
    outs, vjp = jax.vjp(fn, *args)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    want = vjp(tuple(cts))
    ts = [t.requires_grad_(True) for t in _t(*args)]
    kernels.reset_counts()
    got = torch.autograd.grad(tops.band_attention(*ts, nr=nr, mode=mode), ts,
                              _t(*cts))
    assert thbb.band_attention_bwd_ref.calls == 1
    for name, a, b in zip("qkvw", want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_fully_masked_coarse_rows_give_zero():
    """A ListOps-like batch is mostly padding: coarse rows with every key
    at weight 0 give m = -1e30, y = dn = 0, and no gradient or NaN."""
    _, (q, k, v, w) = _inputs(1, 1, 64, 8, seed=9, pad=0)
    w[:, 20:] = 0.0
    v = v * w[..., None]
    for mode in NEW_MODES:
        ts = [t.requires_grad_(True) for t in _t(q, k, v, w)]
        y, dn, m = tops.band_attention(*ts, nr=8, mode=mode)
        assert torch.all(m[0, 0, 40:] == thb._MIN_M)
        assert not y[0, 0, 40:].any() and not dn[0, 0, 40:].any()
        grads = torch.autograd.grad((y.sum() + dn.sum() + m.sum()), ts)
        assert all(torch.isfinite(g).all() for g in grads)
        assert not grads[0][0, 0, 40:].any()


@pytest.mark.parametrize("mode", NEW_MODES + ("l0_causal",))
def test_plain_backward_ties_at_its_own_row_max(mode):
    """Handed an ``m`` one ulp off its own recomputed max (a kernel's
    forward sums the scores in another order), the plain backward still
    routes the max's cotangent to the row's argmax: gmn and the
    gradients move by rounding only, not by |gm|."""
    _, (q, k, v, w) = _inputs(2, 1, 64, 16, seed=2, pad=10)
    args = _t(q, k, v, w)
    y, dn, m = thb.band_attention_fwd(*args, nr=8, mode=mode)
    live = m > thb._MIN_M
    m_off = torch.where(live, torch.nextafter(m, torch.full_like(m, 1e9)), m)
    gm = torch.ones_like(m) * 50.0
    cot = (torch.zeros_like(y), torch.zeros_like(dn), gm)
    want = thbb.band_attention_bwd(*args, y, dn, m, *cot, nr=8, mode=mode)
    got = thbb.band_attention_bwd(*args, y, dn, m_off, *cot, nr=8,
                                  mode=mode)
    assert torch.equal(want[4], got[4]) and bool((got[4][live] != 0).all())
    for a, b in zip(want[:4], got[:4]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_interp_repeat_sums_the_cotangent():
    """Each fine row repeats its coarse row; the coarse row's gradient is
    the sum over its 2**l fine rows."""
    x = torch.arange(6.0).reshape(1, 3, 2).requires_grad_(True)
    y = thc.interp_repeat(x, 4, axis=-2)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.repeat(x.detach().numpy(), 4, axis=-2))
    g = torch.arange(24.0).reshape(1, 12, 2)
    (gx,) = torch.autograd.grad(y, x, g)
    np.testing.assert_array_equal(gx.numpy(),
                                  g.reshape(1, 3, 4, 2).sum(2).numpy())
    assert thc.interp_repeat(x, 1) is x


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

OP_MODES = [(False, "fine-q"), (True, "coarse-q")]
OP_IDS = ["bidir", "coarse-q"]


def _op_inputs(B, G, L, seed, pad):
    rng, (q, k, v, _) = _inputs(B, G, L, 16, seed=seed, pad=0)
    w = np.ones((B, L), np.float32)
    w[-1, L - pad:] = 0.0
    w[0, :2] = 0.5                          # fractional weights too
    return rng, (q, k, v, w)


@pytest.mark.parametrize("causal,causal_mode", OP_MODES, ids=OP_IDS)
@pytest.mark.parametrize("L,nr,G,pad", [(64, 8, 1, 13), (256, 16, 2, 70),
                                        (256, 8, 1, 200), (8, 8, 2, 3)])
def test_h1d_attention_modes_match_jax(causal, causal_mode, L, nr, G, pad):
    """Forward of the whole operator (every level, coarsened queries,
    ``interp_repeat``, the combine; L == nr runs the dense branch)."""
    _, (q, k, v, w) = _op_inputs(2, G, L, seed=L + nr + G, pad=pad)
    want = jax.jit(functools.partial(
        jatt.h1d_attention, nr=nr, causal=causal, causal_mode=causal_mode,
        impl="jnp"))(q, k, v, kv_weight=w)
    got = tatt.h1d_attention(*_t(q, k, v), nr=nr, causal=causal,
                             causal_mode=causal_mode,
                             kv_weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,causal_mode", OP_MODES, ids=OP_IDS)
@pytest.mark.parametrize("L,nr,G,pad", [(64, 8, 1, 13), (256, 16, 2, 70),
                                        (8, 8, 1, 3)])
def test_h1d_attention_mode_grads_match_jax(causal, causal_mode, L, nr, G,
                                            pad):
    """Gradient of the whole operator with respect to q, k, v and the key
    weights, against ``jax.grad`` of ``h1d_attention(impl='jnp')``."""
    rng, (q, k, v, w) = _op_inputs(2, G, L, seed=7 * L + G, pad=pad)
    r = rng.standard_normal((2, G, L, 16)).astype(np.float32)

    def jloss(q, k, v, w):
        z = jatt.h1d_attention(q, k, v, nr=nr, causal=causal,
                               causal_mode=causal_mode, kv_weight=w,
                               impl="jnp")
        return (z * r).sum()
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(q, k, v, w)
    ts = [t.requires_grad_(True) for t in _t(q, k, v, w)]
    z = tatt.h1d_attention(*ts[:3], nr=nr, causal=causal,
                           causal_mode=causal_mode, kv_weight=ts[3])
    got = torch.autograd.grad((z * torch.from_numpy(r)).sum(), ts)
    for name, a, b in zip(("q", "k", "v", "kv_weight"), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,causal_mode", OP_MODES, ids=OP_IDS)
def test_h1d_attention_mha_modes_match_jax(causal, causal_mode):
    """(B, L, H, D) layout with GQA and a padding mask."""
    rng = np.random.default_rng(11)
    B, L, Hq, Hkv, D = 2, 128, 4, 2, 16
    q = rng.standard_normal((B, L, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    w = np.ones((B, L), np.float32)
    w[1, 90:] = 0.0
    want = jax.jit(functools.partial(
        jatt.h1d_attention_mha, nr=8, causal=causal,
        causal_mode=causal_mode))(q, k, v, kv_weight=w)
    got = tatt.h1d_attention_mha(*_t(q, k, v), nr=8, causal=causal,
                                 causal_mode=causal_mode,
                                 kv_weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_causal_mode_raises():
    q, k, v, _ = _t(*_inputs(1, 1, 32, 8, seed=0, pad=1)[1])
    with pytest.raises(ValueError):
        tatt.h1d_attention(q, k, v, nr=8, causal=True, causal_mode="fine")


# ---------------------------------------------------------------------------
# ListOps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,step", [
    (dict(seq_len=256, batch_per_host=4, seed=0, max_depth=4, breadth=3), 0),
    (dict(seq_len=256, batch_per_host=4, seed=0, max_depth=4, breadth=3), 7),
    (dict(seq_len=512, batch_per_host=3, seed=999), 0),
    (dict(seq_len=128, batch_per_host=2, seed=5, host_id=1), 2)])
def test_listops_batches_equal_reference(kw, step):
    want = jlistops.ListOps(**kw).batch(step)
    got = ListOps(**kw).batch(step)
    assert set(got) == set(want) == {"tokens", "label", "mask"}
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# the LRA encoder classifier
# ---------------------------------------------------------------------------

ADAM_STEPS = 3


def _bench_optimizers(n_steps):
    """The optimizer of ``benchmarks/bench_lra_listops.py``: AdamW, peak
    2e-3, warmup 10, weight decay 0.01 (clip 1.0 by default)."""
    return (jopt.adamw(jopt.cosine_schedule(2e-3, 10, n_steps),
                       weight_decay=0.01),
            topt.adamw(topt.cosine_schedule(2e-3, 10, n_steps),
                       weight_decay=0.01))


@pytest.fixture(scope="module")
def encoder():
    """Both classifiers from one JAX init of the smoke encoder (2 layers,
    d 64, nr 8) on ListOps(seq_len=256) batches: logits and gradients of
    batch 0, then ADAM_STEPS AdamW steps on batches 0.. of each."""
    jcfg = jax_smoke(ENCODER)
    tcfg = get_smoke_config(ENCODER)
    jparams, _ = jcls.classifier_init(jax.random.PRNGKey(0), jcfg,
                                      NUM_CLASSES)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    data = ListOps(seq_len=256, batch_per_host=4, seed=0, max_depth=4,
                   breadth=3)
    b0 = data.batch(0)
    jlogits = jax.jit(lambda p, b: jcls.classifier_logits(
        p, jcfg, b["tokens"], b["mask"]))(jparams, b0)
    kernels.reset_counts()
    tlogits = classifier_logits(tparams, tcfg, torch.from_numpy(b0["tokens"]),
                                torch.from_numpy(b0["mask"]))
    fwd_calls = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}

    jgrad = jax.jit(jax.grad(lambda p, b: jcls.classifier_loss(
        p, jcfg, b)[0]))(jparams, b0)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tparams)]
    tl, tm = classifier_loss(tree_unflatten_like(tparams, leaves), tcfg,
                             tloop.batch_to_device(b0, "cpu"))
    tgrad = tree_unflatten_like(tparams,
                                list(torch.autograd.grad(tl, leaves)))
    jl, jm = jax.jit(lambda p, b: jcls.classifier_loss(p, jcfg, b))(
        jparams, b0)

    jopt_, topt_ = _bench_optimizers(ADAM_STEPS)

    @jax.jit
    def jstep(params, opt_state, batch):
        (loss, _), g = jax.value_and_grad(
            lambda p: jcls.classifier_loss(p, jcfg, batch),
            has_aux=True)(params)
        upd, opt_state = jopt_.update(g, opt_state, params)
        return jopt.apply_updates(params, upd), opt_state, loss

    jp, js = jparams, jopt_.init(jparams)
    tp, ts = tparams, topt_.init(tparams)
    losses = []
    for i in range(ADAM_STEPS):
        b = data.batch(i)
        jp, js, jloss = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
        loss, _ = classifier_loss(tree_unflatten_like(tp, leaves), tcfg,
                                  tloop.batch_to_device(b, "cpu"))
        g = tree_unflatten_like(tp, list(torch.autograd.grad(loss, leaves)))
        upd, ts = topt_.update(g, ts, tp)
        tp = topt.apply_updates(tp, upd)
        losses.append((float(jloss), float(loss.detach())))
    return dict(jlogits=np.asarray(jlogits), tlogits=tlogits.detach(),
                fwd_calls=fwd_calls, losses=losses,
                loss0=(float(jl), float(tl.detach())),
                acc0=(float(jm["acc"]), float(tm["acc"])),
                jgrad=params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg,
                                      device="cpu"),
                tgrad=tgrad, tparams=tparams, cfg=tcfg)


def test_classifier_logits_match_reference(encoder):
    got = encoder["tlogits"]
    assert got.shape == (4, NUM_CLASSES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), encoder["jlogits"], **TOL)
    # the encoder ran the bidirectional band modes, never the sub level
    calls = encoder["fwd_calls"]
    assert calls["band_attention_fwd"] > 0
    assert calls["band_attention_sub_fwd"] == 0


def test_classifier_loss_and_acc_match_reference(encoder):
    jl, tl = encoder["loss0"]
    assert abs(jl - tl) <= LOSS_ATOL
    assert encoder["acc0"][0] == encoder["acc0"][1]


def test_classifier_grads_match_reference(encoder):
    """Each leaf within GRAD_RTOL of its own largest |reference| entry;
    the head and every layer are carried."""
    want = dict(tree_flatten_with_paths(encoder["jgrad"]))
    got = tree_flatten_with_paths(encoder["tgrad"])
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        w = want[path].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=path)
    assert "head/w" in want and "layers/1/attn/wq/w" in want


@pytest.mark.parametrize("step", range(ADAM_STEPS))
def test_classifier_adamw_losses_match_reference(encoder, step):
    jl, tl = encoder["losses"][step]
    assert np.isfinite(tl) and abs(jl - tl) <= LOSS_ATOL, (step, jl, tl)


def test_classifier_init_is_seeded_and_shaped():
    cfg = get_smoke_config(ENCODER)
    a = classifier_init(cfg, NUM_CLASSES, seed=3, device="cpu")
    b = classifier_init(cfg, NUM_CLASSES, seed=3, device="cpu")
    assert a["head"]["w"].shape == (cfg.d_model, NUM_CLASSES)
    assert len(a["layers"]) == cfg.num_layers
    for (pa, x), (pb, y) in zip(tree_flatten_with_paths(a),
                                tree_flatten_with_paths(b)):
        assert pa == pb and torch.equal(x, y)
    with pytest.raises(RuntimeError):       # cuda by default, no card here
        classifier_init(cfg, NUM_CLASSES, seed=3)


def test_classifier_pooling_ignores_padding():
    """Tokens past the mask change nothing: the keys are weighted out of
    every layer and the pooling."""
    cfg = get_smoke_config(ENCODER)
    params = classifier_init(cfg, NUM_CLASSES, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 16, (2, 64)).astype(np.int32)
    mask = np.zeros((2, 64), np.float32)
    mask[0, :40] = mask[1, :17] = 1.0
    other = tok.copy()
    other[mask == 0] = 7
    a, b = (classifier_logits(params, cfg, torch.from_numpy(t),
                              torch.from_numpy(mask)) for t in (tok, other))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the coarse-q LM
# ---------------------------------------------------------------------------

def test_coarse_q_prefill_matches_reference():
    """A coarse-q LM layer's ``prefill_into_cache`` against the
    reference's on the same weights and inputs (S = 45, padded to 64
    with weight-0 keys, Lmax 64): the attention output within TOL (it
    ran level 0 in ``l0_causal`` and every coarse level in
    ``coarse_causal``, never ``sub``), and the fine-q decode cache built
    from the prefix's keys and values within TOL at every level."""
    import dataclasses
    jattn = importlib.import_module("repro.models.attention")
    tattn = importlib.import_module("repro_torch.models.attention")
    jcfg = dataclasses.replace(jax_smoke(LM), causal_mode="coarse-q")
    tcfg = dataclasses.replace(get_smoke_config(LM), causal_mode="coarse-q")
    jparams, _ = jax_model(jcfg).init(jax.random.PRNGKey(5), jcfg)
    jp = jax.tree.map(lambda a: np.asarray(a)[0], jparams["layers"]["attn"])
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                         device="cpu")["layers"][0]["attn"]
    rng = np.random.default_rng(11)
    B, S = 2, 45
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, jcache = jax.jit(functools.partial(
        jattn.prefill_into_cache, cfg=jcfg, Lmax=64))(jp, x=x,
                                                      positions=pos)
    kernels.reset_counts()
    tout, tcache = tattn.prefill_into_cache(tp, tcfg, *_t(x, pos), 64)
    assert thb.band_attention_fwd_ref.calls == 1 + 2   # levels 0, 1, 2
    assert thb.band_attention_sub_fwd_ref.calls == 0
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for a, b in zip((tcache.k, tcache.v, *tcache.ck, *tcache.cv),
                    (jcache.k, jcache.v, *jcache.ck, *jcache.cv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_coarse_q_lm_loss_and_grads_match_reference():
    """lm_loss of the smoke LM with causal_mode='coarse-q' (level 0 in
    l0_causal, every coarse level in coarse_causal) against the JAX
    model: the loss, and each gradient leaf within GRAD_RTOL of its
    largest |reference| entry."""
    import dataclasses
    jcfg = dataclasses.replace(jax_smoke(LM), causal_mode="coarse-q")
    tc = tloop.TrainConfig(attn_causal_mode="coarse-q")
    tcfg = tloop.resolve_model_config(get_smoke_config(LM), tc)
    assert tcfg.causal_mode == "coarse-q"
    jparams, _ = jax_model(jcfg).init(jax.random.PRNGKey(2), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 100))
             .astype(np.int32)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model(jcfg).loss(p, jcfg, b)[0]))(jparams, batch)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tparams)]
    kernels.reset_counts()
    tl, _ = get_model(tcfg).loss(tree_unflatten_like(tparams, leaves), tcfg,
                                 tloop.batch_to_device(batch, "cpu"))
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_ATOL
    # 2 layers x (level 0 + coarse levels 1..3 of L = 128, nr 8)
    assert thb.band_attention_fwd_ref.calls == 2 * 4
    assert thbb.band_attention_bwd_ref.calls == 2 * 4
    assert thb.band_attention_sub_fwd_ref.calls == 0
    want = dict(tree_flatten_with_paths(params_from_jax(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu")))
    for (path, _), g in zip(tree_flatten_with_paths(tparams), grads):
        w = want[path].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(w).max()),
                                   err_msg=path)
