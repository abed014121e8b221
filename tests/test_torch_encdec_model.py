"""Port parity of the encoder-decoder model (``seamless-m4t-medium``'s
smoke config) against the JAX package, through ``params_from_jax``: the
teacher-forced logits and the loss over padded frames, every leaf's
gradient with and without remat, the prefill (logits, encoder memory,
self caches), greedy decoding at B = 2 and one in-place AdamW step
against ``repro.train.loop``'s.  fp32 on both sides, the JAX side on
``attn_impl='jnp'``; the tolerances are ``_torch_family``'s: logits and
loss 2e-5, gradients 1e-4 of each leaf's largest |JAX gradient|, caches
1e-4 absolute, greedy tokens identical where every step's top-2 margin
exceeds 4e-5."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_family as fam  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import cosine_schedule  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten_like  # noqa: E402

ARCH = "seamless-m4t-medium"
# 45 frames pad to 64 (8 levels of nr 8); row 1's frames live to 30
SE, LIVE, SD = 45, (45, 30), 24


@pytest.fixture(scope="module")
def smoke():
    return fam.smoke(ARCH)


def _batch(cfg, seed=0):
    frames, fw = ted.stub_frames(cfg, 2, SE, seed=seed, true_len=LIVE)
    tok = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (2, SD)).astype(np.int32)
    return {"frames": frames, "tokens": tok, "frame_weight": fw}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side(smoke):
    """The reference's logits, loss and gradients on ``_batch``."""
    cfg, params, _, _ = smoke
    b = _batch(cfg)

    def logits(p):
        enc = jed.encode(p, cfg, b["frames"], frame_weight=b["frame_weight"])
        return jed.decode_train(p, cfg, b["tokens"], enc,
                                enc_weight=b["frame_weight"])
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jed.encdec_loss(p, cfg, b), has_aux=True))(params)
    return np.asarray(jax.jit(logits)(params)), float(loss), grads


def test_forward_matches_jax(smoke, jax_side):
    """``encdec_forward``: teacher-forced logits (B, Sd, V) in float32
    within 2e-5 of ``decode_train(encode(...))``'s, and aux 0."""
    _, _, tcfg, tp = smoke
    logits, aux = get_model(tcfg).forward(tp, tcfg, _torch(_batch(tcfg)))
    assert logits.dtype == torch.float32 and aux == 0.0
    np.testing.assert_allclose(logits.detach().numpy(), jax_side[0],
                               atol=fam.LOGIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(smoke, jax_side, remat):
    """``encdec_loss`` within 2e-5 and the gradient of every leaf (the
    embedding, the head, both norms, every encoder and decoder layer's
    cross-attention included) within 1e-4 of its largest |JAX gradient|,
    with each layer rematerialised or not."""
    _, _, tcfg, tp = smoke
    tcfg = dataclasses.replace(tcfg, remat=remat)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, metrics = get_model(tcfg).loss(tree_unflatten_like(tp, leaves),
                                         tcfg, _torch(_batch(tcfg)))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jax_side[1]) <= fam.LOGIT_TOL
    assert float(metrics["nll"].detach()) == float(loss.detach())
    want = params_from_jax(jax.tree.map(np.asarray, jax_side[2]), tcfg,
                           device="cpu")
    assert len(tree_leaves(want)) == len(grads)
    for w, g in zip(tree_leaves(want), grads):
        assert torch.isfinite(g).all()
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale <= fam.GRAD_TOL


def _prefill_batch(cfg, seed=7, Sp=8):
    """Two clips of SE frames, row 1's zero past LIVE[1] (a padded clip:
    the prefill takes no frame weights, as the reference's does not), and
    an 8-token target prefix each."""
    frames, _ = ted.stub_frames(cfg, 2, SE, seed=seed)
    frames[1, LIVE[1]:] = 0.0
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, Sp)).astype(np.int32)
    return {"frames": frames, "tokens": tok}


def _close_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == {"self", "mem_k", "mem_v"}
        for k in ("mem_k", "mem_v"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=fam.CACHE_ATOL)
        s = g["self"]
        for a, b in zip([s.k, s.v, *s.ck, *s.cv],
                        jax.tree.leaves(w["self"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=fam.CACHE_ATOL)


LMAX = 64


def test_prefill_matches_jax(smoke):
    """Encoder plus decoder prefill of an 8-token prefix: the last
    logits within 2e-5, every layer's encoder memory and hierarchical
    self cache (every level) within 1e-4, the positions Sd."""
    cfg, params, tcfg, tp = smoke
    b = _prefill_batch(cfg)
    jl, jc, jpos = jax.jit(functools.partial(jax_model(cfg).prefill,
                                             cfg=cfg, Lmax=LMAX))(
        params, batch=b)
    tl, tc, tpos = get_model(tcfg).prefill(tp, tcfg, _torch(b), LMAX)
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=fam.LOGIT_TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tc[0]["mem_k"].shape == (2, SE, cfg.num_kv_heads, cfg.head_dim)
    _close_caches(tc, jc)


def test_greedy_decode_matches_jax(smoke):
    """Prefill, then 8 greedy decode steps at B = 2: every step's logits
    within 2e-5 and its caches within 1e-4 of the reference's, the same
    tokens, each from JAX logits whose top-2 margin exceeds 4e-5."""
    cfg, params, tcfg, tp = smoke
    b = _prefill_batch(cfg)
    fns, tfns = jax_model(cfg), get_model(tcfg)
    jl, jc, pos = jax.jit(functools.partial(fns.prefill, cfg=cfg,
                                            Lmax=LMAX))(params, batch=b)
    tl, tc, _ = tfns.prefill(tp, tcfg, _torch(b), LMAX)
    step = jax.jit(functools.partial(fns.decode_step, cfg=cfg))
    pos = np.asarray(pos).astype(np.int32)
    margin, toks = float("inf"), []
    for _ in range(8):
        jln = np.asarray(jl)
        top2 = np.sort(jln, -1)[:, -2:]
        margin = min(margin, float((top2[:, 1] - top2[:, 0]).min()))
        nxt = jln.argmax(-1).astype(np.int32)
        assert (tl.numpy().argmax(-1) == nxt).all()
        toks.append(nxt)
        jl, jc = step(params, caches=jc, token=nxt, t=pos)
        tl, tc = tfns.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                  torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=fam.LOGIT_TOL)
        pos = pos + 1
    _close_caches(tc, jc)
    assert margin > fam.MARGIN
    assert len({tuple(t) for t in np.stack(toks, 1)}) == 2  # rows differ


def test_in_place_adamw_step_matches_reference():
    """One step of ``make_train_step`` (the in-place AdamW, the clip on)
    against ``repro.train.loop``'s on the same frames batch from the same
    weights: the loss within 2e-5; the first moment (0.1 x the clipped
    gradient) within 1e-4 of each leaf's largest |reference| and the
    second within 2e-4; every parameter and moment updated in place;
    each weight whose clipped gradient is at least 100 x AdamW's eps
    within 2 % of the learning rate of the reference's (AdamW's first
    step moves an entry by lr g / (|g| + eps): below that the ratio, and
    so the update, follows gradient noise of the size the gradient check
    admits, anywhere in [-lr, lr]); ``batch_to_device`` carries the float
    frames and frame weights beside the int tokens."""
    cfg, tcfg = fam.jax_smoke(ARCH), get_smoke_config(ARCH)
    tc = dict(peak_lr=1e-3, warmup=0, total_steps=10, ckpt_every=0)
    jtc = jloop.TrainConfig(attn_impl="jnp", **tc)
    jstate, _ = jloop.init_state(jax.random.PRNGKey(1), cfg, jtc)
    ttc = tloop.TrainConfig(**tc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                              device="cpu")
    opt = tloop.make_optimizer(ttc)
    tstate = tloop.TrainState(torch.zeros((), dtype=torch.int32), tparams,
                              opt.init(tparams), None)
    ptrs = [t.data_ptr() for t in tree_leaves((tstate.params,
                                               tstate.opt_state[1:]))]
    before = [t.clone() for t in tree_leaves(tstate.params)]
    b = _batch(cfg, seed=4)
    tb = tloop.batch_to_device(b, "cpu")
    assert tb["frames"].dtype == tb["frame_weight"].dtype == torch.float32
    assert tb["tokens"].dtype == torch.int32
    jstate, jm = jax.jit(jloop.make_train_step(cfg, jtc))(
        jstate, jax.tree.map(jnp.asarray, b))
    tstate, tm = tloop.make_train_step(tcfg, ttc)(tstate, tb)
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= fam.LOGIT_TOL
    assert int(tstate.step) == 1
    assert [t.data_ptr() for t in tree_leaves(
        (tstate.params, tstate.opt_state[1:]))] == ptrs

    def port(tree):
        return tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree),
                                           tcfg, device="cpu"))
    mu, nu = port(jstate.opt_state.mu), port(jstate.opt_state.nu)
    for got, want, tol in ((tstate.opt_state.mu, mu, fam.GRAD_TOL),
                           (tstate.opt_state.nu, nu, 2 * fam.GRAD_TOL)):
        for g, w in zip(tree_leaves(got), want):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) / scale <= tol
    lr = float(cosine_schedule(ttc.peak_lr, ttc.warmup, ttc.total_steps)(0))
    for w, g, b0, m in zip(port(jstate.params), tree_leaves(tstate.params),
                           before, mu):
        assert g.dtype == w.dtype
        assert not torch.equal(g, b0)
        sure = (m / 0.1).abs() >= 100 * 1e-8
        assert float((g - w).abs()[sure].max()) <= 2e-2 * lr
