"""Shared checks of the port's SSM (mamba2) and hybrid (zamba2) smoke
models against the JAX package, used by ``test_torch_ssm_model.py`` and
``test_torch_hybrid.py`` (one file per family, so that a distributed run
takes them side by side).

Tolerances (fp32 on both sides): logits and the loss 2e-5 (LOGIT_TOL),
gradients 1e-4 of each leaf's largest |JAX gradient| (GRAD_TOL), SSM
states 1e-5 of their largest entry, hierarchical caches 1e-4 absolute
(as ``test_torch_model.py`` holds them), greedy tokens identical with
every token's top-2 margin above 2 x LOGIT_TOL (two paths whose logits
differ by at most LOGIT_TOL each take the same argmax there)."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.train import loop as jloop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import ZipfLM
from repro_torch.interop import params_from_jax
from repro_torch.models import get_model
from repro_torch.models.ssm import SSMState
from repro_torch.optim import cosine_schedule
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_leaves, tree_unflatten_like

LOGIT_TOL, GRAD_TOL, STATE_TOL, CACHE_ATOL = 2e-5, 1e-4, 1e-5, 1e-4
MARGIN = 2 * LOGIT_TOL
# none a multiple of the smoke configs' ssm_chunk (16): chunks 1 and 7
SERVE_LENS = (13, 21, 30)


def smoke(arch):
    """(JAX config, JAX params, port config, the port's copy)."""
    cfg = jax_smoke(arch)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tcfg = get_smoke_config(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def configs_match(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        jax_smoke(arch))


def jax_layers(cfg, params):
    """The JAX tree's layers as a list (an ssm stack is stacked)."""
    layers = params["layers"]
    if isinstance(layers, dict):
        return [jax.tree.map(lambda a, i=i: a[i], layers)
                for i in range(cfg.num_layers)]
    return layers


def params_round_trip(smoke_):
    """Every layer's norm and mixer leaf equal to JAX's, in JAX's dtype
    (A_log, D, dt_bias float32); a missing mixer leaf raises."""
    cfg, params, tcfg, tp = smoke_
    jl = jax_layers(cfg, params)
    assert len(tp["layers"]) == len(jl) == cfg.num_layers
    for t, j in zip(tp["layers"], jl):
        assert set(t) == {"ln", "mixer"}
        assert set(t["mixer"]) == set(j["mixer"])
        for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("A_log", "D", "dt_bias"):
        assert tp["layers"][0]["mixer"][k].dtype == torch.float32
    bad = jax.tree.map(np.asarray, params)
    layer = (bad["layers"] if isinstance(bad["layers"], dict)
             else bad["layers"][0])
    del layer["mixer"]["dt_bias"]
    try:
        params_from_jax(bad, tcfg, device="cpu")
    except KeyError as e:
        assert "mixer.dt_bias" in str(e)
    else:
        raise AssertionError("a tree without dt_bias was taken")


def _jax_grads(cfg, params, tok):
    jfns = jax_model(cfg)
    jlogits, _ = jax.jit(functools.partial(jax_lm_forward, cfg=cfg))(
        params, tokens=tok)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jfns.loss(p, cfg, {"tokens": tok}), has_aux=True))(params)
    return np.asarray(jlogits), float(jloss), jgrads


def loss_and_gradients(smoke_, remat, cache):
    """``lm_forward``'s logits, ``lm_loss`` and every leaf's gradient
    against ``jax.grad`` of the reference's loss, with the port's remat
    on or off (JAX's side is computed once, into ``cache``)."""
    cfg, params, tcfg, tp = smoke_
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                            (2, 40)).astype(np.int32)
    if "jax" not in cache:
        cache["jax"] = _jax_grads(cfg, params, tok)
    jlogits, jloss, jgrads = cache["jax"]
    tfns = get_model(tcfg)
    logits, aux = tfns.forward(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               atol=LOGIT_TOL)
    assert aux == 0.0
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, _ = tfns.loss(tree_unflatten_like(tp, leaves), tcfg,
                        {"tokens": torch.from_numpy(tok)})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jloss) <= LOGIT_TOL
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu")
    assert len(tree_leaves(want)) == len(grads)
    for w, g in zip(tree_leaves(want), grads):
        assert torch.isfinite(g).all()
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale <= GRAD_TOL


def _close_state(got: SSMState, want):
    assert isinstance(got, SSMState)
    assert got.h.dtype == torch.float32
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a.numpy() - b).max()) / scale <= STATE_TOL


def _close_caches(cfg, got, want):
    """The port's per-layer cache list against JAX's (a stacked tree for
    an ssm stack, a list for a hybrid): SSM states and H1D caches."""
    if not isinstance(want, list):          # stacked (h, conv)
        want = [jax.tree.map(lambda a, i=i: a[i], want)
                for i in range(cfg.num_layers)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (tuple, list)) and not hasattr(w, "k"):
            _close_state(g, w)
            continue
        for a, b in zip([g.k, g.v, *g.ck, *g.cv], jax.tree.leaves(w)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=CACHE_ATOL)


def prefill_and_decode(smoke_):
    """A 37-token prefill (chunk 1) of two rows, then 3 greedy decode
    steps: logits, positions, every SSM state and H1D cache against
    JAX."""
    cfg, params, tcfg, tp = smoke_
    Lmax, S = 64, 37
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, S)).astype(np.int32)
    jf, tf = jax_model(cfg), get_model(tcfg)
    jl, jc, jpos = jax.jit(functools.partial(jf.prefill, cfg=cfg,
                                             Lmax=Lmax))(
        params, batch={"tokens": tok})
    tl, tc, tpos = tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                              Lmax)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _close_caches(cfg, tc, jc)
    step = jax.jit(functools.partial(jf.decode_step, cfg=cfg))
    pos = np.asarray(jpos).astype(np.int32)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert (tl.numpy().argmax(-1) == nxt).all()
        jl, jc = step(params, caches=jc, token=nxt, t=pos)
        tl, tc = tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        _close_caches(cfg, tc, jc)
        pos = pos + 1
    fresh = tf.init_caches(tp, tcfg, 2, Lmax)
    assert [type(c) for c in fresh] == [type(c) for c in tc]
    for a, b in zip(tree_leaves(fresh), tree_leaves(tc)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert not a.any()


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in SERVE_LENS]


def jax_manual_greedy(cfg, params, n_new, max_len):
    """The reference's manual greedy loop (``tests/test_serve.py``'s
    ``manual_greedy``): each prompt prefilled alone, then decoded token
    by token."""
    fns = jax_model(cfg)
    prefill = jax.jit(lambda p, b: fns.prefill(p, cfg, b, max_len))
    decode = jax.jit(lambda p, c, tok, pos: fns.decode_step(p, cfg, c, tok,
                                                            pos))
    outs = []
    for prompt in _prompts(cfg.vocab_size):
        logits, caches, pos = prefill(params,
                                      {"tokens": jnp.asarray(prompt)[None]})
        out = [int(jnp.argmax(logits[0]))]
        for _ in range(n_new - 1):
            logits, caches = decode(params, caches,
                                    jnp.array([out[-1]], jnp.int32), pos)
            out.append(int(jnp.argmax(logits[0])))
            pos = pos + 1
        outs.append(out)
    return outs


def engine_tokens(smoke_, n_new=6, max_len=64):
    """``ServeEngine`` at 2 slots on 3 unbucketed requests (one waits for
    a slot, whose SSM state idled a tick): the JAX manual greedy
    tokens, each from logits whose top-2 margin exceeds MARGIN."""
    cfg, params, tcfg, tp = smoke_
    want = jax_manual_greedy(cfg, params, n_new, max_len)
    eng = ServeEngine(tcfg, tp, slots=2, max_len=max_len)
    assert not eng._bucket
    assert eng._bucket_len(13) == 13
    margin = [float("inf")]
    sample = eng._sample

    def recording(z, rows, reqs, tick):
        for i, r in enumerate(reqs):
            if r is not None:
                top2 = z[i].topk(2).values
                margin[0] = min(margin[0], float(top2[0] - top2[1]))
        return sample(z, rows, reqs, tick)
    eng._sample = recording
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(_prompts(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert [list(r.out_tokens) for r in reqs] == want
    assert margin[0] > MARGIN
    assert all(isinstance(c, SSMState) for c in eng.caches[:1])


def paged_refused_sp_serves(smoke_):
    """Paged serving refuses the family (a ValueError, as for any
    non-uniform stack); a 2-way SP mesh serves it, every SSM state whole
    and only a hybrid's shared-block caches sharded, with the mesh-free
    engine's tokens (``test_torch_sp_families.py`` holds them to the JAX
    engine's)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sp_attention import SPCache
    _, _, tcfg, tp = smoke_
    try:
        ServeEngine(tcfg, tp, slots=2, max_len=64, paged=True)
    except ValueError as e:
        assert "uniform h1d attention stack" in str(e)
    else:
        raise AssertionError("paged serving was not refused")
    outs = []
    for mesh in (None, make_mesh((2,), ("data",), device="cpu")):
        eng = ServeEngine(tcfg, tp, slots=2, max_len=64, mesh=mesh)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=3)
                for i, p in enumerate(_prompts(tcfg.vocab_size))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]
    kinds = {type(c) for c in eng.caches}
    assert kinds == ({SSMState, SPCache} if tcfg.family == "hybrid"
                     else {SSMState})


def train_steps(arch):
    """Three AdamW steps from the same converted weights: the reference's
    losses, every parameter and moment updated in place, and every weight
    after them within 2 % of the farthest the steps can move it (the sum
    of their learning rates: AdamW's normalised update moves an entry by
    at most its rate a step, and an entry whose gradient sits below
    GRAD_TOL of its leaf's largest may take any sign in either run)."""
    cfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    tc = dict(peak_lr=1e-3, warmup=2, total_steps=10, ckpt_every=0)
    jtc = jloop.TrainConfig(attn_impl="jnp", **tc)
    jstate, _ = jloop.init_state(jax.random.PRNGKey(1), cfg, jtc)
    ttc = tloop.TrainConfig(**tc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                              device="cpu")
    opt = tloop.make_optimizer(ttc)
    opt_lr = cosine_schedule(ttc.peak_lr, ttc.warmup, ttc.total_steps)
    tstate = tloop.TrainState(torch.zeros((), dtype=torch.int32), tparams,
                              opt.init(tparams), None)
    ptrs = [t.data_ptr() for t in tree_leaves((tstate.params,
                                               tstate.opt_state[1:]))]
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=48, batch_per_host=2,
                  seed=2)
    jstep = jax.jit(jloop.make_train_step(cfg, jtc))
    tstep = tloop.make_train_step(tcfg, ttc)
    for i in range(3):
        b = data.batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, tloop.batch_to_device(b, "cpu"))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOGIT_TOL, i
    assert [t.data_ptr() for t in tree_leaves(
        (tstate.params, tstate.opt_state[1:]))] == ptrs
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                           device="cpu")
    reach = sum(float(opt_lr(i)) for i in range(3))
    for w, g in zip(tree_leaves(want), tree_leaves(tstate.params)):
        assert g.dtype == w.dtype
        assert float((g - w).abs().max()) <= 2e-2 * reach


def clis(arch, capsys, tmp_path):
    """Both CLIs on the smoke config, and ``--layers`` cutting the
    depth."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    reqs = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2",
                           "--new-tokens", "3", "--max-len", "64"])
    assert [len(r.out_tokens) for r in reqs] == [3, 3, 3]
    name = get_smoke_config(arch).name
    assert name in capsys.readouterr().out
    state = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--steps", "2", "--batch", "2", "--seq", "32",
                            "--layers", "3", "--ckpt-every", "0",
                            "--ckpt-dir", str(tmp_path / "ck")])
    assert int(state.step) == 2
    assert len(state.params["layers"]) == 3
    assert name in capsys.readouterr().out


def meta_shapes(arch, n_params):
    """The port's full-size init on the ``meta`` device: every leaf the
    shape and dtype of ``jax.eval_shape`` of the reference's init (its
    stacked layers one by one), ``n_params`` parameters in all."""
    from repro.models.transformer import lm_init as jax_lm_init
    cfg = jax_config(arch)
    shapes = jax.eval_shape(lambda k: jax_lm_init(k, cfg)[0],
                            jax.random.PRNGKey(0))
    tcfg = get_config(arch)
    tp = get_model(tcfg).init(tcfg, seed=0, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(tp))
    jl = shapes["layers"]
    stacked = isinstance(jl, dict)
    flat = []
    for k in sorted(shapes):
        if k != "layers":
            flat += jax.tree.leaves(shapes[k])
            continue
        for i in range(cfg.num_layers):
            flat += ([jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
                      for s in jax.tree.leaves(jl)] if stacked
                     else jax.tree.leaves(jl[i]))
    got = tree_leaves(tp)
    assert len(got) == len(flat)
    for t, s in zip(got, flat):
        assert tuple(t.shape) == tuple(s.shape)
        assert str(t.dtype).split(".")[-1] == s.dtype.name
    assert sum(t.numel() for t in got) == n_params
