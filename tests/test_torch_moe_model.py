"""Port parity of the MoE decoder (``qwen2-moe-a2.7b``'s and
``arctic-480b``'s smoke configs) against the JAX package, through
``params_from_jax``: the loss and its gradients, prefill and greedy
decode, the serving engine on dense slots, the paged pool and 2-way
sequence-parallel shards, and one in-place AdamW step; plus the full
configs' parameter shapes (and llava-next-34b's) on the ``meta`` device
against ``jax.eval_shape`` of the reference's init.

Tolerances (fp32 on both sides): logits 2e-5, the aux loss 1e-6, loss
2e-5, gradients 1e-4 of each leaf's largest |JAX gradient|, greedy
tokens identical (every token's top-2 margin checked above 2e-4, ten
times the logit tolerance, so a near-tie fails loudly instead of
flaking)."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.models.transformer import lm_forward as jax_lm_forward  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import ZipfLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten_like  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "arctic-480b"]
LOGIT_TOL, AUX_TOL, GRAD_TOL = 2e-5, 1e-6, 1e-4
# every greedy token's top-2 margin on the logits the engine took it
# from: 10x the logit tolerance, as tests/test_torch_serve.py's 1e-3
# over 1e-4
MARGIN = 10 * LOGIT_TOL
PROMPT_LENS = [5, 12, 30, 9, 17, 40]


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    cfg = jax_smoke(request.param)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tcfg = get_smoke_config(request.param)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("name", ARCHS + ["llava-next-34b"])
def test_configs_match_jax(name):
    """Full and smoke configs field for field, names included (the smoke
    configs carry their own)."""
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_config(name))
    assert dataclasses.asdict(get_smoke_config(name)) == dataclasses.asdict(
        jax_smoke(name))


def test_params_from_jax_carries_moe_layers(smoke):
    cfg, params, tcfg, tp = smoke
    moe = tp["layers"][1]["moe"]
    assert "mlp" not in tp["layers"][1]
    assert moe["router"].dtype == torch.float32
    for key in ("router", "w1", "w3", "w2"):
        np.testing.assert_array_equal(
            moe[key].numpy(), np.asarray(params["layers"]["moe"][key][1]))
    branch = "shared" if cfg.moe_shared_d_ff else "residual"
    assert set(moe) == {"router", "w1", "w3", "w2", branch} | (
        {"shared_gate"} if branch == "shared" else set())
    np.testing.assert_array_equal(
        moe[branch]["wd"]["w"].numpy(),
        np.asarray(params["layers"]["moe"][branch]["wd"]["w"][1]))
    bad = jax.tree.map(np.asarray, params)
    del bad["layers"]["moe"]["w3"]
    with pytest.raises(KeyError, match="moe.w3"):
        params_from_jax(bad, tcfg, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(smoke, remat):
    """``lm_forward``'s logits and summed aux, ``lm_loss`` and every
    leaf's gradient; with remat (policy ``dots``) the port sums aux
    through the rematerialised layers too."""
    cfg, params, tcfg, tp = smoke
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    batch = {"tokens": tok.astype(np.int32)}
    jfns, tfns = jax_model(cfg), get_model(tcfg)
    jlogits, jaux = jax.jit(functools.partial(
        jax_lm_forward, cfg=cfg))(params, tokens=tok)
    logits, aux = tfns.forward(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL)
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= AUX_TOL

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jfns.loss(p, cfg, batch), has_aux=True))(params)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, m = tfns.loss(tree_unflatten_like(tp, leaves), tcfg,
                        {"tokens": torch.from_numpy(tok)})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= LOGIT_TOL
    assert abs(float(m["aux"].detach()) - float(jm["aux"])) <= AUX_TOL
    # the JAX tree stacks its layers: compare layer by layer
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu")
    assert len(tree_leaves(want)) == len(grads)
    for w, g in zip(tree_leaves(want), grads):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale <= GRAD_TOL


def test_prefill_and_decode_match_jax(smoke):
    """A bucket-padded prefill with per-row true lengths (the MoE's
    capacity follows the bucket's length), then greedy decode steps
    (S = 1, capacity 1): logits and positions against JAX."""
    cfg, params, tcfg, tp = smoke
    Lmax, S = 64, 32
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
    tl = np.array([32, 19, 7], np.int32)
    jf, tf = jax_model(cfg), get_model(tcfg)
    jl, jc, jpos = jax.jit(functools.partial(jf.prefill, cfg=cfg, Lmax=Lmax))(
        params, batch={"tokens": tok}, true_len=tl)
    tl_, tc, tpos = tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                               Lmax, true_len=torch.from_numpy(tl))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    step = jax.jit(functools.partial(jf.decode_step, cfg=cfg))
    pos = tl.copy()
    for _ in range(6):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert (tl_.numpy().argmax(-1) == nxt).all()
        jl, jc = step(params, caches=jc, token=nxt, t=pos)
        tl_, tc = tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        pos = pos + 1


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, make_req, prompts, n_new):
    reqs = [make_req(uid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [list(r.out_tokens) for r in reqs]


def _smallest_margin(eng):
    """Wrap ``eng._sample`` to record the smallest top-2 margin of the
    logits rows it takes a request's token from (the prefill's last
    position, then every decode tick's; a MoE prefill's capacity follows
    its bucket, so a replayed forward would not give these rows)."""
    seen = [float("inf")]
    sample = eng._sample

    def recording(z, rows, reqs, tick):
        for i, r in enumerate(reqs):
            if r is not None:
                top2 = z[i].topk(2).values
                seen[0] = min(seen[0], float(top2[0] - top2[1]))
        return sample(z, rows, reqs, tick)
    eng._sample = recording
    return seen


@pytest.fixture(scope="module")
def jax_tokens(smoke):
    cfg, params, _, _ = smoke
    return _serve(JaxEngine(cfg, params, slots=3, max_len=64), JaxRequest,
                  _prompts(cfg.vocab_size), 6)


@pytest.mark.parametrize("engine", ["dense", "paged", "sp2"])
def test_engine_tokens_match_jax(smoke, jax_tokens, engine):
    """Bucketed prompts (one shorter than nr, several buckets, more
    requests than slots) on dense slots, the paged pool and a 2-way SP
    mesh: the JAX engine's greedy tokens, every one taken from logits
    whose top-2 margin exceeds MARGIN."""
    cfg, params, tcfg, tp = smoke
    kw = {"dense": {}, "paged": dict(paged=True),
          "sp2": dict(mesh=make_mesh((2,), ("data",), device="cpu"))}[engine]
    eng = ServeEngine(tcfg, tp, slots=3, max_len=64, **kw)
    assert eng._bucket
    margin = _smallest_margin(eng)
    got = _serve(eng, Request, _prompts(cfg.vocab_size), 6)
    assert got == jax_tokens
    assert margin[0] > MARGIN


def test_in_place_train_step_matches_reference(smoke):
    """Three AdamW steps from the same converted weights: the reference's
    losses and aux losses; the port's step writes the f32 router, the 3-D
    expert leaves and their moments in place."""
    cfg, params, tcfg, _ = smoke
    tc = dict(peak_lr=1e-3, warmup=2, total_steps=10, ckpt_every=0)
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
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=48, batch_per_host=2,
                  seed=2)
    jstep = jax.jit(jloop.make_train_step(cfg, jtc))
    tstep = tloop.make_train_step(tcfg, ttc)
    for i in range(3):
        b = data.batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, tloop.batch_to_device(b, "cpu"))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOGIT_TOL, i
        assert abs(float(jm["aux"]) - float(tm["aux"])) <= AUX_TOL, i
    assert [t.data_ptr() for t in tree_leaves(
        (tstate.params, tstate.opt_state[1:]))] == ptrs
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                           device="cpu")
    for w, g in zip(tree_leaves(want), tree_leaves(tstate.params)):
        assert float((g - w).abs().max()) <= 1e-5


def test_train_cli_reports_aux(capsys, tmp_path):
    from repro_torch.launch import train as train_cli
    state = train_cli.main(["--arch", "qwen2-moe-a2.7b", "--smoke",
                            "--device", "cpu", "--steps", "2", "--batch",
                            "2", "--seq", "32", "--ckpt-every", "0",
                            "--ckpt-dir", str(tmp_path / "ck")])
    assert int(state.step) == 2
    out = capsys.readouterr().out
    assert "aux=" in out and "qwen2-moe-smoke" in out


# ---------------------------------------------------------------------------
# full-size shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,billions", [("qwen2-moe-a2.7b", 14.32),
                                           ("arctic-480b", 476.85),
                                           ("llava-next-34b", 34.39)])
def test_full_size_shapes_on_meta_match_jax(name, billions):
    """The port's init on the ``meta`` device (nothing drawn) gives every
    leaf the shape and dtype of ``jax.eval_shape`` of the reference's
    ``lm_init``, layer by layer (the reference stacks its layers)."""
    from repro.models.transformer import lm_init as jax_lm_init
    cfg = jax_config(name)
    shapes = jax.eval_shape(lambda k: jax_lm_init(k, cfg)[0],
                            jax.random.PRNGKey(0))
    tcfg = get_config(name)
    tp = get_model(tcfg).init(tcfg, seed=0, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(tp))
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    got = {}
    for path, sds in flat.items():
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "layers":
            for i, lp in enumerate(tp["layers"]):
                leaf = lp
                for k in keys[1:]:
                    leaf = leaf[k]
                assert tuple(leaf.shape) == sds.shape[1:], (keys, i)
                assert str(leaf.dtype).split(".")[-1] == sds.dtype.name
                got[(tuple(keys), i)] = leaf.numel()
        else:
            leaf = tp
            for k in keys:
                leaf = leaf[k]
            assert tuple(leaf.shape) == sds.shape, keys
            assert str(leaf.dtype).split(".")[-1] == sds.dtype.name
            got[tuple(keys)] = leaf.numel()
    assert len(got) == len(tree_leaves(tp))
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == sum(int(np.prod(s.shape)) for s in flat.values())
    assert round(n / 1e9, 2) == billions
