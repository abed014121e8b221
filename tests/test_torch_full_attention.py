"""Port parity of ``attention='full'`` (the paper's baseline) against the
JAX package on the same numpy inputs and weights: the smoke LM (2
layers, d 64, 4 q heads on 2 kv-heads) with full attention -- its loss
and gradients, prefill, decode and dense cache, and the serving engine's
greedy tokens -- and the smoke LRA encoder with full attention and with
full attention inside a 16-token window (Table 1's "local" encoder).

Tolerances: loss and attention outputs 2e-5 absolute / 1e-4 relative
(fp32 on both sides, another summation order), gradients 1e-4 of each
leaf's largest |reference| entry, logits 1e-4 absolute (the port's
forward tolerance), cache positions and greedy tokens exactly."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import classifier as jcls  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.models.common import dense_apply, rmsnorm_apply  # noqa: E402
from repro.models.ffn import mlp_apply  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import ListOps  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.classifier import classifier_logits  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,  # noqa: E402
                              tree_unflatten_like)

ARCH = "h1d-lm-53m"
ENCODER = "h1d-lra-encoder"
TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_RTOL = 1e-4
LOGIT_ATOL = 1e-4
MARGIN = 1e-3
FULL = dict(attention="full", num_kv_heads=2)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(jax_smoke(ARCH), **FULL)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(4), cfg)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), **FULL)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def test_layer_matches_jax_causal_and_bidirectional(smoke):
    """One full layer (GQA 2) on S = 37 with weight-0 keys, causal and
    bidirectional, through no band kernel."""
    cfg, params, tcfg, tparams = smoke
    jp = jax.tree.map(lambda a: np.asarray(a)[0], params["layers"]["attn"])
    tp = tparams["layers"][0]["attn"]
    rng = np.random.default_rng(3)
    B, S = 2, 37
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    w = np.ones((B, S), np.float32)
    w[1, 30:] = 0.0
    kernels.reset_counts()
    for causal in (True, False):
        want = jax.jit(functools.partial(jattn.attn_apply, cfg=cfg,
                                         causal=causal))(
            jp, x=x, positions=pos, kv_weight=w)
        got = tattn.attn_apply(tp, tcfg, *_t(x, pos), causal=causal,
                               kv_weight=torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert all(p.calls == 0 for _, p in kernels.KERNELS.values())


def test_loss_and_grads_match_jax(smoke):
    cfg, params, tcfg, tparams = smoke
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40))
    mask = np.ones((2, 40), np.float32)
    mask[1, 33:] = 0.0
    batch = {"tokens": tok.astype(np.int32), "loss_mask": mask}
    jloss = jax_model(cfg).loss
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, cfg, b), has_aux=True))(params, batch)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tparams)]
    tl, _ = get_model(tcfg).loss(tree_unflatten_like(tparams, leaves), tcfg,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    tg = tree_unflatten_like(tparams, list(torch.autograd.grad(tl, leaves)))
    want = dict(tree_flatten_with_paths(params_from_jax(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu")))
    got = tree_flatten_with_paths(tg)
    assert len(got) == len(want)
    for path, g in got:
        w = want[path].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(w).max()),
                                   err_msg=path)


def test_prefill_decode_and_cache_match_jax(smoke):
    """A bucket-padded prefill (16 rows, true lengths 16 and 11) into the
    dense cache of Lmax 40 rows, then 4 greedy decode steps: logits,
    next positions and every layer's k, v and pos against JAX."""
    cfg, params, tcfg, tparams = smoke
    Lmax, S = 40, 16
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, S)).astype(np.int32)
    tl = np.array([16, 11], np.int32)
    jf, tf = jax_model(cfg), get_model(tcfg)
    jl, jc, jpos = jax.jit(functools.partial(jf.prefill, cfg=cfg, Lmax=Lmax))(
        params, batch={"tokens": tok}, true_len=tl)
    tl_, tc, tpos = tf.prefill(tparams, tcfg,
                               {"tokens": torch.from_numpy(tok)}, Lmax,
                               true_len=torch.from_numpy(tl))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))

    def same(jl, tl_, jc, tc):
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        for i in range(cfg.num_layers):     # JAX caches are layer-stacked
            assert tc[i]["k"].shape == (2, Lmax, 2, cfg.head_dim)
            np.testing.assert_array_equal(tc[i]["pos"].numpy(),
                                          np.asarray(jc["pos"][i]))
            for key in ("k", "v"):
                np.testing.assert_allclose(tc[i][key].numpy(),
                                           np.asarray(jc[key][i]), **TOL)
    same(jl, tl_, jc, tc)
    step = jax.jit(functools.partial(jf.decode_step, cfg=cfg))
    pos = tl.copy()
    for _ in range(4):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = step(params, caches=jc, token=nxt, t=pos)
        tl_, tc = tf.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                 torch.from_numpy(pos))
        same(jl, tl_, jc, tc)
        pos = pos + 1


def _serve(engine, make_req, prompts, n_new=6):
    reqs = [make_req(uid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [list(r.out_tokens) for r in reqs]


def test_engine_greedy_tokens_match_jax(smoke):
    """Prompts of 5..40 tokens, bucketed to powers of two as the
    reference buckets full attention, at max_len 64: the JAX engine's
    tokens from the port's engine at 3 slots and at 1; every token's
    top-2 margin on the port's teacher-forced logits exceeds 1e-3."""
    cfg, params, tcfg, tparams = smoke
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 30, 9, 17, 40)]
    want = _serve(JaxEngine(cfg, params, slots=3, max_len=64), JaxRequest,
                  prompts)
    for slots in (3, 1):
        eng = ServeEngine(tcfg, tparams, slots=slots, max_len=64)
        assert eng._bucket_len(17) == 32
        assert [type(c) for c in eng.caches] == [dict] * cfg.num_layers
        assert _serve(eng, Request, prompts) == want, slots
    fwd = get_model(tcfg).forward
    for p, out in zip(prompts, want):
        seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
        lg, _ = fwd(tparams, tcfg, torch.from_numpy(seq[None]).long())
        top2 = lg[0, len(p) - 1:].topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def test_bf16_full_cache_keeps_bf16(smoke):
    """A bf16 full config's engine serves from bf16 dense caches (prefill
    and decode write them in place) and its logits stay finite."""
    _, _, tcfg, _ = smoke
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    bparams = get_model(bcfg).init(bcfg, device="cpu")
    eng = ServeEngine(bcfg, bparams, slots=2, max_len=48)
    assert {c["k"].dtype for c in eng.caches} == {torch.bfloat16}
    out = _serve(eng, Request, [np.arange(1, 20, dtype=np.int32)], n_new=4)
    assert len(out[0]) == 4
    assert {(c["k"].dtype, c["v"].dtype) for c in eng.caches} == {
        (torch.bfloat16, torch.bfloat16)}
    # the prefill wrote the 32-row bucket, the 3 decode ticks rows 19-21
    for c in eng.caches:
        np.testing.assert_array_equal(c["pos"][0, :22].numpy(),
                                      np.arange(22))


def test_refusals_match_the_reference(smoke):
    """Paged and sequence-parallel serving need the hierarchical cache and
    refuse full attention, as the reference does; an attention name the
    reference does not know raises ValueError, as its attn_apply does."""
    _, _, tcfg, tparams = smoke
    with pytest.raises(ValueError, match="uniform h1d"):
        ServeEngine(tcfg, tparams, slots=2, max_len=64, paged=True)
    with pytest.raises(ValueError, match="attention='full'"):
        ServeEngine(tcfg, tparams, slots=2, max_len=64,
                    mesh=make_mesh((2,), ("data",), device="cpu"))
    bad = dataclasses.replace(tcfg, attention="linear")
    x = torch.zeros((1, 4, tcfg.d_model))
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="linear"):
        tattn.attn_apply(tparams["layers"][0]["attn"], bad, x, pos)
    with pytest.raises(ValueError, match="linear"):
        tattn.init_decode_cache(bad, 1, 8)


# ---------------------------------------------------------------------------
# the encoder: full and windowed ("local") attention
# ---------------------------------------------------------------------------

ENCODERS = {"full": dict(attention="full"),
            "local": dict(attention="full", sliding_window=16,
                          global_every=10 ** 6)}


def _jax_encoder_logits(params, cfg, tokens, mask):
    """The reference's ``classifier_logits`` with each layer's
    ``layer_global`` passed, so a window applies (the reference's
    classifier passes none and runs every layer global)."""
    B, S = tokens.shape
    h = params["embed"]["w"][tokens].astype(cfg.jdtype)
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    for i, lp in enumerate(params["layers"]):
        h = h + jattn.attn_apply(lp["attn"], cfg,
                                 rmsnorm_apply(lp["ln1"], h), positions,
                                 causal=False, kv_weight=mask,
                                 layer_global=cfg.layer_uses_global_attn(i))
        h = h + mlp_apply(lp["mlp"], rmsnorm_apply(lp["ln2"], h),
                          cfg.mlp_activation)
    h = rmsnorm_apply(params["final_norm"], h)
    w = mask[..., None].astype(h.dtype)
    pooled = (h * w).sum(1) / jnp.maximum(w.sum(1), 1.0)
    return dense_apply(params["head"], pooled).astype(jnp.float32)


@pytest.mark.parametrize("kind", sorted(ENCODERS))
def test_encoder_matches_jax(kind):
    """The smoke encoder on a ListOps(seq_len=256) batch (true lengths
    below 256, the mask weighting keys and pooling): full attention
    through no band kernel; the windowed encoder through one
    ``l0_bidir`` level of block size 16 a layer (the band kernel's plain
    version here).  The full encoder against the reference's
    ``classifier_logits``, the windowed one against it with each layer's
    ``layer_global`` passed."""
    jcfg = dataclasses.replace(jax_smoke(ENCODER), **ENCODERS[kind])
    tcfg = dataclasses.replace(get_smoke_config(ENCODER), **ENCODERS[kind])
    jparams, _ = jcls.classifier_init(jax.random.PRNGKey(1), jcfg, 10)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    b = ListOps(seq_len=256, batch_per_host=4, seed=2, max_depth=4,
                breadth=3).batch(0)
    assert b["mask"].sum(1).min() < 256
    fn = (jcls.classifier_logits if kind == "full"
          else functools.partial(_jax_encoder_logits))
    want = jax.jit(lambda p, t, m: fn(p, jcfg, t, m))(
        jparams, b["tokens"], b["mask"])
    kernels.reset_counts()
    got = classifier_logits(tparams, tcfg, *_t(b["tokens"], b["mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    fwd = kernels.KERNELS["band_attention_fwd"][1]
    assert fwd.calls == (0 if kind == "full" else tcfg.num_layers)


def test_reference_classifier_ignores_the_window():
    """What the port departs from: the reference's own
    ``classifier_logits`` of the windowed config equals its full
    encoder's, so its Table 1 "local" row runs full attention."""
    cfgs = {k: dataclasses.replace(jax_smoke(ENCODER), **kw)
            for k, kw in ENCODERS.items()}
    params, _ = jcls.classifier_init(jax.random.PRNGKey(1), cfgs["full"], 10)
    b = ListOps(seq_len=256, batch_per_host=2, seed=3, max_depth=4,
                breadth=3).batch(0)
    full, local = (np.asarray(jcls.classifier_logits(
        params, cfgs[k], b["tokens"], b["mask"])) for k in ("full", "local"))
    np.testing.assert_array_equal(local, full)
    windowed = np.asarray(_jax_encoder_logits(params, cfgs["local"],
                                              b["tokens"], b["mask"]))
    assert np.abs(windowed - full).max() > 1e-4
