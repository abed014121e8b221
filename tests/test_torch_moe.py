"""Port parity of the mixture of experts (``repro_torch.models.ffn``)
against the JAX package's ``moe_apply`` and its sort/scatter oracle
``_moe_apply_scatter``, on the same numpy inputs and the same weights.

Tolerances (fp32 on both sides, summation order the only difference):
output 2e-5, aux loss 1e-6, gradients 1e-4 of each leaf's largest
|JAX gradient|.  Routing (experts, ranks, drops) is compared exactly."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import ffn as jffn  # noqa: E402
from repro.models.common import ModelConfig as JaxConfig  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

OUT_TOL, AUX_TOL, GRAD_TOL = 2e-5, 1e-6, 1e-4
# (name, extra config fields): the plain routed experts, qwen2-moe's
# shared expert with its gate, arctic's dense residual branch
VARIANTS = [("routed", {}),
            ("shared", dict(moe_shared_d_ff=48)),
            ("residual", dict(moe_dense_residual=True, d_ff=40))]


def _cfgs(cf, E=8, k=2, **kw):
    fields = dict(d_model=16, moe_experts=E, moe_top_k=k, moe_d_ff=32,
                  moe_capacity_factor=cf, moe_aux_loss=0.01, **kw)
    return JaxConfig(**fields), ModelConfig(**fields)


def _params(jcfg, seed):
    p, _ = jffn.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if "shared_gate" in p:          # a nonzero gate, so the branch counts
        p["shared_gate"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                             p["shared_gate"].shape) * 0.5
    return p


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


@pytest.mark.parametrize("variant,extra", VARIANTS)
@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("oracle", ["moe_apply", "_moe_apply_scatter"])
def test_moe_apply_matches_jax(variant, extra, cf, oracle):
    """At ample capacity (cf 8: nothing drops) and tight (cf 0.25: most
    assignments drop, their weight not renormalised), against both of
    the reference's dispatches."""
    jcfg, tcfg = _cfgs(cf, **extra)
    p = _params(jcfg, 0)
    x = _x(2, 32, 16, 1)
    want, waux = getattr(jffn, oracle)(p, jcfg, jnp.asarray(x))
    got, aux = ffn.moe_apply(_torch(p), tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL)
    assert abs(float(aux) - float(waux)) <= AUX_TOL


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_routing_matches_jax(cf):
    """Top-k experts, their renormalised weights, the rank of each
    assignment in its expert's queue, the capacity and the aux loss."""
    jcfg, tcfg = _cfgs(cf)
    p = _params(jcfg, 2)
    x = _x(3, 40, 16, 3)
    jw, ji, jr, jaux, jC = jffn._route(p, jcfg, jnp.asarray(x))
    tw, ti, tr, taux, tC = ffn.route(_torch(p), tcfg, torch.from_numpy(x))
    assert tC == jC == ffn.moe_capacity(tcfg, 40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    dropped = int((tr >= tC).sum())
    assert (dropped == 0) if cf == 8.0 else (dropped > 0)


@pytest.mark.parametrize("router", ["zero", "saturated"])
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_exact_ties_break_as_jax_top_k(router, cf):
    """A zeroed router ties every gate; one whose column 0 is saturated
    ties the rest (as ``tests/test_moe.py`` skews it): ``jax.lax.top_k``
    takes the lower expert, and so must the port (its ranks and drops
    follow)."""
    jcfg, tcfg = _cfgs(cf, k=3)
    p = _params(jcfg, 4)
    r = jnp.zeros_like(p["router"])
    p["router"] = r if router == "zero" else r.at[:, 0].set(10.0)
    x = _x(2, 24, 16, 5)
    _, ji, jr, jaux, _ = jffn._route(p, jcfg, jnp.asarray(x))
    _, ti, tr, taux, _ = ffn.route(_torch(p), tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    want, _ = jffn.moe_apply(p, jcfg, jnp.asarray(x))
    got, aux = ffn.moe_apply(_torch(p), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_bucket_padded_sequence(cf):
    """A prompt right-padded to its bucket (the engine pads with real
    tokens): the port's padded call gives the reference's padded call on
    the real rows; the stable sort keeps the pad tail from displacing a
    real token, so those rows equal the unpadded call's wherever the
    capacity is the same."""
    jcfg, tcfg = _cfgs(cf)
    p = _params(jcfg, 6)
    x = _x(2, 32, 16, 7)
    real = 21
    x[:, real:] = x[:, :1]              # pads: copies of one real token
    want, _ = jffn.moe_apply(p, jcfg, jnp.asarray(x))
    got, _ = ffn.moe_apply(_torch(p), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy()[:, :real],
                               np.asarray(want)[:, :real], atol=OUT_TOL)
    # the same capacity at the real length: pads never take a real
    # token's slot
    C = ffn.moe_capacity(tcfg, 32)
    same_c = dataclasses.replace(tcfg, moe_capacity_factor=(
        (C - 0.5) * tcfg.moe_experts / (real * tcfg.moe_top_k)))
    assert ffn.moe_capacity(same_c, real) == C
    alone, _ = ffn.moe_apply(_torch(p), same_c,
                             torch.from_numpy(x[:, :real].copy()))
    np.testing.assert_allclose(got.numpy()[:, :real], alone.numpy(),
                               atol=OUT_TOL)


@pytest.mark.parametrize("variant,extra", VARIANTS)
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_gradients_match_jax(variant, extra, cf):
    """Every leaf's gradient and the input's, of sum(out * cot) + aux,
    against ``jax.grad`` (aux weighted up so its router gradient shows)."""
    jcfg, tcfg = _cfgs(cf, **extra)
    jcfg = dataclasses.replace(jcfg, moe_aux_loss=1.0)
    tcfg = dataclasses.replace(tcfg, moe_aux_loss=1.0)
    p = _params(jcfg, 8)
    x = _x(2, 24, 16, 9)
    cot = _x(2, 24, 16, 10)

    def jloss(p, x):
        out, aux = jffn.moe_apply(p, jcfg, x)
        return jnp.sum(out * cot) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))

    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = ffn.moe_apply(tp, tcfg, tx)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    pairs = [(path, np.asarray(g), leaf.grad.numpy()) for (path, g), leaf in
             zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
                 jax.tree.leaves(tp))]
    pairs.append(("x", np.asarray(jgx), tx.grad.numpy()))
    for path, want, got in pairs:
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        assert err <= GRAD_TOL, (path, err)


def test_forward_is_deterministic_and_dtype_follows_x():
    """Two calls give the same bits (no atomics in the forward: a remat
    recompute gives the forward's); a bf16 input gives a bf16 output
    while the router stays f32."""
    jcfg, tcfg = _cfgs(0.25, moe_shared_d_ff=48)
    p = _torch(_params(jcfg, 11))
    x = torch.from_numpy(_x(2, 32, 16, 12))
    a, aux_a = ffn.moe_apply(p, tcfg, x)
    b, aux_b = ffn.moe_apply(p, tcfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    pb = {k: (v if k == "router" else jax.tree.map(
        lambda t: t.to(torch.bfloat16), v)) for k, v in p.items()}
    out, _ = ffn.moe_apply(pb, tcfg, x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_init_leaves_and_scales():
    """The reference's leaves: the router f32 whatever the dtype, the
    experts in it; the shared gate zero; scales 1/sqrt(d) and
    1/sqrt(ff)."""
    _, tcfg = _cfgs(1.25, E=16, moe_shared_d_ff=48, moe_dense_residual=True,
                    d_ff=40)
    tcfg = dataclasses.replace(tcfg, d_model=256, moe_d_ff=512)
    p, _ = ffn.moe_init(torch.Generator().manual_seed(0), tcfg,
                          torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (256, 16)
    assert {p[k].dtype for k in ("w1", "w3", "w2")} == {torch.bfloat16}
    assert p["w1"].shape == p["w3"].shape == (16, 256, 512)
    assert p["w2"].shape == (16, 512, 256)
    assert not p["shared_gate"].any() and p["shared_gate"].shape == (256, 1)
    assert p["residual"]["wg"]["w"].shape == (256, 40)
    assert abs(float(p["w1"].float().std()) - 256 ** -0.5) < 2e-3
    assert abs(float(p["w2"].float().std()) - 512 ** -0.5) < 2e-3
