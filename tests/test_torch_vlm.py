"""Port parity of the VLM prefix (``llava-next-34b``'s smoke config)
against the JAX package, through ``params_from_jax``: seeded patch
embeddings run before the tokens in the forward, the loss, the prefill
and the decode that follows it.

Tolerances (fp32 on both sides): logits 2e-5, loss 2e-5, gradients 1e-4
of each leaf's largest |JAX gradient|, positions exact."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.models.transformer import lm_forward as jax_lm_forward  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten_like  # noqa: E402

ARCH = "llava-next-34b"
LOGIT_TOL, GRAD_TOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def _batch(cfg, B, S, seed):
    """Seeded tokens and patch embeddings (numpy, x 0.02 as the smoke's
    stubbed frontend scales them) of the config's prefix length."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "patch_embeds": (rng.standard_normal(
                (B, cfg.prefix_len, cfg.d_model)) * 0.02).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_with_patch_embeds_matches_jax(smoke):
    """Logits of the token positions only, the prefix attended through
    every layer."""
    cfg, params, tcfg, tp = smoke
    b = _batch(cfg, 2, 24, 0)
    want, _ = jax.jit(functools.partial(jax_lm_forward, cfg=cfg))(
        params, tokens=b["tokens"], prefix_embeds=b["patch_embeds"])
    got, aux = get_model(tcfg).forward(
        tp, tcfg, torch.from_numpy(b["tokens"]),
        prefix_embeds=torch.from_numpy(b["patch_embeds"]))
    assert got.shape == (2, 24, cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL)
    # the prefix changes the token logits
    alone, _ = get_model(tcfg).forward(tp, tcfg,
                                       torch.from_numpy(b["tokens"]))
    assert float((alone - got).abs().max()) > 1e-4


def test_loss_and_gradients_match_jax(smoke):
    cfg, params, tcfg, tp = smoke
    b = _batch(cfg, 2, 24, 1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model(cfg).loss(p, cfg, b), has_aux=True))(params)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, m = get_model(tcfg).loss(tree_unflatten_like(tp, leaves), tcfg,
                                   _torch(b))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= LOGIT_TOL
    assert float(m["ntok"]) == 2 * 23
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu")
    for w, g in zip(tree_leaves(want), grads):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale <= GRAD_TOL


def test_loss_ignores_prefix_positions(smoke):
    """As ``tests/test_models.py``'s VLM test: the prefix moves the loss
    (through attention) but only token positions are scored; a loss
    mask over the tokens masks token positions, not prefix ones, and
    the JAX loss agrees under it."""
    cfg, params, tcfg, tp = smoke
    fns = get_model(tcfg)
    b = _batch(cfg, 1, 32, 2)
    l1, m1 = fns.loss(tp, tcfg, _torch(b))
    l2, _ = fns.loss(tp, tcfg, {**_torch(b), "patch_embeds": torch.from_numpy(
        b["patch_embeds"] * 2.0)})
    assert np.isfinite(float(l1)) and np.isfinite(float(l2))
    assert float(l1) != float(l2)
    assert float(m1["ntok"]) == 31
    mask = np.zeros((1, 32), np.float32)
    mask[:, 20:] = 1.0
    jl, jm = jax_model(cfg).loss(params, cfg, {**b, "loss_mask": mask})
    tl, tm = fns.loss(tp, tcfg, {**_torch(b),
                                 "loss_mask": torch.from_numpy(mask)})
    assert float(tm["ntok"]) == float(jm["ntok"]) == 12
    assert abs(float(tl) - float(jl)) <= LOGIT_TOL


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_and_decode_match_jax(smoke, bucketed):
    """``lm_prefill`` of the prefix plus a prompt (bucket-padded with
    per-row true lengths, or whole): the last true position's logits and
    next positions ``prefix + true_len``; then greedy decode steps
    continuing at them, against JAX."""
    cfg, params, tcfg, tp = smoke
    Lmax, S = 64, 16
    b = _batch(cfg, 2, S, 3)
    tl = np.array([16, 9], np.int32) if bucketed else None
    jf, tf = jax_model(cfg), get_model(tcfg)
    jl, jc, jpos = jax.jit(functools.partial(jf.prefill, cfg=cfg, Lmax=Lmax))(
        params, batch={k: jnp.asarray(v) for k, v in b.items()},
        true_len=tl)
    tl_, tc, tpos = tf.prefill(
        tp, tcfg, _torch(b), Lmax,
        true_len=None if tl is None else torch.from_numpy(tl))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    want_pos = cfg.prefix_len + (tl if bucketed else np.array([S, S]))
    np.testing.assert_array_equal(tpos.numpy(), want_pos)
    step = jax.jit(functools.partial(jf.decode_step, cfg=cfg))
    pos = np.asarray(jpos).copy()
    for _ in range(5):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert (tl_.numpy().argmax(-1) == nxt).all()
        jl, jc = step(params, caches=jc, token=nxt, t=pos)
        tl_, tc = tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        pos = pos + 1


@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_serve_cli_runs_the_smoke_config(arch, capsys):
    """The CLIs feed no patch embeddings (nor do the reference's): the
    VLM serves text-only; the MoE serves through the same engine."""
    from repro_torch.launch import serve as serve_cli
    reqs = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2",
                           "--new-tokens", "3", "--max-len", "64"])
    assert [len(r.out_tokens) for r in reqs] == [3, 3, 3]
    assert get_smoke_config(arch).name in capsys.readouterr().out


def test_train_cli_runs_the_smoke_config(capsys, tmp_path):
    from repro_torch.launch import train as train_cli
    state = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--steps", "2", "--batch", "2", "--seq", "32",
                            "--ckpt-every", "0", "--ckpt-dir",
                            str(tmp_path / "ck")])
    assert int(state.step) == 2
    assert "llava-smoke" in capsys.readouterr().out
