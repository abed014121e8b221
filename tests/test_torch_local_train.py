"""Port parity of gemma3's training path against the JAX package on the
same numpy inputs and weights: the ``gemma3-4b-smoke`` model's
``lm_loss`` gradient under remat (sliding windows of 16 and 128, the
latter past the staged kernels' nr = 64), the block-local attention's
gradient through its padding to whole windows and its kv-head fold, the
plain band backward at nr = 128 and 256 against the reference's Pallas
backward in interpret mode, three AdamW steps, the remat policies, the
train CLI and the streamed backward's routing and plans.

Tolerances: gradients within 1e-4 of each leaf's largest |reference|
entry (fp32 on both sides, another summation order; the gradients at
init are far below 1), the band backward atol 1e-4 / rtol 1e-3 (the
reference's own kernel-backward bound), losses 1e-4 absolute; the
port's gradients under the three remat policies bit for bit."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import h1d_block as jhb  # noqa: E402
from repro.kernels import h1d_block_bwd as jhbb  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import h1d_block as thb  # noqa: E402
from repro_torch.kernels import h1d_block_bwd as thbb  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,  # noqa: E402
                              tree_unflatten_like)

ARCH = "gemma3-4b"
GRAD_RTOL = 1e-4
BWD_TOL = dict(atol=1e-4, rtol=1e-3)
LOSS_ATOL = 1e-4
STEPS = 3


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _configs(window, **kw):
    """The JAX and port smoke configs at sliding window ``window`` with
    remat on, as gemma3-4b trains."""
    over = dict(sliding_window=window, remat=True, **kw)
    return (dataclasses.replace(jax_smoke(ARCH), **over),
            dataclasses.replace(get_smoke_config(ARCH), **over))


def _port_grads(params, cfg, batch):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params)]
    loss, _ = get_model(cfg).loss(tree_unflatten_like(params, leaves), cfg,
                                  batch)
    return loss, torch.autograd.grad(loss, leaves)


def _close_leaves(got, want):
    """Each leaf of ``got`` (port tree) within GRAD_RTOL of its own largest
    |want| entry."""
    want = dict(tree_flatten_with_paths(want))
    paths = []
    for path, g in tree_flatten_with_paths(got):
        w = want[path].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=path)
        paths.append(path)
    assert len(paths) == len(want)


@pytest.mark.parametrize("window,seq", [(16, 64), (128, 256)])
@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_smoke_grads_match_jax_under_remat(impl, window, seq):
    """The smoke model's lm_loss gradient (4 local layers, 2 global) with
    remat on, against ``jax.grad`` of the reference's lm_loss run with
    ``attn_impl`` jnp or pallas_interpret (its own Pallas kernels,
    forward and backward, in interpret mode); window 128 is the nr > 64
    regime of the streamed kernels on the card."""
    jcfg, tcfg = _configs(window, attn_impl=impl)
    jparams, _ = jax_model(jcfg).init(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                             device="cpu")
    batch = tdata.ZipfLM(vocab_size=tcfg.vocab_size, seq_len=seq,
                         batch_per_host=2, seed=window).batch(0)
    jloss = jax_model(jcfg).loss
    jl, jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, jcfg, b)[0]))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tl, tgrad = _port_grads(params, tcfg, tloop.batch_to_device(batch, "cpu"))
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_ATOL
    _close_leaves(tree_unflatten_like(params, list(tgrad)),
                  params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg,
                                  device="cpu"))


@pytest.mark.parametrize("window,L", [(16, 40), (128, 300)])
@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_local_attention_grads_match_jax(impl, window, L):
    """The block-local attention's gradient in q, k, v and the key
    weights: L pads to whole windows (3 at window 16, 3 at 128) with
    weight-0 keys, 4 q heads fold onto 2 kv-heads (G = 2), one row has a
    zero-weight tail; against ``jax.vjp`` of the reference's
    ``_local_attention``."""
    rng = np.random.default_rng(window + L)
    q = rng.standard_normal((2, L, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, L, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, L, 2, 16)).astype(np.float32)
    w = np.ones((2, L), np.float32)
    w[1, L - 7:] = 0.0
    ct = rng.standard_normal((2, L, 4, 16)).astype(np.float32)
    fn = jax.jit(functools.partial(jattn._local_attention, window=window,
                                   causal=True, impl=impl))
    _, vjp = jax.vjp(lambda *a: fn(*a[:3], kv_weight=a[3]), q, k, v, w)
    want = vjp(ct)
    ts = [t.requires_grad_(True) for t in _t(q, k, v, w)]
    z = tattn._local_attention(*ts[:3], window, True, ts[3])
    got = torch.autograd.grad(z, ts, torch.from_numpy(ct))
    for name, a, b in zip("qkvw", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("nr", [128, 256])
def test_band_bwd_ref_matches_pallas_interpret(nr):
    """The plain l0_causal backward at nr past 64 (the streamed kernel's
    oracle on the card) against the reference's Pallas backward in
    interpret mode (tq = nr), from the reference forward's (y, dn, m)
    and random cotangents on all three, gm included; 3 blocks, one row's
    keys dead from mid-block on."""
    rng = np.random.default_rng(nr)
    B, G, L, d = 2, 2, 3 * nr, 16
    q = (rng.standard_normal((B, G, L, d)) / 4).astype(np.float32)
    k = rng.standard_normal((B, L, d)).astype(np.float32)
    w = np.ones((B, L), np.float32)
    w[1, L - nr // 2 - 5:] = 0.0
    v = (rng.standard_normal((B, L, d)) * w[..., None]).astype(np.float32)
    tq = max(128, nr)
    out = jhb.band_attention_fwd(q, k, v, w, nr=nr, mode="l0_causal", tq=tq,
                                 interpret=True)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in out]
    want = jhbb.band_attention_bwd(q, k, v, w, *out, *cts, nr=nr,
                                   mode="l0_causal", tq=tq, interpret=True)
    got = thbb.band_attention_bwd_ref(
        *_t(q, k, v, w, *(np.asarray(o) for o in out), *cts), nr=nr)
    for name, a, b in zip("qkvw", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.fixture(scope="module")
def smoke_window_128():
    """The port's smoke model at window 128, seeded weights and one
    3-window batch."""
    _, tcfg = _configs(128)
    params = get_model(tcfg).init(tcfg, seed=1, device="cpu")
    batch = tloop.batch_to_device(tdata.ZipfLM(
        vocab_size=tcfg.vocab_size, seq_len=384, batch_per_host=2,
        seed=2).batch(0), "cpu")
    return tcfg, params, batch


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test: the embedding's
    gradient is a scatter-add over repeated tokens, whose order (and so
    whose last bits) the CPU's threads vary from run to run otherwise."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_identical_grads(smoke_window_128, policy,
                                             deterministic):
    """The gradient with remat ``policy`` equals the one with
    ``remat_policy='none'`` bit for bit; a rematerialised step runs each
    layer's band forward twice (forward and recompute) and its backward
    once, 'none' once each."""
    tcfg, params, batch = smoke_window_128
    got = {}
    for pol in ("none", policy):
        kernels.reset_counts()
        loss, g = _port_grads(params, dataclasses.replace(
            tcfg, remat_policy=pol), batch)
        got[pol] = (float(loss.detach()), g, {n: p.calls for n, (_, p)
                                              in kernels.KERNELS.items()})
    assert got["none"][0] == got[policy][0]
    for a, b in zip(got["none"][1], got[policy][1]):
        assert torch.equal(a, b)
    once, twice = got["none"][2], got[policy][2]
    layers = tcfg.num_layers
    assert once["band_attention_fwd"] == once["band_attention_bwd"] == layers
    assert twice["band_attention_fwd"] == 2 * layers
    assert twice["band_attention_bwd"] == layers
    assert twice["band_attention_sub_fwd"] == \
        2 * once["band_attention_sub_fwd"] > 0


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_the_weight_products(smoke_window_128):
    """Under 'dots' the backward recomputes no weight product (the
    reference's ``dots_with_no_batch_dims_saveable``): it runs as many
    matrix products as without remat, while 'full' runs the forward's
    again, each layer's but its last (the recompute stops once the
    backward has what it saved; nothing it saved follows the last
    product)."""
    tcfg, params, batch = smoke_window_128
    counts = {}
    for pol in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat_policy=pol)
        leaves = [p.detach().clone().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = get_model(cfg).loss(tree_unflatten_like(params, leaves),
                                      cfg, batch)
        with _CountMM() as mode:
            torch.autograd.grad(loss, leaves)
        counts[pol] = mode.mm
    # per layer the forward runs wq, wkv, wo and the three mlp products
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 5 * tcfg.num_layers


@pytest.fixture(scope="module")
def adamw_parity():
    """Both packages from the same JAX init of the smoke config at window
    128 with remat on: STEPS AdamW steps on the same ZipfLM batches (the
    JAX step jitted with attn_impl='jnp')."""
    jcfg, tcfg = _configs(128)
    tc = dict(peak_lr=1e-3, warmup=2, total_steps=10, ckpt_every=0)
    jtc = jloop.TrainConfig(attn_impl="jnp", **tc)
    jstate, _ = jloop.init_state(jax.random.PRNGKey(0), jcfg, jtc)
    ttc = tloop.TrainConfig(**tc)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                             device="cpu")
    tstate = tloop.TrainState(torch.zeros((), dtype=torch.int32), params,
                              tloop.make_optimizer(ttc).init(params), None)
    data = tdata.ZipfLM(vocab_size=tcfg.vocab_size, seq_len=256,
                        batch_per_host=2, seed=0)
    jstep = jax.jit(jloop.make_train_step(jcfg, jtc))
    tstep = tloop.make_train_step(tcfg, ttc)
    losses = []
    for i in range(STEPS):
        b = data.batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, tloop.batch_to_device(b, "cpu"))
        losses.append((float(jm["loss"]), float(tm["loss"])))
    return losses


@pytest.mark.parametrize("step", range(STEPS))
def test_adamw_losses_match_jax(adamw_parity, step):
    jl, tl = adamw_parity[step]
    assert np.isfinite(tl) and abs(jl - tl) <= LOSS_ATOL, (step, jl, tl)


def test_train_cli_takes_bf16_and_trains_the_smoke_config(tmp_path,
                                                          capsys):
    """``--arch gemma3-4b`` behaves as the serving CLI: the published
    config is bfloat16, and the bf16 smoke config's training state holds
    bf16 weights and f32 AdamW moments (no full config is drawn on the
    CPU); ``--smoke`` trains the fp32 smoke config."""
    from repro_torch.configs import get_config
    assert get_config(ARCH).dtype == "bfloat16"
    bcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    bstate = tloop.init_state(bcfg, tloop.TrainConfig(), device="cpu")
    assert {t.dtype for t in tree_leaves(bstate.params)} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(bstate.opt_state)
            if t.is_floating_point()} == {torch.float32}
    state = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--steps", "2", "--batch", "2", "--seq", "48",
                            "--ckpt-dir", str(tmp_path)])
    assert int(state.step) == 2
    out = capsys.readouterr().out
    assert "gemma3-4b-smoke" in out and "[train] done: 2 steps" in out


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("nr", [128, 256, 512, 1024])
def test_check_window_bwd_routes(d, nr):
    """l0_causal past the staged bodies' nr = 64 routes to the streamed
    backward, whose two plans fit a CTA's 227 KB at every width and
    window of the local layers; the bidirectional modes still raise
    there, and so does a width past STREAM_MAX_D."""
    assert thb.check_window_bwd("l0_causal", nr, d, d) == "stream"
    assert thb.stream_bwd_takes(nr, d, d)
    assert 4 * thb.stream_dq_floats(d, d, nr) <= thb.SMEM_MAX
    assert 4 * thb.stream_dkvw_floats(d, d) <= thb.SMEM_MAX
    for mode in ("l0_bidir", "coarse_bidir"):
        with pytest.raises(ValueError):
            thb.check_window_bwd(mode, nr, d, d)
    with pytest.raises(ValueError):
        thb.check_window_bwd("l0_causal", nr, thb.STREAM_MAX_D + 4, d)
    assert thb.check_window_bwd("l0_causal", 16, d, d) == "band"


def _forced_ties(seed: int, place: str):
    """(tie, key0): one dQ query tile's window of seeded integer scores
    (keys 1024 .. 3135, 64 rows) with the row max forced onto the keys of
    ``place``: three in one 32-key tile, four across two, seven past the
    tie list, or ``random`` (scores in 0..5, so most rows tie many times)."""
    rng = np.random.default_rng(seed)
    rows, nk, key0 = 64, 2112, 1024
    if place == "random":
        s = rng.integers(0, 6, (rows, nk))
    else:
        s = rng.integers(-50, 50, (rows, nk))
        keys = {"one tile": (64, 67, 81), "two tiles": (94, 95, 96, 98),
                "past the list": (64, 69, 97, 104, 134, 164, 194)}[place]
        s[:, list(keys)] = 100
    admit = rng.random((rows, nk)) > 0.1          # w > 0 and the mask
    m = np.where(admit, s, -1000).max(1)
    return admit & (s == m[:, None]), key0


@pytest.mark.parametrize("place", ["one tile", "two tiles", "past the list",
                                   "random"])
def test_stream_tie_lists_count_exactly(place):
    """The dQ pass's one-sweep tie bookkeeping (host mirror
    ``stream_tie_lists``: per key tile and lane ballot, each tied lane's
    place from the row's earlier ties and the tied lanes below it): every
    row's count is its exact number of ties, its list the first
    STREAM_TIES tied keys in key order, and a row past the list is one the
    kernel rescans; the tie term gmn * (sum of the listed or rescanned
    keys) is the plain version's sum of gmn 1[s == m] k over the window."""
    tie, key0 = _forced_ties(25, place)
    counts, lists = thb.stream_tie_lists(tie, key0)
    exact = tie.sum(1)
    assert (counts == exact).all()
    for r in range(tie.shape[0]):
        tied = (np.flatnonzero(tie[r]) + key0).tolist()
        assert lists[r] == tied[:thb.STREAM_TIES]
    over = counts > thb.STREAM_TIES
    assert over.any() == (place in ("past the list", "random"))
    if place != "random":
        assert (counts[tie.any(1)] > 0).all()
    rng = np.random.default_rng(7)
    k = rng.standard_normal((key0 + tie.shape[1], 8))
    gmh = rng.standard_normal(tie.shape[0])
    for r in range(tie.shape[0]):
        if counts[r] == 0:
            continue
        gmn = gmh[r] / counts[r]
        keys = lists[r] if counts[r] <= thb.STREAM_TIES else \
            (np.flatnonzero(tie[r]) + key0).tolist()
        plain = (gmn * tie[r][:, None] * k[key0:]).sum(0)
        assert np.allclose(gmn * k[keys].sum(0), plain, rtol=1e-12,
                           atol=1e-12)
