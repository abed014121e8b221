"""Port parity of gemma3's sliding-window serving path against the JAX
package on the same numpy inputs and weights: the block-local attention
(``_local_attention``, one ``l0_causal`` band level of block size
``window``, at windows past the staged kernel's nr = 64 and at block
counts that are not powers of two), one local layer's prefill and
decode against its rolling cache, the ``gemma3-4b-smoke`` model and its
serving engine; plus the streamed kernel's host-side plan and the CLI.

Tolerances: attention 2e-5 absolute / 1e-4 relative (the reference's own
for its kernel against the blocked jnp path: fp32 on both sides, another
summation order); logits 1e-4 absolute, the port's forward tolerance;
rolling-cache positions and greedy tokens exactly."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import h1d_block as jhb  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.models.transformer import lm_forward as jax_lm_forward  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import h1d_block as thb  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "gemma3-4b"
TOL = dict(atol=2e-5, rtol=1e-4)
LOGIT_ATOL = 1e-4
MARGIN = 1e-3


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_smoke(ARCH)
    params, _ = jax_model(cfg).init(jax.random.PRNGKey(6), cfg)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, params, tcfg, tparams


def test_config_matches_jax_and_cadence():
    from repro.configs import get_config as jax_config
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        jax_smoke(ARCH))
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    flags = [cfg.layer_uses_global_attn(i) for i in range(cfg.num_layers)]
    assert flags == [jcfg.layer_uses_global_attn(i)
                     for i in range(cfg.num_layers)]
    assert [i for i, f in enumerate(flags) if f] == [5, 11, 17, 23, 29]
    assert get_config("h1d-lm-53m").layer_uses_global_attn(3)


@pytest.mark.parametrize("L", [129, 320])
@pytest.mark.parametrize("window", [16, 64, 128])
@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_local_attention_matches_jax(impl, window, L):
    """G = 2 (4 q heads on 2 kv-heads), a zero-weight tail on one row;
    L pads to 3 and 5 blocks at window 128 and 64 (not powers of two),
    and window 128 runs the plain path past the staged kernel's nr."""
    rng = np.random.default_rng(window + L)
    q = rng.standard_normal((2, L, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, L, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, L, 2, 16)).astype(np.float32)
    w = np.ones((2, L), np.float32)
    w[1, L - 40:] = 0.0
    want = jax.jit(functools.partial(jattn._local_attention, window=window,
                                     causal=True, impl=impl))(
        q, k, v, kv_weight=w)
    got = tattn._local_attention(*_t(q, k, v), window, True,
                                 torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B", [1, 2])
def test_local_attention_hands_the_kernel_contiguous_operands(
        monkeypatch, B):
    """The kernels refuse strided operands; the fold of one sequence's
    heads is a strided view, which the scaling keeps."""
    seen = []
    real = thb.band_attention_fwd

    def spy(q, k, v, w, **kw):
        seen.append([t.is_contiguous() for t in (q, k, v, w)])
        return real(q, k, v, w, **kw)
    monkeypatch.setattr(thb, "band_attention_fwd", spy)
    rng = np.random.default_rng(B)
    q = rng.standard_normal((B, 40, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((B, 40, 2, 16)).astype(np.float32)
    tattn._local_attention(*_t(q, kv, kv), 16, True, None)
    assert seen == [[True] * 4]


def test_band_fwd_ref_three_blocks_matches_pallas_interpret():
    """The plain version at nr = 128 over 3 blocks (L = 384, not
    nr * 2**k) against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(7)
    B, G, L, d, nr = 2, 2, 384, 16, 128
    q = (rng.standard_normal((B, G, L, d)) / 4).astype(np.float32)
    k = rng.standard_normal((B, L, d)).astype(np.float32)
    w = np.ones((B, L), np.float32)
    w[0, 300:] = 0.0
    v = (rng.standard_normal((B, L, d)) * w[..., None]).astype(np.float32)
    want = jhb.band_attention_fwd(q, k, v, w, nr=nr, mode="l0_causal",
                                  tq=nr, interpret=True)
    got = thb.band_attention_fwd_ref(*_t(q, k, v, w), nr=nr,
                                     mode="l0_causal")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    with pytest.raises(ValueError):          # whole blocks only
        thb.band_attention_fwd_ref(*_t(q[:, :, :200], k[:, :200],
                                       v[:, :200], w[:, :200]), nr=nr)


def test_local_layer_prefill_and_decode_match_jax(smoke):
    """Layer 0 (local) of the smoke model: the prefill's output and its
    rolling cache (S = 40 tokens into Lc = 2 * 16 slots, so it keeps the
    last 32), then 8 decode steps that wrap the slots, against JAX with
    ``layer_global=False``."""
    cfg, params, tcfg, _ = smoke
    assert not tcfg.layer_uses_global_attn(0)
    jp = jax.tree.map(lambda a: np.asarray(a)[0], params["layers"]["attn"])
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")["layers"][0]["attn"]
    rng = np.random.default_rng(11)
    B, S, Lmax = 2, 40, 96
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout = jax.jit(functools.partial(jattn.attn_apply, cfg=cfg,
                                     layer_global=False))(jp, x=x,
                                                          positions=pos)
    tout = tattn.attn_apply(tp, tcfg, *_t(x, pos), layer_global=False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    jout, jc = jax.jit(functools.partial(
        jattn.prefill_into_cache, cfg=cfg, Lmax=Lmax, layer_global=False))(
        jp, x=x, positions=pos)
    tout, tc = tattn.prefill_into_cache(tp, tcfg, *_t(x, pos), Lmax,
                                        layer_global=False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)

    def same_cache():
        assert tc["k"].shape == (B, 32, cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(),
                                       np.asarray(jc[key]), **TOL)
    same_cache()
    step = jax.jit(functools.partial(jattn.attn_decode, cfg=cfg,
                                     layer_global=False))
    t = np.array([S, S - 3], np.int32)
    for _ in range(8):
        xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jz, jc = step(jp, x=xd, t=t, cache=jc)
        tz, tc = tattn.attn_decode(tp, tcfg, *_t(xd, t), tc,
                                   layer_global=False)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
        same_cache()
        t = t + 1


def test_smoke_logits_match_jax(smoke):
    """6 layers (4 local, 2 global) through ``params_from_jax``: q/k
    norms, the geglu MLP and the tied head carried from the stacked JAX
    tree; S = 37 pads the local layers to 3 windows and the global ones
    to 64."""
    cfg, params, tcfg, tparams = smoke
    lp = tparams["layers"][0]
    assert set(lp["attn"]) == {"wq", "wkv", "wo", "qn", "kn"}
    assert "lm_head" not in tparams
    np.testing.assert_array_equal(
        lp["attn"]["qn"]["g"].numpy(),
        np.asarray(params["layers"]["attn"]["qn"]["g"][0]))
    tok = np.random.default_rng(37).integers(0, cfg.vocab_size, (2, 37))
    want, _ = jax.jit(functools.partial(jax_lm_forward, cfg=cfg))(
        params, tokens=tok)
    kernels.reset_counts()
    got, _ = get_model(tcfg).forward(tparams, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    # 4 local layers of one level, 2 global layers of levels 0, 1, 2
    assert thb.band_attention_fwd_ref.calls == 4 + 2
    assert thb.band_attention_sub_fwd_ref.calls == 2 * 2


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in (10, 60, 23, 41, 17)]


def _serve(engine, make_req, prompts, n_new=6):
    reqs = [make_req(uid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [list(r.out_tokens) for r in reqs]


def test_engine_greedy_tokens_match_jax(smoke):
    """Prompts of 10..60 tokens at window 16 and max_len 96 (rolling
    caches of 32 slots, wrapped by the long prompts): the JAX engine's
    tokens (2 slots) from the port's engine at 2 slots and at 1; every
    token's top-2 margin on the port's teacher-forced logits exceeds
    1e-3, so equality is not luck."""
    cfg, params, tcfg, tparams = smoke
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxEngine(cfg, params, slots=2, max_len=96), JaxRequest,
                  prompts)
    for slots in (2, 1):
        got = _serve(ServeEngine(tcfg, tparams, slots=slots, max_len=96),
                     Request, prompts)
        assert got == want, slots
    fwd = get_model(tcfg).forward
    for p, out in zip(prompts, want):
        seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
        lg, _ = fwd(tparams, tcfg, torch.from_numpy(seq[None]).long())
        top2 = lg[0, len(p) - 1:].topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def test_engine_refusals_and_no_bucketing(smoke):
    """Sliding-window prompts are never bucket-padded (pads would evict
    real keys from the rolling cache); paged serving is refused as the
    reference refuses it, and SP serving shards the global layers'
    hierarchical caches while the local layers' rolling caches stay
    whole (``test_torch_sp_families.py`` holds its tokens).  The published
    config is bfloat16, and the bf16 smoke config initialises with bf16
    leaves and serves from bf16 rolling and hierarchical caches."""
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, slots=2, max_len=96)
    assert eng._bucket_len(37) == 37
    assert [type(c) for c in eng.caches].count(dict) == 4
    with pytest.raises(ValueError, match="uniform h1d"):
        ServeEngine(tcfg, tparams, slots=2, max_len=96, paged=True)
    spe = ServeEngine(tcfg, tparams, slots=2, max_len=96,
                      mesh=make_mesh((2,), ("data",), device="cpu"))
    assert [type(c).__name__ for c in spe.caches] == [
        "dict", "dict", "SPCache", "dict", "dict", "SPCache"]
    out = _serve(spe, Request, _prompts(tcfg.vocab_size)[:2], n_new=3)
    assert [len(o) for o in out] == [3, 3]
    assert get_config(ARCH).dtype == "bfloat16"
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    bparams = get_model(bcfg).init(bcfg, device="cpu")
    assert {t.dtype for t in tree_leaves(bparams)} == {torch.bfloat16}
    beng = ServeEngine(bcfg, bparams, slots=2, max_len=96)
    out = _serve(beng, Request, _prompts(bcfg.vocab_size)[:3], n_new=3)
    assert [len(o) for o in out] == [3, 3, 3]
    assert {t.dtype for t in tree_leaves(beng.caches)
            if t.is_floating_point()} == {torch.bfloat16}


def test_cli_serves_the_smoke_config(capsys, monkeypatch):
    """The CLI serves the smoke config.  An architecture that is not a
    config of the port raises, naming those that are; the
    encoder-decoder (seamless-m4t-medium) is refused by the serve CLI and
    by ServeEngine with the reference engine's text, and by the train
    CLI, each before any weight is drawn."""
    reqs = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2",
                           "--new-tokens", "3", "--max-len", "64"])
    assert [len(r.out_tokens) for r in reqs] == [3, 3, 3]
    assert "gemma3-4b-smoke" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="yi-6b.*seamless-m4t"):
        serve_cli.main(["--arch", "whisper-large", "--device", "cpu"])
    from repro_torch.launch import train as train_cli
    from repro_torch.models import encdec

    def drawn(*a, **kw):
        raise AssertionError("a weight was drawn")
    monkeypatch.setattr(encdec, "encdec_init", drawn)
    ecfg = jax_smoke("seamless-m4t-medium")
    with pytest.raises(NotImplementedError) as want:
        JaxEngine(ecfg, None, slots=2, max_len=64)
    for argv in (["--arch", "seamless-m4t-medium", "--device", "cpu"],
                 ["--arch", "seamless-m4t-medium", "--smoke", "--device",
                  "cpu"]):
        with pytest.raises(NotImplementedError) as got:
            serve_cli.main(argv)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as got:
        ServeEngine(get_smoke_config("seamless-m4t-medium"), None, slots=2,
                    max_len=64)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="frames"):
        train_cli.main(["--arch", "seamless-m4t-medium", "--smoke",
                        "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("nr", [128, 256, 512, 1024])
def test_stream_plan_fits_the_card(d, nr):
    """The streamed body's shared-memory plan (host mirror of
    ``stream_fwd_floats``) fits a CTA's 227 KB at every width and window
    of the local layers; the forward and the backward take these
    l0_causal shapes through their streamed bodies, while the other modes
    refuse nr past 64."""
    assert 4 * thb.stream_fwd_floats(d, d, nr) <= thb.SMEM_MAX
    assert thb.stream_takes(nr, d, d)
    assert thb.check_window_fwd("l0_causal", nr, d, d) == "stream"
    assert thb.check_window_bwd("l0_causal", nr, d, d) == "stream"
    for mode in ("l0_bidir", "coarse_bidir", "coarse_causal"):
        with pytest.raises(ValueError):
            thb.check_window_fwd(mode, nr, d, d)
    assert not thb.stream_takes(nr, thb.STREAM_MAX_D + 4, d)


@pytest.mark.parametrize("d,dv", [(64, 128), (128, 64)])
@pytest.mark.parametrize("nr", [128, 256, 512, 1024])
def test_stream_plan_fits_mixed_widths(d, dv, nr):
    """Key and value widths apart (y's and dq's register tiles follow dv
    and d, dK/dV/dW's the wider of the two): the streamed forward's and
    both backward passes' plans (host mirrors of ``stream_fwd_floats``,
    ``stream_dq_floats``, ``stream_dkvw_floats``) fit a CTA's 227 KB, and
    both directions take these l0_causal shapes through the streamed
    bodies."""
    assert 4 * thb.stream_fwd_floats(d, dv, nr) <= thb.SMEM_MAX
    assert 4 * max(thb.stream_dq_floats(d, dv, nr),
                   thb.stream_dkvw_floats(d, dv)) <= thb.SMEM_MAX
    assert thb.stream_bwd_takes(nr, d, dv)
    assert thb.check_window_fwd("l0_causal", nr, d, dv) == "stream"
    assert thb.check_window_bwd("l0_causal", nr, d, dv) == "stream"
