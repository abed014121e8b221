"""Port parity of the encoder-decoder family's pieces (``seamless-m4t-
medium``'s smoke config: 2 encoder and 2 decoder layers, d 64, 4 heads
of 16, nr 8) against the JAX package, through ``params_from_jax``: the
configs, the full config's parameter tree on the ``meta`` device, the
parameter copy (bf16 too), the cross-attention and its encoder memory,
the bidirectional encoder over padded frames, and the refusals.  The
model's loss, gradients, prefill, decode and train step are
``test_torch_encdec_model.py``'s.  fp32 on both sides; the JAX side runs
``attn_impl='jnp'``, as the JAX package's own tests run it on the CPU.
Tolerances: forward 2e-5 (``_torch_family.LOGIT_TOL``)."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_family as fam  # noqa: E402
from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models.encdec import encdec_init as jax_encdec_init  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.seamless_m4t_medium import DECODER_LEN  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = fam.LOGIT_TOL


@pytest.fixture(scope="module")
def smoke():
    return fam.smoke(ARCH)


def test_configs_match_jax():
    fam.configs_match(ARCH)
    from repro.configs.seamless_m4t_medium import DECODER_LEN as JAX_LEN
    assert DECODER_LEN == JAX_LEN == 1024


def test_every_assigned_config_is_ported():
    """The port's ARCH_IDS are the reference's ten, in its order, and
    ``get_model`` hands seamless-m4t-medium the encoder-decoder's
    functions."""
    assert ARCH_IDS == list(JAX_ARCH_IDS)
    fns = get_model(get_config(ARCH))
    assert fns.init is ted.encdec_init
    assert fns.loss is ted.encdec_loss
    assert fns.forward is ted.encdec_forward
    assert fns.decode_step is ted.encdec_decode_step


def _eval_shape_leaves(cfg):
    shapes = jax.eval_shape(lambda k: jax_encdec_init(k, cfg)[0],
                            jax.random.PRNGKey(0))
    return jax.tree.leaves(shapes)


def test_full_size_shapes_on_meta_match_jax():
    """977,758,208 parameters (norms included), every leaf the shape and
    dtype (bfloat16) of ``jax.eval_shape`` of the reference's init, in
    the reference's order; 524.7 M of them in the embedding and head."""
    cfg, tcfg = jax_config(ARCH), get_config(ARCH)
    want = _eval_shape_leaves(cfg)
    tp = get_model(tcfg).init(tcfg, seed=0, device="meta")
    got = tree_leaves(tp)
    assert all(t.device.type == "meta" for t in got)
    assert len(got) == len(want)
    for t, s in zip(got, want):
        assert tuple(t.shape) == tuple(s.shape)
        assert str(t.dtype).split(".")[-1] == s.dtype.name == "bfloat16"
    assert sum(t.numel() for t in got) == 977_758_208
    assert (tp["embed"]["w"].numel() + tp["lm_head"]["w"].numel()
            == 2 * 256206 * 1024)
    assert len(tp["encoder"]) == len(tp["decoder"]) == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    """Every leaf of the JAX tree (its lists of encoder and decoder
    layers too) carried bit for bit in its dtype, in the port's tree of
    the same order."""
    cfg = dataclasses.replace(fam.jax_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    params, _ = jax_encdec_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    assert set(tp) == {"embed", "lm_head", "enc_norm", "dec_norm",
                       "encoder", "decoder"}
    assert set(tp["decoder"][0]) == {"ln1", "attn", "lnx", "xattn", "ln2",
                                     "mlp"}
    assert set(tp["decoder"][1]["xattn"]) == {"wq", "wkv", "wo"}
    want = jax.tree.leaves(params)
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert str(a.dtype).split(".")[-1] == b.dtype.name == dtype
        np.testing.assert_array_equal(a.view(torch.int16).numpy()
                                      if dtype == "bfloat16" else a.numpy(),
                                      np.asarray(b).view(np.int16)
                                      if dtype == "bfloat16"
                                      else np.asarray(b))


def test_params_from_jax_refuses_a_short_tree(smoke):
    """A decoder layer without its cross-attention's ``wkv``, or a tree of
    the wrong depth, is refused by name."""
    cfg, params, tcfg, _ = smoke
    bad = jax.tree.map(np.asarray, params)
    del bad["decoder"][1]["xattn"]["wkv"]
    with pytest.raises(KeyError, match=r"decoder\[1\]\.xattn\.wkv"):
        params_from_jax(bad, tcfg, device="cpu")
    short = jax.tree.map(np.asarray, params)
    short["encoder"] = short["encoder"][:1]
    with pytest.raises(ValueError, match="1 encoder layers"):
        params_from_jax(short, tcfg, device="cpu")


def _xattn_case(cfg, B=2, Sd=7, Se=29, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Sd, cfg.d_model)).astype(np.float32)
    mk = rng.standard_normal((B, Se, cfg.num_kv_heads, cfg.head_dim)
                             ).astype(np.float32)
    mv = rng.standard_normal(mk.shape).astype(np.float32)
    # two batch rows with different frame weights: row 0 all live, row 1
    # padded past 17 frames
    w = np.ones((B, Se), np.float32)
    w[1, 17:] = 0.0
    return x, mk, mv, w


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_xattn_matches_jax(smoke, hkv):
    """``_xattn_apply`` at B 2 with per-row frame weights (and GQA groups
    of 1, 2 and 4) against the reference within 2e-5; the weights of
    batch row b mask heads b * hkv .. b * hkv + hkv - 1, so weights
    repeated across rows in place of within them (``.repeat(hkv, 1)``)
    would mask the wrong rows: that form is shown to differ here."""
    cfg, params, tcfg, tp = smoke
    cfg = dataclasses.replace(cfg, num_kv_heads=hkv)
    tcfg = dataclasses.replace(tcfg, num_kv_heads=hkv)
    key = jax.random.PRNGKey(5)
    jp, _ = jed._xattn_init(key, cfg, jax.numpy.float32)
    p = {k: {"w": torch.from_numpy(np.asarray(v["w"]).copy())}
         for k, v in jp.items()}
    x, mk, mv, w = _xattn_case(cfg)
    want = np.asarray(jax.jit(functools.partial(jed._xattn_apply, cfg=cfg))(
        jp, x=x, mem_k=mk, mem_v=mv, mem_weight=w))
    t = [torch.from_numpy(a) for a in (x, mk, mv, w)]
    got = ted._xattn_apply(p, tcfg, *t[:3], mem_weight=t[3]).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    unmasked = ted._xattn_apply(p, tcfg, *t[:3]).numpy()
    assert np.abs(unmasked[1] - want[1]).max() > 100 * TOL
    np.testing.assert_allclose(unmasked[0], want[0], atol=TOL)
    # the wrong repeat: row weights tiled across the batch
    wrong = t[3].repeat(hkv, 1).reshape(-1, t[3].shape[1])
    from repro_torch.core import dense_attention
    B, Sd = x.shape[:2]
    G = cfg.num_heads // hkv
    q = (t[0] @ p["wq"]["w"]).reshape(B, Sd, hkv, G, cfg.head_dim)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B * hkv, G, Sd, cfg.head_dim)
    kh = t[1].permute(0, 2, 1, 3).reshape(B * hkv, -1, cfg.head_dim)
    vh = t[2].permute(0, 2, 1, 3).reshape(B * hkv, -1, cfg.head_dim)
    zw = dense_attention(qh, kh, vh, kv_weight=wrong)
    zr = dense_attention(qh, kh, vh, kv_weight=t[3].repeat_interleave(
        hkv, dim=0))
    if hkv > 1:
        assert float((zw - zr).abs().max()) > 100 * TOL


def test_xattn_memory_matches_jax(smoke):
    """One decoder layer's ``wkv`` over the encoder output: k and v, each
    (B, Se, Hkv, hd), within 2e-5."""
    cfg, params, tcfg, tp = smoke
    enc = np.random.default_rng(2).standard_normal(
        (2, 29, cfg.d_model)).astype(np.float32)
    jk, jv = jed._xattn_memory(params["decoder"][0]["xattn"], cfg, enc)
    tk, tv = ted._xattn_memory(tp["decoder"][0]["xattn"], tcfg,
                               torch.from_numpy(enc))
    assert tuple(tk.shape) == (2, 29, cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)


@pytest.mark.parametrize("Se,live", [(45, (45, 30)), (64, (64, 64)),
                                     (64, (50, 9)), (37, None)])
def test_encode_matches_jax(smoke, Se, live):
    """The bidirectional encoder over ``Se`` frames (45 and 37 pad to 64:
    8 levels of nr 8) with per-row frame weights 0 past ``live`` (or
    none): every output within 2e-5 of the reference's, padded frames
    included."""
    cfg, params, tcfg, tp = smoke
    frames, fw = ted.stub_frames(tcfg, 2, Se, seed=Se, true_len=live)
    jw = None if live is None else fw
    want = jax.jit(functools.partial(jed.encode, cfg=cfg))(
        params, frames=frames, frame_weight=jw)
    got = ted.encode(tp, tcfg, torch.from_numpy(frames),
                     frame_weight=None if live is None
                     else torch.from_numpy(fw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL)


def test_encode_under_remat_gives_the_same_bits(smoke):
    """With ``remat`` on, the encoder's forward and its gradient are the
    bits of the run without it (the recompute runs the same ops on the
    same inputs)."""
    _, _, tcfg, tp = smoke
    frames, fw = ted.stub_frames(tcfg, 2, 40, seed=3, true_len=(40, 21))
    f = torch.from_numpy(frames).requires_grad_(True)
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(tcfg, remat=remat)
        y = ted.encode(tp, c, f, frame_weight=torch.from_numpy(fw))
        g, = torch.autograd.grad(y.square().sum(), f)
        outs.append((y.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_stub_frames_are_seeded_and_weighted():
    tcfg = get_smoke_config(ARCH)
    a, wa = ted.stub_frames(tcfg, 3, 20, seed=1, true_len=(20, 5, 11))
    b, _ = ted.stub_frames(tcfg, 3, 20, seed=1)
    assert a.shape == (3, 20, tcfg.d_model) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert wa.sum(1).tolist() == [20, 5, 11]
    assert (wa[1, :5] == 1).all() and (wa[1, 5:] == 0).all()


def test_refusals(smoke):
    """``init_caches`` raises the reference's text (the caches need the
    encoder memory); the decoder-only functions refuse the family and
    point at models/encdec.py; a bucketed true_len is refused."""
    cfg, params, tcfg, tp = smoke
    fns = get_model(tcfg)
    from repro.models import get_model as jax_model
    with pytest.raises(NotImplementedError) as want:
        jax_model(cfg).init_caches(params, cfg, 2, 64)
    with pytest.raises(NotImplementedError) as got:
        fns.init_caches(tp, tcfg, 2, 64)
    assert str(got.value) == str(want.value)
    for fn in (lambda: tt.lm_init(tcfg, device="meta"),
               lambda: tt.lm_forward(tp, tcfg, torch.zeros((1, 4),
                                                           dtype=torch.long)),
               lambda: tt.lm_init_decode_caches(tp, tcfg, 1, 64)):
        with pytest.raises(NotImplementedError, match="models/encdec.py"):
            fn()
    frames, _ = ted.stub_frames(tcfg, 1, 16)
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.zeros((1, 6), dtype=torch.long)}
    with pytest.raises(ValueError, match="true_len"):
        fns.prefill(tp, tcfg, batch, 32, true_len=4)
    logits, caches, pos = fns.prefill(tp, tcfg, batch, 32, true_len=6)
    assert pos.tolist() == [6] and len(caches) == tcfg.num_layers


def test_xattn_runs_in_its_profiler_range(smoke):
    """Every cross-attention op runs inside the ``xattn`` profiler range
    (the profilers' group of that name): a prefill of the 2-layer smoke
    model opens it twice a decoder layer (the encoder memory's projection,
    then the attention), a decode step once a layer."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import profile_serve as ps
    _, _, tcfg, tp = smoke
    assert ted.XATTN_RANGE == "xattn" and ted.XATTN_RANGE in ps.RANGES
    frames, _ = ted.stub_frames(tcfg, 1, 20, seed=5)
    fns = get_model(tcfg)
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.zeros((1, 5), dtype=torch.long)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, caches, pos = fns.prefill(tp, tcfg, batch, 32)
    spans = [e for e in prof.events() if e.name == ted.XATTN_RANGE]
    assert len(spans) == 2 * tcfg.num_layers
    assert all(e.cpu_children for e in spans)      # its ops run inside
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fns.decode_step(tp, tcfg, caches, logits.argmax(-1), pos)
    assert sum(e.name == ted.XATTN_RANGE
               for e in prof.events()) == tcfg.num_layers
