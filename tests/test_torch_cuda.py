"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a card every test here skips, so they
count nowhere on a CPU run.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

These cover shapes the smoke (``chip_smoke.py``) does not: GQA groups
G > 1, nr from 4 to 32, every band mode, head widths that are not a
multiple of 32 and up to 128, weight-0 keys and fully masked rows, every
mask edge of the decode positions, every sub level up to ratio 32, paged
pools with int8, mixed and fp32 levels.  Tolerances as in ``chip_smoke.py``: attention
forward within 1e-5 scaled by max(1, |plain|) (fp32 on both sides,
another summation order), cache updates bit-exact (paged ones outside
the TRASH page, whose rows several inactive rows write at once),
backward within 1e-4 scaled by max(1, |plain|) where |plain|
of a gradient vector's entry is the largest magnitude of that vector
(a key's dK sums up to nq * G = 512 rows whose terms cancel in single
columns; fp32 rounding is bounded by the terms' size, not by one
column's sum).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import exact_products, kernels  # noqa: E402
from repro_torch.core import h1d_decode as hd  # noqa: E402
from repro_torch.core import hierarchy as hc  # noqa: E402
from repro_torch.core.h1d_attention import h1d_attention  # noqa: E402
from repro_torch.kernels import h1d_block as hb  # noqa: E402
from repro_torch.kernels import h1d_block_bwd as hbb  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as dk  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-5
BWD_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    exact_products()
    return torch.device("cuda")


def _close(got, want):
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        err = ((x.double() - y.double()).abs()
               / y.double().abs().clamp(min=1.0)).max()
        assert float(err) <= TOL, float(err)


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev)


def _close_grads(got, want):
    """(dq, dk, dv, dw, gmn): the first three are rows of vectors, scaled
    by their row's largest magnitude; dw and gmn elementwise."""
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.isfinite(x).all()
        mag = y.double().abs()
        if i < 3:
            mag = mag.amax(-1, keepdim=True)
        err = ((x.double() - y.double()).abs() / mag.clamp(min=1.0)).max()
        assert float(err) <= BWD_TOL, (i, float(err))


def _cotangents(gen, dev, out):
    return [_randn(gen, dev, *t.shape) for t in out]


# the GQA groups of qwen2.5-14b (5) and yi-6b (8) at head width 128
WIDE_GQA = [(2, 5, 256, 128, 128, 16), (2, 8, 256, 128, 128, 16)]


@pytest.mark.parametrize("B,G,L,d,dv,nr", [
    (3, 1, 64, 64, 64, 16), (2, 2, 128, 16, 16, 8), (2, 4, 32, 40, 24, 8),
    (1, 2, 256, 128, 128, 32), (2, 1, 64, 8, 72, 4), *WIDE_GQA])
def test_band_fwd_matches_plain(dev, B, G, L, d, dv, nr):
    gen = torch.Generator(device=dev).manual_seed(L + G)
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    k = _randn(gen, dev, B, L, d)
    w = torch.ones((B, L), device=dev)
    w[0, L // 2:] = 0.0                        # padded tail
    w[-1, : 2 * nr] = 0.0                      # masked head: empty rows
    v = _randn(gen, dev, B, L, dv) * w[..., None]
    got = hb.band_attention_fwd(q, k, v, w, nr=nr)
    _close(got, hb.band_attention_fwd_ref(q, k, v, w, nr=nr))
    # rows whose every key has weight 0 give m = -1e30, y = 0, dn = 0
    y, dn, m = got
    assert torch.all(m[-1, :, :nr] == hb._MIN_M)
    assert not y[-1, :, :nr].any() and not dn[-1, :, :nr].any()


# (d, dv) of the streamed bodies' card tests: every register-tile layout
# (y's follows dv, dq's d, dk/dv's the wider; 2, 4 or 8 rows a lane at
# widths up to 64, 128, 256) and the widths apart both ways
STREAM_DIMS = [(64, 64), (128, 128), (256, 256), (64, 128), (128, 64)]


@pytest.mark.parametrize("blocks", [3, 4])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("d,dv", STREAM_DIMS)
@pytest.mark.parametrize("nr", [128, 256, 1024])
def test_band_stream_matches_plain(dev, nr, d, dv, G, blocks):
    """The streamed l0_causal body (nr past the staged body's 64) against
    the plain version: 3 and 4 blocks, a zero-weight tail that ends
    mid-block, a row whose window starts with a whole dead block (its
    first key tiles are skipped), and rows with no live key at all."""
    B, L = 3, blocks * nr
    gen = torch.Generator(device=dev).manual_seed(nr + dv + G + blocks)
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    k = _randn(gen, dev, B, L, d)
    w = torch.ones((B, L), device=dev)
    w[0, L - nr // 2 - 37:] = 0.0              # tail, as a padded prompt
    w[1, :nr] = 0.0                            # a dead first block
    w[2, : nr + 40] = 0.0                      # rows with no live key
    v = _randn(gen, dev, B, L, dv) * w[..., None]
    assert hb.check_window_fwd("l0_causal", nr, d, dv) == "stream"
    kernels.reset_counts()
    got = hb.band_attention_fwd(q, k, v, w, nr=nr)
    assert hb.band_attention_fwd.mode_launches == {"l0_causal_stream": 1}
    _close(got, hb.band_attention_fwd_ref(q, k, v, w, nr=nr))
    y, dn, m = got
    assert torch.all(m[2, :, :nr] == hb._MIN_M)
    assert not y[2, :, :nr].any() and not dn[2, :, :nr].any()
    for a, b in zip(got, hb.band_attention_fwd(q, k, v, w, nr=nr)):
        assert torch.equal(a, b)


def test_band_stream_plan_matches_launcher(dev):
    """The host mirror of the streamed body's shared-memory plan is the
    launcher's, byte for byte."""
    lib = hb._lib()
    for d, dv, nr in ((64, 64, 128), (256, 256, 1024), (40, 24, 256),
                      (256, 128, 4096), (8, 8, 2)):
        assert lib.h1d_band_stream_smem(d, dv, nr) == \
            4 * hb.stream_fwd_floats(d, dv, nr)


def _stream_operands(gen, dev, B, G, L, d, nr, dv=None):
    """Streamed-body operands: a zero-weight tail ending mid-block, a dead
    first block, rows whose whole window has w = 0; v of dv columns (d
    unless given)."""
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    k = _randn(gen, dev, B, L, d)
    w = torch.ones((B, L), device=dev)
    w[0, L - nr // 2 - 37:] = 0.0
    w[1, :nr] = 0.0
    w[2, : nr + 40] = 0.0
    v = _randn(gen, dev, B, L, dv or d) * w[..., None]
    return q, k, v, w


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("d,dv", STREAM_DIMS)
@pytest.mark.parametrize("nr", [128, 256, 1024])
def test_band_stream_bwd_matches_plain(dev, nr, d, dv, G):
    """The streamed l0_causal backward (#3 past the staged body's nr =
    64) from the streamed forward's saved outputs, random cotangents on
    y, dn and m (gm too), at 3 blocks (L not nr * 2**k): within 1e-4 of
    the plain version; rows whose window has no live key give dq = 0 and
    gmn = 0; two calls give identical bits."""
    B, L = 3, 3 * nr
    gen = torch.Generator(device=dev).manual_seed(nr + dv + G)
    q, k, v, w = _stream_operands(gen, dev, B, G, L, d, nr, dv)
    assert hb.check_window_bwd("l0_causal", nr, d, dv) == "stream"
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    args = (q, k, v, w, *out, *_cotangents(gen, dev, out))
    kernels.reset_counts()
    got = hbb.band_attention_bwd(*args, nr=nr)
    assert hbb.band_attention_bwd.mode_launches == {"l0_causal_stream": 1}
    _close_grads(got, hbb.band_attention_bwd_ref(*args, nr=nr))
    assert not got[0][2, :, :nr].any() and not got[4][2, :, :nr].any()
    for a, b in zip(got, hbb.band_attention_bwd(*args, nr=nr)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("G,d,nr,blocks", [(2, 256, 1024, 3), (2, 64, 128, 4),
                                           (1, 40, 256, 3), (4, 256, 128, 5)])
def test_band_stream_bwd_ties_and_bits(dev, G, d, nr, blocks):
    """The streamed backward on exact scores (q and k integer-valued, so
    every score is exact in any summation order) with the last key of
    each block repeated as the first of the next: a key of +-3 entries,
    and the first 8 rows of the next block aligned with it, whose max it
    then is, so they tie at their max across two key blocks; a dead head
    and dead keys in the middle.  Within 1e-4 of the plain version; each
    row's tie share gmn * c sums to its gmh (c the exact tie count over
    the whole window), rows with no live key give gmn = 0 and dq = 0;
    identical bits twice."""
    B, L = 2, blocks * nr
    gen = torch.Generator(device=dev).manual_seed(L + G + d)
    q = torch.randint(-3, 4, (B, G, L, d), generator=gen,
                      device=dev).float() * 0.125
    k = torch.randint(-3, 4, (B, L, d), generator=gen, device=dev).float()
    kd = 3.0 * (2 * torch.randint(0, 2, (B, blocks - 1, d), generator=gen,
                                  device=dev).float() - 1)
    k[:, nr - 1:L - 1:nr] = kd
    k[:, nr::nr] = kd
    for J in range(1, blocks):
        q[:, :, J * nr: J * nr + 8] = 0.125 * kd[:, None, None, J - 1]
    w = torch.rand((B, L), generator=gen, device=dev) + 0.5
    w[1, : nr + nr // 2] = 0.0
    w[0, L // 2: L // 2 + nr + 8] = 0.0
    v = _randn(gen, dev, B, L, d) * w[..., None]
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    y, dn, m = out
    cot = _cotangents(gen, dev, out)
    args = (q, k, v, w, *out, *cot)
    got = hbb.band_attention_bwd(*args, nr=nr)
    _close_grads(got, hbb.band_attention_bwd_ref(*args, nr=nr))
    for a, b in zip(got, hbb.band_attention_bwd(*args, nr=nr)):
        assert torch.equal(a, b)
    i = torch.arange(L, device=dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    allow = (hb.band_mask(i, j, nr, "l0_causal", L)[None, None]
             & (w > 0)[:, None, None, :])
    dead = (~allow.any(-1)).expand(B, G, L)
    dq, gmn = got[0], got[4]
    assert dead.any() and not dq[dead].any() and not gmn[dead].any()
    s = torch.einsum("bgid,bjd->bgij", q.double(), k.double())
    top = (s == m.double()[..., None]) & allow
    c = top.sum(-1).double()
    gy, gdn, gm = (t.double() for t in cot)
    gmh = gm - ((gy * y.double()).sum(-1) + gdn * dn.double())
    assert torch.allclose(gmn.double() * c, torch.where(c > 0, gmh, 0.0),
                          rtol=1e-5, atol=1e-5)
    blk = top.view(B, G, L, blocks, nr).any(-1).sum(-1)
    assert int((blk >= 2).sum()) > 0


# keys of block 1 (offsets from nr + 64, a 32-key tile boundary) that
# repeat a row's max key: three in one key tile of the dQ pass, four (the
# tie list's length) across two tiles, seven (past it: the window rescan)
TIE_PLACES = {"one tile": (0, 3, 17), "two tiles": (30, 31, 32, 34),
              "past the list": (0, 5, 33, 40, 70, 100, 130)}


@pytest.mark.parametrize("place", sorted(TIE_PLACES))
@pytest.mark.parametrize("G", [1, 2, 4])
def test_band_stream_bwd_tie_lists(dev, G, place):
    """The dQ pass's tie lists: exact scores (integer-valued q and k) and
    copies of one key of +-3 entries at ``TIE_PLACES[place]`` in block 1;
    rows late in block 1 and early in block 2 aligned with it (their max,
    tied at every copy).  Those rows count exactly the copies (three in a
    tile, four across two, seven past the list of hb.STREAM_TIES); each
    row's gmn * c is its gmh; dq, dk, dv, dw within 1e-4 of the plain
    version; identical bits twice."""
    B, nr, d = 2, 256, 64
    L = 3 * nr
    gen = torch.Generator(device=dev).manual_seed(25 + G)
    q = torch.randint(-3, 4, (B, G, L, d), generator=gen,
                      device=dev).float() * 0.125
    k = torch.randint(-3, 4, (B, L, d), generator=gen, device=dev).float()
    kd = 3.0 * (2 * torch.randint(0, 2, (B, d), generator=gen,
                                  device=dev).float() - 1)
    copies = [nr + 64 + o for o in TIE_PLACES[place]]
    k[:, copies] = kd[:, None]
    rows = [*range(nr + 200, nr + 208), *range(2 * nr + 10, 2 * nr + 18)]
    q[:, :, rows] = 0.125 * kd[:, None, None]
    w = torch.rand((B, L), generator=gen, device=dev) + 0.5
    v = _randn(gen, dev, B, L, d) * w[..., None]
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    y, dn, m = out
    cot = _cotangents(gen, dev, out)
    args = (q, k, v, w, *out, *cot)
    got = hbb.band_attention_bwd(*args, nr=nr)
    _close_grads(got, hbb.band_attention_bwd_ref(*args, nr=nr))
    for a, b in zip(got, hbb.band_attention_bwd(*args, nr=nr)):
        assert torch.equal(a, b)
    i = torch.arange(L, device=dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    allow = (hb.band_mask(i, j, nr, "l0_causal", L)[None, None]
             & (w > 0)[:, None, None, :])
    s = torch.einsum("bgid,bjd->bgij", q.double(), k.double())
    c = ((s == m.double()[..., None]) & allow).sum(-1)
    assert (c[:, :, rows] == len(copies)).all()
    gy, gdn, gm = (t.double() for t in cot)
    gmh = gm - ((gy * y.double()).sum(-1) + gdn * dn.double())
    assert torch.allclose(got[4].double() * c, torch.where(c > 0, gmh, 0.0),
                          rtol=1e-5, atol=1e-5)


def test_band_stream_bwd_plan_matches_launcher(dev):
    """The host mirrors of the streamed backward's two shared-memory
    plans are the launcher's, byte for byte, and fit the card."""
    lib = hbb._lib()
    for d, dv, nr in ((64, 64, 128), (256, 256, 1024), (40, 24, 256),
                      (256, 128, 4096), (8, 8, 2)):
        dq = 4 * hb.stream_dq_floats(d, dv, nr)
        kv = 4 * hb.stream_dkvw_floats(d, dv)
        assert lib.h1d_band_bwd_stream_smem(d, dv, nr, 0) == dq
        assert lib.h1d_band_bwd_stream_smem(d, dv, nr, 1) == kv
        assert max(dq, kv) <= hb.SMEM_MAX


def _close_gmn(got, want, y, dn, cot):
    """gmn = (gm - (gy . y + gdn dn)) / c within BWD_TOL of the size of
    the terms it is formed from (|gm| + sum |gy| |y| + |gdn dn|, at least
    1), the row scaling of dq, dk and dv applied to gmh: at deep levels
    dn reaches nr * ratio (2048 at ratio 128), and where the terms
    cancel to a small gmh each fp32 side is off by up to half an ulp of
    the terms (the kernel fuses gdn * dn into its add, the plain version
    rounds the product first)."""
    gy, gdn, gm = (t.double() for t in cot)
    terms = gm.abs() + (gy.abs() * y.double().abs()).sum(-1) \
        + (gdn * dn.double()).abs()
    err = ((got.double() - want.double()).abs() / terms.clamp(min=1.0)).max()
    assert float(err) <= BWD_TOL, float(err)


def test_global_layer_backward_at_gemma_width(dev):
    """gemma3-4b's global layer: the staged #3 l0_causal at nr 16 and #4
    at every sub level (ratio 2 .. 128) at d = 256, G = 2 (one sequence's
    4 kv-heads, 8 q heads), L = 4096, against their plain versions (dq,
    dk, dv and dw as every backward row, gmn by :func:`_close_gmn`); #4
    twice gives identical bits."""
    gen = torch.Generator(device=dev).manual_seed(24)
    B, G, L, D, nr = 4, 2, 4096, 256, 16
    q = _randn(gen, dev, B, G, L, D) / D ** 0.5
    k = _randn(gen, dev, B, L, D)
    w = torch.ones((B, L), device=dev)
    w[:, 3000:] = 0.0
    v = _randn(gen, dev, B, L, D) * w[..., None]
    assert hb.check_window_bwd("l0_causal", nr, D, D) == "band"

    def check(got, want, out, cot):
        _close_grads(got[:4], want[:4])
        _close_gmn(got[4], want[4], out[0], out[1], cot)
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    cot = _cotangents(gen, dev, out)
    args = (q, k, v, w, *out, *cot)
    kernels.reset_counts()
    check(hbb.band_attention_bwd(*args, nr=nr),
          hbb.band_attention_bwd_ref(*args, nr=nr), out, cot)
    assert hbb.band_attention_bwd.mode_launches == {"l0_causal": 1}
    kc, vc, wc = k, v, w
    for lvl in range(1, hc.num_levels(L, nr)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc)
        wc = hc.coarsen_sum(wc, axis=-1)
        fwd = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        kw = dict(nr=nr, ratio=1 << lvl)
        out = hb.band_attention_sub_fwd(*fwd, **kw)
        cot = _cotangents(gen, dev, out)
        args = (*fwd, *out, *cot)
        got = hbb.band_attention_sub_bwd(*args, **kw)
        check(got, hbb.band_attention_sub_bwd_ref(*args, **kw), out, cot)
        for a, b in zip(got, hbb.band_attention_sub_bwd(*args, **kw)):
            assert torch.equal(a, b)
    assert lvl == 7


def test_local_training_grads_on_card_match_plain(dev):
    """The gemma smoke model at window 128 (the streamed forward and
    backward on its local layers) under remat: its lm_loss gradient on
    the kernels within 1e-4 of each leaf's largest |plain| on the card,
    every band kernel of both layer kinds launched, the streamed ones
    twice forward (remat) for each backward."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import ZipfLM
    from repro_torch.models import get_model
    from repro_torch.train import batch_to_device
    from repro_torch.tree import tree_leaves, tree_unflatten_like

    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"),
                              sliding_window=128, remat=True)
    fns = get_model(cfg)
    params = fns.init(cfg, seed=2, device=dev)
    batch = batch_to_device(ZipfLM(vocab_size=cfg.vocab_size, seq_len=384,
                                   batch_per_host=2, seed=4).batch(0), dev)

    def grads():
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = fns.loss(tree_unflatten_like(params, leaves), cfg, batch)
        return torch.autograd.grad(loss, leaves)
    kernels.reset_counts()
    got = grads()
    local = sum(not cfg.layer_uses_global_attn(i)
                for i in range(cfg.num_layers))
    assert hbb.band_attention_bwd.mode_launches["l0_causal_stream"] == local
    assert hb.band_attention_fwd.mode_launches["l0_causal_stream"] == \
        2 * local
    assert hbb.band_attention_sub_bwd.launches > 0
    assert not any(p.calls for _, p in kernels.KERNELS.values())
    swaps = [(hb, "band_attention_fwd", hb.band_attention_fwd_ref),
             (hb, "band_attention_sub_fwd", hb.band_attention_sub_fwd_ref),
             (hbb, "band_attention_bwd", hbb.band_attention_bwd_ref),
             (hbb, "band_attention_sub_bwd", hbb.band_attention_sub_bwd_ref)]
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, fn in swaps:
            mp.setattr(mod, name, fn)
        want = grads()
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("mode", ["l0_causal", "l0_bidir"])
@pytest.mark.parametrize("nr,blocks", [(16, 3), (8, 5), (64, 3)])
def test_band_fwd_whole_blocks(dev, mode, nr, blocks):
    """Level 0 at block counts that are not powers of two (a sliding
    window pads L to a multiple of the window only) on the staged body."""
    B, G, L, d = 2, 2, nr * blocks, 32
    gen = torch.Generator(device=dev).manual_seed(nr * blocks)
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    k = _randn(gen, dev, B, L, d)
    w = torch.ones((B, L), device=dev)
    w[1, L - nr // 2 - 3:] = 0.0
    v = _randn(gen, dev, B, L, d) * w[..., None]
    kernels.reset_counts()
    got = hb.band_attention_fwd(q, k, v, w, nr=nr, mode=mode)
    assert hb.band_attention_fwd.mode_launches == {mode: 1}
    _close(got, hb.band_attention_fwd_ref(q, k, v, w, nr=nr, mode=mode))


BWD_L0 = [(3, 1, 64, 64, 64, 16), (2, 2, 128, 16, 16, 8),
          (2, 4, 32, 40, 24, 8), (1, 2, 256, 128, 128, 32),
          (2, 1, 64, 8, 72, 4), (2, 3, 512, 64, 64, 16), *WIDE_GQA]


@pytest.mark.parametrize("B,G,L,d,dv,nr", BWD_L0)
def test_band_bwd_matches_plain(dev, B, G, L, d, dv, nr):
    """Level-0 backward from the forward kernel's saved outputs, random
    cotangents on y, dn and m; padded tails and fully masked rows."""
    gen = torch.Generator(device=dev).manual_seed(7 * L + G)
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    k = _randn(gen, dev, B, L, d)
    w = torch.ones((B, L), device=dev)
    w[0, L // 2:] = 0.0
    w[-1, : 2 * nr] = 0.0
    v = _randn(gen, dev, B, L, dv) * w[..., None]
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    args = (q, k, v, w, *out, *_cotangents(gen, dev, out))
    got = hbb.band_attention_bwd(*args, nr=nr)
    _close_grads(got, hbb.band_attention_bwd_ref(*args, nr=nr))
    # fully masked rows route nothing; no atomics: identical bits again
    assert not got[4][-1, :, :nr].any() and not got[0][-1, :, :nr].any()
    for a, b in zip(got, hbb.band_attention_bwd(*args, nr=nr)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("G,L,d,nr", [(1, 1024, 64, 16), (2, 128, 16, 8),
                                      (4, 256, 40, 4), (3, 64, 128, 4),
                                      (2, 2048, 128, 32), (5, 512, 128, 16),
                                      (8, 512, 128, 16)])
def test_band_sub_bwd_matches_plain_every_level(dev, G, L, d, nr):
    """Every sub level of a hierarchy (ratio 2 up to L / (2 nr), so 32
    at the first and last cases) on the coarsened chain."""
    gen = torch.Generator(device=dev).manual_seed(G * L + d)
    B = 2
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    kc = _randn(gen, dev, B, L, d)
    wc = torch.ones((B, L), device=dev)
    wc[1, L - L // 3:] = 0.0
    vc = _randn(gen, dev, B, L, d) * wc[..., None]
    for lvl in range(1, hc.num_levels(L, nr)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc)
        wc = hc.coarsen_sum(wc, axis=-1)
        fwd = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        out = hb.band_attention_sub_fwd(*fwd, nr=nr, ratio=1 << lvl)
        args = (*fwd, *out, *_cotangents(gen, dev, out))
        _close_grads(hbb.band_attention_sub_bwd(*args, nr=nr, ratio=1 << lvl),
                     hbb.band_attention_sub_bwd_ref(*args, nr=nr,
                                                    ratio=1 << lvl))


def test_h1d_attention_grads_on_card_match_plain(dev):
    """The whole operator's gradient on the kernels against the plain
    versions on the card (the backward kernels under autograd)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, G, L, D = 4, 2, 512, 64
    x = [_randn(gen, dev, B, G, L, D), _randn(gen, dev, B, L, D),
         _randn(gen, dev, B, L, D)]
    kw = torch.ones((B, L), device=dev)
    kw[0, 400:] = 0.0
    r = _randn(gen, dev, B, G, L, D)

    def grads():
        ts = [t.clone().requires_grad_(True) for t in x]
        z = h1d_attention(*ts, nr=16, causal=True, kv_weight=kw)
        return torch.autograd.grad((z * r).sum(), ts)
    kernels.reset_counts()
    got = grads()
    assert kernels.band_attention_bwd.launches == 1
    assert kernels.band_attention_sub_bwd.launches == hc.num_levels(L, 16) - 1
    swaps = [(hb, "band_attention_fwd", hb.band_attention_fwd_ref),
             (hb, "band_attention_sub_fwd", hb.band_attention_sub_fwd_ref),
             (hbb, "band_attention_bwd", hbb.band_attention_bwd_ref),
             (hbb, "band_attention_sub_bwd", hbb.band_attention_sub_bwd_ref)]
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, fn in swaps:
            mp.setattr(mod, name, fn)
        want = grads()
    _close_grads(got, want)


@pytest.mark.parametrize("G,L,d,nr", [(1, 256, 64, 16), (2, 128, 16, 8),
                                      (3, 64, 40, 4), (5, 512, 128, 16),
                                      (8, 512, 128, 16)])
def test_band_sub_fwd_matches_plain_every_level(dev, G, L, d, nr):
    gen = torch.Generator(device=dev).manual_seed(G * L)
    B = 2
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    kc = _randn(gen, dev, B, L, d)
    wc = torch.ones((B, L), device=dev)
    wc[1, L - 20:] = 0.0
    vc = _randn(gen, dev, B, L, d) * wc[..., None]
    for lvl in range(1, hc.num_levels(L, nr)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc)
        wc = hc.coarsen_sum(wc, axis=-1)
        args = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        _close(hb.band_attention_sub_fwd(*args, nr=nr, ratio=1 << lvl),
               hb.band_attention_sub_fwd_ref(*args, nr=nr, ratio=1 << lvl))


def _sub_level(ratio, nr):
    """Forward, backward and both plain versions of one fine-q level, or
    of coarse_causal (the same kernels) at ratio 1."""
    if ratio == 1:
        kw = dict(nr=nr, mode="coarse_causal")
        return (hb.band_attention_fwd, hb.band_attention_fwd_ref,
                hbb.band_attention_bwd, hbb.band_attention_bwd_ref, kw)
    kw = dict(nr=nr, ratio=ratio)
    return (hb.band_attention_sub_fwd, hb.band_attention_sub_fwd_ref,
            hbb.band_attention_sub_bwd, hbb.band_attention_sub_bwd_ref, kw)


@pytest.mark.parametrize("G,L,d,dv,nr", [
    (1, 256, 64, 64, 16), (2, 128, 40, 24, 8), (4, 64, 128, 128, 4),
    (3, 512, 16, 16, 32), (1, 128, 8, 72, 2)])
def test_band_sub_ties_dead_rows_and_bits_every_level(dev, G, L, d, dv, nr):
    """Forced ties: q and k integer-valued (every score exact in any
    summation order) and each key repeated at the next position, so rows
    tie exactly at their max.  At every sub level and in coarse_causal:
    #2 within 1e-5 and #4 within 1e-4 (row-scaled) of their plain
    versions; each row's tie share gmn * c sums to its gmh (c the exact
    tie count, gmn 0 where c is 0); query block 0 and the rows of dead key
    blocks give m = -1e30, y = 0, dn = 0, dq = 0, gmn = 0; two backward
    calls give identical bits."""
    gen = torch.Generator(device=dev).manual_seed(G * L + nr)
    B = 3
    q = torch.randint(-3, 4, (B, G, L, d), generator=gen,
                      device=dev).float() * 0.125
    ties = 0
    for ratio in [1] + [1 << l for l in range(1, hc.num_levels(L, nr))]:
        Lk, nq = L // ratio, nr * ratio
        k = torch.randint(-3, 4, (B, Lk, d), generator=gen,
                          device=dev).float()
        k[:, 1::2] = k[:, 0::2]
        w = torch.rand((B, Lk), generator=gen, device=dev) + 0.5
        w[0, Lk // 2:] = 0.0                     # a padded tail
        w[1, : 2 * nr] = 0.0                     # key blocks 0, 1 dead
        v = _randn(gen, dev, B, Lk, dv) * w[..., None]
        fwd, fwd_ref, bwd, bwd_ref, kw = _sub_level(ratio, nr)
        out = fwd(q, k, v, w, **kw)
        _close(out, fwd_ref(q, k, v, w, **kw))
        y, dn, m = out
        dead = [(slice(None), slice(0, nq))]
        if Lk >= 3 * nr:
            dead.append((1, slice(nq, 3 * nq)))
        for rows in dead:
            b, i = rows
            assert torch.all(m[b, :, i] == hb._MIN_M)
            assert not y[b, :, i].any() and not dn[b, :, i].any()
        cot = _cotangents(gen, dev, out)
        args = (q, k, v, w, *out, *cot)
        got = bwd(*args, **kw)
        _close_grads(got, bwd_ref(*args, **kw))
        for a, b2 in zip(got, bwd(*args, **kw)):
            assert torch.equal(a, b2)
        dq, gmn = got[0], got[4]
        for b, i in dead:
            assert not dq[b, :, i].any() and not gmn[b, :, i].any()
        # exact scores: the tie count and each row's tie share
        i = torch.arange(L, device=dev)[:, None]
        j = torch.arange(Lk, device=dev)[None, :]
        allow = (hb.band_mask(i, j, nr, "sub", Lk, ratio)[None, None]
                 & (w > 0)[:, None, None, :])
        s = torch.einsum("bgid,bjd->bgij", q.double(), k.double())
        c = ((s == m.double()[..., None]) & allow).sum(-1).double()
        gy, gdn, gm = (t.double() for t in cot)
        gmh = gm - ((gy * y.double()).sum(-1) + gdn * dn.double())
        share = gmn.double() * c
        assert torch.allclose(share, torch.where(c > 0, gmh, 0.0),
                              rtol=1e-5, atol=1e-5)
        assert not gmn[c == 0].any()
        ties += int((c >= 2).sum())
    assert ties > 0


def test_band_sub_lm_shape_every_level(dev):
    """#2 and #4 at the LM path's shapes (64 rows = 8 sequences x 8 kv
    heads, G = 1, L = 1024, d = 64, nr = 16, every third row padded by
    200) on the coarsened chain, every sub level, against their plain
    versions; #4 twice gives identical bits."""
    gen = torch.Generator(device=dev).manual_seed(11)
    B, G, L, D, nr = 64, 1, 1024, 64, 16
    q = _randn(gen, dev, B, G, L, D) / D ** 0.5
    kc = _randn(gen, dev, B, L, D)
    wc = torch.ones((B, L), device=dev)
    wc[::3, L - 200:] = 0.0
    vc = _randn(gen, dev, B, L, D) * wc[..., None]
    for lvl in range(1, hc.num_levels(L, nr)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc)
        wc = hc.coarsen_sum(wc, axis=-1)
        fwd = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        kw = dict(nr=nr, ratio=1 << lvl)
        out = hb.band_attention_sub_fwd(*fwd, **kw)
        _close(out, hb.band_attention_sub_fwd_ref(*fwd, **kw))
        args = (*fwd, *out, *_cotangents(gen, dev, out))
        got = hbb.band_attention_sub_bwd(*args, **kw)
        _close_grads(got, hbb.band_attention_sub_bwd_ref(*args, **kw))
        for a, b in zip(got, hbb.band_attention_sub_bwd(*args, **kw)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the bidirectional and coarse modes of #1 and #3
# ---------------------------------------------------------------------------

NEW_MODES = ("l0_bidir", "coarse_bidir", "coarse_causal")


def _lra_operands(gen, dev, B, G, L, d, dv, nr):
    """Rows right-padded to seeded true lengths (row 0 at nr + 3, so most
    of its coarse rows are fully masked), v pre-weighted."""
    q = _randn(gen, dev, B, G, L, d) / d ** 0.5
    k = _randn(gen, dev, B, L, d)
    lens = torch.randint(L // 4, L + 1, (B,), generator=gen, device=dev)
    lens[0] = nr + 3
    w = (torch.arange(L, device=dev)[None] < lens[:, None]).float()
    v = _randn(gen, dev, B, L, dv) * w[..., None]
    return q, k, v, w


@pytest.mark.parametrize("mode", NEW_MODES)
@pytest.mark.parametrize("B,G,L,d,dv,nr", [
    (3, 1, 256, 64, 64, 16), (2, 2, 128, 16, 16, 8), (2, 4, 32, 40, 24, 8),
    (2, 2, 64, 128, 128, 32), (2, 1, 64, 8, 72, 4), (4, 1, 32, 64, 64, 16)])
def test_band_new_modes_match_plain(dev, mode, B, G, L, d, dv, nr):
    """Forward and backward of each new mode against their plain
    versions: padded rows, fully masked rows, L = 2 blocks; the backward
    twice gives identical bits (no atomics)."""
    gen = torch.Generator(device=dev).manual_seed(L + G + d)
    q, k, v, w = _lra_operands(gen, dev, B, G, L, d, dv, nr)
    kernels.reset_counts()
    out = hb.band_attention_fwd(q, k, v, w, nr=nr, mode=mode)
    _close(out, hb.band_attention_fwd_ref(q, k, v, w, nr=nr, mode=mode))
    y, dn, m = out
    assert torch.all(m[0, :, 3 * nr:] == hb._MIN_M)
    assert not y[0, :, 3 * nr:].any() and not dn[0, :, 3 * nr:].any()
    args = (q, k, v, w, *out, *_cotangents(gen, dev, out))
    got = hbb.band_attention_bwd(*args, nr=nr, mode=mode)
    _close_grads(got, hbb.band_attention_bwd_ref(*args, nr=nr, mode=mode))
    assert not got[4][0, :, 3 * nr:].any() and not got[0][0, :, 3 * nr:].any()
    for a, b in zip(got, hbb.band_attention_bwd(*args, nr=nr, mode=mode)):
        assert torch.equal(a, b)
    assert hb.band_attention_fwd.mode_launches == {mode: 1}
    assert hbb.band_attention_bwd.mode_launches == {mode: 2}


BAND_MODES = ("l0_causal", "l0_bidir", "coarse_bidir")


@pytest.mark.parametrize("mode", BAND_MODES)
@pytest.mark.parametrize("B,G,L,d,dv,nr", [
    (3, 1, 256, 64, 64, 16), (2, 4, 128, 40, 24, 8), (2, 2, 512, 64, 64, 64),
    (2, 1, 128, 256, 256, 16), (3, 3, 64, 16, 16, 2), (3, 1, 128, 32, 72, 4)])
def test_band_ties_dead_tiles_quadrants_and_bits(dev, mode, B, G, L, d, dv,
                                                 nr):
    """The l0_causal, l0_bidir and coarse_bidir bodies on exact scores (q
    and k integer-valued, so every score is exact in any summation order)
    with a key of each block repeated in a block the same rows read (the
    block after in l0_causal and l0_bidir, two blocks on in coarse_bidir),
    so rows tie at their max across two key blocks; dead rows at the head
    and in the middle of a row, blocks with one live half; G up to 4, nr
    up to 64, d = dv = 256.  #1 within 1e-5 and #3 within 1e-4 of their
    plain versions; every row whose band has no key with w > 0 gives m =
    -1e30, y = 0, dn = 0, dq = 0, gmn = 0; each row's tie share gmn * c
    sums to its gmh (c the exact tie count over the whole band); two
    backward calls give identical bits."""
    gen = torch.Generator(device=dev).manual_seed(L + 7 * G + nr + d)
    nb = L // nr
    q = torch.randint(-3, 4, (B, G, L, d), generator=gen,
                      device=dev).float() * 0.125
    k = torch.randint(-3, 4, (B, L, d), generator=gen, device=dev).float()
    if mode == "coarse_bidir":
        k[:, 2 * nr::nr] = k[:, 0:L - 2 * nr:nr].clone()
    else:
        k[:, nr::nr] = k[:, nr - 1:L - 1:nr].clone()
    w = torch.rand((B, L), generator=gen, device=dev) + 0.5
    w[1, : L // 4] = 0.0                          # a dead head
    w[-1, L // 2: L // 2 + L // 4] = 0.0          # dead rows in the middle
    if nb >= 7:                                   # one live half a block
        w[0, 3 * nr: 3 * nr + nr // 2] = 0.0
        w[0, 5 * nr + nr // 2: 6 * nr] = 0.0
    v = _randn(gen, dev, B, L, dv) * w[..., None]
    kw = dict(nr=nr, mode=mode)
    out = hb.band_attention_fwd(q, k, v, w, **kw)
    _close(out, hb.band_attention_fwd_ref(q, k, v, w, **kw))
    y, dn, m = out
    i = torch.arange(L, device=dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    allow = (hb.band_mask(i, j, nr, mode, L)[None, None]
             & (w > 0)[:, None, None, :])
    dead = (~allow.any(-1)).expand(B, G, L)
    assert dead.any() and not dead.all()
    assert torch.all(m[dead] == hb._MIN_M)
    assert not y[dead].any() and not dn[dead].any()
    cot = _cotangents(gen, dev, out)
    args = (q, k, v, w, *out, *cot)
    got = hbb.band_attention_bwd(*args, **kw)
    _close_grads(got, hbb.band_attention_bwd_ref(*args, **kw))
    for a, b in zip(got, hbb.band_attention_bwd(*args, **kw)):
        assert torch.equal(a, b)
    dq, gmn = got[0], got[4]
    assert not dq[dead].any() and not gmn[dead].any()
    # exact scores: the tie count over the whole band and each row's share
    s = torch.einsum("bgid,bjd->bgij", q.double(), k.double())
    top = (s == m.double()[..., None]) & allow
    c = top.sum(-1).double()
    gy, gdn, gm = (t.double() for t in cot)
    gmh = gm - ((gy * y.double()).sum(-1) + gdn * dn.double())
    assert torch.allclose(gmn.double() * c, torch.where(c > 0, gmh, 0.0),
                          rtol=1e-5, atol=1e-5)
    assert not gmn[c == 0].any()
    # some rows tie at their max across two key blocks
    blocks = (top.view(B, G, L, nb, nr).any(-1)).sum(-1)
    assert int((blocks >= 2).sum()) > 0


@pytest.mark.parametrize("causal,causal_mode", [(False, "fine-q"),
                                                (True, "coarse-q")])
def test_h1d_attention_new_modes_grads_on_card_match_plain(dev, causal,
                                                           causal_mode):
    """The encoder and coarse-q operators on the kernels (every coarse
    level of L = 512 on coarsened queries), output and gradient, against
    the plain versions on the card."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B, G, L, D = 4, 1, 512, 64
    x = [_randn(gen, dev, B, G, L, D), _randn(gen, dev, B, L, D),
         _randn(gen, dev, B, L, D)]
    kw = torch.ones((B, L), device=dev)
    kw[0, 130:] = 0.0
    kw[2, 400:] = 0.0
    r = _randn(gen, dev, B, G, L, D)

    def run():
        ts = [t.clone().requires_grad_(True) for t in x]
        z = h1d_attention(*ts, nr=16, causal=causal, causal_mode=causal_mode,
                          kv_weight=kw)
        return (z.detach(), *torch.autograd.grad((z * r).sum(), ts))
    kernels.reset_counts()
    got = run()
    coarse = "coarse_causal" if causal else "coarse_bidir"
    l0 = "l0_causal" if causal else "l0_bidir"
    levels = hc.num_levels(L, 16) - 1
    for kernel in (hb.band_attention_fwd, hbb.band_attention_bwd):
        assert kernel.mode_launches == {l0: 1, coarse: levels}
    assert hb.band_attention_sub_fwd.launches == 0
    swaps = [(hb, "band_attention_fwd", hb.band_attention_fwd_ref),
             (hbb, "band_attention_bwd", hbb.band_attention_bwd_ref)]
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, fn in swaps:
            mp.setattr(mod, name, fn)
        want = run()
    _close(got[:1], want[:1])
    _close_grads(got[1:], want[1:])


def test_smoke_classifier_on_card_matches_cpu(dev):
    """The smoke encoder's logits and three AdamW losses on a ListOps
    batch, card (bidirectional modes launched, no plain version run)
    against CPU."""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import ListOps
    from repro_torch.models import classifier_init, classifier_loss
    from repro_torch.train import batch_to_device
    from repro_torch.tree import tree_leaves, tree_unflatten_like

    cfg = get_smoke_config("h1d-lra-encoder")
    data = ListOps(seq_len=256, batch_per_host=4, seed=0, max_depth=4,
                   breadth=3)
    losses = {}
    for device in ("cpu", "cuda"):
        params = classifier_init(cfg, 10, seed=1, device=device)
        opt = optim.adamw(optim.cosine_schedule(2e-3, 10, 3),
                          weight_decay=0.01)
        state = opt.init(params)
        kernels.reset_counts()
        losses[device] = []
        for i in range(3):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(params)]
            loss, _ = classifier_loss(tree_unflatten_like(params, leaves),
                                      cfg, batch_to_device(data.batch(i),
                                                           device))
            g = torch.autograd.grad(loss, leaves)
            upd, state = opt.update(tree_unflatten_like(params, list(g)),
                                    state, params)
            params = optim.apply_updates(params, upd)
            losses[device].append(float(loss.detach()))
        if device == "cuda":
            counts = kernels.mode_launches()
            for key in kernels.LRA_KERNELS:
                assert counts.get(key, 0) > 0, key
            assert not any(p.calls for _, p in kernels.KERNELS.values())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4)


def _ts(Lmax, nr):
    M = hc.num_levels(Lmax, nr)
    span = nr << max(M - 1, 1)
    ts = {0, 1, nr - 1, nr, 2 * nr - 1, span - 1, span,
          span + span // 2 - 1, span + span // 2, Lmax - 1}
    ts |= set(np.random.default_rng(Lmax).integers(0, Lmax, 6).tolist())
    return sorted(t % Lmax for t in ts)


@pytest.mark.parametrize("Lmax,nr,G,D,Dv", [
    (2048, 16, 1, 64, 64), (256, 8, 4, 16, 16), (512, 16, 2, 40, 24),
    (64, 8, 1, 16, 16), (16, 16, 2, 16, 16)])
def test_decode_attend_matches_plain(dev, Lmax, nr, G, D, Dv):
    gen = torch.Generator(device=dev).manual_seed(Lmax + G)
    ts = _ts(Lmax, nr)
    R = len(ts)
    cache = hd.prefill_cache(_randn(gen, dev, R, Lmax, D),
                             _randn(gen, dev, R, Lmax, Dv), Lmax, nr)
    q = _randn(gen, dev, R, G, D)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    _close([dk.decode_attend_fused(cache, q, t, nr=nr)],
           [dk.decode_attend_ref(cache, q, t, nr=nr)])


def _clone_cache(c):
    return hd.H1DCache(c.k.clone(), c.v.clone(),
                       tuple(a.clone() for a in c.ck),
                       tuple(a.clone() for a in c.cv))


def _levels(c):
    return (c.k, c.v, *c.ck, *c.cv)


@pytest.mark.parametrize("Lmax,nr,D,Dv", [
    (2048, 16, 64, 64), (128, 8, 16, 40), (16, 16, 8, 8), (256, 8, 5, 7),
    (256, 16, 64, 5), (512, 16, 256, 256), (64, 32, 7, 5),
    (8192, 8, 600, 600), (262144, 2, 3, 5)])
def test_update_cache_bit_exact(dev, Lmax, nr, D, Dv):
    """#6 against its plain version over 5 chained updates, bit-exact:
    odd widths, D != Dv, D = Dv = 256, one level ((16, 16), (64, 32)),
    more columns than a CTA's threads (600 + 600 at 10 levels) and 17
    levels; rows 0 and 1 at t = Lmax (which writes the last pair) and
    Lmax - 1."""
    gen = torch.Generator(device=dev).manual_seed(Lmax)
    R = 8
    base = hd.prefill_cache(_randn(gen, dev, R, Lmax, D),
                            _randn(gen, dev, R, Lmax, Dv), Lmax, nr)
    a, b = _clone_cache(base), _clone_cache(base)
    for step in range(5):
        t = torch.randint(0, Lmax, (R,), generator=gen, device=dev,
                          dtype=torch.int32)
        t[0], t[1] = Lmax, Lmax - 1
        kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, Dv)
        dk.update_cache_fused(a, kn, vn, t)
        dk.update_cache_ref(b, kn, vn, t)
        for x, y in zip(_levels(a), _levels(b)):
            assert torch.equal(x, y)


def test_wrappers_validate_operands(dev):
    q = torch.zeros((1, 1, 32, 8), device=dev)
    k = torch.zeros((1, 32, 8), device=dev)
    w = torch.ones((1, 32), device=dev)
    with pytest.raises(ValueError):            # non-contiguous
        hb.band_attention_fwd(q, k.transpose(1, 2).contiguous()
                              .transpose(1, 2), k, w, nr=8)
    with pytest.raises(ValueError):            # wrong dtype
        hb.band_attention_fwd(q.double(), k, k, w, nr=8)
    with pytest.raises(ValueError):            # unknown mode
        hb.band_attention_fwd(q, k, k, w, nr=8, mode="l1_bidir")
    # outside the staged bodies' envelope: nr > 64 in every mode, and a
    # bidirectional window of 3 x 64 keys at d = dv = 128, whose 16-row
    # tiles exceed the card's 227 KB of shared memory.  Both passes
    # refuse all of them but l0_causal at nr 128, which the streamed
    # bodies take
    gen = torch.Generator(device=dev).manual_seed(1)
    q128 = _randn(gen, dev, 1, 1, 256, 8)
    k128 = _randn(gen, dev, 1, 256, 8)
    w128 = torch.ones((1, 256), device=dev)
    qw = torch.zeros((1, 1, 128, 128), device=dev)
    kw = torch.zeros((1, 128, 128), device=dev)
    w64 = torch.ones((1, 128), device=dev)
    bad = [(mode, q128, k128, w128, 128) for mode in hb.MODES]
    bad += [(mode, qw, kw, w64, 64) for mode in ("l0_bidir", "coarse_bidir")]
    for mode, qb, kb, wb, nr in bad:
        out = hb.band_attention_fwd_ref(qb, kb, kb, wb, nr=nr, mode=mode)
        if mode == "l0_causal":
            _close(hb.band_attention_fwd(qb, kb, kb, wb, nr=nr, mode=mode),
                   out)
        else:
            with pytest.raises(ValueError):
                hb.band_attention_fwd(qb, kb, kb, wb, nr=nr, mode=mode)
        if mode == "l0_causal":
            _close_grads(hbb.band_attention_bwd(qb, kb, kb, wb, *out, *out,
                                                nr=nr, mode=mode),
                         hbb.band_attention_bwd_ref(qb, kb, kb, wb, *out,
                                                    *out, nr=nr, mode=mode))
        else:
            with pytest.raises(ValueError):
                hbb.band_attention_bwd(qb, kb, kb, wb, *out, *out, nr=nr,
                                       mode=mode)
    # whole blocks only: L = 200 is no multiple of nr = 128
    with pytest.raises(ValueError):
        hb.band_attention_fwd(q128[:, :, :200].contiguous(),
                              k128[:, :200].contiguous(),
                              k128[:, :200].contiguous(), w128[:, :200],
                              nr=128)
    # a window of 3 x 64 keys at d = 8 is inside it now
    q64 = _randn(gen, dev, 1, 1, 128, 8)
    k64 = _randn(gen, dev, 1, 128, 8)
    for mode in ("l0_bidir", "coarse_bidir"):
        _close(hb.band_attention_fwd(q64, k64, k64, w64, nr=64, mode=mode),
               hb.band_attention_fwd_ref(q64, k64, k64, w64, nr=64,
                                         mode=mode))


def test_smoke_engine_on_card_matches_cpu(dev):
    """The smoke model serves the same greedy tokens on the card (every
    kernel launched, no plain version run) as on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_smoke_config("h1d-lm-53m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 30, 9, 17, 40)]
    outs = {}
    for device in ("cpu", "cuda"):
        params = get_model(cfg).init(cfg, seed=2, device=device)
        eng = ServeEngine(cfg, params, slots=2, max_len=64)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_counts()
        eng.run()
        outs[device] = [r.out_tokens for r in reqs]
        if device == "cuda":
            for name in kernels.SERVE_KERNELS:
                kernel, plain = kernels.KERNELS[name]
                assert kernel.launches > 0 and plain.calls == 0
    assert outs["cuda"] == outs["cpu"]


def test_smoke_training_on_card_matches_cpu(dev):
    """Three AdamW steps of the smoke model on the card (every band
    kernel launched in both passes, no plain version run) give the CPU
    path's losses within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import ZipfLM
    from repro_torch.train import TrainConfig, init_state, make_train_step
    from repro_torch.train import batch_to_device

    cfg = get_smoke_config("h1d-lm-53m")
    tc = TrainConfig(peak_lr=1e-3, warmup=1, total_steps=10)
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=128, batch_per_host=4,
                  seed=5)
    losses = {}
    for device in ("cpu", "cuda"):
        state = init_state(cfg, tc, seed=1, device=device)
        step = make_train_step(cfg, tc)
        kernels.reset_counts()
        losses[device] = []
        for i in range(3):
            state, m = step(state, batch_to_device(data.batch(i), device))
            losses[device].append(float(m["loss"]))
        if device == "cuda":
            for name in kernels.TRAIN_KERNELS:
                kernel, plain = kernels.KERNELS[name]
                assert kernel.launches > 0 and plain.calls == 0, name
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4)


# ---------------------------------------------------------------------------
# paged pools (#7-#10)
# ---------------------------------------------------------------------------

def _paged_pool(gen, dev, M, nr, npages, D, Dv, quant):
    """Random pool: ``quant`` None for fp32, else per-level int8 flags."""
    def lvl(l, d, is_q):
        if is_q:
            return torch.randint(-127, 128, (npages, nr, d), generator=gen,
                                 device=dev, dtype=torch.int8)
        return _randn(gen, dev, npages, nr, d) * 2 ** l

    def sc():
        return torch.rand((npages, nr), generator=gen, device=dev) * 0.05 \
            + 1e-3

    flags = quant or (False,) * M
    k = [lvl(l, D, flags[l]) for l in range(M)]
    v = [lvl(l, Dv, flags[l]) for l in range(M)]
    if quant is None:
        return hd.PagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]))
    ks = [sc() if flags[l] else torch.ones((npages, nr), device=dev)
          for l in range(M)]
    vs = [sc() if flags[l] else torch.ones((npages, nr), device=dev)
          for l in range(M)]
    return hd.QuantPagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]),
                                 ks[0], vs[0], tuple(ks[1:]), tuple(vs[1:]))


def _quant(pattern, M):
    return {None: None, "all": (True,) * M,
            "ql1": (True,) + (False,) * (M - 1),
            "ql2": (True, True) + (False,) * (M - 2)}[pattern]


def _pool_clone(p):
    return type(p)(*[tuple(a.clone() for a in x) if isinstance(x, tuple)
                     else x.clone() for x in p])


def _pool_arrays(p):
    return [a for x in p for a in (x if isinstance(x, tuple) else (x,))]


@pytest.mark.parametrize("Lmax,nr,G,D,Dv,quant", [
    (2048, 16, 1, 64, 64, None), (2048, 16, 1, 64, 64, "all"),
    (256, 8, 4, 16, 16, "ql1"), (512, 16, 2, 40, 24, "ql2"),
    (128, 4, 2, 16, 16, "all"), (256, 32, 3, 64, 64, None)])
def test_paged_attend_matches_plain(dev, Lmax, nr, G, D, Dv, quant):
    gen = torch.Generator(device=dev).manual_seed(Lmax + nr + G)
    M = hc.num_levels(Lmax, nr)
    ts = _ts(Lmax, nr)
    R, npages = len(ts), 3 * len(ts) + 2
    pool = _paged_pool(gen, dev, M, nr, npages, D, Dv, _quant(quant, M))
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    bidx = torch.randint(0, npages, (R, 1 + M), generator=gen, device=dev,
                         dtype=torch.int32)
    q = _randn(gen, dev, R, G, D)
    kernel, plain = ((dk.decode_attend_paged, dk.decode_attend_paged_ref)
                     if quant is None else
                     (dk.decode_attend_paged_quant,
                      dk.decode_attend_paged_quant_ref))
    _close([kernel(pool, q, t, bidx, nr=nr)],
           [plain(pool, q, t, bidx, nr=nr)])


def _misaligned(x):
    """``x``'s values in a contiguous tensor that starts 4 bytes past a
    16-byte boundary, so the staged attend takes its cp.async copies."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    flat.copy_(x.reshape(-1))
    return flat.view(x.shape)


def _double(c):
    """A cache or pool with every array in float64."""
    return type(c)(*[tuple(a.double() for a in x) if isinstance(x, tuple)
                     else x.double() for x in c])


def _close_exact(got, want64, row_scaled=()):
    """``_close`` against the plain version evaluated in float64.  The
    staged cases reach 12 levels of D = Dv = 256, where the fp32 plain
    version is itself up to 2.5e-5 from the exact answer (values that sum
    2048 rows), so two fp32 evaluations can differ by more than TOL while
    both are right; the exact one is the yardstick there.  Outputs whose
    index is in ``row_scaled`` are scaled by their row's largest
    magnitude (the last axis) instead of their own: #11's numerator sums
    terms up to ~400 into entries near 1, where any fp32 order, the plain
    version's too, is ~2e-5 off element by element but ~1e-6 off for the
    row."""
    for i, (x, y) in enumerate(zip(got, want64)):
        assert x.shape == y.shape and torch.isfinite(x).all()
        mag = y.abs()
        if i in row_scaled:
            mag = mag.amax(-1, keepdim=True)
        err = ((x.double() - y).abs() / mag.clamp(min=1.0)).max()
        assert float(err) <= TOL, (i, float(err))


# the ring (13 bands of D = Dv = 256 at G = 4 exceed 227 KB: nr 32 streams
# keys and values, nr 16 values), D / Dv that are not multiples of 4
# (bulk copies of whole 4-row granules; nr 2: cp.async), blocks that are
# not 16-byte aligned (cp.async)
STAGED = [(65536, 32, 4, 256, 256, False), (32768, 16, 4, 256, 256, False),
          (256, 8, 2, 5, 7, False), (64, 2, 1, 3, 5, False),
          (512, 16, 3, 64, 40, True)]


@pytest.mark.parametrize("Lmax,nr,G,D,Dv,misalign", STAGED)
def test_paged_attend_ring_trash_rows_and_bits(dev, Lmax, nr, G, D, Dv,
                                               misalign):
    """#7's staged body against its plain version (in float64) at shapes
    off the main path, with two inactive rows as the engine builds them
    (t = 0, every band on the TRASH page, whose rows hold large values),
    and identical bits on a second call.  Keys are unit normals at every
    level (a coarse key is a mean), values scale by 2^l (a sum)."""
    gen = torch.Generator(device=dev).manual_seed(Lmax + nr + D)
    M = hc.num_levels(Lmax, nr)
    ts = _ts(Lmax, nr) + [0, 0]
    R, npages, trash = len(ts), 3 * len(ts) + 2, 1
    k = [_randn(gen, dev, npages, nr, D) for _ in range(M)]
    v = [_randn(gen, dev, npages, nr, Dv) * 2 ** l for l in range(M)]
    pool = hd.PagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]))
    for a in _pool_arrays(pool):
        a[trash] = 1e3 * _randn(gen, dev, *a[trash].shape)
    if misalign:
        pool = type(pool)(*[tuple(_misaligned(a) for a in x)
                            if isinstance(x, tuple) else _misaligned(x)
                            for x in pool])
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    bidx = torch.randint(2, npages, (R, 1 + M), generator=gen, device=dev,
                         dtype=torch.int32)
    bidx[R - 2:] = trash
    q = _randn(gen, dev, R, G, D)
    got = dk.decode_attend_paged(pool, q, t, bidx, nr=nr)
    _close_exact([got], [dk.decode_attend_paged_ref(
        _double(pool), q.double(), t, bidx, nr=nr)])
    assert torch.equal(got, dk.decode_attend_paged(pool, q, t, bidx, nr=nr))
    assert dk.plan_attend_stages(G, D, Dv, nr, M).resident == (Lmax < 32768)


@pytest.mark.parametrize("Lmax,nr,G,D,Dv,misalign", STAGED)
def test_dense_attend_ring_odd_misaligned_and_bits(dev, Lmax, nr, G, D, Dv,
                                                   misalign):
    """#5 on the staged body (the dense addressor) against its plain
    version in float64 at #7's staged shapes, rows at every mask edge
    and at t = Lmax (band 0 on the last block, clamped), and identical
    bits on a second call.  Keys are unit normals at every level, values
    scale by 2^l."""
    gen = torch.Generator(device=dev).manual_seed(Lmax + nr + D + 5)
    M = hc.num_levels(Lmax, nr)
    ts = _ts(Lmax, nr) + [Lmax]
    R = len(ts)
    k = [_randn(gen, dev, R, Lmax >> l, D) for l in range(M)]
    v = [_randn(gen, dev, R, Lmax >> l, Dv) * 2 ** l for l in range(M)]
    if misalign:
        k, v = [_misaligned(a) for a in k], [_misaligned(a) for a in v]
    cache = hd.H1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]))
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    q = _randn(gen, dev, R, G, D)
    got = dk.decode_attend_fused(cache, q, t, nr=nr)
    _close_exact([got], [dk.decode_attend_ref(_double(cache), q.double(), t,
                                              nr=nr)])
    assert torch.equal(got, dk.decode_attend_fused(cache, q, t, nr=nr))
    assert dk.plan_attend_stages(G, D, Dv, nr, M).resident == (Lmax < 32768)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("Lmax,nr,G,D,Dv,misalign", STAGED[1:])
def test_sp_partial_ring_rows_owning_nothing_and_bits(dev, d, Lmax, nr, G,
                                                      D, Dv, misalign):
    """#11's staged body against its plain version (in float64) on every
    shard at shapes off the main path, with rows whose bands are all
    unowned (num = den = 0, m = -1e30), and identical bits on a second
    call."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    gen = torch.Generator(device=dev).manual_seed(Lmax + d + D)
    ts = _sp_ts(Lmax, nr, d)
    R = len(ts)
    dense = hd.prefill_cache(_randn(gen, dev, R, Lmax, D),
                             _randn(gen, dev, R, Lmax, Dv), Lmax, nr)
    sc = sp.shard_cache(dense, make_mesh((d,), ("data",)), nr)
    del dense
    q = _randn(gen, dev, R, G, D)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    tabs = sp.sp_tables(np.array(ts), nr=nr, Lmax=Lmax, d=d, device=dev)
    for s, sh in enumerate(sc.shards):
        if misalign:
            sh = hd.H1DCache(_misaligned(sh.k), _misaligned(sh.v),
                             tuple(_misaligned(a) for a in sh.ck),
                             tuple(_misaligned(a) for a in sh.cv))
        owned = tabs.owned[s].clone()
        owned[:2] = 0
        args = (sh, q, t, tabs.bidx[s], owned)
        got = dk.decode_attend_partial(*args, nr=nr)
        _close_exact(got, dk.decode_attend_partial_ref(
            _double(sh), q.double(), *args[2:], nr=nr), row_scaled=(0,))
        num, den, m = got
        assert (num[:2] == 0).all() and (den[:2] == 0).all()
        assert (m[:2] == -1e30).all()
        for x, y in zip(got, dk.decode_attend_partial(*args, nr=nr)):
            assert torch.equal(x, y)


# #8's staged body on int8 pools off the main path (G, D, Dv, nr, Lmax,
# int8 levels, misaligned): the ring (13 bands of D = Dv = 256), odd
# widths at nr 8 (plain loads) and nr 16 (bulk copies of whole bands), a
# mixed pool, pools whose int8 rows start 1 byte and whose scales start 4
# bytes past a 16-byte boundary (plain loads), the main path's shape
QUANT_STAGED = [(65536, 32, 4, 256, 256, "all", False),
                (256, 8, 2, 5, 7, "all", False),
                (256, 16, 2, 5, 7, "all", False),
                (512, 16, 3, 64, 40, "ql2", False),
                (512, 16, 3, 64, 40, "all", True),
                (2048, 16, 1, 64, 64, "all", True)]


@pytest.mark.parametrize("Lmax,nr,G,D,Dv,quant,misalign", QUANT_STAGED)
def test_paged_quant_attend_staged_ring_odd_misaligned_and_bits(
        dev, Lmax, nr, G, D, Dv, quant, misalign):
    """#8 on the staged body against its plain version (in float64 on the
    same int8 rows and scales) with two inactive rows on the TRASH page
    (large rows and scales there), and identical bits on a second
    call."""
    gen = torch.Generator(device=dev).manual_seed(Lmax + nr + D + 8)
    M = hc.num_levels(Lmax, nr)
    ts = _ts(Lmax, nr) + [0, 0]
    R, npages, trash = len(ts), 3 * len(ts) + 2, 1
    pool = _paged_pool(gen, dev, M, nr, npages, D, Dv, _quant(quant, M))
    for a in _pool_arrays(pool):
        if a.dtype == torch.int8:
            a[trash] = 127
        elif a.dim() == 2:
            a[trash] = 1e3
        else:
            a[trash] = 1e3 * _randn(gen, dev, *a[trash].shape)
    if misalign:
        pool = type(pool)(*[tuple(_misaligned(a) for a in x)
                            if isinstance(x, tuple) else _misaligned(x)
                            for x in pool])
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    bidx = torch.randint(2, npages, (R, 1 + M), generator=gen, device=dev,
                         dtype=torch.int32)
    bidx[R - 2:] = trash
    q = _randn(gen, dev, R, G, D)
    got = dk.decode_attend_paged_quant(pool, q, t, bidx, nr=nr)
    _close_exact([got], [dk.decode_attend_paged_quant_ref(
        pool, q.double(), t, bidx, nr=nr)])
    assert torch.equal(got, dk.decode_attend_paged_quant(pool, q, t, bidx,
                                                         nr=nr))
    plan = dk.plan_attend_stages(G, D, Dv, nr, M, quant=True)
    assert plan.resident == (Lmax < 32768)


def test_attend_plan_mirrors_the_launcher(dev):
    """``plan_attend_stages`` equals the launcher's own plan (stages, rows
    a chunk, row quantum, shared memory) at every card test's shape, for
    f32 and bf16 caches and pools with int8 levels beside either, and past
    the envelope, where both refuse."""
    import ctypes

    lib = dk._lib()
    shapes = [(G, D, Dv, nr, nlev) for G in (1, 2, 3, 4, 9)
              for D, Dv in ((64, 64), (16, 16), (40, 24), (5, 7), (3, 5),
                            (256, 256), (64, 40), (1024, 1024))
              for nr in (2, 4, 8, 16, 32, 64) for nlev in (1, 4, 7, 12, 32)]
    out = (ctypes.c_int * 4)()
    for G, D, Dv, nr, nlev in shapes + [(1, 60000, 60000, 16, 5)]:
        for quant, half in ((0, 0), (1, 0), (0, 1), (1, 1)):
            assert lib.h1d_decode_attend_plan(G, D, Dv, nr, nlev, quant,
                                              half, out) == 0
            key = (G, D, Dv, nr, nlev, quant, half)
            try:
                plan = dk.plan_attend_stages(G, D, Dv, nr, nlev,
                                             quant=bool(quant),
                                             half=bool(half))
            except ValueError:
                assert out[0] == 0, key
                continue
            assert (plan.stages, plan.chunk_rows, plan.quantum,
                    plan.smem) == tuple(out), key


@pytest.mark.parametrize("Lmax,nr,D,Dv,quant", [
    (2048, 16, 64, 64, None), (2048, 16, 64, 64, "all"),
    (128, 8, 16, 40, "ql1"), (256, 4, 24, 8, "ql2"), (256, 32, 64, 64, None),
    (128, 8, 16, 40, None), (16, 16, 8, 8, None), (256, 8, 5, 7, None),
    (256, 16, 64, 5, None), (512, 16, 256, 256, None), (64, 32, 7, 5, None),
    (8192, 8, 600, 600, None), (262144, 2, 3, 5, None)])
def test_paged_update_bit_exact_outside_trash(dev, Lmax, nr, D, Dv, quant):
    """Five chained appends from 8 rows, two of them inactive (their
    update rows all on the TRASH page, as the engine builds them): the
    kernel equals the plain version bit for bit on every pool row except
    TRASH's, and a second run of the kernel gives the same bits there.
    #9 (fp32) also at #6's envelope (``test_update_cache_bit_exact``'s
    shapes: odd widths, D != Dv, D = Dv = 256, one level, 600 + 600
    columns at 10 levels, 17 levels)."""
    gen = torch.Generator(device=dev).manual_seed(Lmax + nr)
    M = max(hc.num_levels(Lmax, nr), 1)
    R, npages, trash = 8, 40, 1
    base = _paged_pool(gen, dev, M, nr, npages, D, Dv, _quant(quant, M))
    a, b, c = _pool_clone(base), _pool_clone(base), _pool_clone(base)
    kernel, plain = ((dk.update_cache_paged, dk.update_cache_paged_ref)
                     if quant is None else
                     (dk.update_cache_paged_quant,
                      dk.update_cache_paged_quant_ref))
    for step in range(5):
        t = torch.randint(0, Lmax, (R,), generator=gen, device=dev,
                          dtype=torch.int32)
        utab = torch.stack([torch.randperm(npages - 2, generator=gen,
                                           device=dev)[:R] + 2
                            for _ in range(M)], 1).to(torch.int32)
        utab[R - 2:] = trash
        kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, Dv)
        kernel(a, kn, vn, t, utab)
        kernel(c, kn, vn, t, utab)
        plain(b, kn, vn, t, utab)
        for x, y, z in zip(_pool_arrays(a), _pool_arrays(b),
                           _pool_arrays(c)):
            keep = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
            keep[trash] = False
            assert torch.equal(x[keep], y[keep])
            assert torch.equal(x[keep], z[keep])
            assert torch.isfinite(x.float()).all()


def _mixed_pool(gen, dev, nlev, nr, npages, D, Dv, qlevels):
    """A quantized pool of ``nlev`` levels, the first ``qlevels`` int8."""
    flags = tuple(l < qlevels for l in range(nlev))
    return _paged_pool(gen, dev, nlev, nr, npages, D, Dv, flags)


@pytest.mark.parametrize("nlev,qlevels,D,Dv", [
    (4, 4, 1024, 1024), (14, 0, 1024, 1024), (3, 1, 1024, 1)])
def test_paged_quant_update_at_the_envelope_edge(dev, nlev, qlevels, D, Dv):
    """#10 at the edge of its envelope -- widths of 1024 (32 columns a
    lane), and 14 f32 levels of 1024, whose staged pairs take 229376 of
    the 232448 bytes -- bit-exact against its plain version outside the
    TRASH page over chained ticks, with identical bits on a second run."""
    gen = torch.Generator(device=dev).manual_seed(nlev + D + Dv)
    R, nr, npages, trash = 6, 4, 16, 1
    assert dk.update_quant_smem(D, Dv, (1 << qlevels) - 1, nlev) \
        <= dk.SMEM_LIMIT
    base = _mixed_pool(gen, dev, nlev, nr, npages, D, Dv, qlevels)
    a, b, c = _pool_clone(base), _pool_clone(base), _pool_clone(base)
    for step in range(3):
        t = torch.randint(0, nr << nlev, (R,), generator=gen, device=dev,
                          dtype=torch.int32)
        utab = torch.stack([torch.randperm(npages - 2, generator=gen,
                                           device=dev)[:R] + 2
                            for _ in range(nlev)], 1).to(torch.int32)
        utab[R - 2:] = trash
        kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, Dv)
        dk.update_cache_paged_quant(a, kn, vn, t, utab)
        dk.update_cache_paged_quant(c, kn, vn, t, utab)
        dk.update_cache_paged_quant_ref(b, kn, vn, t, utab)
        for x, y, z in zip(_pool_arrays(a), _pool_arrays(b),
                           _pool_arrays(c)):
            keep = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
            keep[trash] = False
            assert torch.equal(x[keep], y[keep])
            assert torch.equal(x[keep], z[keep])


@pytest.mark.parametrize("nlev,qlevels,D,Dv", [
    (2, 2, 1025, 64), (2, 2, 64, 1025), (15, 0, 1024, 1024)])
def test_paged_quant_update_raises_past_the_envelope(dev, nlev, qlevels, D,
                                                     Dv):
    """Past #10's envelope (a width over 1024; 15 f32 levels of 1024,
    whose staged pairs exceed 232448 bytes) the wrapper raises with the
    sizes, and nothing is written."""
    gen = torch.Generator(device=dev).manual_seed(nlev)
    R, nr, npages = 2, 4, 4
    pool = _mixed_pool(gen, dev, nlev, nr, npages, D, Dv, qlevels)
    before = _pool_clone(pool)
    t = torch.zeros((R,), dtype=torch.int32, device=dev)
    utab = torch.full((R, nlev), 2, dtype=torch.int32, device=dev)
    kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, Dv)
    with pytest.raises(ValueError, match=f"D={D}, Dv={Dv}"):
        dk.update_cache_paged_quant(pool, kn, vn, t, utab)
    for x, y in zip(_pool_arrays(pool), _pool_arrays(before)):
        assert torch.equal(x, y)


def test_paged_smoke_engines_on_card_match_cpu(dev):
    """The smoke model served from paged pools on the card (fp32 with
    prefix sharing, copy on write and swap preemption; int8 at every
    level) gives the CPU's tokens, through #7/#9 and #8/#10 alone."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_smoke_config("h1d-lm-53m")
    rng = np.random.default_rng(7)
    pre = rng.integers(0, cfg.vocab_size, 21).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, n)
                               .astype(np.int32)]) for n in (3, 9, 14, 5)]
    prompts += [prompts[0], prompts[1]]
    runs = {"fp32": (dict(pool_pages=8, lookahead=4),
                     ("decode_attend_paged", "update_cache_paged")),
            "int8": (dict(cache_dtype="int8"),
                     ("decode_attend_paged_quant",
                      "update_cache_paged_quant"))}
    for name, (kw, used) in runs.items():
        outs = {}
        for device in ("cpu", "cuda"):
            params = get_model(cfg).init(cfg, seed=2, device=device)
            eng = ServeEngine(cfg, params, slots=4, max_len=64, paged=True,
                              **kw)
            reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            kernels.reset_counts()
            eng.run()
            outs[device] = [r.out_tokens for r in reqs]
            if device == "cuda":
                for k in used:
                    kernel, plain = kernels.KERNELS[k]
                    assert kernel.launches > 0 and plain.calls == 0, k
                assert eng.pool.stats.shared_maps > 0
                if name == "fp32":
                    assert eng.preemptions > 0
        assert outs["cuda"] == outs["cpu"], name


# ---------------------------------------------------------------------------
# sequence-parallel shards (#11, #12)
# ---------------------------------------------------------------------------

def _sp_ts(Lmax, nr, d):
    """Mask edges, every shard edge s*Lloc - 1 and s*Lloc, the last
    position and the out-of-range Lmax."""
    ts = set(_ts(Lmax, nr)) | {Lmax - 1, Lmax}
    for s in range(1, d):
        ts |= {s * Lmax // d - 1, s * Lmax // d}
    return sorted(ts)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("Lmax,nr,G,D,Dv", [
    (2048, 16, 1, 64, 64), (256, 8, 4, 16, 16), (512, 16, 2, 40, 24)])
def test_sp_partial_kernels_match_plain(dev, d, Lmax, nr, G, D, Dv):
    """#11 against its plain version on every shard's slab (1e-5 scaled)
    and merged against #5 on the unsharded cache; #12 bit-exact on every
    shard (slabs and carries), and the whole SP update (with the
    deep-level #6 step where levels replicate) against #6 on the
    unsharded cache."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    gen = torch.Generator(device=dev).manual_seed(Lmax + d)
    ts = _sp_ts(Lmax, nr, d)
    R = len(ts)
    dense = hd.prefill_cache(_randn(gen, dev, R, Lmax, D),
                             _randn(gen, dev, R, Lmax, Dv), Lmax, nr)
    mesh = make_mesh((d,), ("data",))
    sc = sp.shard_cache(dense, mesh, nr)
    q = _randn(gen, dev, R, G, D)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    tabs = sp.sp_tables(np.array(ts), nr=nr, Lmax=Lmax, d=d, device=dev)
    for s, sh in enumerate(sc.shards):
        got = dk.decode_attend_partial(sh, q, t, tabs.bidx[s],
                                       tabs.owned[s], nr=nr)
        want = dk.decode_attend_partial_ref(sh, q, t, tabs.bidx[s],
                                            tabs.owned[s], nr=nr)
        _close(got, want)
    kernels.reset_counts()
    with sp.sp_scope(mesh):
        merged = hd.decode_attend(sc, q, t, nr=nr, tables=tabs)
    assert kernels.KERNELS["decode_attend_partial"][0].launches == d
    _close([merged], [dk.decode_attend_fused(dense, q, t, nr=nr)])

    nsh = sp.sp_sharded_levels(Lmax, nr, d)
    kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, Dv)
    for s, sh in enumerate(sc.shards):
        def slab(c):
            return hd.H1DCache(c.k.clone(), c.v.clone(),
                               tuple(a.clone() for a in c.ck[:nsh - 1]),
                               tuple(a.clone() for a in c.cv[:nsh - 1]))
        a, b = slab(sh), slab(sh)
        _, ak, av = dk.update_cache_partial(a, kn, vn, tabs.t_loc[s],
                                            tabs.upd_owned[s])
        _, bk, bv = dk.update_cache_partial_ref(b, kn, vn, tabs.t_loc[s],
                                                tabs.upd_owned[s])
        for x, y in zip((a.k, a.v, *a.ck, *a.cv, ak, av),
                        (b.k, b.v, *b.ck, *b.cv, bk, bv)):
            assert torch.equal(x, y)
    with sp.sp_scope(mesh):
        hd.update_cache(sc, kn, vn, t, tables=tabs)
    dk.update_cache_fused(dense, kn, vn, t)
    back = sp.unshard_cache(sc)
    for x, y in zip((back.k, back.v, *back.ck, *back.cv),
                    (dense.k, dense.v, *dense.ck, *dense.cv)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("Lmax,nr,D,Dv", [
    (2048, 16, 64, 64), (256, 8, 5, 7), (512, 16, 40, 24), (64, 16, 8, 5)])
def test_update_partial_bit_exact(dev, d, Lmax, nr, D, Dv):
    """#12 on every shard's sharded levels over 5 chained ticks, each row
    near a mask, pair or shard edge (position base - 2 .. base + 2,
    clamped to [0, Lmax]): the slabs and every row's carries (owner and
    non-owner rows) bit-exact against the plain version, with t_loc past
    Lloc on the shards left of a row's owner.  (64, 16) at d = 4 shards
    one level."""
    from repro_torch.parallel import sp_attention as sp

    gen = torch.Generator(device=dev).manual_seed(Lmax + 10 * d)
    base = np.array(_sp_ts(Lmax, nr, d))
    R = len(base)
    nsh = sp.sp_sharded_levels(Lmax, nr, d)
    Lloc = Lmax // d

    def slab():
        ks = [_randn(gen, dev, R, (Lmax >> l) // d, D) for l in range(nsh)]
        vs = [_randn(gen, dev, R, (Lmax >> l) // d, Dv) for l in range(nsh)]
        return hd.H1DCache(ks[0], vs[0], tuple(ks[1:]), tuple(vs[1:]))
    got = [slab() for _ in range(d)]
    want = [_clone_cache(c) for c in got]
    past = nonowner = False
    for step in range(5):
        t = np.clip(base - 2 + step, 0, Lmax)
        tabs = sp.sp_tables(t, nr=nr, Lmax=Lmax, d=d, device=dev)
        kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, Dv)
        for s in range(d):
            upd = (kn, vn, tabs.t_loc[s], tabs.upd_owned[s])
            _, ak, av = dk.update_cache_partial(got[s], *upd)
            _, bk, bv = dk.update_cache_partial_ref(want[s], *upd)
            for x, y in zip((*_levels(got[s]), ak, av),
                            (*_levels(want[s]), bk, bv)):
                assert torch.equal(x, y)
        past |= bool((tabs.t_loc >= Lloc).any())
        nonowner |= bool((tabs.upd_owned == 0).any())
    assert past and nonowner


@pytest.mark.parametrize("partial", [False, True])
def test_update_chain_two_calls_same_bits(dev, partial):
    """#6 (7 levels) and #12 (shard 3 of 4) at ``chip_smoke.py``'s
    shapes, twice on two copies of one cache with the same inputs: the
    same bits in every level and carry."""
    from repro_torch.parallel import sp_attention as sp

    gen = torch.Generator(device=dev).manual_seed(7)
    R, Lmax, nr, D, d = 64, 2048, 16, 64, 4
    cache = hd.prefill_cache(_randn(gen, dev, R, Lmax, D),
                             _randn(gen, dev, R, Lmax, D), Lmax, nr)
    t = np.random.default_rng(7).integers(0, Lmax + 1, R)
    kn, vn = _randn(gen, dev, R, D), _randn(gen, dev, R, D)
    if partial:
        tabs = sp.sp_tables(t, nr=nr, Lmax=Lmax, d=d, device=dev)
        nsh = sp.sp_sharded_levels(Lmax, nr, d)
        Lloc = Lmax // d
        cache = hd.H1DCache(
            cache.k[:, -Lloc:].contiguous(), cache.v[:, -Lloc:].contiguous(),
            tuple(a[:, -a.shape[1] // d:].contiguous()
                  for a in cache.ck[:nsh - 1]),
            tuple(a[:, -a.shape[1] // d:].contiguous()
                  for a in cache.cv[:nsh - 1]))

        def run(c):
            _, ck, cv = dk.update_cache_partial(c, kn, vn, tabs.t_loc[d - 1],
                                                tabs.upd_owned[d - 1])
            return (*_levels(c), ck, cv)
    else:
        tt = torch.as_tensor(t, dtype=torch.int32, device=dev)

        def run(c):
            return _levels(dk.update_cache_fused(c, kn, vn, tt))
    for x, y in zip(run(_clone_cache(cache)), run(_clone_cache(cache))):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_sp_wrappers_validate_operands(dev):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    dense = hd.init_cache(2, 64, 8, 8, 8, device=dev)
    sh = sp.shard_cache(dense, make_mesh((2,), ("data",)), 8).shards[0]
    q = torch.zeros((2, 1, 8), device=dev)
    t = torch.zeros((2,), dtype=torch.int32, device=dev)
    tab = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):            # bidx of the wrong width
        dk.decode_attend_partial(sh, q, t, tab[:, :3].contiguous(), tab,
                                 nr=8)
    with pytest.raises(ValueError):            # int64 ownership bits
        dk.decode_attend_partial(sh, q, t, tab, tab.long(), nr=8)
    with pytest.raises(ValueError):            # level rows not nr-blocks
        dk.decode_attend_partial(sh, q, t, tab, tab, nr=16)
    kn = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):            # int64 positions
        dk.update_cache_partial(sh, kn, kn, t.long(), t)


def test_sp_smoke_engine_on_card_matches_dense(dev):
    """The smoke model served over 2 and 4 shards on the card gives the
    dense engine's greedy tokens (#11, #12 and the band kernels launched,
    #5 not, no plain version run); slots=1 at d=4 takes the uniform
    path and the deep-level carry (#6; at d=2 every level is sharded)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_smoke_config("h1d-lm-53m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 30, 9, 17, 40)]
    params = get_model(cfg).init(cfg, seed=2, device=dev)

    def serve(slots, mesh=None):
        eng = ServeEngine(cfg, params, slots=slots, max_len=64, mesh=mesh)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_counts()
        eng.run()
        return [r.out_tokens for r in reqs]

    for d, slots in ((2, 3), (4, 1)):
        want = serve(slots)
        got = serve(slots, make_mesh((d,), ("data",)))
        for name in kernels.SP_SERVE_KERNELS:
            launches = kernels.KERNELS[name][0].launches
            assert launches > 0 or (d, name) == (2, "update_cache_fused")
        assert kernels.KERNELS["decode_attend_fused"][0].launches == 0
        assert not any(p.calls for _, p in kernels.KERNELS.values())
        assert got == want


# ---------------------------------------------------------------------------
# SP training, coarse-q and sampled serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,nr,D,d", [(1024, 16, 64, 4), (1024, 16, 64, 2),
                                      (256, 8, 24, 4), (512, 16, 40, 4)])
@pytest.mark.parametrize("causal,causal_mode", [(True, "fine-q"),
                                                (True, "coarse-q"),
                                                (False, "fine-q")])
def test_sp_operator_grads_on_card(dev, L, nr, D, d, causal, causal_mode):
    """``sp_h1d_attention``'s output and its q, k, v and key-weight
    gradients on the card against the unsharded operator's on the card
    (forward 2e-5, gradients 1e-4, row-scaled): per-shard slabs at every
    local level, the sub level whose query block is the whole slab, and
    the gathered deep levels (d = 4)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    gen = torch.Generator(device=dev).manual_seed(L + nr + D + d)
    B, G = 3, 2
    w = torch.ones((B, L), device=dev)
    w[0, L - L // 5:] = 0.0
    x = [_randn(gen, dev, B, G, L, D), _randn(gen, dev, B, L, D),
         _randn(gen, dev, B, L, D), w]
    cot = _randn(gen, dev, B, G, L, D)
    kw = dict(nr=nr, causal=causal, causal_mode=causal_mode)

    def run(fn):
        ts = [t.clone().requires_grad_(True) for t in x]
        out = fn(*ts)
        return out.detach(), torch.autograd.grad(out, ts, cot)

    kernels.reset_counts()
    out, g = run(lambda q, k, v, w: sp.sp_h1d_attention(
        q, k, v, mesh=make_mesh((d,), ("data",)), kv_weight=w, **kw))
    assert kernels.KERNELS["band_attention_bwd"][0].launches >= d
    assert not any(p.calls for _, p in kernels.KERNELS.values())
    ref, want = run(lambda q, k, v, w: h1d_attention(q, k, v, kv_weight=w,
                                                     **kw))
    for got_, want_, tol in [(out, ref, 2e-5)] + [
            (a, b, BWD_TOL) for a, b in zip(g, want)]:
        mag = want_.double().abs()
        if mag.dim() > 2:
            mag = mag.amax(-1, keepdim=True)
        err = ((got_.double() - want_.double()).abs()
               / mag.clamp(min=1.0)).max()
        assert torch.isfinite(got_).all() and float(err) <= tol, float(err)


@pytest.mark.parametrize("d", [2, 4])
def test_sp_smoke_training_on_card_matches_cpu(dev, d, tmp_path):
    """Two AdamW steps of the smoke model through ``train(..., mesh=)``
    on the card (#1-#4 launched, no plain version) give the CPU path's
    losses within 1e-4, and the unsharded card run's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import ZipfLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainConfig, train

    cfg = get_smoke_config("h1d-lm-53m")
    tc = TrainConfig(peak_lr=1e-3, warmup=1, total_steps=10, ckpt_every=0,
                     ckpt_dir=str(tmp_path))
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=256, batch_per_host=4,
                  seed=5)
    losses = {}
    for device, sharded in (("cpu", True), ("cuda", True), ("cuda", False)):
        mesh = make_mesh((d,), ("data",), device=device) if sharded else None
        kernels.reset_counts()
        _, m = train(cfg, tc, data, 2, device=device, mesh=mesh,
                     log=lambda *_: None)
        losses[device, sharded] = [h["loss"] for h in m["history"]]
        if device == "cuda":
            for name in kernels.TRAIN_KERNELS:
                kernel, plain = kernels.KERNELS[name]
                assert kernel.launches > 0 and plain.calls == 0, name
    for key in (("cuda", True), ("cuda", False)):
        np.testing.assert_allclose(losses[key], losses["cpu", True],
                                   atol=1e-4)


def test_coarse_q_and_sampled_smoke_engines_on_card(dev):
    """The coarse-q smoke model served on the card gives the CPU path's
    greedy tokens (#1 in ``coarse_causal``, #5 and #6 launched, no plain
    version run); sampled on the card, one seed gives the same tokens
    twice and at 1, 2 and 4 slots."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_smoke_config("h1d-lm-53m"),
                              causal_mode="coarse-q")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 30, 9, 17, 40)]

    def serve(device, slots=2, **kw):
        params = get_model(cfg).init(cfg, seed=2, device=device)
        eng = ServeEngine(cfg, params, slots=slots, max_len=64, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_counts()
        eng.run()
        return [r.out_tokens for r in reqs]

    want = serve("cpu")
    got = serve("cuda")
    counts = kernels.mode_launches()
    assert counts.get(("band_attention_fwd", "coarse_causal"), 0) > 0
    for name in ("decode_attend_fused", "update_cache_fused"):
        assert kernels.KERNELS[name][0].launches > 0
    assert not any(p.calls for _, p in kernels.KERNELS.values())
    assert got == want
    sampled = serve("cuda", greedy=False, seed=4)
    assert sampled != got
    for slots in (2, 1, 4):
        assert serve("cuda", slots, greedy=False, seed=4) == sampled


# ---------------------------------------------------------------------------
# bf16 caches (#5-#9, #11, #12): the published dtype of the dense configs
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# the GQA groups of gemma3-4b (2), llama3.2-1b (4), qwen2.5-14b (5) and
# yi-6b (8), at the head widths of the assigned configs; qwen2-moe-a2.7b
# (G 1) and llava-next-34b (G 7) at their head width 128
BF16_SHAPES = [(G, D) for G in (2, 4, 5, 8) for D in (64, 128, 256)] + [
    (1, 128), (7, 128)]


def _bf16(c):
    """A cache or pool with every float level in bf16 (int8 levels and
    the scales as they are)."""
    def cast(a):
        return a.to(BF16) if a.dtype == torch.float32 and a.dim() == 3 else a
    return type(c)(*[tuple(cast(a) for a in x) if isinstance(x, tuple)
                     else cast(x) for x in c])


def _q16(gen, dev, *shape):
    """f32 values a bf16 projection gives (the wrappers widen them)."""
    return _randn(gen, dev, *shape).to(BF16).float()


@pytest.mark.parametrize("G,D", BF16_SHAPES)
def test_bf16_dense_attend_and_update_match_plain(dev, G, D):
    """#5 and #6 on a bf16 cache (Lmax 2048, nr 16) at every mask edge:
    the attend within 1e-5 of its plain version on the f32 output (a bf16
    q gives that output rounded to bf16), two calls the same bits; the
    update over 5 chained appends of bf16 rows bit for bit, rows 0 and 1
    at t = Lmax and Lmax - 1."""
    Lmax, nr = 2048, 16
    gen = torch.Generator(device=dev).manual_seed(G * D)
    ts = _ts(Lmax, nr)
    R = len(ts)
    cache = hd.prefill_cache(_randn(gen, dev, R, Lmax, D).to(BF16),
                             _randn(gen, dev, R, Lmax, D).to(BF16), Lmax, nr)
    assert cache.ck[0].dtype == BF16
    q = _q16(gen, dev, R, G, D)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    kernels.reset_counts()
    got = dk.decode_attend_fused(cache, q, t, nr=nr)
    _close([got], [dk.decode_attend_ref(cache, q, t, nr=nr)])
    assert torch.equal(got, dk.decode_attend_fused(cache, q, t, nr=nr))
    half = dk.decode_attend_fused(cache, q.to(BF16), t, nr=nr)
    assert half.dtype == BF16 and torch.equal(half, got.to(BF16))
    assert dk.decode_attend_fused.mode_launches == {"bf16": 3}
    a, b = _clone_cache(cache), _clone_cache(cache)
    for step in range(5):
        tu = torch.randint(0, Lmax, (R,), generator=gen, device=dev,
                           dtype=torch.int32)
        tu[0], tu[1] = Lmax, Lmax - 1
        kn = _randn(gen, dev, R, D).to(BF16)
        vn = _randn(gen, dev, R, D).to(BF16)
        dk.update_cache_fused(a, kn, vn, tu)
        dk.update_cache_ref(b, kn, vn, tu)
        for x, y in zip(_levels(a), _levels(b)):
            assert x.dtype == BF16 and torch.equal(x, y)
    assert dk.update_cache_fused.mode_launches == {"bf16": 5}


@pytest.mark.parametrize("G,D", BF16_SHAPES)
def test_bf16_paged_kernels_match_plain(dev, G, D):
    """#7 and #9 on a bf16 pool (Lmax 2048, nr 16; inactive rows on the
    TRASH page), #8 on a pool whose level 0 is int8 and the rest bf16:
    attends within 1e-5 on the f32 output of the plain version evaluated
    in float64 on the same bf16 rows (values scale by 2^l, so at D 128
    and 256 the fp32 plain version can be ~1e-5 off itself, as in the
    staged f32 cases), the update over 5 chained appends bit for bit
    outside TRASH.  #10 refuses the bf16 levels."""
    from repro_torch.core import quantization as qz

    Lmax, nr = 2048, 16
    gen = torch.Generator(device=dev).manual_seed(3 * G * D)
    M = hc.num_levels(Lmax, nr)
    ts = _ts(Lmax, nr)
    R, npages, trash = len(ts), 3 * len(ts) + 2, 1
    # keys unit normals at every level (a coarse key is a mean), values
    # scaled by 2^l (a sum), as the staged cases build them
    k = [_randn(gen, dev, npages, nr, D) for _ in range(M)]
    v = [_randn(gen, dev, npages, nr, D) * 2 ** l for l in range(M)]
    pool = _bf16(hd.PagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:])))
    (qk, sk), (qv, sv) = (qz.quantize_int8(x, axis=-1) for x in (k[0], v[0]))
    ones = tuple(torch.ones((npages, nr), device=dev) for _ in range(M - 1))
    mixed = hd.QuantPagedH1DCache(qk, qv, pool.ck, pool.cv, sk[..., 0],
                                  sv[..., 0], ones, ones)
    assert pool.k.dtype == BF16 and mixed.k.dtype == torch.int8
    assert mixed.ck[0].dtype == BF16
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    bidx = torch.randint(0, npages, (R, 1 + M), generator=gen, device=dev,
                         dtype=torch.int32)
    q = _q16(gen, dev, R, G, D)
    _close_exact([dk.decode_attend_paged(pool, q, t, bidx, nr=nr)],
                 [dk.decode_attend_paged_ref(pool, q.double(), t, bidx,
                                             nr=nr)])
    _close_exact([dk.decode_attend_paged_quant(mixed, q, t, bidx, nr=nr)],
                 [dk.decode_attend_paged_quant_ref(mixed, q.double(), t,
                                                   bidx, nr=nr)])
    a, b = _pool_clone(pool), _pool_clone(pool)
    keep = torch.ones(npages, dtype=torch.bool, device=dev)
    keep[trash] = False
    for step in range(5):
        tu = torch.randint(0, Lmax, (R,), generator=gen, device=dev,
                           dtype=torch.int32)
        utab = torch.stack([torch.randperm(npages - 2, generator=gen,
                                           device=dev)[:R] + 2
                            for _ in range(M)], 1).to(torch.int32)
        utab[R - 2:] = trash
        kn = _randn(gen, dev, R, D).to(BF16)
        vn = _randn(gen, dev, R, D).to(BF16)
        dk.update_cache_paged(a, kn, vn, tu, utab)
        dk.update_cache_paged_ref(b, kn, vn, tu, utab)
        for x, y in zip(_pool_arrays(a), _pool_arrays(b)):
            assert x.dtype == BF16 and torch.equal(x[keep], y[keep])
    with pytest.raises(ValueError, match="bfloat16"):
        dk.update_cache_paged_quant(mixed, kn, vn, tu, utab)


@pytest.mark.parametrize("G,D", BF16_SHAPES)
def test_bf16_partial_kernels_match_plain(dev, G, D):
    """#11 and #12 on every shard of a bf16 cache split 4 ways (Lmax
    2048, nr 16): the partial attend within 1e-5 of its plain version,
    the partial update bit for bit with its carries in bf16, and the
    whole SP update (#12, then #6 on the replicated levels from the
    rounded carry) bit for bit against #6 on the unsharded cache."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    Lmax, nr, d = 2048, 16, 4
    gen = torch.Generator(device=dev).manual_seed(5 * G * D)
    ts = _sp_ts(Lmax, nr, d)
    R = len(ts)
    dense = hd.prefill_cache(_randn(gen, dev, R, Lmax, D).to(BF16),
                             _randn(gen, dev, R, Lmax, D).to(BF16), Lmax, nr)
    mesh = make_mesh((d,), ("data",))
    sc = sp.shard_cache(dense, mesh, nr)
    q = _q16(gen, dev, R, G, D)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    tabs = sp.sp_tables(np.array(ts), nr=nr, Lmax=Lmax, d=d, device=dev)
    for s, sh in enumerate(sc.shards):
        _close(dk.decode_attend_partial(sh, q, t, tabs.bidx[s],
                                        tabs.owned[s], nr=nr),
               dk.decode_attend_partial_ref(sh, q, t, tabs.bidx[s],
                                            tabs.owned[s], nr=nr))
    nsh = sp.sp_sharded_levels(Lmax, nr, d)
    kn = _randn(gen, dev, R, D).to(BF16)
    vn = _randn(gen, dev, R, D).to(BF16)
    for s, sh in enumerate(sc.shards):
        def slab(c):
            return hd.H1DCache(c.k.clone(), c.v.clone(),
                               tuple(a.clone() for a in c.ck[:nsh - 1]),
                               tuple(a.clone() for a in c.cv[:nsh - 1]))
        a, b = slab(sh), slab(sh)
        _, ak, av = dk.update_cache_partial(a, kn, vn, tabs.t_loc[s],
                                            tabs.upd_owned[s])
        _, bk, bv = dk.update_cache_partial_ref(b, kn, vn, tabs.t_loc[s],
                                                tabs.upd_owned[s])
        assert ak.dtype == av.dtype == BF16
        for x, y in zip((a.k, a.v, *a.ck, *a.cv, ak, av),
                        (b.k, b.v, *b.ck, *b.cv, bk, bv)):
            assert torch.equal(x, y)
    with sp.sp_scope(mesh):
        hd.update_cache(sc, kn, vn, t, tables=tabs)
    dk.update_cache_fused(dense, kn, vn, t)
    back = sp.unshard_cache(sc)
    for x, y in zip(_levels(back), _levels(dense)):
        assert torch.equal(x, y)


def test_decode_wrappers_refuse_other_cache_dtypes(dev):
    """A cache element the kernels do not take (float16) raises before
    any launch, in every decode wrapper that takes a cache."""
    Lmax, nr, R, D = 64, 8, 2, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = hd.prefill_cache(_randn(gen, dev, R, Lmax, D).half(),
                             _randn(gen, dev, R, Lmax, D).half(), Lmax, nr)
    q, kn = _randn(gen, dev, R, 1, D), _randn(gen, dev, R, D)
    t = torch.zeros((R,), dtype=torch.int32, device=dev)
    M = hc.num_levels(Lmax, nr)
    pool = _paged_pool(gen, dev, M, nr, 4, D, D, None)
    pool = type(pool)(*[tuple(a.half() for a in x) if isinstance(x, tuple)
                        else x.half() for x in pool])
    tabs = torch.zeros((R, 1 + M), dtype=torch.int32, device=dev)
    kernels.reset_counts()
    calls = [lambda: dk.decode_attend_fused(cache, q, t, nr=nr),
             lambda: dk.update_cache_fused(cache, kn, kn, t),
             lambda: dk.decode_attend_paged(pool, q, t, tabs, nr=nr),
             lambda: dk.update_cache_paged(pool, kn, kn, t, tabs[:, :M]),
             lambda: dk.decode_attend_partial(cache, q, t, tabs, tabs,
                                              nr=nr),
             lambda: dk.update_cache_partial(cache, kn, kn, t, t)]
    for call in calls:
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call()
    assert not any(k.launches for k, _ in kernels.KERNELS.values())


# ---------------------------------------------------------------------------
# the dense oracles, full attention and the in-place optimizer update
# ---------------------------------------------------------------------------

ORACLE_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal,mode", [(True, "fine-q"),
                                         (True, "coarse-q"),
                                         (False, "fine-q")])
def test_h1d_attention_kernels_match_dense_oracle(dev, causal, mode):
    """The operator on the band kernels against ``h1d_dense_oracle`` at G
    3, L 512, d 48, nr 8, key weights in (0.5, 1.5) with zeros, at the
    reference's own tolerance for it."""
    from repro_torch.core import h1d_dense_oracle
    gen = torch.Generator(device=dev).manual_seed(3)
    B, G, L, d, nr = 2, 3, 512, 48, 8
    q = _randn(gen, dev, B, G, L, d)
    k = _randn(gen, dev, B, L, d)
    v = _randn(gen, dev, B, L, d)
    w = torch.rand((B, L), generator=gen, device=dev) + 0.5
    w[0, L - 100:] = 0.0
    w[1, ::7] = 0.0
    kernels.reset_counts()
    got = h1d_attention(q, k, v, nr=nr, causal=causal, causal_mode=mode,
                        kv_weight=w)
    assert kernels.KERNELS["band_attention_fwd"][0].launches > 0
    assert not any(p.calls for _, p in kernels.KERNELS.values())
    want = h1d_dense_oracle(q, k, v, nr=nr, causal=causal, causal_mode=mode,
                            kv_weight=w)
    torch.testing.assert_close(got, want, **ORACLE_TOL)


@pytest.mark.parametrize("mode,ratio", [("l0_causal", 1), ("l0_bidir", 1),
                                        ("coarse_causal", 1),
                                        ("coarse_bidir", 1), ("sub", 2),
                                        ("sub", 8)])
def test_band_kernels_match_band_ref(dev, mode, ratio):
    """#1 in every mode and #2 against ``band_attention_ref`` (one masked
    product over every key) at G 2, L 256, d 32, nr 16, weight-0 keys."""
    gen = torch.Generator(device=dev).manual_seed(ratio)
    B, G, L, d, nr = 3, 2, 256, 32, 16
    Lk = L // ratio if mode == "sub" else L
    q = _randn(gen, dev, B, G, L, d) / 4
    k = _randn(gen, dev, B, Lk, d)
    w = torch.ones((B, Lk), device=dev)
    w[0, Lk // 2:] = 0.0
    v = _randn(gen, dev, B, Lk, d) * w[..., None]
    if mode == "sub":
        got = hb.band_attention_sub_fwd(q, k, v, w, nr=nr, ratio=ratio)
    else:
        got = hb.band_attention_fwd(q, k, v, w, nr=nr, mode=mode)
    _close(got, kernels.band_attention_ref(q, k, v, w, nr=nr, mode=mode,
                                           ratio=ratio))


def test_in_place_adamw_is_bit_equal_on_card(dev):
    """The in-place AdamW update against the functional one on the card,
    bf16 leaves with one past CHUNK_ELEMS (two row chunks), three steps
    with the clip active: parameters and moments the same bits, the
    tensors kept in place."""
    import importlib
    from repro_torch import optim
    adamw_mod = importlib.import_module("repro_torch.optim.adamw")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = adamw_mod.CHUNK_ELEMS // 512 + 100
    params = {"big": _randn(gen, dev, rows, 512).bfloat16(),
              "small": [_randn(gen, dev, 7).bfloat16()]}
    assert len(adamw_mod._row_chunks(params["big"])) == 2
    opt = optim.adamw(optim.cosine_schedule(1e-2, 1, 10))
    p_fn = {"big": params["big"].clone(), "small": [params["small"][0].clone()]}
    s_in, s_fn = opt.init(params), opt.init(p_fn)
    ptrs = [t.data_ptr() for t in (params["big"], s_in.mu["big"])]
    for _ in range(3):
        g = {"big": _randn(gen, dev, rows, 512).bfloat16(),
             "small": [_randn(gen, dev, 7).bfloat16()]}
        upd, s_fn = opt.update({"big": g["big"].clone(),
                                "small": [g["small"][0].clone()]}, s_fn, p_fn)
        p_fn = optim.apply_updates(p_fn, upd)
        s_in = opt.update_(g, s_in, params)
    for a, b in ((params["big"], p_fn["big"]),
                 (params["small"][0], p_fn["small"][0]),
                 (s_in.mu["big"], s_fn.mu["big"]),
                 (s_in.nu["big"], s_fn.nu["big"])):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in (params["big"], s_in.mu["big"])] == ptrs


def test_full_attention_smoke_on_card_matches_cpu(dev):
    """The smoke LM with ``attention='full'`` (GQA 2): logits on the card
    within 1e-4 of the CPU's from the same seed, and the engine's greedy
    tokens the same on both, no kernel launched on the card."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_smoke_config("h1d-lm-53m"),
                              attention="full", num_kv_heads=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 33, 20)]
    logits, outs = {}, {}
    for device in ("cpu", "cuda"):
        params = get_model(cfg).init(cfg, seed=2, device=device)
        tok = torch.as_tensor(prompts[1][None], dtype=torch.long,
                              device=device)
        logits[device] = get_model(cfg).forward(params, cfg, tok)[0].cpu()
        eng = ServeEngine(cfg, params, slots=2, max_len=64)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_counts()
        eng.run()
        assert not any(k.launches for k, _ in kernels.KERNELS.values())
        outs[device] = [r.out_tokens for r in reqs]
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=0)
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# mixture of experts (models/ffn.py: plain products, sorts and gathers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,E,k,ff,cf", [(64, 8, 2, 32, 8.0),
                                         (64, 8, 2, 32, 0.25),
                                         (256, 60, 4, 176, 1.25)])
def test_moe_apply_on_card_matches_cpu(dev, d, E, k, ff, cf):
    """``moe_apply`` (with a shared expert) on the card against its CPU
    run on the same fp32 inputs: the same experts and ranks (so the same
    drops), the output within 2e-5 * max(1, |cpu|) and the aux loss
    within 1e-6 (the products sum in other orders), the input's and the
    router's gradients within 1e-4 of their largest |cpu|; two forward
    calls on the card the same bits (no atomics in the forward), in fp32
    and in bf16, and two bf16 input gradients the same bits."""
    from repro_torch.models import ffn
    from repro_torch.models.common import ModelConfig
    cfg = ModelConfig(d_model=d, moe_experts=E, moe_top_k=k, moe_d_ff=ff,
                      moe_shared_d_ff=2 * ff, moe_capacity_factor=cf)
    p = ffn.moe_init(torch.Generator().manual_seed(E + k), cfg)
    p["shared_gate"] = torch.randn((d, 1), generator=torch.Generator()
                                   .manual_seed(1)) * 0.5
    x = torch.randn((2, 256, d), generator=torch.Generator().manual_seed(2))
    cuda = {n: (v.to(dev) if torch.is_tensor(v) else
                {m: {"w": w["w"].to(dev)} for m, w in v.items()})
            for n, v in p.items()}
    for a, b in zip(ffn.route(p, cfg, x)[1:3],
                    ffn.route(cuda, cfg, x.to(dev))[1:3]):
        assert torch.equal(a, b.cpu())

    def run(params, xx):
        leaves = [params["router"].clone().requires_grad_(True),
                  xx.clone().requires_grad_(True)]
        out, aux = ffn.moe_apply(dict(params, router=leaves[0]), cfg,
                                 leaves[1])
        g = torch.autograd.grad((out * out).sum() + aux, leaves)
        return out.detach(), aux.detach(), g
    want, waux, wg = run(p, x)
    got, aux, g = run(cuda, x.to(dev))
    err = ((got.cpu().double() - want.double()).abs()
           / want.double().abs().clamp(min=1.0)).max()
    assert float(err) <= 2e-5 and abs(float(aux) - float(waux)) <= 1e-6
    for a, b in zip(g, wg):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-4
    again, _ = ffn.moe_apply(cuda, cfg, x.to(dev))
    assert torch.equal(again, ffn.moe_apply(cuda, cfg, x.to(dev))[0])
    half = {n: (v if n == "router" else
                v.to(BF16) if torch.is_tensor(v) else
                {m: {"w": w["w"].to(BF16)} for m, w in v.items()})
            for n, v in cuda.items()}
    xb = x.to(dev).to(BF16)
    one, _ = ffn.moe_apply(half, cfg, xb)
    assert one.dtype == BF16 and torch.equal(one,
                                             ffn.moe_apply(half, cfg, xb)[0])

    def input_grad():           # the dispatch's backward sums in order
        xx = xb.clone().requires_grad_(True)
        out, aux = ffn.moe_apply(half, cfg, xx)
        return torch.autograd.grad((out.float() ** 2).sum() + aux, xx)[0]
    assert torch.equal(input_grad(), input_grad())


# ---------------------------------------------------------------------------
# the SSM and hybrid families (models/ssm.py: the SSD in plain products;
# zamba2's shared attention block on the band and decode kernels)
# ---------------------------------------------------------------------------

def _rel(got, want):
    """max |got - want| over max |want|, want on the CPU."""
    want = want.double()
    return float((got.cpu().double() - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("S", [512, 509])
def test_mamba2_full_width_mixer_on_card_matches_cpu(dev, S):
    """One mamba2-1.3b mixer at full width (d 2048, d_inner 4096, 64
    heads of 64, N 128, chunk 256) in fp32 on the card against the same
    function on the CPU: S 512 runs chunk 256, S 509 (prime) chunk 1.
    Output, h and the convolution state within 1e-4 of the CPU's largest
    entry (products of depth 2048-4096 summed in other orders)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), dtype="float32")
    p = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want, wst = ssm.mamba2_apply(p, cfg, x, return_state=True)
    cuda = {k: ({"g": v["g"].to(dev)} if k == "norm" else
                {"w": v["w"].to(dev)} if isinstance(v, dict) else v.to(dev))
            for k, v in p.items()}
    got, st = ssm.mamba2_apply(cuda, cfg, x.to(dev), return_state=True)
    for a, b in ((got, want), (st.h, wst.h), (st.conv, wst.conv)):
        assert torch.isfinite(a).all() and _rel(a, b) <= 1e-4
    assert ssm._chunk_len(cfg, S) == (256 if S == 512 else 1)


def test_zamba2_smoke_kernel_path_matches_cpu(dev):
    """zamba2-smoke (6 Mamba2 layers, the shared h1d block after layers 2
    and 5) on the card, kernels launched, against the plain path on the
    CPU from the same seed: logits within 1e-4, every leaf's gradient
    within 1e-4 of its largest |cpu| (#1-#4 launched), and the engine's
    greedy tokens on 3 unbucketed requests at 2 slots (#5, #6 launched)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import tree_leaves, tree_unflatten_like
    cfg = get_smoke_config("zamba2-1.2b")
    fns = get_model(cfg)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 100))
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (13, 21, 30)]
    out = {}
    for device in ("cpu", "cuda"):
        params = fns.init(cfg, seed=2, device=device)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        batch = {"tokens": torch.as_tensor(tok, device=device)}
        kernels.reset_counts()
        logits = fns.forward(tree_unflatten_like(params, leaves), cfg,
                             batch["tokens"])[0]
        loss = fns.loss(tree_unflatten_like(params, leaves), cfg, batch)[0]
        grads = torch.autograd.grad(loss, leaves)
        launched = {n for n, (k, _) in kernels.KERNELS.items()
                    if k.launches}
        eng = ServeEngine(cfg, params, slots=2, max_len=64)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_counts()
        eng.run()
        served = {n for n, (k, _) in kernels.KERNELS.items() if k.launches}
        out[device] = (logits.detach().cpu(), [g.cpu() for g in grads],
                       [r.out_tokens for r in reqs], launched, served)
    (wl, wg, wt, _, _), (gl, gg, gt, launched, served) = (out["cpu"],
                                                          out["cuda"])
    torch.testing.assert_close(gl, wl, atol=1e-4, rtol=0)
    for a, b in zip(gg, wg):
        assert torch.isfinite(a).all() and _rel(a, b) <= 1e-4
    assert gt == wt
    assert {"band_attention_fwd", "band_attention_sub_fwd",
            "band_attention_bwd", "band_attention_sub_bwd"} <= launched
    assert {"decode_attend_fused", "update_cache_fused",
            "band_attention_fwd", "band_attention_sub_fwd"} <= served


def test_band_and_decode_kernels_at_zamba2_heads(dev):
    """#1-#4 at one zamba2 sequence's 32 kv-heads x G 1, head_dim 64, L
    2048, nr 16 (every other row padded past 1500, q, k, v rounded to
    bf16), every sub level; #5 and #6 on a bf16 cache at its decode shape
    (4 slots x 32 = 128 rows, D 64, Lmax 4096): each within its bound of
    the plain version, the updates bit for bit over 3 appends."""
    R, G, L, d, nr = 32, 1, 2048, 64, 16
    gen = torch.Generator(device=dev).manual_seed(29)
    q = _q16(gen, dev, R, G, L, d) / d ** 0.5
    k = _q16(gen, dev, R, L, d)
    w = torch.ones((R, L), device=dev)
    w[1::2, 1500:] = 0.0
    v = _q16(gen, dev, R, L, d) * w[..., None]
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    _close(out, hb.band_attention_fwd_ref(q, k, v, w, nr=nr))
    args = (q, k, v, w, *out, *_cotangents(gen, dev, out))
    _close_grads(hbb.band_attention_bwd(*args, nr=nr),
                 hbb.band_attention_bwd_ref(*args, nr=nr))
    kc, vc, wc = k, v, w
    for lvl in range(1, hc.num_levels(L, nr)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        sub = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        so = hb.band_attention_sub_fwd(*sub, nr=nr, ratio=1 << lvl)
        _close(so, hb.band_attention_sub_fwd_ref(*sub, nr=nr,
                                                 ratio=1 << lvl))
        bargs = (*sub, *so, *_cotangents(gen, dev, so))
        got = hbb.band_attention_sub_bwd(*bargs, nr=nr, ratio=1 << lvl)
        want = hbb.band_attention_sub_bwd_ref(*bargs, nr=nr, ratio=1 << lvl)
        _close_grads(got[:4], want[:4])
        # gmn cancels terms that grow with 2^l: scaled by its terms
        y, dn, _, gy, gdn, gm = bargs[4:]
        terms = gm.abs() + (gy * y).abs().sum(-1) + (gdn * dn).abs()
        assert float(((got[4] - want[4]).abs()
                      / terms.clamp(min=1.0)).max()) <= BWD_TOL
    Rd, Lmax = 4 * R, 4096
    cache = hd.prefill_cache(_randn(gen, dev, Rd, Lmax, d).to(BF16),
                             _randn(gen, dev, Rd, Lmax, d).to(BF16), Lmax, nr)
    qd = _q16(gen, dev, Rd, G, d)
    t = torch.randint(0, Lmax, (Rd,), generator=gen, device=dev,
                      dtype=torch.int32)
    t[:4] = torch.tensor([0, nr - 1, nr, Lmax - 1], dtype=torch.int32)
    _close([dk.decode_attend_fused(cache, qd, t, nr=nr)],
           [dk.decode_attend_ref(cache, qd, t, nr=nr)])
    a, b = _clone_cache(cache), _clone_cache(cache)
    for step in range(3):
        kn = _randn(gen, dev, Rd, d).to(BF16)
        vn = _randn(gen, dev, Rd, d).to(BF16)
        tt = (t + step).clamp(max=Lmax - 1)
        dk.update_cache_fused(a, kn, vn, tt)
        dk.update_cache_ref(b, kn, vn, tt)
    for x, y in zip(_levels(a), _levels(b)):
        assert torch.equal(x, y)


def _encdec_smoke(device):
    """seamless-smoke (2 + 2 layers, nr 8, head_dim 16) from seed 3 on
    ``device``, and a seeded batch: 2 clips of 45 frames (row 1 live to
    30), 24 target tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models.encdec import stub_frames
    cfg = get_smoke_config("seamless-m4t-medium")
    fns = get_model(cfg)
    frames, fw = stub_frames(cfg, 2, 45, seed=3, true_len=(45, 30))
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
    batch = {"frames": torch.as_tensor(frames, device=device),
             "frame_weight": torch.as_tensor(fw, device=device),
             "tokens": torch.as_tensor(tok, device=device)}
    return cfg, fns, fns.init(cfg, seed=3, device=device), batch


def test_encdec_smoke_training_on_card_matches_cpu(dev):
    """The encoder-decoder smoke model's loss and every leaf's gradient
    (remat on and off) on the card, kernels launched, against the plain
    path on the CPU from the same seed: the loss within 1e-4, each leaf
    within 1e-4 of its largest |cpu|; #1 and #3 launched in ``l0_bidir``
    and ``coarse_bidir`` (the encoder) and ``l0_causal`` (the decoder),
    #2 and #4 at the decoder's sub levels."""
    import dataclasses
    from repro_torch.tree import tree_leaves, tree_unflatten_like
    for remat in (False, True):
        out = {}
        for device in ("cpu", "cuda"):
            cfg, fns, params, batch = _encdec_smoke(device)
            cfg = dataclasses.replace(cfg, remat=remat)
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(params)]
            kernels.reset_counts()
            loss = fns.loss(tree_unflatten_like(params, leaves), cfg,
                            batch)[0]
            grads = torch.autograd.grad(loss, leaves)
            out[device] = (float(loss.detach()), [g.cpu() for g in grads],
                           kernels.mode_launches(),
                           {n for n, (k, _) in kernels.KERNELS.items()
                            if k.launches})
        (wl, wg, _, _), (gl, gg, modes, launched) = out["cpu"], out["cuda"]
        assert abs(gl - wl) <= 1e-4
        for a, b in zip(gg, wg):
            assert torch.isfinite(a).all() and _rel(a, b) <= 1e-4
        for name in ("band_attention_fwd", "band_attention_bwd"):
            for mode in ("l0_bidir", "coarse_bidir", "l0_causal"):
                assert modes.get((name, mode)), (name, mode, modes)
        assert {"band_attention_sub_fwd", "band_attention_sub_bwd"} <= launched


@pytest.mark.parametrize("B", [2, 1])
def test_encdec_smoke_greedy_on_card_matches_cpu(dev, B):
    """Encoder prefill of a 40-token target prefix (the decoder's prefill
    runs #2 at its sub levels), then 8 greedy decode steps at Lmax 64, on
    the card against the CPU: the same tokens, the prefill's logits within
    1e-4; #1 in ``l0_bidir``, ``coarse_bidir`` and ``l0_causal``, #2, #5
    and #6 launched (B = 1 through the uniform-position decode)."""
    out = {}
    for device in ("cpu", "cuda"):
        cfg, fns, params, batch = _encdec_smoke(device)
        prefix = torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (B, 40)), device=device)
        kernels.reset_counts()
        logits, caches, pos = fns.prefill(
            params, cfg, {"frames": batch["frames"][:B], "tokens": prefix},
            64)
        first = logits.cpu()
        toks = [logits.argmax(-1)]
        for _ in range(8):
            logits, caches = fns.decode_step(params, cfg, caches, toks[-1],
                                             pos)
            toks.append(logits.argmax(-1))
            pos = pos + 1
        out[device] = (first, torch.stack(toks, 1).cpu(),
                       kernels.mode_launches(),
                       {n for n, (k, _) in kernels.KERNELS.items()
                        if k.launches})
    (wl, wt, _, _), (gl, gt, modes, launched) = out["cpu"], out["cuda"]
    torch.testing.assert_close(gl, wl, atol=1e-4, rtol=0)
    assert torch.equal(gt, wt)
    for mode in ("l0_bidir", "coarse_bidir", "l0_causal"):
        assert modes.get(("band_attention_fwd", mode)), (mode, modes)
    assert {"band_attention_sub_fwd", "decode_attend_fused",
            "update_cache_fused"} <= launched


# ---------------------------------------------------------------------------
# telemetry: every launch accounted (repro_torch.obs)
# ---------------------------------------------------------------------------

def _telemetry_call(name, gen, dev):
    """A call of kernel wrapper ``name`` at a small shape, and what its
    launch records must equal: the band bytes on all-ones key weights
    (``band_bytes`` / ``sub_bytes``), or the wrapper's operands' shapes."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    B, G, L, d, nr = 2, 2, 128, 16, 16
    q = _randn(gen, dev, B, G, L, d)
    k, v = _randn(gen, dev, B, L, d), _randn(gen, dev, B, L, d)
    w = torch.ones((B, L), device=dev)
    band = dict(nr=nr, G=G, d=d, dv=d)
    if name in ("band_attention_fwd", "band_attention_bwd"):
        fwd = (q, k, v, w)
        out = hb.band_attention_fwd(*fwd, nr=nr)
        bwd = name.endswith("bwd")
        kernel = hbb.band_attention_bwd if bwd else hb.band_attention_fwd
        args = fwd + (out + tuple(_cotangents(gen, dev, out)) if bwd else ())
        want = hb.band_bytes(w, mode="l0_causal", backward=bwd, **band)
        return lambda: kernel(*args, nr=nr), want
    if name in ("band_attention_sub_fwd", "band_attention_sub_bwd"):
        ratio = 4
        fwd = (q, k[:, :L // ratio].contiguous(), v[:, :L // ratio]
               .contiguous(), w[:, :L // ratio].contiguous())
        out = hb.band_attention_sub_fwd(*fwd, nr=nr, ratio=ratio)
        bwd = name.endswith("bwd")
        kernel = (hbb.band_attention_sub_bwd if bwd
                  else hb.band_attention_sub_fwd)
        args = fwd + (out + tuple(_cotangents(gen, dev, out)) if bwd else ())
        want = hb.sub_bytes(fwd[3], ratio=ratio, backward=bwd, **band)
        return lambda: kernel(*args, nr=nr, ratio=ratio), want
    Lmax = 256
    M = hc.num_levels(Lmax, nr)
    ts = _sp_ts(Lmax, nr, 2)[:-1]             # in range: no Lmax
    R = len(ts)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    qd = _randn(gen, dev, R, G, d)
    kn, vn = _randn(gen, dev, R, d), _randn(gen, dev, R, d)
    cache = hd.prefill_cache(_randn(gen, dev, R, Lmax, d),
                             _randn(gen, dev, R, Lmax, d), Lmax, nr)
    npages = 3 * R + 2
    bidx = torch.randint(0, npages, (R, 1 + M), generator=gen, device=dev,
                         dtype=torch.int32)
    utab = torch.stack([torch.randperm(npages, generator=gen,
                                       device=dev)[:R] for _ in range(M)],
                       1).to(torch.int32)
    quant = name.endswith("_quant")
    pool = _paged_pool(gen, dev, M, nr, npages, d, d,
                       _quant("all" if quant else None, M))
    mesh = make_mesh((2,), ("data",), device=dev)
    sh = sp.shard_cache(cache, mesh, nr).shards[1]
    tabs = sp.sp_tables(np.array(ts), nr=nr, Lmax=Lmax, d=2, device=dev)
    nsh = sp.sp_sharded_levels(Lmax, nr, 2)
    slab = hd.H1DCache(sh.k, sh.v, sh.ck[:nsh - 1], sh.cv[:nsh - 1])
    calls = {
        "decode_attend_fused": (
            lambda: dk.decode_attend_fused(cache, qd, t, nr=nr),
            (cache.k, cache.v, *cache.ck, *cache.cv)),
        "update_cache_fused": (
            lambda: dk.update_cache_fused(cache, kn, vn, t),
            (cache.k, cache.v, *cache.ck, *cache.cv)),
        "decode_attend_paged": (
            lambda: dk.decode_attend_paged(pool, qd, t, bidx, nr=nr),
            (bidx, *_pool_arrays(pool))),
        "decode_attend_paged_quant": (
            lambda: dk.decode_attend_paged_quant(pool, qd, t, bidx, nr=nr),
            (bidx, *_pool_arrays(pool))),
        "update_cache_paged": (
            lambda: dk.update_cache_paged(pool, kn, vn, t, utab),
            (utab, *_pool_arrays(pool))),
        "update_cache_paged_quant": (
            lambda: dk.update_cache_paged_quant(pool, kn, vn, t, utab),
            (utab, *_pool_arrays(pool))),
        "decode_attend_partial": (
            lambda: dk.decode_attend_partial(sh, qd, t, tabs.bidx[1],
                                             tabs.owned[1], nr=nr),
            (tabs.bidx[1], tabs.owned[1], sh.k, sh.v, *sh.ck, *sh.cv)),
        "update_cache_partial": (
            lambda: dk.update_cache_partial(slab, kn, vn, tabs.t_loc[1],
                                            tabs.upd_owned[1]),
            (tabs.upd_owned[1], slab.k, slab.v, *slab.ck, *slab.cv)),
    }
    call, operands = calls[name]
    return call, sorted(tuple(x.shape) for x in operands)


@pytest.mark.parametrize("name", list(kernels.KERNELS))
def test_telemetry_counts_every_launch(dev, name):
    """With telemetry on, one call of each of the twelve wrappers: the
    ``kernel.launches`` counter of its family rises by exactly the
    wrapper's ``.launches`` delta, each launch hands over one record of
    that family, and the counted bytes are the traffic model's: for the
    band kernels ``band_bytes`` / ``sub_bytes`` on all-ones weights, for
    the decode kernels the record's operands are the wrapper's, shape
    for shape."""
    from repro_torch import obs
    from repro_torch.analysis import contracts
    from repro_torch.obs import traffic

    gen = torch.Generator(device=dev).manual_seed(31)
    call, want = _telemetry_call(name, gen, dev)
    fam = kernels.FAMILY[name]
    wrapper = kernels.KERNELS[name][0]
    obs.disable()
    obs.reset()
    obs.enable()
    try:
        before = wrapper.launches
        with contracts.capture() as buf:
            call()
        torch.cuda.synchronize()
        delta = wrapper.launches - before
        c = obs.export.snapshot()["metrics"]["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert delta == 1
    assert c[f"kernel.launches{{family={fam}}}"] == delta
    assert [r.family for r in buf] == [fam] * delta
    (rec,) = buf
    # the grids the launcher reports: the staged backward runs its dQ and
    # dK/dV/dW kernels, every other launch one kernel
    two = fam == "band_bwd" and rec.meta["mode"] != "coarse_causal"
    assert len(rec.grid) == (2 if two else 1), rec.describe()
    assert all(n > 0 for g in rec.grid for n in g)
    b = traffic.record_hbm_bytes(rec)
    assert c[f"kernel.hbm_read_bytes{{family={fam}}}"] == b["read_bytes"]
    assert c[f"kernel.hbm_write_bytes{{family={fam}}}"] == b["write_bytes"]
    if isinstance(want, int):
        assert b["read_bytes"] + b["write_bytes"] == want
    else:
        shapes = {tuple(o.shape) for o in rec.inputs}
        assert all(s in shapes for s in want), (want, rec.describe())
