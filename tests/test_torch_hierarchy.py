"""Port parity: ``repro_torch.core.hierarchy`` and ``band_mask`` against
the JAX reference.  Same numpy inputs through both; every function here
is pure data movement or one fp32 add / halving / divide per element, so
the port must be bit-exact."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import hierarchy as jhc  # noqa: E402
from repro.kernels import h1d_block as jhb  # noqa: E402
from repro_torch.core import hierarchy as thc  # noqa: E402
from repro_torch.kernels import h1d_block as thb  # noqa: E402


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_constants():
    assert thc.NEG_INF == jhc.NEG_INF
    assert thb.NEG_INF == jhb.NEG_INF and thb._MIN_M == jhb._MIN_M
    assert thb.NEG_INF != thc.NEG_INF   # two constants, kept apart


@pytest.mark.parametrize("L", [1, 7, 8, 9, 16, 100, 1024, 1500, 2048])
@pytest.mark.parametrize("nr", [8, 16])
def test_lengths_and_levels(L, nr):
    Lp = thc.padded_length(L, nr)
    assert Lp == jhc.padded_length(L, nr)
    assert thc.num_levels(Lp, nr) == jhc.num_levels(Lp, nr)
    assert thc.validate_h1d_shape(Lp, nr) == jhc.validate_h1d_shape(Lp, nr)


@pytest.mark.parametrize("L,nr", [(24, 8), (48, 16), (16, 3)])
def test_validate_rejects_bad_shapes(L, nr):
    with pytest.raises(ValueError):
        jhc.validate_h1d_shape(L, nr)
    with pytest.raises(ValueError):
        thc.validate_h1d_shape(L, nr)


def test_coarsen_block_shift_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 32, 5)).astype(np.float32)
    w = (rng.random((3, 32)) > 0.3).astype(np.float32) * 2.0
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _eq(jhc.coarsen_mean(x), thc.coarsen_mean(xt))
    _eq(jhc.coarsen_sum(x), thc.coarsen_sum(xt))
    _eq(jhc.coarsen_sum(w, axis=-1), thc.coarsen_sum(wt, axis=-1))
    for xa in (x, x[:, 0]):     # (B, G, L, D) and (B, L, D) layouts
        ja, jw = jhc.coarsen_weighted_mean(xa, w)
        ta, tw = thc.coarsen_weighted_mean(torch.from_numpy(xa), wt)
        _eq(ja, ta)
        _eq(jw, tw)
    xb = jhc.block(x, 8)
    tb = thc.block(xt, 8)
    _eq(xb, tb)
    _eq(jhc.unblock(xb), thc.unblock(tb))
    for off in (-2, -1, 0, 1, 5):
        _eq(jhc.shift_blocks(xb, off), thc.shift_blocks(tb, off))
    wb = jhc.block(w, 8, axis=-1)
    _eq(jhc.shift_blocks(wb, -1, block_axis=-2),
        thc.shift_blocks(thc.block(wt, 8, axis=-1), -1, block_axis=-2))


@pytest.mark.parametrize("nq,nk", [(8, 8), (32, 8), (16, 16)])
def test_masks(nq, nk):
    for kind in ("sub", "super"):
        _eq(jhc.quadrant_mask(nq, nk, kind), thc.quadrant_mask(nq, nk, kind))
    _eq(jhc.causal_block_mask(nq), thc.causal_block_mask(nq))


@pytest.mark.parametrize("mode", ["l0_bidir", "l0_causal", "coarse_bidir",
                                  "coarse_causal", "sub"])
def test_band_mask_all_modes(mode):
    """Global indices incl. negative and past-the-end keys (the halo)."""
    nr, lk = 8, 64
    ratio = 4 if mode == "sub" else 1
    lq = lk * ratio
    qi = np.arange(lq)[:, None]
    ki = np.arange(-nr, lk + nr)[None, :]
    want = jhb.band_mask(jax.numpy.asarray(qi), jax.numpy.asarray(ki), nr,
                         mode, lk, ratio)
    got = thb.band_mask(torch.from_numpy(qi), torch.from_numpy(ki), nr, mode,
                        lk, ratio)
    _eq(want, got)
