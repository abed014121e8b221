"""The sub-level kernels' launch geometry (``kernels.h1d_block``'s host
mirrors of ``csrc/h1d_band.cuh``) against the JAX reference's
``band_mask`` on numpy indices: which rows are live, which key blocks are
read, the bytes a call must move, how the backward splits a block's rows
over CTAs, and which (row, key) pairs the score pass computes.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``);
these are what decides what they read and compute."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import h1d_block as jhb  # noqa: E402
from repro_torch.kernels import h1d_block as thb  # noqa: E402

# (nr, ratio, Lk): ratio 1 is coarse_causal, the same structure
CASES = [(2, 1, 64), (4, 1, 32), (16, 1, 128), (8, 2, 64), (16, 4, 64),
         (16, 32, 32), (32, 4, 128), (64, 2, 128)]


def _weights(B, Lk, seed):
    """Key weights with padded tails, a dead head and holes, as prefill
    and the coarsened chain give them."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, (B, Lk)).astype(np.float32)
    w[0, Lk // 2:] = 0.0
    w[1, : Lk // 3] = 0.0
    w[2, 1::3] = 0.0
    w[3, :] = 0.0
    return w


def _allowed(nr, ratio, Lk, w):
    """(B, Lq, Lk) pairs the reference admits: band_mask and w > 0."""
    Lq = Lk * ratio
    qi = np.arange(Lq)[:, None]
    ki = np.arange(Lk)[None, :]
    mask = np.asarray(jhb.band_mask(qi, ki, nr, "sub", Lk, ratio))
    return mask[None] & (w > 0)[:, None, :]


@pytest.mark.parametrize("nr,ratio,Lk", CASES)
def test_sub_live_rows_blocks_and_bytes_match_band_mask(nr, ratio, Lk):
    B, G, d, dv = 4, 3, 40, 24
    w = _weights(B, Lk, nr + ratio)
    pairs = _allowed(nr, ratio, Lk, w)
    live = pairs.any(-1)                                    # (B, Lq)
    got = thb.sub_live_rows(torch.from_numpy(w), nr, ratio).numpy()
    np.testing.assert_array_equal(got, live)
    # a key block is read when some row reads one of its keys; the last
    # has no query block after it
    read = pairs.any(1).reshape(B, -1, nr).any(-1)
    flags = thb.sub_block_flags(torch.from_numpy(w), nr).numpy()
    np.testing.assert_array_equal(flags[:, :-1] != 0, read[:, :-1])
    assert not read[:, -1].any()
    nb = Lk // nr
    Lq = Lk * ratio
    for backward in (False, True):
        rows = live.sum() * G * ((d + 2 * dv + 4) if backward else d)
        out = (B * G * Lq * (d + 1) + B * Lk * (d + dv + 1) if backward
               else B * G * Lq * (dv + 2))
        want = 4 * (rows + read.sum() * nr * (d + dv)
                    + B * (nb - 1) * nr + out)
        assert thb.sub_bytes(torch.from_numpy(w), nr=nr, ratio=ratio, G=G,
                             d=d, dv=dv, backward=backward) == want


@pytest.mark.parametrize("nr,ratio,Lk", CASES)
@pytest.mark.parametrize("G", [1, 3, 4])
def test_sub_bwd_splits_partition_each_blocks_readers(nr, ratio, Lk, G):
    """The S CTAs of key block J own disjoint runs of its readers' rows
    (query block J + 1 in every group), a multiple of 64 rows each unless
    one CTA takes them all, and together all of them."""
    nq = nr * ratio
    S = thb.sub_bwd_splits(G, nq)
    assert 1 <= S <= thb.SUB_MAX_SPLIT and (G * nq) % S == 0
    Rs = G * nq // S
    assert S == 1 or Rs % thb.SUB_TQ == 0
    qi = np.arange(Lk * ratio)[:, None]
    ki = np.arange(Lk)[None, :]
    mask = np.asarray(jhb.band_mask(qi, ki, nr, "sub", Lk, ratio))
    for J in range(Lk // nr):
        readers = set(np.flatnonzero(mask[:, J * nr:(J + 1) * nr].any(-1)))
        owned = []
        for s in range(S):
            for f in range(s * Rs, (s + 1) * Rs):
                g, p = divmod(f, nq)
                if (J + 1) * nq + p < Lk * ratio:
                    owned.append((g, (J + 1) * nq + p))
        assert len(owned) == len(set(owned))
        assert set(owned) == {(g, i) for g in range(G) for i in readers}


@pytest.mark.parametrize("nr,ratio,Lk", CASES)
def test_sub_pair_items_cover_band_and_skip_the_masked_quadrant(nr, ratio,
                                                                Lk):
    """On every tile the two kernels form (64 rows; 32 and 16 for the
    backward's wide heads), each (row pair, key group) is computed once,
    the groups of a row pair sit in aligned lanes (the shuffles' groups),
    every admitted pair is covered, and a first-half row is given no key
    group past the first half's when the groups split."""
    nq = nr * ratio
    half, nkg, nkgh = nr // 2, -(-nr // 4), -(-(nr // 2) // 4)
    Lq = Lk * ratio
    qi = nq + np.arange(nq)[:, None]            # query block 1
    ki = np.arange(nr)[None, :]                 # reads key block 0
    mask = np.asarray(jhb.band_mask(qi, ki, nr, "sub", Lk, ratio))
    for tq in (64, 32, 16):
        for f0 in range(0, max(Lq, nq), tq):
            rows = min(tq, max(Lq, nq) - f0)
            p0 = f0 % nq
            items = thb.sub_pair_items(rows, p0, nq, nkg, nkgh)
            seen = set()
            for it, (row, kg, width) in enumerate(items):
                assert it % width == kg and 0 <= row < rows and row % 2 == 0
                assert (row, kg) not in seen
                seen.add((row, kg))
                for r in (row, row + 1):
                    first = (p0 + r) % nq < nq // 2
                    assert width == (nkgh if first else nkg)
            for r in range(rows):
                p = (p0 + r) % nq
                want = set(np.flatnonzero(mask[p]))
                got = {4 * kg + t for (row, kg) in seen if row == r - r % 2
                       for t in range(4) if 4 * kg + t < nr}
                assert want <= got
                if p < nq // 2 and nkgh < nkg:
                    assert max(got) < 4 * nkgh and 4 * nkgh >= half
