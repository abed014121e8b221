"""The band kernels' launch geometry (``kernels.h1d_block``'s host
mirrors of ``csrc/h1d_band.cuh``) against the JAX reference's
``band_mask`` on numpy indices, for the sub level (and coarse_causal)
and for l0_causal, l0_bidir and coarse_bidir: which rows are live, which
key blocks are read, the bytes a call must move, how the backward splits
or tiles the keys and their readers over CTAs, which (row, key) pairs
the score pass computes and on which lanes, and the tile sizes.  The
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


# ---------------------------------------------------------------------------
# l0_causal, l0_bidir and coarse_bidir
# ---------------------------------------------------------------------------

BAND_MODES = ("l0_causal", "l0_bidir", "coarse_bidir")
# (nr, L): L from 2 blocks up
BAND_CASES = [(2, 4), (2, 64), (4, 32), (8, 64), (16, 32), (16, 256),
              (32, 128), (64, 128)]


def _band_weights(B, L, nr, seed):
    """Key weights with a padded tail ending inside a block, a dead head
    of two blocks, holes, a fully masked row and one live key in the
    second half of a block (one live quadrant)."""
    w = _weights(B, L, seed)
    w[0, L // 2 + nr // 2:] = 0.0
    w[1, : 2 * nr] = 0.0
    w[4, :] = 0.0
    w[4, nr + nr - 1] = 1.0
    return w


def _band_allowed(mode, nr, L, w):
    qi = np.arange(L)[:, None]
    ki = np.arange(L)[None, :]
    mask = np.asarray(jhb.band_mask(qi, ki, nr, mode, L))
    return mask[None] & (w > 0)[:, None, :]


@pytest.mark.parametrize("nr,L", BAND_CASES)
@pytest.mark.parametrize("mode", BAND_MODES)
def test_band_live_rows_blocks_and_bytes_match_band_mask(mode, nr, L):
    B, G, d, dv = 5, 3, 40, 24
    w = _band_weights(B, L, nr, nr + L)
    pairs = _band_allowed(mode, nr, L, w)
    live = pairs.any(-1)                                    # (B, L)
    got = thb.band_live_rows(torch.from_numpy(w), nr, mode).numpy()
    np.testing.assert_array_equal(got, live)
    assert live[4].any() and not live[4, 3 * nr:].any()
    # a key block is read when some row reads one of its keys
    read = pairs.any(1).reshape(B, -1, nr).any(-1)
    info = thb.band_block_info(torch.from_numpy(w), nr).numpy()
    np.testing.assert_array_equal((info & 3) != 0, read)
    for backward in (False, True):
        rows = live.sum() * G * ((d + 2 * dv + 4) if backward else d)
        out = (B * G * L * (d + 1) + B * L * (d + dv + 1) if backward
               else B * G * L * (dv + 2))
        want = 4 * (rows + read.sum() * nr * (d + dv) + B * L + out)
        assert thb.band_bytes(torch.from_numpy(w), nr=nr, mode=mode, G=G,
                              d=d, dv=dv, backward=backward) == want


@pytest.mark.parametrize("nr", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("mode", BAND_MODES)
def test_band_admits_is_band_mask_within_each_band(mode, nr):
    """The kernels' per-band mask (block difference known, positions in
    the blocks) is the JAX band_mask on every (row, key) of every band of
    a query block in the middle of a sequence, and band_mask admits no key
    outside the mode's bands."""
    L = 8 * nr
    I = 4
    pq = np.arange(nr)[:, None]
    pk = np.arange(nr)[None, :]
    qi = I * nr + pq
    offs = {thb.band_off(mode, b) for b in range(thb.band_count(mode))}
    for off in (-2, -1, 0, 1, 2):
        want = np.asarray(jhb.band_mask(qi, (I + off) * nr + pk, nr, mode, L))
        if off not in offs:
            assert not want.any()
            continue
        got = thb.band_admits(mode, off, torch.from_numpy(pq),
                              torch.from_numpy(pk), nr)
        np.testing.assert_array_equal(np.broadcast_to(got.numpy(),
                                                      want.shape), want)


@pytest.mark.parametrize("nr,L", BAND_CASES)
@pytest.mark.parametrize("mode", BAND_MODES)
def test_band_pair_items_cover_band_and_skip_masked_groups(mode, nr, L):
    """On every tile the forward and the dQ pass form (64, 32 and 16
    rows), each row pair takes W = slots * nr / 4 lanes (a power of two
    that divides a warp: the row max, dn and the tie count are shuffles
    among them), each lane one group of 4 keys in the bands of its slot,
    each band of the mode in one slot; every admitted key of a row lies in a
    group its pair computes, and no computed group is masked whole for
    both rows.  The y / dq register tiles (4 rows, 2 at nr 2) read every
    admitted group."""
    nkg = -(-nr // 4)
    W = thb.BAND_SLOTS * nkg
    assert W & (W - 1) == 0 and 32 % W == 0
    qi = np.arange(L)[:, None]
    ki = np.arange(L)[None, :]
    mask = np.asarray(jhb.band_mask(qi, ki, nr, mode, L))
    for tq in (64, 32, 16):
        for t0 in range(0, L, tq):
            rows = min(tq, L - t0)
            items = thb.band_pair_items(mode, t0, rows, nr)
            assert len(items) == rows // 2 * W
            got, lanes_of = {}, {}
            for it, r0, lanes, groups in items:
                assert lanes == W and 0 <= r0 < rows
                lanes_of.setdefault(r0, []).append(it)
                for off, kg in groups:
                    assert kg == thb.lane_item(it, W)[1] % nkg
                    assert (off, kg) not in got.get(r0, set())
                    got.setdefault(r0, set()).add((off, kg))
            # a pair's W lanes sit in one warp, closed under the shuffles'
            # xor offsets; a phase of 8 lanes holds at most two of a pair's
            # lanes (j, j ^ 1) when a warp holds four pairs or more
            for r0, its in lanes_of.items():
                assert len(its) == W and len({i // 32 for i in its}) == 1
                o = 1
                while o < W:
                    assert {i ^ thb.lane_xor(o, W) for i in its} == set(its)
                    o *= 2
                if 4 * W <= 32:
                    for ph in range(4):
                        js = {thb.lane_item(i, W)[1] for i in its
                              if (i % 32) // 8 == ph}
                        assert len(js) <= 2 and (not js or max(js) -
                                                 min(js) <= 1)
            for r0, groups in got.items():
                i = t0 + r0
                blk = i // nr
                for off, kg in groups:
                    keys = [(blk + off) * nr + 4 * kg + t for t in range(4)
                            if 4 * kg + t < nr]
                    assert any(0 <= j < L and mask[i + rr, j] for rr in (0, 1)
                               for j in keys) or not (0 <= keys[0] < L)
            ry = 4 if nr >= 4 else 2
            for r in range(rows):
                i = t0 + r
                for j in np.flatnonzero(mask[i]):
                    off = j // nr - i // nr
                    kg = (j % nr) // 4
                    assert (off, kg) in got.get(r - r % 2, set()), (i, j)
                    p0 = (i - i % ry) % nr
                    lo, hi = thb.band_group_range(mode, off, p0, ry, nr)
                    assert lo <= kg < hi, (i, j)


@pytest.mark.parametrize("nr,L", BAND_CASES)
@pytest.mark.parametrize("mode", BAND_MODES)
@pytest.mark.parametrize("G", [1, 3, 4])
def test_band_dkvw_ctas_own_each_key_once_with_all_its_readers(mode, nr, L,
                                                               G):
    """The dK/dV/dW pass: its CTAs own disjoint runs of whole key blocks
    that cover every key; a CTA streams the rows of every group g over
    its reader range in chunks, and each (g, row) a band_mask admits for
    one of its keys is in a chunk once; per key group and band, the row
    range the sums run over holds every admitted row and no row that is
    masked for the whole group."""
    B = 64 // G
    nkb, tq = thb.band_dkvw_tiles(mode, B, L, 64, 64, nr)
    assert tq in (16, 32, 64) and nkb >= 1 and nkb & (nkb - 1) == 0
    qi = np.arange(L)[:, None]
    ki = np.arange(L)[None, :]
    mask = np.asarray(jhb.band_mask(qi, ki, nr, mode, L))
    owned = []
    for J0, nkh, (lo, hi) in thb.band_dkvw_ctas(mode, L, nr, nkb):
        owned += range(J0 * nr, (J0 + nkh) * nr)
        seen = [(g, i) for g in range(G) for f0 in range(lo, hi, tq)
                for i in range(f0, min(f0 + tq, hi))]
        assert len(seen) == len(set(seen))
        for j in range(J0 * nr, (J0 + nkh) * nr):
            readers = np.flatnonzero(mask[:, j])
            assert all((g, i) in set(seen) for g in range(G)
                       for i in readers)
        for J in range(J0, J0 + nkh):
            for kg in range(-(-nr // 4)):
                keys = [J * nr + 4 * kg + t for t in range(4)
                        if 4 * kg + t < nr]
                for b in range(thb.band_count(mode)):
                    off = thb.band_off(mode, b)
                    I = J - off
                    if not 0 <= I < L // nr:
                        continue
                    plo, phi = thb.band_row_range(mode, off, kg, nr)
                    for p in range(nr):
                        adm = mask[I * nr + p, keys].any()
                        assert adm <= (plo <= p < phi), (J, kg, off, p)
                        if plo <= p < phi:
                            assert mask[I * nr + plo: I * nr + phi,
                                        keys].any()
    assert sorted(owned) == list(range(L))


@pytest.mark.parametrize("nr", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("mode", BAND_MODES)
def test_band_tiles_fit_the_card_and_fill_it(mode, nr):
    """Tiles of 16-64 rows within the H100's 227 KB of shared memory,
    halved while the grid has fewer than two CTAs per SM; the backward
    check keeps on the staged body exactly the shapes whose 16-row tiles
    fit, and the forward check keeps the same shapes there (only
    ``l0_causal`` streams the ones they refuse, in both directions).  At
    the LRA path's coarse levels (64 rows, L from 1024 down to 2 blocks)
    the grid holds at least 128 CTAs."""
    for d, dv in ((64, 64), (128, 128), (256, 256), (40, 24)):
        try:
            route = thb.check_window_bwd(mode, nr, d, dv)
        except ValueError:
            route = None
        fits = route == "band"
        if fits:
            assert thb.check_window_fwd(mode, nr, d, dv) == "band"
        elif mode == "l0_causal":
            assert thb.check_window_fwd(mode, nr, d, dv) == "stream"
            assert route == "stream"
        else:
            assert route is None
            with pytest.raises(ValueError):
                thb.check_window_fwd(mode, nr, d, dv)
        tq = thb.band_fwd_tq(mode, 64, 1, 1024, d, dv, nr)
        tqb = thb.band_fwd_tq(mode, 64, 1, 1024, d, dv, nr, backward=True)
        nkb, tk = thb.band_dkvw_tiles(mode, 64, 1024, d, dv, nr)
        assert fits == (tq > 0 and tqb > 0 and tk > 0), (d, dv)
        if not fits:
            continue
        assert 4 * thb.band_fwd_floats(mode, tq, d, dv, nr) <= thb.SMEM_MAX
        assert 4 * thb.band_dq_floats(mode, tqb, d, dv, nr) <= thb.SMEM_MAX
        assert (4 * thb.band_dkvw_floats(mode, nkb, tk, d, dv, nr)
                <= thb.SMEM_MAX)
    # today's envelope stays: d, dv up to 128, nr up to 64 causal and 32
    # bidirectional
    if mode == "l0_causal" or nr <= 32:
        thb.check_window_bwd(mode, nr, 128, 128)
    for L in (1024, 512, 256, 128, 64, 32):
        if L < 2 * nr:
            continue
        tq = thb.band_fwd_tq(mode, 64, 1, L, 64, 64, nr)
        nkb, _ = thb.band_dkvw_tiles(mode, 64, L, 64, 64, nr)
        assert 64 * -(-L // tq) >= min(thb.FILL_CTAS, 64 * L // 16)
        assert 64 * -(-(L // nr) // nkb) >= min(thb.FILL_CTAS,
                                                64 * (L // nr))
