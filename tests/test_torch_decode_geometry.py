"""The staged decode attend's geometry (``kernels.h1d_decode_kernel``'s
host mirrors of ``csrc/h1d_decode.cu``) against the JAX reference's
decode kernels, run in interpret mode on numpy inputs.

#5 (``decode_attend_fused``), #7 (``decode_attend_paged``), #8
(``decode_attend_paged_quant``) and #11 (``decode_attend_partial``)
copy, of each band, only the prefix of rows that
:func:`attend_band_rows` names (#8: rounded up to the int8 row quantum),
and nothing of a band that is masked whole or not owned; #5 reads it
from the block of the row's slab that :func:`attend_dense_blocks`
names.  Here, for every position of three (Lmax, nr) geometries, that
rule equals the reference kernel's own masks (read out of its output:
zero keys and queries give every counted key the weight 1, and one-hot
values name the keys), and changing every row the rule leaves out
(#8: its int8 rows and scales) leaves the reference's output
bit-identical, while changing one row it keeps does not.  The launch
plan's envelope is checked at every card test's shape, fp32 and int8.
#10 (``update_cache_paged_quant``), #6 (``update_cache_fused``), #12
(``update_cache_partial``) and #9 (``update_cache_paged``) read every
level's sibling pair before their carry chain writes any; a numpy
mirror of that order equals the reference's kernel bit for bit.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import h1d_decode as jhd  # noqa: E402
from repro.kernels import h1d_decode_kernel as jdk  # noqa: E402
from repro_torch.core import h1d_decode as thd  # noqa: E402
from repro_torch.core import hierarchy as hc  # noqa: E402
from repro_torch.kernels import h1d_decode_kernel as tdk  # noqa: E402
from repro_torch.parallel import sp_attention as sp  # noqa: E402

CASES = [(256, 8), (2048, 16), (512, 32)]
# rows of one interpret call on a slab: interpret mode's time per grid
# step grows with the arrays it is given, so a call takes few rows (and
# the calls of one shape share one compiled kernel)
CHUNK = 512


@functools.lru_cache(maxsize=None)
def _attend_fused(nr):
    return jax.jit(functools.partial(jdk.decode_attend_fused, nr=nr,
                                     interpret=True))


@functools.lru_cache(maxsize=None)
def _attend_paged(nr):
    return jax.jit(functools.partial(jdk.decode_attend_paged, nr=nr,
                                     interpret=True))


@functools.lru_cache(maxsize=None)
def _attend_paged_quant(nr):
    return jax.jit(functools.partial(jdk.decode_attend_paged_quant, nr=nr,
                                     interpret=True))


@functools.lru_cache(maxsize=None)
def _attend_partial(nr, t_hi):
    return jax.jit(functools.partial(jdk.decode_attend_partial, nr=nr,
                                     t_hi=t_hi, interpret=True))


def _prefix(rows, nr):
    """(R, nbands, nr) masks of the prefixes ``rows`` (R, nbands)."""
    return np.arange(nr)[None, None, :] < rows[:, :, None]


def _jax_copy(a):
    """A JAX array of its own: ``jnp.asarray`` may share a numpy array's
    memory on the CPU, and the update mirrors write theirs in place while
    the JAX call dispatched before them may still be reading."""
    return jnp.asarray(np.array(a, copy=True))


def _paged(levels):
    k, v = zip(*levels)
    return jhd.PagedH1DCache(k=_jax_copy(k[0]), v=_jax_copy(v[0]),
                             ck=tuple(map(_jax_copy, k[1:])),
                             cv=tuple(map(_jax_copy, v[1:])))


def _slab(levels):
    k, v = zip(*levels)
    return jhd.H1DCache(k=_jax_copy(k[0]), v=_jax_copy(v[0]),
                        ck=tuple(map(_jax_copy, k[1:])),
                        cv=tuple(map(_jax_copy, v[1:])))


def _one_band_tables(Lmax, nb):
    """Rows (t, band) for t in 0..Lmax-1: block 1 for that band, block 0
    (zeros) for the others."""
    t = np.repeat(np.arange(Lmax, dtype=np.int32), nb)
    band = np.tile(np.arange(nb), Lmax)
    bidx = np.zeros((Lmax * nb, nb), np.int32)
    bidx[np.arange(Lmax * nb), band] = 1
    return t, band, bidx


@pytest.mark.parametrize("Lmax,nr", CASES)
def test_band_rows_equal_paged_masks(Lmax, nr):
    """Per band, the keys the JAX paged kernel counts (one-hot values on
    page 1, every other band on a zero page, zero keys and query: o > 0
    exactly where a key counts) are the prefix ``attend_band_rows``
    names, at every position."""
    M = hc.num_levels(Lmax, nr)
    nb = M + 1
    t, band, bidx = _one_band_tables(Lmax, nb)
    k = np.zeros((2, nr, 2), np.float32)
    v = np.stack([np.zeros((nr, nr), np.float32), np.eye(nr,
                                                         dtype=np.float32)])
    o = np.asarray(_attend_paged(nr)(
        _paged([(k, v)] * M), jnp.zeros((len(t), 1, 2)), jnp.asarray(t),
        jnp.asarray(bidx)))[:, 0]
    rows = tdk.attend_band_rows(t, nr, nb)[np.arange(len(t)), band]
    np.testing.assert_array_equal(o > 0, np.arange(nr)[None] < rows[:, None])
    # every band counts somewhere, and band 0 always
    assert (rows.reshape(Lmax, nb) > 0).any(0).all()
    assert (rows.reshape(Lmax, nb)[:, 0] > 0).all()


def _perturb(levels, keep, rng, scale=1e4):
    """Every row outside ``keep`` (per level, a mask over the rows of its
    (..., rows, width) arrays) moved by up to ``scale``."""
    out = []
    for (k, v), kp in zip(levels, keep):
        out.append(tuple(
            a + np.where(kp[..., None], 0.0, scale * rng.standard_normal(
                a.shape)).astype(np.float32) for a in (k, v)))
    return out


@pytest.mark.parametrize("Lmax,nr", CASES)
def test_rows_left_out_do_not_change_paged_output(Lmax, nr):
    """Every row t in 0..Lmax-1 reads private pages; moving every page
    row that ``attend_band_rows`` leaves out leaves the JAX paged
    kernel's output bit-identical; moving band 0's first row, which it
    always keeps, changes every output."""
    rng = np.random.default_rng(Lmax + nr)
    M = hc.num_levels(Lmax, nr)
    nb = M + 1
    R, G, D = Lmax, 2, 4
    t = np.arange(R, dtype=np.int32)
    # level 0: own pages 0..R-1, previous R..2R-1; level l: pages 0..R-1
    bidx = np.tile(np.arange(R, dtype=np.int32)[:, None], (1, nb))
    bidx[:, 1] += R
    levels = [(rng.standard_normal((2 * R if l == 0 else R, nr, D)),
               rng.standard_normal((2 * R if l == 0 else R, nr, D)) * 2 ** l)
              for l in range(M)]
    levels = [(k.astype(np.float32), v.astype(np.float32))
              for k, v in levels]
    q = rng.standard_normal((R, G, D)).astype(np.float32)
    rows = tdk.attend_band_rows(t, nr, nb)
    keep = [np.zeros((a.shape[0], nr), bool) for a, _ in levels]
    for b in range(nb):
        keep[max(b - 1, 0)][bidx[:, b]] |= _prefix(rows, nr)[:, b]

    def run(lv):
        return np.asarray(_attend_paged(nr)(
            _paged(lv), jnp.asarray(q), jnp.asarray(t), jnp.asarray(bidx)))
    want = run(levels)
    np.testing.assert_array_equal(run(_perturb(levels, keep, rng)), want)
    first = [np.ones_like(kp) for kp in keep]
    first[0][:R, 0] = False
    assert (run(_perturb(levels, first, rng)) != want).any(-1).all()


# #5 on dense slabs: every position 0..Lmax (Lmax itself reads the last
# block, clamped) of two geometries, the edge positions of a third
DENSE_CASES = [(256, 8, False), (512, 32, False), (2048, 16, True)]


def _dense_positions(Lmax, nr, edges):
    return (_edges(Lmax, nr) if edges
            else np.arange(Lmax + 1, dtype=np.int32))


def _dense_keep(ts, Lmax, nr, nb):
    """Per level, an (R, Lmax >> l) mask of the slab rows #5 stages: of
    each band the prefix :func:`attend_band_rows` names, in the block
    :func:`attend_dense_blocks` names."""
    blocks = tdk.attend_dense_blocks(ts, nr, Lmax, nb)
    rows = tdk.attend_band_rows(ts, nr, nb)
    keep = [np.zeros((len(ts), Lmax >> l), bool) for l in range(nb - 1)]
    j = np.arange(nr)[None]
    for b in range(nb):
        l = max(b - 1, 0)
        idx = blocks[:, b, None] * nr + j
        np.put_along_axis(keep[l], idx, np.take_along_axis(keep[l], idx, 1)
                          | (j < rows[:, b, None]), 1)
    return keep


@pytest.mark.parametrize("Lmax,nr,edges", DENSE_CASES)
def test_dense_blocks_equal_fused_masks(Lmax, nr, edges):
    """Per band, the keys the JAX fused kernel counts are the prefix
    ``attend_band_rows`` names of the block ``attend_dense_blocks``
    names: row j of band b's named block holds a one in value column b *
    nr + j, every other slab row zeros, keys and query are zero (every
    counted key has weight 1), and the output is > 0 exactly on the
    columns of the rows the mirrors name.  Where two bands of one level
    name one block (bands 0 and 1 while t < nr, band 1 then counting
    nothing), a column shows the rows either band counts."""
    M = hc.num_levels(Lmax, nr)
    nb = M + 1
    ts = _dense_positions(Lmax, nr, edges)
    blocks = tdk.attend_dense_blocks(ts, nr, Lmax, nb)
    rows = tdk.attend_band_rows(ts, nr, nb)
    lvl = np.maximum(np.arange(nb) - 1, 0)
    j = np.arange(nr)
    want = np.zeros((len(ts), nb, nr), bool)
    for b in range(nb):
        for b2 in np.flatnonzero(lvl == lvl[b]):
            same = blocks[:, b2] == blocks[:, b]
            want[:, b] |= same[:, None] & (j[None] < rows[:, b2, None])
    Dv = nb * nr
    chunk = min(len(ts), max(1, (1 << 22) // (Lmax * Dv)))
    got = []
    for r0 in range(0, len(ts), chunk):
        # a full chunk every call (one compiled kernel): pad with t = 0
        t = np.zeros(chunk, np.int32)
        t[:len(ts[r0:r0 + chunk])] = ts[r0:r0 + chunk]
        blk = tdk.attend_dense_blocks(t, nr, Lmax, nb)
        levels = [(np.zeros((chunk, Lmax >> l, 1), np.float32),
                   np.zeros((chunk, Lmax >> l, Dv), np.float32))
                  for l in range(M)]
        for b in range(nb):
            v = levels[lvl[b]][1]
            v[np.arange(chunk)[:, None], blk[:, b, None] * nr + j[None],
              b * nr + j[None]] = 1.0
        o = np.asarray(_attend_fused(nr)(
            _slab(levels), jnp.zeros((chunk, 1, 1)), jnp.asarray(t)))[:, 0]
        got.append(o[:len(ts[r0:r0 + chunk])])
    got = np.concatenate(got).reshape(len(ts), nb, nr)
    np.testing.assert_array_equal(got > 0, want)
    # band 0 always counts, band 1 and every coarse band somewhere
    assert (rows[:, 0] > 0).all() and (rows > 0).any(0).all()


@pytest.mark.parametrize("Lmax,nr,edges", DENSE_CASES)
def test_rows_left_out_do_not_change_fused_output(Lmax, nr, edges):
    """Rows at every position (or the edge positions), each on its own
    slab: moving every slab row outside the prefixes of the blocks the
    mirrors name by up to 1e4 leaves the JAX fused kernel's output
    bit-identical; moving band 0's first row, which is always kept,
    changes every output."""
    rng = np.random.default_rng(Lmax + nr + 5)
    M = hc.num_levels(Lmax, nr)
    nb = M + 1
    ts = _dense_positions(Lmax, nr, edges)
    R, G, D = len(ts), 2, 4
    levels = [(rng.standard_normal((R, Lmax >> l, D)).astype(np.float32),
               (rng.standard_normal((R, Lmax >> l, D)) * 2 ** l).astype(
                   np.float32)) for l in range(M)]
    q = rng.standard_normal((R, G, D)).astype(np.float32)
    keep = _dense_keep(ts, Lmax, nr, nb)

    def run(lv):
        return np.asarray(_attend_fused(nr)(_slab(lv), jnp.asarray(q),
                                            jnp.asarray(ts)))
    want = run(levels)
    np.testing.assert_array_equal(run(_perturb(levels, keep, rng)), want)
    first = [np.ones_like(kp) for kp in keep]
    blk0 = tdk.attend_dense_blocks(ts, nr, Lmax, nb)[:, 0]
    first[0][np.arange(R), blk0 * nr] = False
    assert (run(_perturb(levels, first, rng)) != want).any(-1).all()


def _quant_pool(levels, scales):
    """A JAX ``QuantPagedH1DCache`` from per-level (k, v) data and (k, v)
    scales."""
    k, v = zip(*levels)
    ks, vs = zip(*scales)
    a = functools.partial(map, _jax_copy)
    return jhd.QuantPagedH1DCache(
        k=_jax_copy(k[0]), v=_jax_copy(v[0]), ck=tuple(a(k[1:])),
        cv=tuple(a(v[1:])), ksc=_jax_copy(ks[0]), vsc=_jax_copy(vs[0]),
        cksc=tuple(a(ks[1:])), cvsc=tuple(a(vs[1:])))


def _move_int8(levels, scales, keep, rng):
    """Every int8 row and scale outside ``keep`` (per level, a mask over
    the (pages, nr) rows) redrawn: rows uniform in [-127, 127], scales in
    [1e-3, 1e2)."""
    lv, sc = [], []
    for (k, v), (ksc, vsc), kp in zip(levels, scales, keep):
        lv.append(tuple(np.where(kp[..., None], a, rng.integers(
            -127, 128, a.shape)).astype(np.int8) for a in (k, v)))
        sc.append(tuple(np.where(kp, a, rng.uniform(1e-3, 1e2, a.shape))
                        .astype(np.float32) for a in (ksc, vsc)))
    return lv, sc


@pytest.mark.parametrize("Lmax,nr", CASES)
def test_rows_left_out_do_not_change_paged_quant_output(Lmax, nr):
    """#8 on an int8 pool (every level): every row t in 0..Lmax-1 reads
    private pages; redrawing every int8 key and value row and every
    scale outside the prefixes ``attend_band_rows`` names with the int8
    quantum leaves the JAX kernel's output bit-identical; redrawing band
    0's first row (and its scales), which it always keeps, changes every
    output."""
    rng = np.random.default_rng(Lmax + nr + 1)
    M = hc.num_levels(Lmax, nr)
    nb = M + 1
    R, G, D = Lmax, 2, 4
    quantum = tdk.attend_quantum(D, D, nr, quant=True)
    assert quantum == 4
    t = np.arange(R, dtype=np.int32)
    bidx = np.tile(np.arange(R, dtype=np.int32)[:, None], (1, nb))
    bidx[:, 1] += R
    pages = [2 * R if l == 0 else R for l in range(M)]
    levels = [tuple(rng.integers(-127, 128, (n, nr, D)).astype(np.int8)
                    for _ in range(2)) for n in pages]
    # keys near unit normals at every level (a coarse key is a mean),
    # values scaled by 2^l (a sum)
    scales = [tuple(rng.uniform(1e-3, 0.02 * 2 ** (l * i), (n, nr)).astype(
        np.float32) for i in range(2)) for l, n in enumerate(pages)]
    q = rng.standard_normal((R, G, D)).astype(np.float32)
    rows = tdk.attend_band_rows(t, nr, nb, quantum=quantum)
    assert (rows % quantum == 0).all()
    keep = [np.zeros((n, nr), bool) for n in pages]
    for b in range(nb):
        keep[max(b - 1, 0)][bidx[:, b]] |= _prefix(rows, nr)[:, b]

    def run(lv, sc):
        return np.asarray(_attend_paged_quant(nr)(
            _quant_pool(lv, sc), jnp.asarray(q), jnp.asarray(t),
            jnp.asarray(bidx)))
    want = run(levels, scales)
    np.testing.assert_array_equal(run(*_move_int8(levels, scales, keep,
                                                  rng)), want)
    first = [np.ones_like(kp) for kp in keep]
    first[0][:R, 0] = False
    assert (run(*_move_int8(levels, scales, first, rng)) != want).any(
        -1).all()


def _update_quant_mirror(levels, scales, qflags, k_new, v_new, t, utab, nr):
    """#10's order in numpy, in place: per cache row, every level's
    sibling pair and scales read first (page ``utab[r, l]``, rows
    ``((t >> l) % nr) & ~1`` and the next), then the carry chain --
    dequantize, put in the carry, requantize with fresh absmax scales
    (int8 levels) and write -- carrying the f32 pair's mean (k) or sum
    (v)."""
    f32 = np.float32
    eps, recip, half = f32(1e-12), f32(1.0 / 127.0), f32(0.5)
    for r in range(len(t)):
        pairs = []
        for l in range(len(levels)):
            page, j = utab[r, l], ((t[r] >> l) % nr) & ~1
            pairs.append([a[page, j:j + 2].copy()
                          for a in (*levels[l], *scales[l])])
        carry = [k_new[r].astype(f32), v_new[r].astype(f32)]
        for l, (pk, pv, sk, sv) in enumerate(pairs):
            page, j = utab[r, l], ((t[r] >> l) % nr) & ~1
            sel = (t[r] >> l) & 1
            for i, (x, s) in enumerate(((pk, sk), (pv, sv))):
                x = x.astype(f32) * s[:, None] if qflags[l] else x.copy()
                x[sel] = carry[i]
                if qflags[l]:
                    s = np.maximum(np.abs(x).max(1), eps) * recip
                    levels[l][i][page, j:j + 2] = np.clip(
                        np.rint(x / s[:, None]), -127, 127).astype(np.int8)
                    scales[l][i][page, j:j + 2] = s
                else:
                    levels[l][i][page, j:j + 2] = x
                carry[i] = (x[0] + x[1]) * half if i == 0 else x[0] + x[1]


@pytest.mark.parametrize("quant", ["all", "mixed"])
def test_update_mirror_equals_paged_quant_kernel(quant):
    """Five chained ticks of 6 rows, two of them inactive (every level's
    pair on the TRASH page, which both write): the mirror of #10's order
    (all of a row's loads, then its chain) equals the JAX
    ``update_cache_paged_quant`` (interpret) bit for bit on every pool
    row outside TRASH."""
    rng = np.random.default_rng(5)
    Lmax, nr, D, Dv, R, npages, trash = 256, 8, 4, 8, 6, 16, 1
    M = hc.num_levels(Lmax, nr)
    qflags = [True] * M if quant == "all" else [l < 2 for l in range(M)]
    levels, scales = [], []
    for l in range(M):
        if qflags[l]:
            levels.append([rng.integers(-127, 128, (npages, nr, w)).astype(
                np.int8) for w in (D, Dv)])
            scales.append([rng.uniform(1e-3, 0.05, (npages, nr)).astype(
                np.float32) for _ in range(2)])
        else:
            levels.append([(rng.standard_normal((npages, nr, w)) * 2 ** l)
                           .astype(np.float32) for w in (D, Dv)])
            scales.append([np.ones((npages, nr), np.float32)
                           for _ in range(2)])
    pool = _quant_pool(levels, scales)
    upd = jax.jit(functools.partial(jdk.update_cache_paged_quant,
                                    interpret=True))
    for step in range(5):
        t = rng.integers(0, Lmax, R).astype(np.int32)
        utab = np.stack([rng.permutation(npages - 2)[:R] + 2
                         for _ in range(M)], 1).astype(np.int32)
        utab[R - 2:] = trash
        kn = rng.standard_normal((R, D)).astype(np.float32)
        vn = rng.standard_normal((R, Dv)).astype(np.float32)
        pool = upd(pool, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(t),
                   jnp.asarray(utab))
        _update_quant_mirror(levels, scales, qflags, kn, vn, t, utab, nr)
        got = [pool.k, pool.v, pool.ksc, pool.vsc]
        want = [levels[0][0], levels[0][1], scales[0][0], scales[0][1]]
        for l in range(1, M):
            got += [pool.ck[l - 1], pool.cv[l - 1], pool.cksc[l - 1],
                    pool.cvsc[l - 1]]
            want += [levels[l][0], levels[l][1], scales[l][0], scales[l][1]]
        keep = np.arange(npages) != trash
        for g, w in zip(got, want):
            g = np.asarray(g)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g[keep].view(np.uint8),
                                          w[keep].view(np.uint8))


def _update_chain_mirror(levels, k_new, v_new, t, owned=None, utab=None):
    """numpy mirror of #6 / #12 / #9's order (``update_chain_kernel``),
    in place on ``levels`` [(k, v)], level l of shape (R, Ll, D / Dv), or
    with ``utab`` (R, nlev) a paged pool's (pages, nr, D / Dv): per row,
    both rows of every level's sibling pair read first (pair ``min(t >>
    (l+1), Ll/2 - 1)`` of the row's slab; paged: pair ``(t >> (l+1)) &
    (nr/2 - 1)`` of page ``utab[r, l]``), then the carry chain (an owner
    row's carry takes row ``(t >> l) & 1`` of the pair; the next carry is
    the pair's mean (k) or sum (v)), then the taken rows stored (owner
    rows: every row where ``owned`` is None).  Returns the carries past
    the last level, (R, D) and (R, Dv)."""
    f32, half = np.float32, np.float32(0.5)
    out_k, out_v = [], []
    for r in range(len(t)):
        own = owned is None or owned[r] != 0
        pairs = []
        for l, (k, v) in enumerate(levels):
            if utab is None:
                p, j = r, 2 * min(t[r] >> (l + 1), k.shape[1] // 2 - 1)
            else:
                p, j = utab[r, l], 2 * ((t[r] >> (l + 1))
                                        & (k.shape[1] // 2 - 1))
            pairs.append((p, j, k[p, j:j + 2].copy(), v[p, j:j + 2].copy()))
        carry = [k_new[r].astype(f32), v_new[r].astype(f32)]
        for l, (_, _, pk, pv) in enumerate(pairs):
            for i, x in enumerate((pk, pv)):
                if own:
                    x[(t[r] >> l) & 1] = carry[i]
                carry[i] = (x[0] + x[1]) * half if i == 0 else x[0] + x[1]
        if own:
            for l, (p, j, pk, pv) in enumerate(pairs):
                sel = (t[r] >> l) & 1
                levels[l][0][p, j + sel] = pk[sel]
                levels[l][1][p, j + sel] = pv[sel]
        out_k.append(carry[0])
        out_v.append(carry[1])
    return np.stack(out_k), np.stack(out_v)


def _edges(Lmax, nr, extra=()):
    """Positions at pair and level boundaries (every 2^k - 1, 2^k, and
    around nr and Lmax) and ``extra``, within [0, Lmax]."""
    ts = {0, 1, 2, 3, nr - 1, nr, nr + 1, Lmax - 2, Lmax - 1, Lmax, *extra}
    for k in range(1, Lmax.bit_length()):
        ts |= {(1 << k) - 1, 1 << k}
    return np.array(sorted(x for x in ts if 0 <= x <= Lmax), np.int32)


def _random_levels(rng, R, Lmax, nlev, D, Dv, rows=None):
    """(k, v) of every level l < nlev, (R, rows(l), D / Dv) float32,
    level l scaled by 2^l as the pairwise sums grow."""
    rows = rows or (lambda l: Lmax >> l)
    return [tuple((rng.standard_normal((R, rows(l), w)) * 2.0 ** l)
                  .astype(np.float32) for w in (D, Dv))
            for l in range(nlev)]


def _torch_slab(levels):
    k, v = zip(*[(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
                 for a, b in levels])
    return thd.H1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]))


def _same_bits(got, want):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("Lmax,nr,nlev,D,Dv", [
    (256, 8, 5, 3, 5), (2048, 16, 7, 4, 8), (32, 16, 1, 5, 7)])
def test_update_mirror_equals_dense_kernel(Lmax, nr, nlev, D, Dv):
    """Five chained ticks, each row near a pair or level boundary (its
    position walks base - 2 .. base + 2, clamped to [0, Lmax]; Lmax
    itself writes the last pair): the mirror of #6's order (every pair
    read, then the chain, then the stores) equals the JAX
    ``update_cache_fused`` (interpret) bit for bit, and so does the
    port's plain version.  The last case is a one-level cache, the SP
    deep tail's shape."""
    rng = np.random.default_rng(Lmax + nlev)
    base = _edges(Lmax, nr)
    R = len(base)
    levels = _random_levels(rng, R, Lmax, nlev, D, Dv)
    cache = _slab(levels)
    port = _torch_slab(levels)
    upd = jax.jit(functools.partial(jdk.update_cache_fused, interpret=True))
    for step in range(5):
        t = np.clip(base - 2 + step, 0, Lmax).astype(np.int32)
        kn = rng.standard_normal((R, D)).astype(np.float32)
        vn = rng.standard_normal((R, Dv)).astype(np.float32)
        cache = upd(cache, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(t))
        _update_chain_mirror(levels, kn, vn, t)
        tdk.update_cache_ref(port, torch.from_numpy(kn), torch.from_numpy(vn),
                             torch.from_numpy(t))
        got = [cache.k, cache.v, *[a for kv in zip(cache.ck, cache.cv)
                                   for a in kv]]
        mine = [port.k, port.v, *[a for kv in zip(port.ck, port.cv)
                                  for a in kv]]
        want = [a for kv in levels for a in kv]
        for g, m, w in zip(got, mine, want):
            _same_bits(g, w)
            _same_bits(m.numpy(), w)


@pytest.mark.parametrize("Lmax,nr,d", [(256, 8, 2), (256, 8, 4),
                                       (64, 16, 4)])
def test_update_mirror_equals_partial_kernel(Lmax, nr, d):
    """Five chained ticks on every shard's sharded levels, rows at global
    positions near pair, level and shard boundaries up to the global
    length (so a shard left of the owner sees t_loc past Lloc): the
    mirror of #12's order equals the JAX ``update_cache_partial``
    (interpret, ``t_hi`` = Lmax) bit for bit on the slab and on the
    carries of owner and non-owner rows, and so does the port's plain
    version.  (64, 16, 4) shards one level."""
    rng = np.random.default_rng(Lmax + d)
    nsh = sp.sp_sharded_levels(Lmax, nr, d)
    Lloc = Lmax // d
    base = _edges(Lmax, nr, [s * Lloc + e for s in range(1, d)
                             for e in (-1, 0, 1)])
    R = len(base)
    upd = jax.jit(functools.partial(jdk.update_cache_partial, t_hi=Lmax,
                                    interpret=True))
    slabs = [_random_levels(rng, R, Lmax, nsh, 3, 6,
                            rows=lambda l: (Lmax >> l) // d)
             for _ in range(d)]
    jax_slabs = [_slab(lv) for lv in slabs]
    port_slabs = [_torch_slab(lv) for lv in slabs]
    for step in range(5):
        t = np.clip(base - 2 + step, 0, Lmax)
        tabs = sp.sp_tables(t, nr=nr, Lmax=Lmax, d=d, device="cpu")
        kn = rng.standard_normal((R, 3)).astype(np.float32)
        vn = rng.standard_normal((R, 6)).astype(np.float32)
        assert int(tabs.upd_owned.sum(0).min()) == 1   # one owner a row
        for s in range(d):
            t_loc, own = tabs.t_loc[s].numpy(), tabs.upd_owned[s].numpy()
            jax_slabs[s], jk, jv = upd(
                jax_slabs[s], jnp.asarray(kn), jnp.asarray(vn),
                jnp.asarray(t_loc), jnp.asarray(own))
            mk, mv = _update_chain_mirror(slabs[s], kn, vn, t_loc, own)
            _, pk, pv = tdk.update_cache_partial_ref(
                port_slabs[s], torch.from_numpy(kn), torch.from_numpy(vn),
                tabs.t_loc[s], tabs.upd_owned[s])
            for g, m, w in ((jk, pk, mk), (jv, pv, mv)):
                _same_bits(g, w)
                _same_bits(m.numpy(), w)
            c, pc = jax_slabs[s], port_slabs[s]
            got = [c.k, c.v, *[a for kv in zip(c.ck, c.cv) for a in kv]]
            mine = [pc.k, pc.v, *[a for kv in zip(pc.ck, pc.cv)
                                  for a in kv]]
            want = [a for kv in slabs[s] for a in kv]
            for g, m, w in zip(got, mine, want):
                _same_bits(g, w)
                _same_bits(m.numpy(), w)
        if step == 0:     # t_loc past Lloc, owners and non-owners
            assert (tabs.t_loc.numpy() >= Lloc).any()
            assert (tabs.upd_owned.numpy() == 0).any()


def test_update_mirror_equals_paged_kernel():
    """Five chained ticks of 6 rows, two of them inactive (every level's
    pair on the TRASH page, which both write): the mirror of #9's order
    (``update_chain_kernel`` with the paged addressor: all of a row's
    pair reads, then its chain, then its stores) equals the JAX
    ``update_cache_paged`` (interpret) bit for bit on every pool row
    outside TRASH, and so does the port's plain version."""
    rng = np.random.default_rng(9)
    Lmax, nr, D, Dv, R, npages, trash = 256, 8, 3, 5, 6, 16, 1
    M = hc.num_levels(Lmax, nr)
    levels = [tuple((rng.standard_normal((npages, nr, w)) * 2.0 ** l)
                    .astype(np.float32) for w in (D, Dv)) for l in range(M)]
    pool = _paged(levels)
    k, v = zip(*[(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
                 for a, b in levels])
    port = thd.PagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]))
    upd = jax.jit(functools.partial(jdk.update_cache_paged, interpret=True))
    keep = np.arange(npages) != trash
    for step in range(5):
        t = rng.integers(0, Lmax + 1, R).astype(np.int32)
        utab = np.stack([rng.permutation(npages - 2)[:R] + 2
                         for _ in range(M)], 1).astype(np.int32)
        utab[R - 2:] = trash
        kn = rng.standard_normal((R, D)).astype(np.float32)
        vn = rng.standard_normal((R, Dv)).astype(np.float32)
        pool = upd(pool, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(t),
                   jnp.asarray(utab))
        _update_chain_mirror(levels, kn, vn, t, utab=utab)
        tdk.update_cache_paged_ref(port, torch.from_numpy(kn),
                                   torch.from_numpy(vn), torch.from_numpy(t),
                                   torch.from_numpy(utab))
        got = [pool.k, pool.v, *[a for kv in zip(pool.ck, pool.cv)
                                 for a in kv]]
        mine = [port.k, port.v, *[a for kv in zip(port.ck, port.cv)
                                  for a in kv]]
        want = [a for kv in levels for a in kv]
        for g, m, w in zip(got, mine, want):
            _same_bits(np.asarray(g)[keep], w[keep])
            _same_bits(m.numpy()[keep], w[keep])


def _bits(nr):
    """Value rows that spell their index: row j is 2^j in column 0 (j <
    16) or 2^(j - 16) in column 1, so a sum of distinct rows is exact."""
    v = np.zeros((nr, 2), np.float32)
    j = np.arange(nr)
    v[j < 16, 0] = 2.0 ** j[j < 16]
    v[j >= 16, 1] = 2.0 ** (j[j >= 16] - 16)
    return v


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("Lmax,nr", CASES)
def test_band_rows_equal_partial_masks(Lmax, nr, d):
    """Per band and shard, the keys the JAX partial kernel counts under
    ``sp_tables``' ownership (block 1 of every level spells its rows'
    indices, the other bands read a zero block 0; num then holds the
    counted keys' bits) are the prefix ``attend_band_rows`` names with
    that ownership, at every position."""
    M = hc.num_levels(Lmax, nr)
    nb = M + 1
    t, band, bidx = _one_band_tables(Lmax, nb)
    owned = sp.sp_tables(t, nr=nr, Lmax=Lmax, d=d, device="cpu").owned
    R = len(t)
    k = np.zeros((CHUNK, 2 * nr, 2), np.float32)
    v = np.zeros((CHUNK, 2 * nr, 2), np.float32)
    v[:, nr:] = _bits(nr)
    slab = _slab([(k, v)] * M)
    for s in range(d):
        own = owned[s].numpy()
        for r0 in range(0, R, CHUNK):
            rs = slice(r0, r0 + CHUNK)
            num, den, m = _attend_partial(nr, Lmax - 1)(
                slab, jnp.zeros((CHUNK, 1, 2)), jnp.asarray(t[rs]),
                jnp.asarray(bidx[rs]), jnp.asarray(own[rs]))
            num = np.asarray(num)[:, 0].astype(np.int64)
            got = (num[:, 0] | num[:, 1] << 16)[:, None] >> np.arange(nr) & 1
            rows = tdk.attend_band_rows(t[rs], nr, nb, owned=own[rs])
            rows = rows[np.arange(CHUNK), band[rs]]
            np.testing.assert_array_equal(
                got == 1, np.arange(nr)[None] < rows[:, None])
    # across the shards every counted key is counted once
    total = sum(tdk.attend_band_rows(t, nr, nb, owned=owned[s].numpy())
                for s in range(d))
    np.testing.assert_array_equal(total, tdk.attend_band_rows(t, nr, nb))


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("Lmax,nr", CASES)
def test_rows_left_out_do_not_change_partial_output(Lmax, nr, d):
    """On every shard's slab, for rows t in 0..Lmax-1 with ``sp_tables``'
    block indices and ownership: moving every slab row that
    ``attend_band_rows`` leaves out leaves the JAX partial kernel's
    (num, den, m) bit-identical; moving every row it keeps changes each
    row that keeps one."""
    rng = np.random.default_rng(Lmax + nr + d)
    M = hc.num_levels(Lmax, nr)
    nb = M + 1
    nsh = sp.sp_sharded_levels(Lmax, nr, d)
    G, D = 2, 2
    for t0 in range(0, Lmax, CHUNK // 2):
        t = np.arange(t0, min(t0 + CHUNK // 2, Lmax), dtype=np.int32)
        R = len(t)
        tabs = sp.sp_tables(t, nr=nr, Lmax=Lmax, d=d, device="cpu")
        q = rng.standard_normal((R, G, D)).astype(np.float32)
        for s in range(d):
            bidx, own = tabs.bidx[s].numpy(), tabs.owned[s].numpy()
            levels = []
            for l in range(M):
                n = (Lmax >> l) // d if l < nsh else Lmax >> l
                levels.append(tuple(
                    (rng.standard_normal((R, n, D)) * 2 ** (l * i)).astype(
                        np.float32) for i in (0, 1)))
            rows = tdk.attend_band_rows(t, nr, nb, owned=own)
            keep = [np.zeros(a.shape[:2], bool) for a, _ in levels]
            for b in range(nb):
                j = bidx[:, b, None] * nr + np.arange(nr)[None]
                np.put_along_axis(keep[max(b - 1, 0)], j, _prefix(
                    rows, nr)[:, b] | np.take_along_axis(
                        keep[max(b - 1, 0)], j, 1), 1)

            def run(lv):
                return [np.asarray(x) for x in _attend_partial(nr, Lmax - 1)(
                    _slab(lv), jnp.asarray(q), jnp.asarray(t),
                    jnp.asarray(bidx), jnp.asarray(own))]
            want = run(levels)
            for got, w in zip(run(_perturb(levels, keep, rng)), want):
                np.testing.assert_array_equal(got, w)
            moved = run(_perturb(levels, [~kp for kp in keep], rng, 1.0))
            counts = rows.sum(1) > 0
            assert (moved[0] != want[0]).any((1, 2))[counts].all()
            assert (moved[0] == want[0]).all((1, 2))[~counts].all()


# every shape of the card tests (tests/test_torch_cuda.py) of the f32
# attends, #5's (dense slabs: its own cases, the SP merge's, the smoke
# engine's, the staged ring, odd widths and misaligned slabs) as #7's and
# #11's: G, D, Dv, nr, Lmax; the last two need a ring (13 bands of D = Dv
# = 256 at G = 4)
CARD_SHAPES = [(1, 64, 64, 16, 2048), (3, 64, 64, 32, 256),
               (4, 16, 16, 8, 256), (2, 40, 24, 16, 512),
               (1, 16, 16, 8, 64), (2, 16, 16, 16, 16), (2, 5, 7, 8, 256),
               (1, 3, 5, 2, 64), (3, 64, 40, 16, 512),
               (4, 256, 256, 16, 32768), (4, 256, 256, 32, 65536)]


@pytest.mark.parametrize("G,D,Dv,nr,Lmax", CARD_SHAPES)
def test_plan_attend_stages_takes_every_card_shape(G, D, Dv, nr, Lmax):
    nlev = hc.num_levels(Lmax, nr)
    plan = tdk.plan_attend_stages(G, D, Dv, nr, nlev)
    assert 1 <= plan.stages and plan.smem <= tdk.SMEM_LIMIT
    assert plan.chunk_rows % plan.quantum == 0 and nr % plan.chunk_rows == 0
    assert plan.quantum == (4 if (D % 4 or Dv % 4) and nr % 4 == 0 else 1)
    # resident: a slot per band for keys and for values, nr rows each
    assert plan.resident == (Lmax < 32768)
    if plan.resident:
        assert (plan.stages, plan.chunk_rows) == (2 * (nlev + 1), nr)
    else:
        assert plan.stages >= 2
        bigger = tdk._attend_smem(G, D, Dv, nr, nlev, plan.stages + 1,
                                  plan.chunk_rows)
        assert bigger > tdk.SMEM_LIMIT


# every int8 shape of the card tests: G, D, Dv, nr, Lmax; odd widths at
# nr 8 (no bulk copies: quantum 1) and nr 16 (whole 16-row bands), the
# ring of 13 bands of D = Dv = 256
QUANT_CARD_SHAPES = [(1, 64, 64, 16, 2048), (4, 16, 16, 8, 256),
                     (2, 40, 24, 16, 512), (2, 16, 16, 4, 128),
                     (2, 5, 7, 8, 256), (2, 5, 7, 16, 256),
                     (3, 64, 40, 16, 512), (4, 256, 256, 32, 65536)]


@pytest.mark.parametrize("G,D,Dv,nr,Lmax", QUANT_CARD_SHAPES)
def test_plan_attend_stages_int8_takes_every_quant_card_shape(G, D, Dv, nr,
                                                              Lmax):
    """With int8 levels the row quantum is the rows whose 4-byte scales
    and D- and Dv-byte rows fill 16 bytes (1 where nr is not a multiple),
    the plan fits the card, and it keeps the f32 plan's shape: an int8
    block and its scales fit the slot an f32 block takes."""
    nlev = hc.num_levels(Lmax, nr)
    plan = tdk.plan_attend_stages(G, D, Dv, nr, nlev, quant=True)
    q = max(4, 16 // math.gcd(D, 16), 16 // math.gcd(Dv, 16))
    assert plan.quantum == (q if nr % q == 0 else 1)
    for W in (D, Dv):
        if plan.quantum > 1:
            assert (plan.quantum * W) % 16 == 0 and plan.quantum % 4 == 0
    assert 1 <= plan.stages and plan.smem <= tdk.SMEM_LIMIT
    assert plan.chunk_rows % plan.quantum == 0 and nr % plan.chunk_rows == 0
    f32 = tdk.plan_attend_stages(G, D, Dv, nr, nlev)
    assert (plan.stages, plan.chunk_rows, plan.smem, plan.resident) == \
        (f32.stages, f32.chunk_rows, f32.smem, f32.resident)
    cr = plan.chunk_rows
    assert 4 * tdk._slot(cr, D, Dv, True) >= \
        16 * -(-cr // 4) + cr * max(D, Dv)


@pytest.mark.parametrize("G,D,Dv,nr,nlev", [
    (1, 60000, 60000, 16, 5), (1000, 64, 64, 64, 32)])
@pytest.mark.parametrize("quant", [False, True])
def test_plan_attend_stages_raises_past_the_card(G, D, Dv, nr, nlev, quant):
    with pytest.raises(ValueError, match=r"bytes of shared memory"):
        tdk.plan_attend_stages(G, D, Dv, nr, nlev, quant=quant)
