"""Distributed-ownership checker for the sequence-parallel layer.

Port of ``repro.analysis.dist`` over the port's own SP rules
(``parallel/sp_attention.py``: ``_band_geometry``, ``sp_update_owner``,
``sp_update_local_t``, ``sp_n_shallow``, ``sp_sharded_levels``,
``sp_halo_pack``), checked over mesh sizes {1, 2, 4, 8} with no device:
every rule is a host function of the shard index, so each can be swept
per global position.

The reference reads its Pallas kernels' index maps under
``jax.eval_shape``.  The port's decode kernels read their blocks and
pairs from host tables and from ``t``, mirrored on the host by
``kernels/h1d_decode_kernel.py`` (``attend_dense_blocks``: the block of
each band #5 stages; ``attend_band_rows``: the rows of each band the
staged attend copies, none where a band is not owned;
``update_pair_index``: the sibling pair #6 and #12 write).  Those
mirrors stand in for the index maps.

Checks, per (mesh size d, geometry):

* **decode attend ownership** -- every (position, band) pair is owned by
  exactly ONE shard (``ownership-gap`` / ``ownership-overlap``); every
  shard's tables stay in the partial attend's domains (``t`` in ``[0,
  Lmax]``, ownership bits 0 or 1, block indices inside the shard's slab,
  owners and non-owners alike); on the owning shard the table's block
  plus the shard's offset is the block the single-card attend (#5)
  reads; and the rows the shards' partial attends copy add up, band by
  band, to the rows the single-card attend copies (``halo-mismatch``).
* **decode update ownership** -- ``sp_update_owner`` covers every ``t``
  in ``[0, Lmax]`` exactly once, the last shard owning ``t == Lmax``; the
  owner's local position keeps the sibling parity bits; the partial
  update's pair (#12, shard-local) plus the shard's offset, and the
  replicated deep levels' pair (#6 at ``t >> nsh``), are the pair the
  single-card update (#6) writes, level by level.
* **halo protocol** -- for every band mode and shallow level the
  out-of-shard key blocks the global ``band_mask`` makes a shard's
  queries attend are exactly the one ``nr``-row block per direction the
  halo exchange delivers (``halo-mismatch``).
* **transition threshold + comm volume** -- ``sp_n_shallow`` matches the
  ``L >> l >= d * nr`` rule and the decode path's
  ``sp_sharded_levels``; the real ``sp_halo_pack`` buffer holds ``B *
  n_shallow * nr * (Dk + Dv + 1)`` words a direction; the gathered
  transition-level KV stays within ``d * nr / 2`` rows
  (``comm-mismatch``).

Every rule is injectable (``band_geometry=``, ``update_owner=``,
``update_local_t=``, ``update_owned=``, ``halo_blocks=``,
``n_shallow_fn=``), so that tests can prove each kind is caught.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .violation import Violation

#: data-axis sizes the checks sweep (1 == the degenerate single card)
MESH_SIZES = (1, 2, 4, 8)
#: (nr, Lmax) decode cache geometries
DECODE_GEOMS = ((4, 64), (4, 128))
#: (nr, L) training/prefill geometries for the halo + comm checks
BAND_GEOMS = ((4, 64), (4, 128))

DIST_KINDS = ("ownership-gap", "ownership-overlap", "halo-mismatch",
              "comm-mismatch")

#: head dim of the packed halo buffer (the rules never depend on it)
_D = 8


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64)


def _first(mask) -> Tuple[int, ...]:
    return tuple(int(i[0]) for i in np.nonzero(mask))


# ---------------------------------------------------------------------------
# decode: attend-band + update ownership
# ---------------------------------------------------------------------------

def check_decode(d: int, nr: int, Lmax: int, *,
                 band_geometry: Optional[Callable] = None,
                 update_owner: Optional[Callable] = None,
                 update_local_t: Optional[Callable] = None,
                 update_owned: Optional[Callable] = None,
                 ) -> Tuple[int, List[Violation]]:
    """All decode-path ownership checks for one ``(d, nr, Lmax)``.

    Returns ``(checks_run, violations)``.  The hooks default to the
    port's ``sp_attention`` rules; ``update_owned(t, s, Lloc, d)`` (a 0/1
    array) overrides the per-shard ownership bit derived from
    ``update_owner``."""
    from ..core import hierarchy as hc
    from ..kernels import h1d_decode_kernel as dk
    from ..parallel import sp_attention as sp

    band_geometry = band_geometry or sp._band_geometry
    update_owner = update_owner or sp.sp_update_owner
    update_local_t = update_local_t or sp.sp_update_local_t

    out: List[Violation] = []
    checks = 0
    fam = f"sp_decode d{d} nr{nr} L{Lmax}"
    Lloc = Lmax // d
    M = hc.num_levels(Lmax, nr)
    nsh = sp.sp_sharded_levels(Lmax, nr, d)
    if nsh < 1:
        return 0, []          # shard_cache refuses this geometry loudly
    nsh_u = min(nsh, M)       # nsh > M just means ALL levels shard
    nbands = M + 1
    t = np.arange(Lmax, dtype=np.int64)   # one row per global position

    # the per-shard tables sp_tables builds (bidx, owned), per shard
    geo = [tuple(_np(a) for a in band_geometry(t, s, nr, Lmax, d, nsh,
                                                M - 1))
           for s in range(d)]

    # -- (1) exactly-once attend-band ownership across shards ----------
    own_total = np.sum([o for _, o in geo], axis=0)
    for band in range(nbands):
        checks += 1
        col = own_total[:, band]
        gaps = np.nonzero(col == 0)[0]
        if gaps.size:
            out.append(Violation(
                fam, f"band{band}", "ownership-gap",
                f"{gaps.size} global positions owned by NO shard "
                f"(first: t={int(gaps[0])})"))
        over = np.nonzero(col > 1)[0]
        if over.size:
            out.append(Violation(
                fam, f"band{band}", "ownership-overlap",
                f"{over.size} global positions owned by "
                f"{int(col[over[0]])} shards (first: t={int(over[0])})"))

    # -- (2) partial attend (#11) against the single-card attend (#5) ---
    dense_blk = dk.attend_dense_blocks(t, nr, Lmax, nbands)
    dense_rows = dk.attend_band_rows(t, nr, nbands)
    band_lvl = [max(b - 1, 0) for b in range(nbands)]
    rows_sum = np.zeros_like(dense_rows)
    for s, (bidx_s, own_s) in enumerate(geo):
        # the tables' domains: the partial attend's launch takes t in
        # [0, Lmax] and ownership bits 0 / 1
        for name, tab, lo, hi in (("t", t, 0, Lmax),
                                  ("owned", own_s, 0, 1)):
            checks += 1
            bad = (tab < lo) | (tab > hi)
            if bad.any():
                at = _first(bad)
                out.append(Violation(
                    fam, name, "halo-mismatch",
                    f"shard {s}: real {name} table value {int(tab[at])} "
                    f"escapes the partial attend's domain [{lo}, {hi}] at "
                    f"index {at}"))
        rows_sum += dk.attend_band_rows(t, nr, nbands, owned=own_s)
        for b in range(nbands):
            lam = band_lvl[b]
            nbl = (Lmax >> lam) // nr
            nbl_loc = nbl // d if lam < nsh else nbl
            loc = bidx_s[:, b]
            checks += 1
            oob = np.nonzero((loc < 0) | (loc >= nbl_loc))[0]
            if oob.size:
                out.append(Violation(
                    fam, f"band{b}", "halo-mismatch",
                    f"shard {s}: local block {int(loc[oob[0]])} escapes "
                    f"the {nbl_loc}-block slab at t={int(oob[0])} "
                    f"(non-owners must read clamped in-slab blocks)"))
                continue
            ownm = own_s[:, b] > 0
            glob = loc + (s * nbl_loc if lam < nsh else 0)
            mism = np.nonzero(ownm & (glob != dense_blk[:, b]))[0]
            if mism.size:
                tt = int(mism[0])
                out.append(Violation(
                    fam, f"band{b}", "halo-mismatch",
                    f"shard {s} owns t={tt} but reads global block "
                    f"{int(glob[tt])}; the single-card attend reads "
                    f"{int(dense_blk[tt, b])}"))
    for b in range(nbands):
        checks += 1
        mism = np.nonzero(rows_sum[:, b] != dense_rows[:, b])[0]
        if mism.size:
            tt = int(mism[0])
            out.append(Violation(
                fam, f"band{b}", "halo-mismatch",
                f"the shards' partial attends copy {int(rows_sum[tt, b])} "
                f"rows of band {b} at t={tt}; the single-card attend "
                f"copies {int(dense_rows[tt, b])}"))

    # -- (3) update ownership: exactly-once over [0, Lmax] -------------
    tu = np.arange(Lmax + 1, dtype=np.int64)
    if update_owned is None:
        owners_all = _np(update_owner(tu, Lloc, d))
        owned_bits = np.stack([(owners_all == s).astype(np.int64)
                               for s in range(d)])
    else:
        owned_bits = np.stack([_np(update_owned(tu, s, Lloc, d))
                               for s in range(d)])
    checks += 1
    tot = owned_bits.sum(axis=0)
    gaps = np.nonzero(tot == 0)[0]
    if gaps.size:
        out.append(Violation(
            fam, "update_owner", "ownership-gap",
            f"{gaps.size} update positions owned by NO shard (first: "
            f"t={int(gaps[0])}; t=Lmax={Lmax} must go to the LAST "
            f"shard)"))
    over = np.nonzero(tot > 1)[0]
    if over.size:
        out.append(Violation(
            fam, "update_owner", "ownership-overlap",
            f"{over.size} update positions owned by "
            f"{int(tot[over[0]])} shards (first: t={int(over[0])})"))
    checks += 1
    if not owned_bits[d - 1, Lmax]:
        out.append(Violation(
            fam, "update_owner", "ownership-gap",
            f"defensive row t=Lmax={Lmax} is not owned by the last "
            f"shard (the masked-sum carry would write zeros)"))

    # the owner's local position keeps the sibling parity bits of the
    # unclamped single-card value at every sharded level
    owner_of = np.argmax(owned_bits, axis=0)
    tl_owner = np.empty_like(tu)
    for s in range(d):
        rows = np.nonzero(owner_of == s)[0]
        tl_owner[rows] = _np(update_local_t(tu[rows], s, Lloc))
    for l in range(nsh_u):
        checks += 1
        bad = np.nonzero(((tl_owner >> l) & 1) != ((tu >> l) & 1))[0]
        if bad.size:
            out.append(Violation(
                fam, "update_local_t", "halo-mismatch",
                f"owner-local position loses the level-{l} sibling "
                f"parity bit at t={int(bad[0])} (t_loc="
                f"{int(tl_owner[bad[0]])}) -- the pair select writes "
                f"the wrong row"))

    # -- (4) partial (#12) and deep (#6) update pairs vs single-card #6 -
    # every shard's t_loc table stays in the partial update's domain
    for s in range(d):
        checks += 1
        tab = _np(update_local_t(t, s, Lloc))
        bad = np.nonzero((tab < 0) | (tab > Lmax))[0]
        if bad.size:
            out.append(Violation(
                fam, "t_loc", "halo-mismatch",
                f"shard {s}: real t_loc value {int(tab[bad[0]])} escapes "
                f"the partial update's domain [0, {Lmax}] at "
                f"t={int(bad[0])}"))
    tlo = tl_owner[:Lmax]
    own_idx = owner_of[:Lmax]
    for l in range(nsh_u):
        checks += 1
        dense_pair = dk.update_pair_index(t, Lmax >> l, l)
        part_pair = dk.update_pair_index(tlo, Lloc >> l, l)
        glob = part_pair + own_idx * (Lloc >> (l + 1))
        mism = np.nonzero(glob != dense_pair)[0]
        if mism.size:
            tt = int(mism[0])
            out.append(Violation(
                fam, f"k_l{l}", "halo-mismatch",
                f"owner shard writes global level-{l} pair "
                f"{int(glob[tt])} at t={tt}; the single-card update "
                f"writes {int(dense_pair[tt])}"))
    if nsh < M:
        t_deep = t >> nsh
        for ld in range(M - nsh):
            checks += 1
            lev = nsh + ld
            dense_pair = dk.update_pair_index(t, Lmax >> lev, lev)
            deep_pair = dk.update_pair_index(t_deep, Lmax >> lev, ld)
            mism = np.nonzero(deep_pair != dense_pair)[0]
            if mism.size:
                tt = int(mism[0])
                out.append(Violation(
                    fam, f"k_l{lev}", "halo-mismatch",
                    f"replicated deep level {lev}: carried update "
                    f"writes pair {int(deep_pair[tt])} at t={tt}; the "
                    f"single-card update writes {int(dense_pair[tt])}"))
    return checks, out


# ---------------------------------------------------------------------------
# training/prefill: halo protocol vs the global band_mask
# ---------------------------------------------------------------------------

def _default_halo_blocks(s: int, nbl_loc: int, d: int,
                         causal: bool) -> set:
    """Key blocks (GLOBAL nr-row block indices, in the level's coarse
    resolution) the halo exchange delivers to shard ``s``: the left
    neighbour's last block, plus (bidir only) the right neighbour's
    first block."""
    provided = set()
    if s > 0:
        provided.add(s * nbl_loc - 1)
    if not causal and s < d - 1:
        provided.add((s + 1) * nbl_loc)
    return provided


def check_halo(d: int, nr: int, L: int, *,
               halo_blocks: Optional[Callable] = None,
               n_shallow_fn: Optional[Callable] = None,
               ) -> Tuple[int, List[Violation]]:
    """Every out-of-shard key block the global ``band_mask`` requires
    must be delivered by the halo protocol, for every mode x shallow
    level x shard.  Returns ``(checks_run, violations)``."""
    import torch

    from ..core import hierarchy as hc
    from ..kernels import h1d_block
    from ..parallel import sp_attention as sp

    halo_blocks = halo_blocks or _default_halo_blocks
    n_shallow_fn = n_shallow_fn or sp.sp_n_shallow

    out: List[Violation] = []
    checks = 0
    fam = f"sp_halo d{d} nr{nr} L{L}"
    Lloc = L // d
    if L % d or Lloc % nr or Lloc < nr:
        return 0, []          # _validate_sp_shape refuses this geometry
    M = hc.num_levels(L, nr)
    n_shallow = n_shallow_fn(M, Lloc, nr)

    cases = [("l0_causal", 0, 1), ("l0_bidir", 0, 1)]
    for l in range(1, n_shallow):
        cases += [("coarse_causal", l, 1), ("coarse_bidir", l, 1),
                  ("sub", l, 1 << l)]
    for mode, l, ratio in cases:
        lk = L >> l
        cl = Lloc >> l                      # local coarse length
        nbl_loc = cl // nr                  # local nr-row key blocks
        causal = mode.endswith("causal") or mode == h1d_block.SUB_MODE
        ki = np.arange(lk, dtype=np.int64)
        for s in range(d):
            checks += 1
            if mode == h1d_block.SUB_MODE:
                qi = s * Lloc + np.arange(Lloc, dtype=np.int64)
            else:
                qi = s * cl + np.arange(cl, dtype=np.int64)
            mask = h1d_block.band_mask(
                torch.from_numpy(qi[:, None]), torch.from_numpy(ki[None, :]),
                nr, mode, lk, ratio).numpy()
            needed_keys = ki[mask.any(axis=0)]
            outside = needed_keys[(needed_keys < s * cl)
                                  | (needed_keys >= (s + 1) * cl)]
            needed = set(int(b) for b in np.unique(outside // nr))
            provided = halo_blocks(s, nbl_loc, d, causal)
            missing = needed - provided
            if missing:
                out.append(Violation(
                    fam, f"{mode} l{l}", "halo-mismatch",
                    f"shard {s} needs out-of-shard key block(s) "
                    f"{sorted(missing)} under the global band_mask but "
                    f"the halo exchange only delivers "
                    f"{sorted(provided)}"))
    return checks, out


# ---------------------------------------------------------------------------
# transition threshold + per-step comm volume
# ---------------------------------------------------------------------------

def check_comm(d: int, nr: int, L: int, *, B: int = 1, Dk: int = _D,
               Dv: int = _D,
               n_shallow_fn: Optional[Callable] = None,
               ) -> Tuple[int, List[Violation]]:
    """Transition-threshold consistency and the per-step comm formulas.
    The halo word count comes from the real ``sp_halo_pack`` buffer, not
    a re-derived closed form."""
    import torch

    from ..core import hierarchy as hc
    from ..parallel import sp_attention as sp

    n_shallow_fn = n_shallow_fn or sp.sp_n_shallow

    out: List[Violation] = []
    checks = 0
    fam = f"sp_comm d{d} nr{nr} L{L}"
    Lloc = L // d
    if L % d or Lloc % nr or Lloc < nr:
        return 0, []
    M = hc.num_levels(L, nr)
    n_shallow = n_shallow_fn(M, Lloc, nr)

    # threshold: level l runs locally iff L >> l >= d * nr
    for l in range(M):
        checks += 1
        rule = (L >> l) >= d * nr
        code = l < n_shallow
        if rule != code:
            out.append(Violation(
                fam, f"level{l}", "comm-mismatch",
                f"all_gather transition threshold: level {l} is "
                f"{'local' if code else 'gathered'} but L>>l={L >> l} "
                f"{'>=' if rule else '<'} d*nr={d * nr} says it must be "
                f"{'local' if rule else 'gathered'}"))
    # one cache layout: the decode path's sharded-level rule must agree
    checks += 1
    nsh_dec = min(sp.sp_sharded_levels(L, nr, d), M)
    if nsh_dec != n_shallow:
        out.append(Violation(
            fam, "sharded_levels", "comm-mismatch",
            f"decode shards {nsh_dec} levels but the prefill path keeps "
            f"{n_shallow} local -- attend and update would disagree on "
            f"the cache layout"))

    # halo volume from the real packer: one buffer per direction
    kc = [torch.zeros((B, Lloc >> l, Dk)) for l in range(n_shallow)]
    vc = [torch.zeros((B, Lloc >> l, Dv)) for l in range(n_shallow)]
    wc = [torch.zeros((B, Lloc >> l)) for l in range(n_shallow)]
    buf = sp.sp_halo_pack(kc, vc, wc, n_shallow, nr, "prev")
    checks += 1
    pinned = B * n_shallow * nr * (Dk + Dv + 1)
    if buf.numel() != pinned:
        out.append(Violation(
            fam, "halo", "comm-mismatch",
            f"packed halo buffer carries {buf.numel()} words per "
            f"direction; the exchange's formula is "
            f"B*n_shallow*nr*(Dk+Dv+1) = {pinned}"))
    # deep-level gather: <= d*nr/2 transition-level rows in total
    if n_shallow < M:
        checks += 1
        rows = L >> n_shallow
        if rows > d * nr // 2:
            out.append(Violation(
                fam, "gather", "comm-mismatch",
                f"all_gather moves {rows} transition-level rows; the "
                f"bound is d*nr/2 = {d * nr // 2}"))
    return checks, out


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def run_dist(*, mesh_sizes=MESH_SIZES, decode_geoms=DECODE_GEOMS,
             band_geoms=BAND_GEOMS,
             ) -> Tuple[Dict[str, int], List[Violation]]:
    """Sweep every check over the mesh x geometry grid.  Returns
    ``({'configs': ..., 'checks': ...}, violations)``."""
    violations: List[Violation] = []
    checks = 0
    configs = 0
    for d in mesh_sizes:
        for nr, Lmax in decode_geoms:
            n, vs = check_decode(d, nr, Lmax)
            if n:
                configs += 1
            checks += n
            violations.extend(vs)
        for nr, L in band_geoms:
            for fn in (check_halo, check_comm):
                n, vs = fn(d, nr, L)
                if n:
                    configs += 1
                checks += n
                violations.extend(vs)
    return {"configs": configs, "checks": checks}, violations
