"""Gate over the port's kernels and serving layer: the launch records, SP
ownership and the page pool.

    PYTHONPATH=src python -m repro_torch.analysis.check [--json -]

Port of ``repro.analysis.check``.  With no section flag (or
``--kernels``) it makes the launch record of every kernel family on
``meta`` tensors -- nothing is built or launched -- over the reference's
case list: the band and sub forwards and backwards at every candidate
tile of the launch policy (``kernels.tuning``: every band mode at L 64
and 1024, ``sub`` at (ratio, L) (2, 256) and (8, 1024), nr 16, d 16), and
every decode family at two geometries (Lmax 16 nr, R 3, G 2 and 64 nr,
R 4, G 1; nr 4 and 16) with per-level page pools of unequal sizes, the
sequence-parallel (``_partial``) forms and f32 and bf16 caches, each
attend at every stage plan the policy lists.  Each record goes through
:mod:`repro_torch.analysis.checker`: every CTA's reads and writes in
bounds, outputs written exactly once, in-place updates aliased, page
tables within their domains, grids and shared memory the launchers'.

``--dist`` runs :mod:`repro_torch.analysis.dist` (cross-shard ownership,
halo protocol, comm volume over mesh sizes 1/2/4/8, no device);
``--pool`` runs :mod:`repro_torch.analysis.pool_model` (a bounded
exhaustive model check of the port's
:class:`~repro_torch.serve.paged_cache.PagePool`).  ``--family SUBSTR``
keeps the records (and violations) whose family or label contains
SUBSTR; ``--json [PATH]`` writes a report of the reference's schema
(``sections``, ``contracts``, ``families``, ``violations``, ``dist``,
``pool``, ``ok``, ``runtime_s``).  Exit code 1 on any violation.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Tuple

import torch

from . import checker, contracts
from .contracts import LaunchRecord
from .violation import Violation

BAND_LS = (64, 1024)
SUB_CASES = ((2, 256), (8, 1024))   # (ratio, L)
DECODE_GEOMETRIES = ((16, 3, 2), (64, 4, 1))   # (Lmax / nr, R, G)
CACHE_DTYPES = (torch.float32, torch.bfloat16)

_META = torch.device("meta")


def _e(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=_META)


def band_contracts(policy, *, nr: int, d: int
                   ) -> List[Tuple[str, LaunchRecord]]:
    """(label, record) of every band / sub candidate config."""
    from ..kernels import h1d_block as hb
    from ..kernels import tuning

    out: List[Tuple[str, LaunchRecord]] = []
    cases = [(m, 1, L) for m in hb.MODES for L in BAND_LS]
    cases += [("sub", r, L) for r, L in SUB_CASES]
    B, G = 1, 2
    for mode, ratio, L in cases:
        sub = mode == "sub"
        Lk = L // ratio if sub else L
        q, k, v, w = _e(B, G, L, d), _e(B, Lk, d), _e(B, Lk, d), _e(B, Lk)
        for fam in (("sub_fwd", "sub_bwd") if sub
                    else ("band_fwd", "band_bwd")):
            for cand in policy.candidates(fam, L=L, nr=nr, mode=mode,
                                          ratio=ratio, d=d, B=B, G=G):
                tile = tuning.tile_of(cand)
                label = (f"{fam} {mode} r{ratio} L{L} "
                         + " ".join(f"{f}{v}" for f, v in tile.items()))
                if sub:
                    rec = getattr(contracts, fam)(q, k, v, w, nr=nr,
                                                  ratio=ratio, tile=tile)
                else:
                    body = (hb.check_window_fwd if fam == "band_fwd"
                            else hb.check_window_bwd)(mode, nr, d, d)
                    rec = getattr(contracts, fam)(q, k, v, w, nr=nr,
                                                  mode=mode, body=body,
                                                  tile=tile)
                out.append((label, rec))
    return out


def _caches(R: int, Lmax: int, nr: int, d: int, dtype):
    """A dense cache (the partial forms' slab too), per-level page pools
    of unequal sizes, and an int8 pool whose even levels are int8."""
    from ..core import h1d_decode as hd
    from ..core import hierarchy as hc
    nlev = max(hc.num_levels(Lmax, nr), 1)
    lv = [(_e(R, Lmax >> l, d, dtype=dtype), _e(R, Lmax >> l, d, dtype=dtype))
          for l in range(nlev)]
    cache = hd.H1DCache(lv[0][0], lv[0][1], tuple(x[0] for x in lv[1:]),
                        tuple(x[1] for x in lv[1:]))
    nbands = nlev + 1
    pages = [8 + 2 * nbands - 2 * i for i in range(nlev)]
    pk = [_e(n, nr, d, dtype=dtype) for n in pages]
    pv = [_e(n, nr, d, dtype=dtype) for n in pages]
    pool = hd.PagedH1DCache(pk[0], pv[0], tuple(pk[1:]), tuple(pv[1:]))
    qt = [torch.int8 if l % 2 == 0 else dtype for l in range(nlev)]
    qk = [_e(n, nr, d, dtype=t) for n, t in zip(pages, qt)]
    qv = [_e(n, nr, d, dtype=t) for n, t in zip(pages, qt)]
    sc = [_e(n, nr) for n in pages]
    qpool = hd.QuantPagedH1DCache(qk[0], qv[0], tuple(qk[1:]), tuple(qv[1:]),
                                  sc[0], sc[0], tuple(sc[1:]), tuple(sc[1:]))
    return cache, pool, qpool, nlev


def decode_contracts(policy, *, nr: int, d: int
                     ) -> List[Tuple[str, LaunchRecord]]:
    """(label, record) of every decode family at the two geometries, f32
    and bf16 caches, each attend at every stage plan of the policy."""
    out: List[Tuple[str, LaunchRecord]] = []
    for blocks, R, G in DECODE_GEOMETRIES:
        Lmax = blocks * nr
        for dtype in CACHE_DTYPES:
            dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
            label = f"nr{nr} Lmax{Lmax} R{R} {dt}"
            cache, pool, qpool, nlev = _caches(R, Lmax, nr, d, dtype)
            q, t = _e(R, G, d), _e(R, dtype=torch.int32)
            kn, vn = _e(R, d), _e(R, d)
            bidx = _e(R, nlev + 1, dtype=torch.int32)
            utab = _e(R, nlev, dtype=torch.int32)
            own1 = _e(R, dtype=torch.int32)
            attends = (
                ("decode_attend", False, lambda tl: contracts.decode_attend(
                    cache, q, t, nr=nr, tile=tl)),
                ("decode_attend_paged", False,
                 lambda tl: contracts.decode_attend_paged(
                     pool, q, t, bidx, nr=nr, tile=tl)),
                ("decode_attend_paged_quant", True,
                 lambda tl: contracts.decode_attend_paged_quant(
                     qpool, q, t, bidx, nr=nr, tile=tl)),
                ("decode_attend_partial", False,
                 lambda tl: contracts.decode_attend_partial(
                     cache, q, t, bidx, bidx, nr=nr, tile=tl)),
            )
            for fam, quant, make in attends:
                for cand in policy.candidates(fam, G=G, d=d, dv=d, nr=nr,
                                              levels=nlev, quant=quant,
                                              dtype=dt):
                    out.append((f"{fam} {label} cr{cand['cr']}",
                                make({"cr": cand["cr"]})))
            updates = [
                ("decode_update", contracts.decode_update(
                    cache, kn, vn, t, tile={})),
                ("decode_update_paged", contracts.decode_update_paged(
                    pool, kn, vn, t, utab, tile={})),
                ("decode_update_partial", contracts.decode_update_partial(
                    cache, kn, vn, t, own1, tile={})),
            ]
            if dtype == torch.float32:   # #10 takes f32 beside its int8
                updates.append((
                    "decode_update_paged_quant",
                    contracts.decode_update_paged_quant(
                        qpool, kn, vn, t, utab, tile={})))
            out += [(f"{fam} {label}", rec) for fam, rec in updates]
    return out


def kernel_contracts(*, nr: int, d: int) -> List[Tuple[str, LaunchRecord]]:
    """The whole kernels sweep: band / sub at ``nr``, decode at nr 4 and
    ``nr``."""
    from ..kernels import tuning
    policy = tuning.KernelPolicy()
    labeled = band_contracts(policy, nr=nr, d=d)
    for n in sorted({4, nr}):
        labeled += decode_contracts(policy, nr=n, d=d)
    return labeled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nr", type=int, default=16,
                    help="block size of the band sweep")
    ap.add_argument("--d", type=int, default=16,
                    help="head dim of the records' shapes")
    ap.add_argument("--samples", type=int, default=checker.DEFAULT_SAMPLES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", action="store_true",
                    help="check the kernels' launch records (the default "
                         "when no section flag is given)")
    ap.add_argument("--dist", action="store_true",
                    help="check SP cross-shard ownership/halo/comm")
    ap.add_argument("--pool", action="store_true",
                    help="model-check the paged-pool state machine")
    ap.add_argument("--pool-states", type=int, default=12000,
                    help="distinct-state budget for --pool")
    ap.add_argument("--family", default=None, metavar="SUBSTR",
                    help="only check/report records and violations "
                         "whose family or label contains SUBSTR")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="write a JSON report to PATH ('-' = stdout)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    sections = [s for s, on in (("kernels", args.kernels),
                                ("dist", args.dist),
                                ("pool", args.pool)) if on] or ["kernels"]
    t0 = time.time()
    violations: List[Tuple[str, Violation]] = []
    dist_stats = pool_stats = None
    fams: Dict[str, int] = {}
    n_records = 0
    t_build = 0.0

    if "kernels" in sections:
        labeled = kernel_contracts(nr=args.nr, d=args.d)
        if args.family:
            labeled = [(lb, r) for lb, r in labeled
                       if args.family in lb or args.family in r.family]
        t_build = time.time() - t0
        n_records = len(labeled)
        for label, rec in labeled:
            fams[rec.family] = fams.get(rec.family, 0) + 1
            for v in checker.check_contract(rec, samples=args.samples,
                                            seed=args.seed):
                violations.append((label, v))
            if args.verbose:
                print(f"  {label}: {rec.describe()} smem={list(rec.smem)}")

    if "dist" in sections:
        from . import dist
        dist_stats, vs = dist.run_dist()
        if args.family:
            vs = [v for v in vs if args.family in v.family]
        violations.extend((v.family, v) for v in vs)

    if "pool" in sections:
        from . import pool_model
        pool_stats, vs = pool_model.run_pool(max_states=args.pool_states)
        if args.family:
            vs = [v for v in vs if args.family in v.family]
        violations.extend((v.family, v) for v in vs)

    total = time.time() - t0
    if "kernels" in sections:
        print(f"checked {n_records} contracts across {len(fams)} "
              f"families in {total:.1f}s (records {t_build:.1f}s):")
        for fam in sorted(fams):
            print(f"  {fam}: {fams[fam]} contracts")
    if dist_stats is not None:
        print(f"dist: {dist_stats['configs']} configs, "
              f"{dist_stats['checks']} ownership/halo/comm checks")
    if pool_stats is not None:
        cov = pool_stats["coverage"]
        print(f"pool: {pool_stats['states']} states, "
              f"{pool_stats['transitions']} transitions "
              f"(cow {cov.get('cow_copies', 0)}, "
              f"evict {cov.get('evictions', 0)}, "
              f"restore {cov.get('restore', 0)})")

    if args.json is not None:
        report = {
            "sections": sections,
            "contracts": n_records,
            "families": fams,
            "violations": [dict(label=label, **dataclasses.asdict(v))
                           for label, v in violations],
            "dist": dist_stats,
            "pool": pool_stats,
            "ok": not violations,
            "runtime_s": round(total, 3),
        }
        if args.json == "-":
            json.dump(report, sys.stdout, indent=2)
            print()
        else:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=2)

    if violations:
        print(f"FAILED: {len(violations)} violations")
        for label, v in violations:
            print(f"  {label}: {v}")
        return 1
    print("OK: no violations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
