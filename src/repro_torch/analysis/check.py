"""Gate over the serving layer's rules: SP ownership and the page pool.

    PYTHONPATH=src python -m repro_torch.analysis.check --dist --pool \\
        --json -

Port of ``repro.analysis.check`` for two of its sections.  ``--dist``
runs :mod:`repro_torch.analysis.dist` (cross-shard ownership, halo
protocol, comm volume over mesh sizes 1/2/4/8, no device); ``--pool``
runs :mod:`repro_torch.analysis.pool_model` (a bounded exhaustive model
check of the port's :class:`~repro_torch.serve.paged_cache.PagePool`,
``--pool-states`` distinct states).  With no section flag both run.
``--kernels`` (the launch records' shared memory, registers and tile
table) raises ``NotImplementedError`` until ROADMAP A.13's kernels
section lands.  ``--family SUBSTR`` keeps the violations whose family
contains SUBSTR; ``--json [PATH]`` writes a report of the reference's
schema (``sections``, ``contracts``, ``families``, ``violations``,
``dist``, ``pool``, ``ok``, ``runtime_s``; no kernel section fills
``contracts`` or ``families`` here).  Exit code 1 on any violation.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Tuple

from .violation import Violation

KERNELS_PENDING = ("the kernels section (each launch's shared memory and "
                   "registers, a Hopper tile table, a checker over the "
                   "launch records) is not ported yet: ROADMAP A.13")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernels", action="store_true",
                    help="check the kernel launches (not ported yet: "
                         "raises NotImplementedError)")
    ap.add_argument("--dist", action="store_true",
                    help="check SP cross-shard ownership/halo/comm")
    ap.add_argument("--pool", action="store_true",
                    help="model-check the paged-pool state machine")
    ap.add_argument("--pool-states", type=int, default=12000,
                    help="distinct-state budget for --pool")
    ap.add_argument("--family", default=None, metavar="SUBSTR",
                    help="only report violations whose family contains "
                         "SUBSTR")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="write a JSON report to PATH ('-' = stdout)")
    args = ap.parse_args(argv)
    if args.kernels:
        raise NotImplementedError(KERNELS_PENDING)

    sections = [s for s, on in (("dist", args.dist),
                                ("pool", args.pool)) if on] or ["dist",
                                                                "pool"]
    t0 = time.time()
    violations: List[Tuple[str, Violation]] = []
    dist_stats = pool_stats = None
    fams: Dict[str, int] = {}

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
            "contracts": 0,
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
