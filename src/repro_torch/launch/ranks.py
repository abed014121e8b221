"""What the serving and training CLIs share to run one shard a process
under ``torchrun``: joining the group and each rank's report.

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.serve --sp-data 2 --device cuda:0 \\
        --rank-report 'serve.{rank}.json'

A CLI started by ``torchrun`` (``parallel.group.launched()``) joins the
group its environment describes; one whose process already joined a
group (a test's worker, ``parallel.group.init``) uses that group.  With
``--rank-report PATH`` each rank writes a JSON document to ``PATH`` with
``{rank}`` replaced by its rank: its kernel launches by wrapper and by
``wrapper[mode]``, the plain versions' calls, its collectives' calls,
bytes and seconds (``parallel.group.STATS``, timed; on a ``DATAxMODEL``
mesh also ``by_axis``: each axis group's, ``op@axis`` counted under
``axis``, the world's under ``world``), and what the CLI adds (tokens,
per-step times, losses, a digest of the parameters).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.parallel import group as grp
from repro_torch.tree import tree_flatten_with_paths


def join(device) -> Tuple[Optional[grp.RankGroup], bool]:
    """(the group, whether this call joined it): the group this process
    already joined, else the one ``torchrun`` describes, else None."""
    g = grp.current()
    if g is not None or not grp.launched():
        return g, False
    return grp.init_from_env(device), True


def counts() -> dict:
    """Launches since the last ``kernels.reset_counts``: by wrapper, by
    ``wrapper[mode]``, and the plain versions' calls as ``plain:name``."""
    out = {n: k.launches for n, (k, _) in kernels.KERNELS.items()}
    out.update({f"{n}[{m}]": c for (n, m), c in
                kernels.mode_launches().items()})
    out.update({f"plain:{n}": p.calls for n, (_, p) in
                kernels.KERNELS.items()})
    return out


def digest(tree) -> str:
    """sha256 of every leaf's bytes in tree order: equal digests on two
    ranks are bit-identical parameters."""
    h = hashlib.sha256()
    for path, leaf in tree_flatten_with_paths(tree):
        h.update(path.encode())
        h.update(leaf.detach().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def by_axis(stats: grp.CommStats) -> dict:
    """The collectives' calls, bytes and seconds summed by axis group
    (``op@axis`` under ``axis``, the world's ops under ``world``)."""
    out: dict = {}
    for field, table in (("calls", stats.calls), ("bytes", stats.nbytes),
                         ("seconds", stats.seconds)):
        for op, n in table.items():
            axis = op.partition("@")[2] or "world"
            row = out.setdefault(axis, {"calls": 0, "bytes": 0,
                                        "seconds": 0.0})
            row[field] += n
    return out


def collectives() -> dict:
    """The collectives' calls, bytes and seconds so far, by op and by
    axis (``parallel.group.STATS``)."""
    return dict(calls=dict(grp.STATS.calls), bytes=dict(grp.STATS.nbytes),
                seconds=dict(grp.STATS.seconds), by_axis=by_axis(grp.STATS))


def write_report(path: str, g: grp.RankGroup, comm=None, **fields) -> str:
    """This rank's report (module docstring) at ``path`` with ``{rank}``
    replaced; ``comm`` the collectives to report (default: all so far,
    :func:`collectives`).  Returns the path written."""
    out = path.replace("{rank}", str(g.rank))
    doc = dict(rank=g.rank, world=g.world, device=str(g.device),
               placement=g.placement, backend=g.backend, launches=counts(),
               collectives=comm if comm is not None else collectives(),
               **fields)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f)
    return out
