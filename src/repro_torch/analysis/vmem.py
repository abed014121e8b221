"""Per-launch shared memory of the CUDA kernels, in place of VMEM.

Port of ``repro.analysis.vmem``.  A Pallas TPU launch keeps its operand
blocks in VMEM; a launch of the port's kernels keeps a tile's rows in the
shared memory its launcher sets (``cudaFuncAttributeMaxDynamicSharedMemorySize``),
at most 232448 bytes a block on the H100 (:data:`SMEM_MAX`, the opt-in
limit).  The bytes come from the Python mirrors of the launchers' plans
in the kernel modules, never from closed forms written here:
``band_fwd_floats``, ``band_dq_floats``, ``band_dkvw_floats``,
``sub_fwd_floats``, ``sub_bwd_floats`` (at ``sub_bwd_tq``),
``stream_*_floats`` (``kernels.h1d_block``), ``plan_attend_stages``
(``_attend_smem``), ``update_quant_smem`` and ``update_chain_plan``
(``kernels.h1d_decode_kernel``).  ``chip_smoke.py`` holds every
record's bytes to what its launcher set on the card.

``kernels/tuning.py`` calls :func:`band_launch_bytes` while it lists a
family's candidates, and drops those over the budget as
``rejected:vmem``.  The names are the reference's: the budget is the
shared memory of one block, not a TPU's VMEM.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from .contracts import LaunchRecord

#: shared memory one block may opt in to on the H100, bytes (the
#: launchers plan against all of it)
SMEM_MAX = 232448


def default_budget() -> int:
    """The shared-memory budget in bytes ($REPRO_VMEM_BUDGET overrides).
    A malformed override warns and falls back to the default."""
    env = os.environ.get("REPRO_VMEM_BUDGET")
    if env:
        try:
            return int(env)
        except ValueError:
            warnings.warn(
                f"REPRO_VMEM_BUDGET={env!r} is not an integer; using "
                f"the default budget",
                RuntimeWarning, stacklevel=2)
    return SMEM_MAX


def launch_tile(family: str, meta: Dict[str, Any]) -> Dict[str, Any]:
    """A band record's tile: its own, else the launch policy's default
    at its shape."""
    tile = meta.get("tile")
    if tile:
        return tile
    from ..kernels import tuning
    return tuning.default_tile(family, L=meta["Lq"], nr=meta["nr"],
                               mode=meta["mode"], ratio=meta["ratio"],
                               B=meta["B"], G=meta["G"], d=meta["d"],
                               dv=meta["dv"])


def launch_smem(family: str, meta: Dict[str, Any]) -> Tuple[int, ...]:
    """Dynamic shared memory of each kernel of one launch, in bytes, from
    the record's ``meta`` (its ``tile``, else the launch policy's default
    at the shape): what the launcher sets."""
    from ..kernels import h1d_block as hb
    from ..kernels import h1d_decode_kernel as dk
    if family in ("band_fwd", "sub_fwd", "band_bwd", "sub_bwd"):
        d, dv, nr, mode = meta["d"], meta["dv"], meta["nr"], meta["mode"]
        body = meta.get("body", "band")
        bwd = family.endswith("bwd")
        if body == "stream":
            return ((4 * hb.stream_dq_floats(d, dv, nr),
                     4 * hb.stream_dkvw_floats(d, dv)) if bwd
                    else (4 * hb.stream_fwd_floats(d, dv, nr),))
        tile = launch_tile(family, meta)
        if mode in ("sub", "coarse_causal"):
            ratio = meta["ratio"] if mode == "sub" else 1
            if not bwd:
                return (4 * hb.sub_fwd_floats(d, dv, nr, ratio),)
            tq = hb.sub_bwd_tq(meta["G"], nr * ratio, tile["splits"], d, dv,
                               nr)
            return (4 * hb.sub_bwd_floats(tq, d, dv, nr),)
        if not bwd:
            return (4 * hb.band_fwd_floats(mode, tile["tq"], d, dv, nr),)
        return (4 * hb.band_dq_floats(mode, tile["tq"], d, dv, nr),
                4 * hb.band_dkvw_floats(mode, tile["nkb"], tile["tk"], d, dv,
                                        nr))
    d, dv, nlev = meta["d"], meta["dv"], meta["levels"]
    if family.startswith("decode_attend"):
        cr = (meta.get("tile") or {}).get("cr")
        plan = dk.plan_attend_stages(meta["G"], d, dv, meta["nr"], nlev,
                                     quant=meta.get("qmask", 0) != 0,
                                     half=bool(meta["half"]), cr=cr)
        return (plan.smem,)
    if family == "decode_update_paged_quant":
        return (dk.update_quant_smem(d, dv, meta["qmask"], nlev,
                                     bool(meta["half"])),)
    return (dk.update_chain_plan(d, dv, nlev,
                                 paged=family == "decode_update_paged")[1],)


def record_smem_bytes(record: LaunchRecord) -> int:
    """Shared memory of one launch's larger kernel, in bytes (the
    counterpart of the reference's ``contract_vmem_bytes``)."""
    return int(max(launch_smem(record.family, record.meta)))


def band_launch_bytes(family: str, *, L: int, nr: int, mode: str, tq,
                      ratio: int = 1, d: int = 64, dv: Optional[int] = None,
                      B: int = 1, G: int = 1,
                      dtype: str = "float32") -> int:
    """Shared memory of one band candidate's larger launch: the record of
    ``(family, shape, tq)`` made on ``meta`` tensors (nothing runs) and
    sized by :func:`record_smem_bytes`.  ``tq`` is rows a tile (a
    backward's dQ tile, its other fields the default's) or a candidate's
    fields."""
    from . import contracts
    from ..kernels import h1d_block as hb
    from ..kernels import tuning

    dv = d if dv is None else dv
    sub = family in ("sub_fwd", "sub_bwd")
    if sub:
        mode = hb.SUB_MODE
    Lk = L // ratio if sub else L
    shape = dict(L=L, nr=nr, mode=mode, ratio=ratio, B=B, G=G, d=d, dv=dv)
    tile = tuning.default_tile(family, **shape)
    tile = dict(tuning.tile_of(tile), **(
        {"tq": int(tq)} if isinstance(tq, int) else tuning.tile_of(tq)))
    if "splits" in tile:
        tile.pop("tq", None)
    meta = torch.device("meta")
    q = torch.empty((B, G, L, d), device=meta)
    k = torch.empty((B, Lk, d), device=meta)
    v = torch.empty((B, Lk, dv), device=meta)
    w = torch.empty((B, Lk), device=meta)
    if sub:
        rec = getattr(contracts, family)(q, k, v, w, nr=nr, ratio=ratio,
                                         tile=tile)
    else:
        body = (hb.check_window_fwd if family == "band_fwd"
                else hb.check_window_bwd)(mode, nr, d, dv)
        rec = getattr(contracts, family)(q, k, v, w, nr=nr, mode=mode,
                                         body=body, tile=tile)
    return record_smem_bytes(rec)
