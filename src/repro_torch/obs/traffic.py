"""Analytic HBM traffic and FLOPs of one kernel launch.

Port of ``repro.obs.traffic`` for the CUDA kernels.  The reference
counts the block fetches of a Pallas grid walk; the port counts the
work: the bytes a launch must move between HBM and the card with every
row and key that the band admits by position, whatever the data (key
weights ``w`` taken as all ones), each input read once and each output
written once.  That is the "all rows" count of the bound columns of
PERF.md's kernel table, and ``chip_smoke.py`` computes those columns
here, so the table and the telemetry share one count:

* #1-#4 (``band_*``, ``sub_*``): ``kernels.h1d_block.band_bytes`` /
  ``sub_bytes`` (``coarse_causal`` runs the sub body at ratio 1) on
  ``w = ones`` -- q (and y, the cotangents, m, dn in the backward) of the
  rows that have a band, k and v of the key blocks some row reads, w,
  every output;
* the attends (#5, #7, #8, #11): every band's ``nr`` key and value rows
  of every row (an int8 level's rows at one byte an element plus their
  two 4-byte scales), q, t and the tables read, the output written;
* the updates (#6, #9): ``chip_smoke.update_bound``'s rule -- new k and
  v (float32) and t read, one row of every level written and the sibling
  of every level but the last read; #12 (one shard) also reads the last
  level's sibling and writes the carried row; #10 reads and rewrites
  every level's sibling pair and its scales.

FLOPs are the admitted (query, key) pairs times ``2d + 2dv + 3`` in the
forward and ``6d + 4dv + 5`` in the backward (``4d + 3`` and ``10d + 5``
at d = dv, the counts of ``chip_smoke.py``'s bounds), ``R G K (2D + 2Dv
+ 4)`` for an attend of K keys a row; an update counts two operations a
carried element.  These are analytic estimates for roofline ratios,
not hardware counters.

Everything is read from the record's shapes and meta in closed form,
once a record (kept in ``LaunchRecord.memo``; a record function hands
over one record per launch signature), so :func:`on_launch`, the hook
``obs.enable()`` registers, costs microseconds a launch and never
touches the device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..analysis.contracts import LaunchRecord
from . import metrics as _m
from . import tracing as _t

_BAND_FAMILIES = ("band_fwd", "sub_fwd", "band_bwd", "sub_bwd")


def band_pairs(mode: str, Lq: int, Lk: int, nr: int, ratio: int = 1) -> int:
    """(query, key) pairs of one (batch row, group) plane that
    ``band_mask`` admits in ``mode`` with every key weight positive."""
    if mode == "sub":
        nq = nr * ratio
        return max(Lq // nq - 1, 0) * 3 * nq * nr // 4
    nb = Lq // nr
    if mode == "l0_causal":
        return nb * nr * (nr + 1) // 2 + max(nb - 1, 0) * nr * nr
    if mode == "l0_bidir":
        return (nb + 2 * max(nb - 1, 0)) * nr * nr
    # a coarse mode: a query block's neighbour blocks, less the quadrant
    # (first-half rows against second-half keys below, the mirror above)
    quad = 3 * nr * nr // 4
    if mode == "coarse_bidir":
        return 2 * max(nb - 1, 0) * quad
    if mode == "coarse_causal":
        return max(nb - 1, 0) * quad
    raise ValueError(f"unknown band mode {mode!r}")


def band_traffic(mode: str, B: int, G: int, Lq: int, Lk: int, d: int,
                 dv: int, nr: int, ratio: int = 1, backward: bool = False
                 ) -> Tuple[int, int, int]:
    """(read bytes, write bytes, FLOPs) of one band call on every row
    (``band_bytes`` / ``sub_bytes`` on ``w = ones``)."""
    if mode in ("sub", "coarse_causal"):
        # the sub body: a query block reads the key block before it; the
        # first block's rows have none, the last key block no reader
        nq = nr * ratio
        nbk = -(-Lk // nr)
        live = B * G * max(Lq - nq, 0)
        blocks = B * max(nbk - 1, 0)
        wread = B * max(nbk - 1, 0) * nr
    else:
        nb = Lq // nr
        none = mode == "coarse_bidir" and nb <= 1
        live = 0 if none else B * G * Lq
        blocks = 0 if none else B * nb
        wread = B * Lk
    if backward:
        rows_in = live * (d + 2 * dv + 4)
        out = B * G * Lq * (d + 1) + B * Lk * (d + dv + 1)
        per_pair = 6 * d + 4 * dv + 5
    else:
        rows_in = live * d
        out = B * G * Lq * (dv + 2)
        per_pair = 2 * d + 2 * dv + 3
    read = 4 * (rows_in + blocks * nr * (d + dv) + wread)
    flops = B * G * band_pairs(mode, Lq, Lk, nr, ratio) * per_pair
    return read, 4 * out, flops


def update_traffic(R: int, nlev: int, D: int, Dv: int, es: int = 4,
                   table_cols: int = 0) -> Tuple[int, int, int]:
    """(read bytes, write bytes, FLOPs) of #6's (and #9's) update on R
    rows of ``nlev`` levels, ``es`` bytes a cache element: the new k and
    v (float32), t and ``table_cols`` int32 columns of a page table read,
    one row of every level written, the sibling of every level but the
    last (whose carry nothing takes) read."""
    read = (4 * R * (D + Dv) + 4 * R * (1 + table_cols)
            + es * R * max(nlev - 1, 0) * (D + Dv))
    return read, es * R * nlev * (D + Dv), R * max(nlev - 1, 0) * (D + Dv)


def _levels(rec: LaunchRecord):
    """(dtype, bytes of one k row plus one v row) of every level."""
    D, Dv = rec.meta["d"], rec.meta["dv"]
    out = []
    for l in range(rec.meta["levels"]):
        dt = rec.operand(f"k{l}").dtype
        row = (D + Dv + 8 if dt == torch.int8 else dt.itemsize * (D + Dv))
        out.append((dt, row))
    return out


def _attend(rec: LaunchRecord) -> Tuple[int, int, int]:
    nlev, nr = rec.meta["levels"], rec.meta["nr"]
    q = rec.operand("q").shape
    R, G, D = q
    Dv = rec.meta["dv"]
    rows = _levels(rec)
    # band 0 (own block) and 1 (previous) on level 0, band l + 1 on l
    per_row = nr * (2 * rows[0][1] + sum(r for _, r in rows[1:]))
    tables = sum(_size(op) for op in rec.inputs
                 if op.name in ("t", "bidx", "owned"))
    read = R * per_row + 4 * R * G * D + tables
    write = sum(_size(op) for op in rec.outputs)
    keys = (nlev + 1) * nr
    return read, write, R * G * keys * (2 * D + 2 * Dv + 4)


def _size(op) -> int:
    n = op.dtype.itemsize
    for s in op.shape:
        n *= s
    return n


def _update(rec: LaunchRecord) -> Tuple[int, int, int]:
    fam, nlev = rec.family, rec.meta["levels"]
    R, D = rec.operand("k_new").shape
    Dv = rec.meta["dv"]
    if fam == "decode_update_paged_quant":
        # every level's sibling pair (and an int8 level's scales) read and
        # rewritten
        pair = sum(2 * (D + Dv) + 16 if dt == torch.int8
                   else 2 * 4 * (D + Dv) for dt, _ in _levels(rec))
        head = 4 * R * (D + Dv) + 4 * R * (1 + nlev)
        return head + R * pair, R * pair, R * nlev * (D + Dv) * 8
    es = rec.operand("k0").dtype.itemsize
    if fam == "decode_update_partial":
        # every row as the owner: the sibling of every level read (the
        # last one's pair is carried out), the carried row written
        read = (4 * R * (D + Dv) + 8 * R + es * R * nlev * (D + Dv))
        return (read, es * R * (nlev + 1) * (D + Dv),
                R * nlev * (D + Dv))
    cols = rec.operand("utab").shape[1] if fam == "decode_update_paged" else 0
    return update_traffic(R, nlev, D, Dv, es, cols)


def _traffic(rec: LaunchRecord) -> Tuple[int, int, int]:
    """(read bytes, write bytes, FLOPs) of ``rec``, computed once a record
    and kept in its ``memo``."""
    hit = rec.memo.get("traffic")
    if hit is None:
        hit = rec.memo["traffic"] = _count(rec)
    return hit


def _count(rec: LaunchRecord) -> Tuple[int, int, int]:
    family, m = rec.family, rec.meta
    if family in _BAND_FAMILIES:
        B, G, Lq, d = rec.operand("q").shape
        Lk = rec.operand("k").shape[-2]
        return band_traffic(m["mode"], B, G, Lq, Lk, d, m["dv"], m["nr"],
                            m["ratio"], backward=family.endswith("_bwd"))
    if family.startswith("decode_attend"):
        return _attend(rec)
    if family.startswith("decode_update"):
        return _update(rec)
    raise ValueError(f"no traffic model for family {family!r}")


def record_hbm_bytes(rec: LaunchRecord) -> Dict[str, int]:
    """``{"read_bytes", "write_bytes"}`` of one launch."""
    read, write, _ = _traffic(rec)
    return {"read_bytes": read, "write_bytes": write}


def record_flops(rec: LaunchRecord) -> int:
    """Analytic FLOPs of one launch."""
    return _traffic(rec)[2]


_COUNTERS = ("kernel.launches", "kernel.hbm_read_bytes",
             "kernel.hbm_write_bytes", "kernel.flops")
#: family -> (registry generation, its four live counters): the lookup of
#: four labelled counters would cost a launch more than the rest of the
#: hook
_LIVE: Dict[str, tuple] = {}


def _counters(fam: str):
    """The four ``kernel.*`` counters of ``fam``, looked up once per
    registry generation (a launch then costs no label-key work)."""
    reg = _m.registry()
    hit = _LIVE.get(fam)
    if hit is None or hit[0] != reg.generation:
        hit = (reg.generation,
               tuple(_m.counter(n, family=fam) for n in _COUNTERS))
        if _m.enabled():
            _LIVE[fam] = hit
    return hit[1]


def on_launch(rec: LaunchRecord) -> None:
    """Launch hook (registered by ``obs.enable()``): account one kernel
    launch into counters and the kernel trace track."""
    read, write, flops = _traffic(rec)
    fam = rec.family
    launches, reads, writes, ops = _counters(fam)
    launches.inc()
    reads.inc(read)
    writes.inc(write)
    ops.inc(flops)
    args = {
        "family": fam,
        "grid": [list(g) for g in rec.grid],
        "hbm_read_bytes": read,
        "hbm_write_bytes": write,
        "flops": flops,
    }
    for k in ("impl", "tq", "mode", "nr", "Lmax", "levels"):
        if k in rec.meta:
            args[k] = rec.meta[k]
    _t.instant("kernel.launch", tid=_t.TRACK_KERNELS, args=args)
