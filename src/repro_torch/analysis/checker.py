"""Static checker over the CUDA kernels' launch records.

Port of ``repro.analysis.checker``.  The reference evaluates every
BlockSpec index map of a ``pallas_call`` over its whole grid; the port's
kernels are hand-written CUDA with no index maps, so the checker
evaluates the host mirrors of what each CTA of a record's grid reads and
writes -- the mirrors that ``analysis.dist`` and the card tests already
hold to the kernels:

* ``band_window_blocks`` (the key blocks a tile stages), with
  ``band_pair_items`` (the blocks its score pass reads, which must lie
  in that window) and ``band_dkvw_ctas`` (a dK/dV/dW CTA's key blocks
  and reader rows) for ``band_*``;
* ``SUB_TQ`` tiles and ``sub_bwd_splits`` / the record's splits for
  ``sub_*`` (a CTA of the backward owns a share of a query block's rows
  and, with its cluster, key block I - 1);
* ``attend_band_rows`` and ``attend_dense_blocks`` for the attends (each
  band's rows from its page, slab block or dense block);
* ``update_pair_index`` for the updates (each level's sibling pair);
* the ``bidx`` / ``utab`` / ``owned`` tables for the paged and partial
  forms, sampled within their declared domains (``record.scalars``).

A CTA's reads and writes are row ranges of its operands (a row: one
position of a (.., d) operand, one element of a vector).  The streamed
bodies visit their tiles in ``stream_slot`` order, a permutation: the
mirror lists them in grid order, which leaves every check unchanged.

Checks, per record (the reference's kinds):

* ``oob`` -- every read and write inside its operand, at every CTA;
* ``coverage-gap`` / ``double-write`` -- a non-aliased output's rows
  written exactly once; a row written by several CTAs is legal only when
  they are consecutive in grid order (a thread block cluster's shares of
  one key block in the sub backward, the port's accumulation);
* ``alias-mismatch`` -- an in-place update's read and written operand
  agree in shape and dtype, and each CTA writes the rows it read;
* ``scalar-oob`` -- an access out of its operand only under a sampled
  table (the hi corner, or ``samples`` seeded tables, of the declared
  domains);
* ``bad-spec`` -- an empty or negative declared domain, a grid that is
  not the one the launcher builds for the record's tile
  (:func:`launch_grid`), shared memory that is not the launcher's, or a
  mirror that fails.

Pure numpy over the records: no tensor data is read and nothing runs.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .contracts import Grid, LaunchRecord, Operand
from .vmem import launch_tile
from .violation import Violation

DEFAULT_SAMPLES = 3   # seeded tables per record (plus lo and hi)

#: operands whose last axis is a row's width (rows = all other axes)
_WIDE = {"q", "k", "v", "y", "gy", "dq", "dk", "dv", "out", "num", "k_new",
         "v_new", "carry_k", "carry_v", "bidx", "owned", "utab"}

#: (operand, "r" | "w", kernel, CTA in grid order, first row, end row)
Access = Tuple[str, str, int, int, int, int]


def _rows(op: Operand) -> int:
    wide = len(op.shape) >= 2 and (op.name in _WIDE or op.name[0] in "kv"
                                   and op.name[1:].isdigit())
    return int(math.prod(op.shape[:-1] if wide else op.shape))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# the launchers' grids
# ---------------------------------------------------------------------------

def launch_grid(family: str, meta: Dict[str, Any]) -> Grid:
    """The CUDA grid of each kernel that the launcher builds for a
    record's shape and ``tile`` (the default where it has none)."""
    from ..kernels import h1d_block as hb
    if family.startswith("decode"):
        return ((meta["R"], 1),)
    B, G, L, Lk, nr = meta["B"], meta["G"], meta["Lq"], meta["Lk"], \
        meta["nr"]
    body, mode = meta.get("body", "band"), meta["mode"]
    bwd = family.endswith("bwd")
    if body == "stream":
        g = ((B * G * _cdiv(L, hb.STREAM_TQ), 1),)
        return g + ((B * _cdiv(L, hb.STREAM_KV_TK), 1),) if bwd else g
    if mode in ("sub", "coarse_causal"):
        if not bwd:
            return ((G * _cdiv(L, hb.SUB_TQ), B),)
        return ((_cdiv(Lk, nr) * launch_tile(family, meta)["splits"], B),)
    tile = launch_tile(family, meta)
    g = ((G * _cdiv(L, tile["tq"]), B),)
    return g + ((_cdiv(L // nr, tile["nkb"]), B),) if bwd else g


# ---------------------------------------------------------------------------
# what each CTA reads and writes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _score_blocks(mode: str, p0: int, rows: int, nr: int) -> frozenset:
    """Key blocks, relative to a tile's first row's block, that the score
    pass (``band_pair_items``) of a tile of ``rows`` rows from position
    ``p0`` of its block reads."""
    from ..kernels import h1d_block as hb
    out = set()
    for _, r0, _, groups in hb.band_pair_items(mode, p0, rows, nr):
        for off, _ in groups:
            out.add((p0 + r0) // nr + off)
    return frozenset(out)


def _tile_rows(t: int, tq: int, L: int) -> Tuple[int, int]:
    """Rows of tile t: a partial last tile stops at L (the kernels guard
    rows past it); a tile wholly past L is not guarded."""
    r0 = t * tq
    return r0, (min(r0 + tq, L) if r0 < L else r0 + tq)


def _band_tiles(acc, kernel: int, grid, G: int, L: int, Lk: int, tq: int,
                ins, outs, keys):
    """The row tiles of one kernel: CTA (x, b) takes tile x % nt of head
    x // nt; ``keys(b, r0, hi)`` lists its key-row ranges."""
    gx, gy = grid
    nt = max(gx // G, 1)
    for b in range(gy):
        for x in range(gx):
            g, t = divmod(x, nt)
            r0, hi = _tile_rows(t, tq, L)
            base = (b * G + g) * L
            cta = b * gx + x
            for name in ins:
                acc.append((name, "r", kernel, cta, base + r0, base + hi))
            for name in outs:
                acc.append((name, "w", kernel, cta, base + r0, base + hi))
            for lo, end in keys(b, r0, hi):
                for name in ("k", "v", "w"):
                    acc.append((name, "r", kernel, cta, b * Lk + lo,
                                b * Lk + end))


def _band_window(mode: str, nr: int, nb: int, tq: int):
    from ..kernels import h1d_block as hb
    nwb = hb.band_window_blocks(mode, tq, nr)

    def keys(b, r0, hi):
        first = r0 // nr - 1
        lo, end = max(first, 0), min(first + nwb, nb)
        if r0 < nb * nr:
            rel = _score_blocks(mode, r0 % nr, hi - r0, nr)
            if not all(-1 <= x < nwb - 1 for x in rel):
                raise ValueError(f"the score pass of rows {r0}..{hi} reads "
                                 f"key blocks {sorted(rel)} past its "
                                 f"{nwb}-block window")
        return [(lo * nr, end * nr)] if lo < end else []
    return keys


def _fp_band(rec: LaunchRecord, tables) -> List[Access]:
    from ..kernels import h1d_block as hb
    m = rec.meta
    fam, mode, nr = rec.family, m["mode"], m["nr"]
    B, G, L, Lk = m["B"], m["G"], m["Lq"], m["Lk"]
    bwd = fam.endswith("bwd")
    acc: List[Access] = []
    fwd_in = ("q",) + (("y", "dn", "m", "gy", "gdn", "gm") if bwd else ())
    fwd_out = ("dq", "gmn") if bwd else ("y", "dn", "m")
    body = m.get("body", "band")
    if mode in ("sub", "coarse_causal"):
        ratio = m["ratio"] if mode == "sub" else 1
        nq, nbk = nr * ratio, _cdiv(Lk, nr)
        if not bwd:
            def keys(b, r0, hi):
                lo = max(r0 // nq - 1, 0)
                end = min((hi - 1) // nq, nbk)
                return [(lo * nr, min(end * nr, Lk))] if lo < end else []
            _band_tiles(acc, 0, rec.grid[0], G, L, Lk, hb.SUB_TQ, fwd_in,
                        fwd_out, keys)
            return acc
        _sub_bwd(acc, rec.grid[0], G, L, Lk, nr, nq,
                 launch_tile(fam, m)["splits"], fwd_in, fwd_out)
        return acc
    if body == "stream":
        _stream_rows(acc, rec.grid[0], G, L, nr, fwd_in, fwd_out)
        if bwd:
            _stream_kv(acc, rec.grid[1], B, G, L, nr)
        return acc
    tile = launch_tile(fam, m)
    _band_tiles(acc, 0, rec.grid[0], G, L, Lk, tile["tq"], fwd_in, fwd_out,
                _band_window(mode, nr, L // nr, tile["tq"]))
    if bwd:
        _band_dkvw(acc, rec.grid[1], mode, G, L, nr, tile["nkb"])
    return acc


def _stream_rows(acc, grid, G, L, nr, ins, outs):
    """The streamed forward (or dQ pass): a CTA a tile of STREAM_TQ rows of
    one (b, g), reading the keys from the block before its first row's
    to its last row."""
    from ..kernels import h1d_block as hb
    gx, _ = grid
    nt = _cdiv(L, hb.STREAM_TQ)
    for x in range(gx):
        bg, t = divmod(x, nt)
        b = bg // G
        r0, hi = _tile_rows(t, hb.STREAM_TQ, L)
        for name in ins:
            acc.append((name, "r", 0, x, bg * L + r0, bg * L + hi))
        for name in outs:
            acc.append((name, "w", 0, x, bg * L + r0, bg * L + hi))
        k0 = max(r0 // nr - 1, 0) * nr
        for name in ("k", "v", "w"):
            acc.append((name, "r", 0, x, b * L + k0, b * L + hi))


def _band_dkvw(acc, grid, mode, G, L, nr, nkb):
    """dK/dV/dW CTAs (``band_dkvw_ctas``): key blocks [J0, J0 + nkh) and
    their reader rows of every head."""
    from ..kernels import h1d_block as hb
    gx, gy = grid
    ctas = hb.band_dkvw_ctas(mode, L, nr, nkb)
    for b in range(gy):
        for x in range(gx):
            if x < len(ctas):
                J0, nkh, (lo, hi) = ctas[x]
            else:                           # past the last key block
                J0, nkh, (lo, hi) = x * nkb, nkb, (x * nkb * nr,
                                                   (x + 1) * nkb * nr)
            cta = b * gx + x
            k0, k1 = b * L + J0 * nr, b * L + (J0 + nkh) * nr
            for g in range(G):
                base = (b * G + g) * L
                for name in ("q", "gy", "gdn"):
                    acc.append((name, "r", 1, cta, base + lo, base + hi))
            acc.append(("w", "r", 1, cta, b * L + lo, b * L + hi))
            for name in ("dk", "dv", "dw"):
                acc.append((name, "w", 1, cta, k0, k1))


def _stream_kv(acc, grid, B, G, L, nr):
    """The streamed dK/dV/dW pass: a CTA a tile of STREAM_KV_TK keys of
    one sequence, read by the rows of their own block (at or after them)
    and of the block after."""
    from ..kernels import h1d_block as hb
    gx, _ = grid
    nkt = _cdiv(L, hb.STREAM_KV_TK)
    for x in range(gx):
        b, kt = divmod(x, nkt)
        k0 = kt * hb.STREAM_KV_TK
        k1 = min(k0 + hb.STREAM_KV_TK, L) if b < B else k0 + hb.STREAM_KV_TK
        r1 = min(L, ((k1 - 1) // nr + 2) * nr)
        for g in range(G):
            base = (b * G + g) * L
            for name in ("q", "gy", "gdn", "m"):
                acc.append((name, "r", 1, x, base + k0, base + r1))
        for name in ("k", "v", "w"):
            acc.append((name, "r", 1, x, b * L + k0, b * L + k1))
        for name in ("dk", "dv", "dw"):
            acc.append((name, "w", 1, x, b * L + k0, b * L + k1))


def _sub_bwd(acc, grid, G, Lq, Lk, nr, nq, S, ins, outs):
    """CTA (I, split) of the sub backward: its share of query block I's G
    nq rows, and key block I - 1 (I = 0: the last key block's zeros),
    whose gradients the cluster's S CTAs write in shares."""
    gx, gy = grid
    nbk = _cdiv(Lk, nr)
    Rs = G * nq // S
    for b in range(gy):
        for x in range(gx):
            I, split = divmod(x, S)
            cta = b * gx + x
            here = min(nq, Lq - I * nq) if I * nq < Lq else nq
            f, f1 = split * Rs, (split + 1) * Rs
            while f < f1:
                g, p = divmod(f, nq)
                p1 = min(nq, p + (f1 - f))
                lo = (b * G + g) * Lq + I * nq + p
                end = (b * G + g) * Lq + I * nq + min(p1, here)
                if end > lo:
                    for name in ins:
                        acc.append((name, "r", 0, cta, lo, end))
                    for name in outs:
                        acc.append((name, "w", 0, cta, lo, end))
                f += p1 - p
            J = I - 1 if I > 0 else nbk - 1
            k0 = b * Lk + J * nr
            k1 = b * Lk + (min(Lk, (J + 1) * nr) if J < nbk else
                           (J + 1) * nr)
            if I > 0:
                for name in ("k", "v", "w"):
                    acc.append((name, "r", 0, cta, k0, k1))
            for name in ("dk", "dv", "dw"):
                acc.append((name, "w", 0, cta, k0, k1))


def _levels_of(rec: LaunchRecord) -> List[Operand]:
    return [rec.operand(f"k{l}") for l in range(rec.meta["levels"])]


def _fp_attend(rec: LaunchRecord, tables) -> List[Access]:
    from ..kernels import h1d_decode_kernel as dk
    m, fam = rec.meta, rec.family
    R, G, nr, nlev = m["R"], m["G"], m["nr"], m["levels"]
    nb = nlev + 1
    quant = m.get("qmask", 0) != 0
    quantum = dk.attend_quantum(m["d"], m["dv"], nr, quant, bool(m["half"]))
    t = tables["t"]
    owned = tables.get("owned")
    rows = dk.attend_band_rows(t, nr, nb, owned=owned, quantum=quantum)
    lv = _levels_of(rec)
    if fam == "decode_attend":
        blk = dk.attend_dense_blocks(t, nr, m["Lmax"], nb)
    else:
        blk = tables["bidx"]
    outs = ("num", "den", "m") if fam == "decode_attend_partial" else ("out",)
    acc: List[Access] = []
    for r in range(R):
        acc.append(("q", "r", 0, r, r * G, (r + 1) * G))
        acc.append(("t", "r", 0, r, r, r + 1))
        for name in ("bidx", "owned"):
            if name in tables:
                acc.append((name, "r", 0, r, r, r + 1))
        for name in outs:
            acc.append((name, "w", 0, r, r * G, (r + 1) * G))
        for band in range(nb):
            n = int(rows[r, band])
            if n == 0:
                continue
            l = max(band - 1, 0)
            if fam in ("decode_attend", "decode_attend_partial"):
                first = r * lv[l].shape[1] + int(blk[r, band]) * nr
            else:
                first = int(blk[r, band]) * nr
            names = [f"k{l}", f"v{l}"]
            if quant and lv[l].dtype.itemsize == 1:
                names += [f"ksc{l}", f"vsc{l}"]
            for name in names:
                acc.append((name, "r", 0, r, first, first + n))
    return acc


def _fp_update(rec: LaunchRecord, tables) -> List[Access]:
    from ..kernels import h1d_decode_kernel as dk
    m, fam = rec.meta, rec.family
    R, nlev = m["R"], m["levels"]
    t = tables["t"]
    lv = _levels_of(rec)
    acc: List[Access] = []
    for r in range(R):
        for name in ("k_new", "v_new", "t", "utab", "owned"):
            if name in ("k_new", "v_new", "t") or name in tables:
                acc.append((name, "r", 0, r, r, r + 1))
        if fam == "decode_update_partial":
            for name in ("carry_k", "carry_v"):
                acc.append((name, "w", 0, r, r, r + 1))
            if not tables["owned"][r]:
                continue
        for l in range(nlev):
            if fam in ("decode_update_paged", "decode_update_paged_quant"):
                nr = m["nr"]
                first = (int(tables["utab"][r, l]) * nr
                         + 2 * ((int(t[r]) >> (l + 1)) & (nr // 2 - 1)))
            else:
                n = lv[l].shape[1]
                first = r * n + 2 * int(dk.update_pair_index(t[r], n, l))
            names = [f"k{l}", f"v{l}"]
            if m.get("qmask", 0) >> l & 1:
                names += [f"ksc{l}", f"vsc{l}"]
            for name in names:
                acc.append((name, "r", 0, r, first, first + 2))
                acc.append((name, "w", 0, r, first, first + 2))
    return acc


def footprint(rec: LaunchRecord, tables: Dict[str, np.ndarray]
              ) -> List[Access]:
    """Every CTA's reads and writes of one record under one sample of its
    tables."""
    if rec.family.startswith("decode_attend"):
        return _fp_attend(rec, tables)
    if rec.family.startswith("decode_update"):
        return _fp_update(rec, tables)
    return _fp_band(rec, tables)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _bounds(s, which: str) -> np.ndarray:
    return np.broadcast_to(np.asarray(getattr(s, which), dtype=np.int64),
                           s.shape)


def _samples(rec: LaunchRecord, samples: int, seed: int):
    """The lo corner, the hi corner and ``samples`` seeded tables, all
    within the declared domains."""
    if not rec.scalars:
        return [("none", {})]
    los = [_bounds(s, "lo") for s in rec.scalars]
    his = [_bounds(s, "hi") for s in rec.scalars]
    names = [s.name for s in rec.scalars]
    out = [("lo", dict(zip(names, (lo.copy() for lo in los)))),
           ("hi", dict(zip(names, (hi.copy() for hi in his))))]
    rng = np.random.default_rng(seed)
    for i in range(samples):
        out.append((f"rand{i}", {
            n: lo + (rng.random(lo.shape) * (hi - lo + 1)).astype(np.int64)
            .clip(0, np.maximum(hi - lo, 0))
            for n, lo, hi in zip(names, los, his)}))
    return out


def _spec(rec: LaunchRecord) -> List[Violation]:
    out = []
    for s in rec.scalars:
        lo, hi = _bounds(s, "lo"), _bounds(s, "hi")
        if (lo > hi).any() or (lo < 0).any():
            out.append(Violation(rec.family, s.name, "bad-spec",
                                 f"declared domain lo={s.lo} hi={s.hi} is "
                                 f"empty or negative"))
    want = launch_grid(rec.family, rec.meta)
    if rec.grid and tuple(rec.grid) != want:
        out.append(Violation(rec.family, "grid", "bad-spec",
                             f"grid {list(rec.grid)} is not the "
                             f"{list(want)} its launcher builds for tile "
                             f"{rec.meta.get('tile')}"))
    got = rec.meta.get("smem_set")
    if got is not None and tuple(got) != tuple(rec.smem):
        out.append(Violation(rec.family, "smem", "bad-spec",
                             f"the launcher set {list(got)} bytes of "
                             f"shared memory, the plan mirrors give "
                             f"{list(rec.smem)}"))
    return out


def _check_sample(rec: LaunchRecord, acc: List[Access], sample: str,
                  reported: set) -> List[Violation]:
    ops = {op.name: op for op in rec.inputs + rec.outputs}
    aliased = {rec.outputs[o].name for _, o in rec.aliases}
    kind = "scalar-oob" if rec.scalars and sample != "lo" else "oob"
    out: List[Violation] = []
    for name, rw, kernel, cta, lo, hi in acc:
        if name not in ops or name in reported:
            continue
        n = _rows(ops[name])
        if lo < 0 or hi > n:
            reported.add(name)
            out.append(Violation(
                rec.family, name, kind,
                f"rows [{lo}, {hi}) of kernel {kernel}'s CTA {cta} escape "
                f"its {n} rows (shape {tuple(ops[name].shape)}) "
                f"[scalar sample: {sample}]"))
    if out:
        return out
    for op in rec.outputs:
        if op.name in aliased or op.name in reported:
            continue
        n = _rows(op)
        count = np.zeros(n, np.int64)
        first = np.full(n, -1, np.int64)
        last = np.full(n, -1, np.int64)
        for name, rw, kernel, cta, lo, hi in acc:
            if name != op.name or rw != "w":
                continue
            count[lo:hi] += 1
            seg = first[lo:hi]
            seg[seg < 0] = cta
            last[lo:hi] = cta
        if (count == 0).any():
            reported.add(op.name)
            out.append(Violation(
                rec.family, op.name, "coverage-gap",
                f"{int((count == 0).sum())} of {n} rows never written "
                f"(first: {int(np.argmax(count == 0))}) "
                f"[scalar sample: {sample}]"))
        bad = (count > 1) & (last - first + 1 != count)
        if bad.any():
            reported.add(op.name)
            r = int(np.argmax(bad))
            out.append(Violation(
                rec.family, op.name, "double-write",
                f"row {r} written by {int(count[r])} CTAs that are not "
                f"consecutive ({int(first[r])}..{int(last[r])}) "
                f"[scalar sample: {sample}]"))
    for i, o in rec.aliases:
        name = rec.outputs[o].name
        if name in reported:
            continue
        reads = sorted(a[2:] for a in acc if a[0] == name and a[1] == "r")
        writes = sorted(a[2:] for a in acc if a[0] == name and a[1] == "w")
        if reads != writes:
            reported.add(name)
            out.append(Violation(
                rec.family, name, "alias-mismatch",
                f"an in-place update writes other rows than it reads "
                f"[scalar sample: {sample}]"))
    return out


def check_contract(rec: LaunchRecord, *, samples: int = DEFAULT_SAMPLES,
                   seed: int = 0, footprint_fn=None) -> List[Violation]:
    """All violations of one launch record (empty: clean).
    ``footprint_fn`` replaces :func:`footprint` (the tests' mutations)."""
    fp = footprint if footprint_fn is None else footprint_fn
    violations: List[Violation] = []
    try:
        violations += _spec(rec)
    except Exception as e:  # a mirror that cannot evaluate the record
        return [Violation(rec.family, "grid", "bad-spec",
                          f"launch_grid failed: {type(e).__name__}: {e}")]
    for i, o in rec.aliases:
        a, b = rec.inputs[i], rec.outputs[o]
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            violations.append(Violation(
                rec.family, f"{a.name}~{b.name}", "alias-mismatch",
                f"aliased operand {tuple(a.shape)}/{a.dtype} vs output "
                f"{tuple(b.shape)}/{b.dtype}"))
    reported: set = set()
    for sample, tables in _samples(rec, samples, seed):
        try:
            acc = fp(rec, tables)
        except Exception as e:
            violations.append(Violation(
                rec.family, "footprint", "bad-spec",
                f"the mirror failed: {type(e).__name__}: {e} "
                f"[scalar sample: {sample}]"))
            break
        violations += _check_sample(rec, acc, sample, reported)
    return violations


def check_contracts(records, *, samples: int = DEFAULT_SAMPLES,
                    seed: int = 0) -> List[Violation]:
    out: List[Violation] = []
    for r in records:
        out.extend(check_contract(r, samples=samples, seed=seed))
    return out


def summarize(violations: List[Violation]) -> Dict[str, Any]:
    by_kind: Dict[str, int] = {}
    for v in violations:
        by_kind[v.kind] = by_kind.get(v.kind, 0) + 1
    return {"total": len(violations), "by_kind": by_kind}


__all__ = ["Violation", "launch_grid", "footprint", "check_contract",
           "check_contracts", "summarize", "DEFAULT_SAMPLES"]
