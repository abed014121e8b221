"""Sequence-parallel (SP) execution: the hierarchical operator and the
decode tick over a sequence-sharded KV cache.

Port of ``repro.parallel.sp_attention``.  An :class:`SPMesh` takes one of
two forms, and both run the same shard bodies (band launches, halo
packs, ``_edge_term``, ``_merge_rows``, the partial attend and update):

* one process: the body runs once per shard of the mesh in a loop, every
  shard on one device, and the collectives are tensor ops over the
  shards' outputs: ``ppermute`` is taking the neighbour's tensor (zeros
  at the edge), ``all_gather`` a ``torch.cat`` in shard order, ``pmax`` a
  ``torch.stack(...).amax(0)`` and ``psum`` a sum in shard order;
* ranks: one shard a process over a ``torch.distributed`` group
  (``parallel/group.py``; ``launch.mesh.make_mesh`` inside an
  initialised group builds it).  A rank runs the body of its own shard
  only, on its own device, and the collectives are the group's:
  ``ppermute`` by ``batch_isend_irecv``, ``all_gather``, and all-reduces
  for ``pmax`` and ``psum``.  The operator takes replicated q, k, v (every
  rank holds the whole sequence, as every rank computes the layers
  around the attention), scatters them by rank and gathers the output
  for replicated use; ``group.py`` sets out the gradient of each step.
  A rank computes exactly the bits of its shard in the loop.

* Prefill: each shard runs the band kernels (``kernels.ops``) on its
  local ``L/d`` rows.  The banded structure is translation-invariant by
  multiples of the query block, so a local launch computes every
  contribution except those that cross a shard boundary; the missing
  ``nr``-row halo block per level per direction comes from the
  neighbour, all levels packed into one buffer, and is merged into the
  edge rows by a log-sum-exp epilogue with global ``band_mask`` indices.
  Levels too deep to keep an ``nr``-row block per shard are computed from
  the gathered transition-level coarse KV (<= ``d * nr / 2`` rows).
* Decode: the cache's fine level and the coarse levels that keep a whole
  ``nr``-row block per shard are sharded along the sequence
  (:class:`SPCache`, one ``H1DCache`` slab per shard this process
  holds: every shard in one process, its own on a rank); the deeper
  levels are replicated.  Each shard's partial attend kernel reads the
  bands it owns at shard-local block indices, the partial ``(num, den,
  m)`` triples merge with one pmax and one psum; a token's sharded
  ancestors all live on one shard, which alone writes them, and the
  carried row (a psum with one non-zero term, so exact) updates every
  shard's replicated deep levels with the dense update kernel.  The band
  geometry is built on the host once per tick (:func:`sp_tables`) and
  shared by every layer.

Differentiable: every shard's level runs through the autograd Functions
of ``kernels.ops.band_attention`` (the backward kernels #3 and #4 per
shard on the card), and the halo packs, edge terms, row merges,
gathered deep levels and the ranks' collectives are out-of-place tensor
ops or autograd Functions, so ``autograd`` carries the gradient of q, k,
v and ``kv_weight`` back through the exchange (SP training,
``train.loop.train(..., mesh=)``).

Entry points: ``sp_band_attention`` (one banded level, every mode),
``sp_h1d_attention`` (the whole operator), ``sp_decode_attend`` /
``sp_update_cache`` (the decode tick), ``shard_cache`` /
``unshard_cache`` / ``scatter_rows`` (one hierarchical cache's layout),
``shard_caches`` / ``unshard_caches`` (a model's mixed cache list: only
the hierarchical caches shard), ``sp_scope`` /
``sp_ctx`` (the callers in ``core/`` and ``kernels/ops.py`` route through
this module inside ``sp_scope(mesh)``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import hierarchy as hc
from ..core.h1d_decode import H1DCache
from ..kernels import h1d_block
from ..kernels import h1d_decode_kernel as dk
from . import group as grp

NEG_INF = hc.NEG_INF
_MIN_M = -1e30

#: SP dispatches per operation (``band_attention``, ``h1d_attention``,
#: ``decode_attend``, ``update_cache``); clear it with
#: ``DISPATCHES.clear()``
DISPATCHES: Dict[str, int] = {}


def _note_dispatch(op: str, shards: int) -> None:
    """One SP dispatch of ``op`` over ``shards`` shards: counted here and,
    with telemetry on, as the reference's ``sp.dispatches{op, shards}``
    (the port counts every call, the reference every traced shape)."""
    DISPATCHES[op] = DISPATCHES.get(op, 0) + 1
    obs.counter("sp.dispatches", op=op, shards=shards).inc()


@dataclasses.dataclass(frozen=True)
class SPMesh:
    """A one-axis mesh of ``d`` shards (``launch.mesh.make_mesh`` builds
    it), in one of two forms:

    * one process (``group`` None): one device per shard, ``d =
      len(devices)``, every shard on the same device; this process runs
      every shard.  Shards on distinct devices in one process raise: they
      take the rank form;
    * ranks (``group``, a ``parallel.group.RankGroup``): one shard a
      process, ``d`` the group's world size; ``devices`` holds this
      rank's device alone and this process runs shard ``group.rank``."""
    axis: str
    devices: Tuple[torch.device, ...]
    group: Optional[grp.RankGroup] = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("an SPMesh needs at least one shard")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                "shards on distinct devices run one shard a process: "
                "join a process group (parallel.group, torchrun) and "
                "build the mesh with launch.mesh.make_mesh; every shard "
                f"of a one-process mesh sits on one device, got "
                f"{self.devices}")
        if self.group is not None and (
                len(self.devices) != 1
                or self.devices[0] != self.group.device):
            raise ValueError(f"a rank's mesh holds its own device "
                             f"{self.group.device}, got {self.devices}")

    @property
    def d(self) -> int:
        """The number of shards."""
        return self.group.world if self.group is not None else len(
            self.devices)

    @property
    def shards(self) -> range:
        """The shards this process computes: all of them, or its rank's."""
        if self.group is not None:
            return range(self.group.rank, self.group.rank + 1)
        return range(len(self.devices))

    @property
    def device(self) -> torch.device:
        """The device this process's shards sit on."""
        return self.devices[0]


# ---------------------------------------------------------------------------
# SP context
# ---------------------------------------------------------------------------

_state = threading.local()


@contextmanager
def sp_scope(mesh: Optional[SPMesh]):
    """Enable SP dispatch: ``h1d_attention`` / ``band_attention`` / the
    decode entry points check :func:`sp_ctx` and route through this
    module when a mesh of more than one shard is active.  A ``None``
    mesh (or a 1-way one) is a no-op, so callers can wrap
    unconditionally."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = mesh if mesh is not None and mesh.d > 1 else None
    try:
        yield
    finally:
        _state.ctx = prev


def sp_ctx() -> Optional[SPMesh]:
    """The active SP mesh, or None."""
    return getattr(_state, "ctx", None)


@contextmanager
def _local_region():
    """Suppress SP re-dispatch around a shard's own kernel calls: they
    already see shard-local tensors."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = None
    try:
        yield
    finally:
        _state.ctx = prev


# ---------------------------------------------------------------------------
# collectives over the shards' outputs, halo pack and edge correction
# ---------------------------------------------------------------------------

# the collectives of the two mesh forms: lists over the shards this
# process computes (``mesh.shards``), every shard or its rank's alone

def _split(x, mesh: SPMesh, dim: int) -> List[torch.Tensor]:
    """The shards of a replicated ``x`` along ``dim``, each contiguous."""
    if mesh.group is not None:
        return [grp.scatter(x, mesh.group, dim)]
    return [c.contiguous() for c in torch.chunk(x, mesh.d, dim)]


def _ppermute_right(xs, mesh: SPMesh):
    """Shard s receives shard s-1's tensor; shard 0 receives zeros, which
    the global masks and w > 0 kill anyway."""
    if mesh.group is not None:
        return [grp.ppermute_right(xs[0], mesh.group)]
    return [torch.zeros_like(xs[0])] + list(xs[:-1])


def _ppermute_left(xs, mesh: SPMesh):
    if mesh.group is not None:
        return [grp.ppermute_left(xs[0], mesh.group)]
    return list(xs[1:]) + [torch.zeros_like(xs[-1])]


def _psum(xs, mesh: SPMesh):
    if mesh.group is not None:
        return grp.psum(xs[0], mesh.group)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _pmax(xs, mesh: SPMesh):
    if mesh.group is not None:
        return grp.pmax(xs[0], mesh.group)
    return torch.stack(xs).amax(0)


def _gather(xs, mesh: SPMesh, dim: int, grad: str):
    """Every shard's tensor concatenated along ``dim`` in shard order.
    ``grad`` (``group.all_gather``): ``"slice"`` where every shard uses
    the result alike (the output), ``"sum"`` where each uses it for its
    own rows (the deep levels' coarse KV)."""
    if mesh.group is not None:
        return grp.all_gather(xs[0], mesh.group, dim, grad)
    return torch.cat(xs, dim)


def _pack_kvw(k, v, w):
    """(B, R, Dk) + (B, R, Dv) + (B, R) -> one (B, R, Dk+Dv+1) buffer, so
    the whole exchange is ONE neighbour copy per direction."""
    return torch.cat([k, v, w[..., None]], dim=-1)


def _unpack_kvw(buf, dk: int, dv: int):
    return buf[..., :dk], buf[..., dk:dk + dv], buf[..., dk + dv]


def sp_n_shallow(M: int, Lloc: int, nr: int) -> int:
    """Number of hierarchy levels (fine level 0 included) the prefill
    runs LOCALLY per shard: level ``l`` keeps at least one whole
    ``nr``-row coarse block per shard iff ``Lloc >> l >= nr``.  Levels
    at or above the returned count go through the gathered deep path."""
    return min(M, int(math.log2(Lloc // nr)) + 1)


def sp_halo_pack(kc_l, vc_l, wc_l, n_shallow: int, nr: int, side: str):
    """Pack the shard-boundary ``nr``-row block of every shallow level
    into ONE ``(B, n_shallow * nr, Dk + Dv + 1)`` buffer.  ``side='prev'``
    takes each level's LAST block (sent rightward), ``side='next'`` the
    FIRST (sent leftward)."""
    sl = slice(-nr, None) if side == "prev" else slice(None, nr)
    return torch.cat([_pack_kvw(kc_l[l][:, sl], vc_l[l][:, sl],
                                wc_l[l][:, sl]) for l in range(n_shallow)],
                     dim=1)


def _edge_term(qe, ke, ve, we, mask):
    """Partial banded softmax of an edge query slab against one halo key
    block.  qe: (B, G, nq, D); ke/ve: (B, nk, *); we: (B, nk); mask:
    broadcastable (.., nq, nk) allowed-mask.  Returns float32 (y, dn, m)
    like one band kernel launch."""
    f32 = torch.float32
    we = we.to(f32)[:, None, :, None]                 # (B, 1, nk, 1)
    s = qe.to(f32) @ ke.to(f32).transpose(-1, -2)[:, None]
    s = torch.where(mask & (we > 0).transpose(-1, -2), s, NEG_INF)
    m = torch.clamp(s.amax(-1), min=_MIN_M)
    a = torch.exp(s - m[..., None])
    return a @ ve.to(f32)[:, None], (a @ we)[..., 0], m


def _merge_rows(acc, corr, start: int):
    """LSE-merge a correction triple into rows [start, start+n) of a
    (y, dn, m) accumulator (the cross-shard epilogue of
    ``_stream_combine``).  Out of place: the merged rows are concatenated
    with the untouched ones, so every tensor autograd saved stays
    intact."""
    y, dn, m = acc
    yl, dl, ml = corr
    n = yl.shape[-2]
    sl = slice(start, start + n)
    m0 = m[..., sl]
    mn = torch.maximum(m0, ml)
    e0 = torch.exp(m0 - mn)
    el = torch.exp(ml - mn)

    def put(a, rows, dim):
        return torch.cat([a.narrow(dim, 0, start), rows,
                          a.narrow(dim, start + n, a.shape[dim] - start - n)],
                         dim)
    return (put(y, y[..., sl, :] * e0[..., None] + yl * el[..., None], -2),
            put(dn, dn[..., sl] * e0 + dl * el, -1), put(m, mn, -1))


@functools.lru_cache(maxsize=1024)
def _halo_mask(mode, nr, ratio, lkg, q0, k0, nq_rows, nk_rows, device):
    """Allowed-mask (1, 1, nq_rows, nk_rows) of query rows from ``q0`` and
    key rows from ``k0``, GLOBAL indices (an edge correction, or a deep
    level's whole key range).  Kept per shape and offset: every layer
    and every prefill of a length bucket asks for the same masks."""
    qi = q0 + torch.arange(nq_rows, device=device)[:, None]
    ki = k0 + torch.arange(nk_rows, device=device)[None, :]
    return h1d_block.band_mask(qi, ki, nr, mode, lkg, ratio)[None, None]


# ---------------------------------------------------------------------------
# single banded level under SP
# ---------------------------------------------------------------------------

def sp_shardable(L: int, d: int, nr: int, mode: Optional[str] = None,
                 ratio: int = 1) -> bool:
    """True when a length-``L`` sequence keeps at least one whole query
    block per shard on ``d`` shards: ``L/d`` a positive multiple of the
    block, ``nr * ratio`` rows in mode ``'sub'`` and ``nr`` otherwise
    (the whole operator, every other band mode, and the decode cache's
    fine level).  Shapes that fail it stay on the single-launch kernels
    (a cache raises)."""
    blk = nr * ratio if mode == h1d_block.SUB_MODE else nr
    return L % d == 0 and L // d >= blk and (L // d) % blk == 0


def _validate_sp_shape(L, d, nr, what):
    if not sp_shardable(L, d, nr):
        raise ValueError(
            f"{what}: L={L} over {d} shards must leave each a positive "
            f"multiple of nr={nr} rows; use fewer shards for this sequence")
    return L // d


def sp_band_attention(q, k, v, w, *, nr: int, mode: str, ratio: int = 1,
                      mesh: SPMesh):
    """One banded level under sequence parallelism: the contract of
    ``kernels.ops.band_attention`` (float32 ``(y, dn, m)`` at query
    resolution) with the query and key sequence axes split over the
    ``mesh.d`` shards: each shard runs the kernel on its rows, and the
    boundary blocks are fixed up from the neighbours' halo blocks.

    ``mode='sub'`` requires the local query slab to hold at least one
    whole ``nr * ratio``-row query block (deeper levels are the gathered
    path of :func:`sp_h1d_attention`)."""
    from ..kernels.ops import band_attention

    d = mesh.d
    _note_dispatch("band_attention", d)
    B, G, Lq, dk = q.shape
    dv = v.shape[-1]
    Lk = k.shape[1]
    sub = mode == h1d_block.SUB_MODE
    causal = mode.endswith("causal") or sub
    lloc = _validate_sp_shape(Lq, d, nr, "sp_band_attention")
    if sub:
        nq = nr * ratio
        if nq > lloc:
            raise ValueError(
                f"sp_band_attention(mode='sub'): query block nq={nq} "
                f"exceeds the local slab L/d={lloc}; deep levels go "
                f"through sp_h1d_attention's gathered path")
    else:
        nq = nr
    kloc = Lk // d
    qs, ks, vs, ws = (_split(q, mesh, 2), _split(k, mesh, 1),
                      _split(v, mesh, 1), _split(w, mesh, 1))
    # one packed halo buffer per direction
    prev = _ppermute_right([_pack_kvw(a[:, -nr:], b[:, -nr:], c[:, -nr:])
                            for a, b, c in zip(ks, vs, ws)], mesh)
    if not causal:
        nxt = _ppermute_left([_pack_kvw(a[:, :nr], b[:, :nr], c[:, :nr])
                              for a, b, c in zip(ks, vs, ws)], mesh)
    outs = []
    for i, s in enumerate(mesh.shards):
        qloc = qs[i]
        with _local_region():
            acc = band_attention(qloc, ks[i], vs[i], ws[i], nr=nr, mode=mode,
                                 ratio=ratio)
        # left boundary: the first query block attends the left
        # neighbour's last key block (masked out by the local call)
        kh, vh, wh = _unpack_kvw(prev[i], dk, dv)
        q0 = s * lloc if sub else s * kloc
        acc = _merge_rows(acc, _edge_term(
            qloc[:, :, :nq], kh, vh, wh,
            _halo_mask(mode, nr, ratio, Lk, q0, s * kloc - nr, nq, nr,
                       q.device)), 0)
        if not causal:
            kn, vn, wn = _unpack_kvw(nxt[i], dk, dv)
            acc = _merge_rows(acc, _edge_term(
                qloc[:, :, -nr:], kn, vn, wn,
                _halo_mask(mode, nr, ratio, Lk, s * kloc + kloc - nr,
                           (s + 1) * kloc, nr, nr, q.device)), lloc - nr)
        outs.append(acc)
    return tuple(_gather(list(parts), mesh, 2, "slice")
                 for parts in zip(*outs))


# ---------------------------------------------------------------------------
# full hierarchical operator under SP
# ---------------------------------------------------------------------------

def sp_h1d_attention(q, k, v, *, mesh: SPMesh, nr: int = 16, causal: bool = False,
                     causal_mode: str = "fine-q", kv_weight=None,
                     softmax_scale: Optional[float] = None):
    """``core.h1d_attention`` semantics with the L axis split over the
    ``mesh.d`` shards.  Every level that keeps an ``nr``-row block per shard
    runs the band kernel locally (+ halo epilogue); deeper levels are
    computed from the gathered transition-level coarse KV (<= ``d*nr/2``
    rows).  Each shard's fine rows are normalised on their own; the
    shards' outputs are concatenated."""
    from ..core.h1d_attention import _stream_combine
    from ..kernels.ops import band_attention

    d = mesh.d
    B, G, L, D = q.shape
    Dk, Dv = k.shape[-1], v.shape[-1]
    _note_dispatch("h1d_attention", d)
    Lloc = _validate_sp_shape(L, d, nr, "sp_h1d_attention")
    M = hc.num_levels(L, nr)
    fine_q = causal and causal_mode == "fine-q"
    # levels 0..n_shallow-1 keep >= one nr-row coarse block per shard
    n_shallow = sp_n_shallow(M, Lloc, nr)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    l0_mode = "l0_causal" if causal else "l0_bidir"
    coarse_mode = "coarse_causal" if causal else "coarse_bidir"
    f32 = torch.float32
    dev = q.device
    w_in = (torch.ones((B, L), dtype=f32, device=dev) if kv_weight is None
            else kv_weight.to(f32).expand(B, L))

    # ---- per shard: local coarse pyramid (pairwise ops never cross
    # shards); levels 1..n_shallow-1 run the kernel, the extra level
    # n_shallow (if any) only seeds the deep-level gather
    n_pyr = min(M - 1, n_shallow)
    shards = []
    for qs, ks, vs, ws in zip(_split(q, mesh, 2), _split(k, mesh, 1),
                              _split(v, mesh, 1), _split(w_in, mesh, 1)):
        qs = qs.to(f32) * scale
        ks = ks.to(f32)
        vs = vs.to(f32) * ws[..., None]
        kc_l, vc_l, wc_l = [ks], [vs], [ws]
        qc_l, wq_l = [qs], [ws]
        for _ in range(n_pyr):
            kcl, _ = hc.coarsen_weighted_mean(kc_l[-1], wc_l[-1])
            kc_l.append(kcl)
            vc_l.append(hc.coarsen_sum(vc_l[-1], axis=-2))
            wc_l.append(hc.coarsen_sum(wc_l[-1], axis=-1))
            if not fine_q:
                qcl, _ = hc.coarsen_weighted_mean(qc_l[-1], wq_l[-1])
                qc_l.append(qcl)
                wq_l.append(hc.coarsen_sum(wq_l[-1], axis=-1))
        shards.append((kc_l, vc_l, wc_l, qc_l, wq_l))

    # ---- one packed halo exchange per direction ----------------------
    prev_halo = _ppermute_right([sp_halo_pack(*sh[:3], n_shallow, nr,
                                              "prev") for sh in shards], mesh)
    if not causal:
        next_halo = _ppermute_left([sp_halo_pack(*sh[:3], n_shallow, nr,
                                                 "next") for sh in shards],
                                   mesh)

    def halo(buf, l):
        return _unpack_kvw(buf[:, l * nr:(l + 1) * nr], Dk, Dv)

    # ---- deep levels: the gathered tiny coarse KV, the same on every
    # shard (fine-q keeps the chain, coarse-q its whole (y, dn, m))
    deep = []
    if n_shallow < M:
        lt = n_shallow
        kg, vg, wg = (_gather([sh[i][lt] for sh in shards], mesh, 1, "sum")
                      for i in range(3))
        if not fine_q:
            qg = _gather([sh[3][lt] for sh in shards], mesh, 2, "sum")
            wqg = _gather([sh[4][lt] for sh in shards], mesh, 1, "sum")
        for l in range(lt, M):
            lkg = L >> l
            if fine_q:
                deep.append((l, (kg, vg, wg)))
            else:
                mask = _halo_mask(coarse_mode, nr, 1, lkg, 0, 0, lkg, lkg,
                                  dev)
                deep.append((l, _edge_term(qg, kg, vg, wg, mask)))
            if l + 1 < M:
                kg, _ = hc.coarsen_weighted_mean(kg, wg)
                vg = hc.coarsen_sum(vg, axis=-2)
                wg = hc.coarsen_sum(wg, axis=-1)
                if not fine_q:
                    qg, _ = hc.coarsen_weighted_mean(qg, wqg)
                    wqg = hc.coarsen_sum(wqg, axis=-1)

    outs = []
    for i, (s, (kc_l, vc_l, wc_l, qc_l, _)) in enumerate(zip(mesh.shards,
                                                             shards)):
        qs = qc_l[0]
        # ---- level 0 seeds the streaming accumulator -----------------
        with _local_region():
            acc = band_attention(qs, kc_l[0], vc_l[0], wc_l[0], nr=nr,
                                 mode=l0_mode)
        kh, vh, wh = halo(prev_halo[i], 0)
        acc = _merge_rows(acc, _edge_term(
            qs[:, :, :nr], kh, vh, wh,
            _halo_mask(l0_mode, nr, 1, L, s * Lloc, s * Lloc - nr, nr, nr,
                       dev)), 0)
        if not causal:
            kh, vh, wh = halo(next_halo[i], 0)
            acc = _merge_rows(acc, _edge_term(
                qs[:, :, -nr:], kh, vh, wh,
                _halo_mask(l0_mode, nr, 1, L, (s + 1) * Lloc - nr,
                           (s + 1) * Lloc, nr, nr, dev)), Lloc - nr)

        # ---- shallow coarse levels: local kernel + halo epilogue -----
        for l in range(1, n_shallow):
            kc, vc, wc = kc_l[l], vc_l[l], wc_l[l]
            cl = Lloc >> l                     # local coarse length
            lkg = L >> l                       # global coarse length
            kh, vh, wh = halo(prev_halo[i], l)
            if fine_q:
                ratio = 1 << l
                with _local_region():
                    yl, dl, ml = band_attention(qs, kc, vc, wc, nr=nr,
                                                mode="sub", ratio=ratio)
                nq = nr * ratio
                corr = _edge_term(
                    qs[:, :, :nq], kh, vh, wh,
                    _halo_mask("sub", nr, ratio, lkg, s * Lloc, s * cl - nr,
                               nq, nr, dev))
                yl, dl, ml = _merge_rows((yl, dl, ml), corr, 0)
            else:
                qc = qc_l[l]
                with _local_region():
                    yl, dl, ml = band_attention(qc, kc, vc, wc, nr=nr,
                                                mode=coarse_mode)
                corr = _edge_term(
                    qc[:, :, :nr], kh, vh, wh,
                    _halo_mask(coarse_mode, nr, 1, lkg, s * cl, s * cl - nr,
                               nr, nr, dev))
                yl, dl, ml = _merge_rows((yl, dl, ml), corr, 0)
                if not causal:
                    kh, vh, wh = halo(next_halo[i], l)
                    corr = _edge_term(
                        qc[:, :, -nr:], kh, vh, wh,
                        _halo_mask(coarse_mode, nr, 1, lkg, (s + 1) * cl - nr,
                                   (s + 1) * cl, nr, nr, dev))
                    yl, dl, ml = _merge_rows((yl, dl, ml), corr, cl - nr)
                rep = 1 << l
                yl = hc.interp_repeat(yl, rep, axis=-2)
                dl = hc.interp_repeat(dl, rep, axis=-1)
                ml = hc.interp_repeat(ml, rep, axis=-1)
            acc = _stream_combine(acc, yl, dl, ml)

        # ---- deep levels ---------------------------------------------
        for l, item in deep:
            lkg = L >> l
            if fine_q:
                kg, vg, wg = item
                mask = _halo_mask("sub", nr, 1 << l, lkg, s * Lloc, 0, Lloc,
                                  lkg, dev)
                yl, dl, ml = _edge_term(qs, kg, vg, wg, mask)
            else:
                yc, dc, mc = item
                cidx = (s * Lloc + torch.arange(Lloc, device=dev)) >> l
                yl = yc.index_select(-2, cidx)
                dl = dc.index_select(-1, cidx)
                ml = mc.index_select(-1, cidx)
            acc = _stream_combine(acc, yl, dl, ml)

        y, dn, _ = acc
        outs.append(y / torch.clamp(dn, min=1e-9)[..., None])
    return _gather(outs, mesh, 2, "slice").to(v.dtype)


# ---------------------------------------------------------------------------
# sequence-sharded decode cache
# ---------------------------------------------------------------------------

class SPCache(NamedTuple):
    """A decode cache split along its sequence axis: one ``H1DCache``
    slab per shard this process holds (``mesh.shards``: every shard in
    shard order in one process, its own on a rank).  Levels ``l <
    sp_sharded_levels`` (the fine level first) keep their ``1/d`` rows of
    the sequence in each slab; deeper levels are replicated, one copy per
    shard."""
    shards: Tuple[H1DCache, ...]


def sp_sharded_levels(Lmax: int, nr: int, d: int) -> int:
    """Number of cache levels (fine level 0 included) whose sequence axis
    shards over a ``d``-way data axis: level ``l`` keeps a whole
    ``nr``-row block per shard iff ``Lmax >> l >= d * nr``.  Deeper
    levels replicate (they are tiny)."""
    n = 0
    while (Lmax >> n) >= d * nr and (Lmax >> n) % (d * nr) == 0:
        n += 1
    return n


def _shardable_levels(Lmax: int, nr: int, d: int) -> int:
    nsh = sp_sharded_levels(Lmax, nr, d)
    if nsh < 1:     # not sp_shardable(Lmax, d, nr)
        raise ValueError(
            f"SP decode: Lmax={Lmax} < data_axis*nr = {d * nr}; the fine "
            f"level cannot keep an nr-row block per shard -- use fewer "
            f"shards")
    return nsh


def _sp_layout(cache: SPCache, mesh: Optional[SPMesh] = None):
    """(d, Lmax, nr, nsh) of a sharded cache of ``mesh`` (None: one
    process holding every shard): a cache of ``nlev`` levels has Lmax =
    nr << nlev (``init_cache`` builds num_levels(Lmax, nr) levels, fine
    included)."""
    d = len(cache.shards) if mesh is None else mesh.d
    Lmax = cache.shards[0].k.shape[-2] * d
    nr = Lmax >> (1 + len(cache.shards[0].ck))
    return d, Lmax, nr, _shardable_levels(Lmax, nr, d)


def _levels(cache: H1DCache):
    return list(zip((cache.k, *cache.ck), (cache.v, *cache.cv)))


def _part(a, l: int, s: int, d: int, nsh: int):
    """Shard ``s``'s rows of level-``l`` array ``a`` (all of a replicated
    level)."""
    if l >= nsh:
        return a
    n = a.shape[1] // d
    return a[:, s * n:(s + 1) * n]


def _copy(a, device):
    out = torch.empty(a.shape, dtype=a.dtype, device=device)
    return out.copy_(a)


def _cache_of(levels) -> H1DCache:
    ks, vs = zip(*levels)
    return H1DCache(k=ks[0], v=vs[0], ck=tuple(ks[1:]), cv=tuple(vs[1:]))


def _need(cache, kind, what: str) -> None:
    if not isinstance(cache, kind):
        raise TypeError(f"{what} takes a {kind.__name__}, got "
                        f"{type(cache).__name__}")


def shard_cache(cache: H1DCache, mesh: SPMesh, nr: int) -> SPCache:
    """Copy a dense cache into the slabs of the shards this process holds
    (``mesh.shards``, on ``mesh.device``).  Raises ``ValueError`` when
    the fine level cannot keep an ``nr``-row block per shard,
    ``TypeError`` for any other cache than an ``H1DCache``."""
    _need(cache, H1DCache, "shard_cache")
    d = mesh.d
    nsh = _shardable_levels(cache.k.shape[-2], nr, d)
    return SPCache(shards=tuple(
        _cache_of([(_copy(_part(k, l, s, d, nsh), mesh.device),
                    _copy(_part(v, l, s, d, nsh), mesh.device))
                   for l, (k, v) in enumerate(_levels(cache))])
        for s in mesh.shards))


def unshard_cache(cache: SPCache, mesh: Optional[SPMesh] = None) -> H1DCache:
    """The dense cache of a sharded one: sharded levels concatenated in
    shard order, replicated levels from the first slab.  On a rank mesh
    the sharded levels are all-gathered, so every rank gets the whole
    cache; ``mesh`` None is one process holding every shard."""
    _need(cache, SPCache, "unshard_cache")
    d, _, _, nsh = _sp_layout(cache, mesh)
    if mesh is None:
        mesh = SPMesh("data", (cache.shards[0].k.device,) * d)
    per_shard = [_levels(sh) for sh in cache.shards]
    return _cache_of([
        tuple(_gather([lv[l][i] for lv in per_shard], mesh, 1, "slice")
              if l < nsh else per_shard[0][l][i] for i in range(2))
        for l in range(len(per_shard[0]))])


def scatter_rows(cache: SPCache, dense: H1DCache, rows,
                 mesh: SPMesh) -> None:
    """Write the first ``len(rows)`` rows of the dense cache ``dense``
    into rows ``rows`` of every slab this process holds (``mesh.shards``;
    admission of a prefilled group: one slice per shard and level)."""
    _need(cache, SPCache, "scatter_rows")
    _need(dense, H1DCache, "scatter_rows")
    d, _, _, nsh = _sp_layout(cache, mesh)
    n = rows.numel()
    src = _levels(dense)
    for s, sh in zip(mesh.shards, cache.shards):
        for l, (dst, one) in enumerate(zip(_levels(sh), src)):
            for a, b in zip(dst, one):
                a.index_copy_(0, rows, _part(b[:n], l, s, d, nsh))


def shard_caches(caches, mesh: SPMesh, nr: int) -> list:
    """A model's per-layer cache list with every hierarchical cache
    sharded (:func:`shard_cache`) and every other cache -- a full or
    local layer's ``{"k", "v", "pos"}`` dict, an SSM layer's state --
    kept whole, as the reference keeps it on every shard."""
    return [shard_cache(c, mesh, nr) if isinstance(c, H1DCache) else c
            for c in caches]


def unshard_caches(caches) -> list:
    """The inverse of :func:`shard_caches`: every ``SPCache`` of the list
    unsharded (:func:`unshard_cache`), every other cache passed
    through."""
    return [unshard_cache(c) if isinstance(c, SPCache) else c
            for c in caches]


# ---------------------------------------------------------------------------
# per-tick shard geometry, built on the host
# ---------------------------------------------------------------------------

def sp_update_owner(t, Lloc: int, d: int):
    """Owning shard of a decode-update row at global position ``t``.
    Out-of-range ``t`` is owned by the LAST shard, whose kernel then
    clamps the pair index exactly like the single-device launch --
    without the clip no shard owns the row and the masked-sum carry would
    write ZEROS into the deep levels."""
    return np.clip(t // Lloc, 0, d - 1)


def sp_update_local_t(t, s, Lloc: int):
    """Shard-local position handed to ``update_cache_partial``.  Keeps
    the raw low bits (no upper clip): the kernel min()-clamps the pair
    index, and the sibling parity ``(t >> l) & 1`` must match the
    unclamped single-device value."""
    return np.maximum(t - s * Lloc, 0)


def _band_geometry(t, s, nr, Lmax, d, nsh, nlevels):
    """Per-row (local block index, owned) for every decode band.

    t: (R,) global positions; s: the shard index, or an array of them
    that broadcasts against ``t`` (``arange(d)[:, None]`` gives every
    shard at once).  Band 0/1 are the own/prev fine blocks; band ``l+1``
    is coarse level ``l``'s single ``I_l - 1`` block.  Sharded levels
    translate the global block index to shard-local coordinates and set
    ``owned`` on the owning shard only; replicated levels are owned by
    shard 0 (any single shard -- the merge is a sum)."""
    idx, own = [], []
    for band in range(2 + nlevels):
        if band == 0:
            l, gb = 0, t // nr
        elif band == 1:
            l, gb = 0, np.maximum(t // nr - 1, 0)
        else:
            l = band - 1
            gb = t // (nr << l) - 1
        nbl = (Lmax >> l) // nr
        gb = np.clip(gb, 0, nbl - 1)
        if l < nsh:
            nbl_loc = nbl // d
            owner = gb // nbl_loc
            idx.append(np.clip(gb - s * nbl_loc, 0, nbl_loc - 1))
            own.append(owner == s)
        else:
            idx.append(gb)
            own.append((s == 0) & np.ones_like(gb, bool))
    return (np.stack(np.broadcast_arrays(*idx), axis=-1).astype(np.int32),
            np.stack(np.broadcast_arrays(*own), axis=-1).astype(np.int32))


class SPTables(NamedTuple):
    """One tick's shard geometry on the device, shared by every layer
    (all layers decode the same positions).  Indexed by shard first."""
    bidx: torch.Tensor       # (d, R, nbands) local block index per band
    owned: torch.Tensor      # (d, R, nbands) band ownership bits
    t_loc: torch.Tensor      # (d, R) shard-local update positions
    upd_owned: torch.Tensor  # (d, R) update ownership bits
    t_deep: torch.Tensor     # (R,) position on the first replicated level


def sp_tables(t, *, nr: int, Lmax: int, d: int, device) -> SPTables:
    """The shard geometry of rows at global positions ``t`` (R,) (numpy,
    or a tensor, read back to the host), computed on the host for every
    shard at once and copied to ``device`` in ONE transfer through a
    pinned staging buffer (``non_blocking``; PyTorch's pinned allocator
    keeps the buffer alive until the copy has run)."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    t = np.asarray(t, np.int64)
    nsh = _shardable_levels(Lmax, nr, d)
    Lloc = Lmax // d
    shard = np.arange(d)[:, None]
    bidx, owned = _band_geometry(t, shard, nr, Lmax, d, nsh,
                                 hc.num_levels(Lmax, nr) - 1)
    parts = [bidx, owned, sp_update_local_t(t, shard, Lloc),
             sp_update_owner(t, Lloc, d) == shard, t >> nsh]
    parts = [np.ascontiguousarray(p, np.int32) for p in parts]
    buf = torch.from_numpy(np.concatenate([p.ravel() for p in parts]))
    dev = torch.device(device)
    if dev.type == "cuda":
        buf = buf.pin_memory().to(dev, non_blocking=True)
    out, at = [], 0
    for p in parts:
        out.append(buf[at:at + p.size].view(p.shape))
        at += p.size
    return SPTables(*out)


# ---------------------------------------------------------------------------
# sequence-sharded decode
# ---------------------------------------------------------------------------

def _check_shards(cache, mesh: SPMesh) -> None:
    n = len(mesh.shards)
    if not isinstance(cache, SPCache) or len(cache.shards) != n:
        raise ValueError(f"SP decode on a {mesh.d}-way mesh takes an SPCache "
                         f"of the {n} shards this process holds "
                         f"(shard_cache), got {type(cache)}")


def sp_decode_attend(cache, q, t, *, nr: int, softmax_scale=None,
                     mesh: SPMesh, tables: SPTables):
    """Decode attention over a sequence-sharded cache.  Same contract as
    ``core.h1d_decode.decode_attend``: ``q`` (R, G, D), ``t`` (R,) int32
    global positions -> (R, G, Dv).  Each shard launches the partial
    attend kernel over the bands it owns, then the partial ``(num, den,
    m)`` triples merge with one pmax and one psum.  ``tables``: this
    tick's :func:`sp_tables`."""
    _check_shards(cache, mesh)
    _note_dispatch("decode_attend", mesh.d)
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    # t stays GLOBAL inside the partial kernel: the band masks compare
    # global positions
    nums, dens, ms = zip(*(
        dk.decode_attend_partial(sh, q, t, tables.bidx[s], tables.owned[s],
                                 nr=nr, softmax_scale=scale)
        for s, sh in zip(mesh.shards, cache.shards)))
    mg = _pmax(list(ms), mesh)
    es = [torch.exp(m - mg) for m in ms]
    # num and den in one buffer: the merge is one pmax and one psum
    nd = _psum([torch.cat([n * e[..., None], (dn * e)[..., None]], -1)
                for n, dn, e in zip(nums, dens, es)], mesh)
    num, den = nd[..., :-1], nd[..., -1]
    return (num / torch.clamp(den, min=1e-9)[..., None]).to(q.dtype)


def sp_update_cache(cache, k_new, v_new, t, *, mesh: SPMesh,
                    tables: SPTables):
    """Ancestor update over a sequence-sharded cache, in place; returns
    it.  All of a token's sharded-level ancestors live on ONE shard (the
    hierarchy is a binary tree over a contiguous shard span), so the
    owning shard's partial update kernel writes them at shard-local pair
    indices while the others write nothing.  The carried row at the top
    of the sharded chain is summed over the shards masked by ownership,
    and every shard's replicated deep levels take it through the dense
    update kernel at ``t >> nsh``; ``tables``: this tick's
    :func:`sp_tables`, built from ``t``."""
    _check_shards(cache, mesh)
    _note_dispatch("update_cache", mesh.d)
    nsh = _sp_layout(cache, mesh)[3]
    nlev = 1 + len(cache.shards[0].ck)
    carries = []
    for s, sh in zip(mesh.shards, cache.shards):
        sharded = H1DCache(k=sh.k, v=sh.v, ck=sh.ck[:nsh - 1],
                           cv=sh.cv[:nsh - 1])
        _, ck, cv = dk.update_cache_partial(sharded, k_new, v_new,
                                            tables.t_loc[s],
                                            tables.upd_owned[s])
        carries.append((ck, cv, tables.upd_owned[s][:, None]))
    if nsh < nlev:
        # the owner's carried row (exact: every other term is a zero; k
        # and v in one buffer, one psum), then the replicated deep levels
        # with the dense kernel
        dkey = carries[0][0].shape[-1]
        carry = _psum([torch.cat([ck, cv], -1) * own
                       for ck, cv, own in carries], mesh)
        carry_k = carry[..., :dkey].contiguous()
        carry_v = carry[..., dkey:].contiguous()
        for sh in cache.shards:
            deep = H1DCache(k=sh.ck[nsh - 1], v=sh.cv[nsh - 1],
                            ck=sh.ck[nsh:], cv=sh.cv[nsh:])
            dk.update_cache_fused(deep, carry_k, carry_v, tables.t_deep)
    return cache
