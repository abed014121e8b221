"""Incremental decoding with a hierarchical KV cache.

Port of the dense-cache entry points of ``repro.core.h1d_decode``.
Alongside the fine KV cache the coarsened levels are kept (k: pairwise
mean, v: pairwise sum).  Per generated token the update touches the
token's O(log L) ancestors and the attention reads 2*nr fine keys plus nr
coarse keys per level.

Shapes: the caller folds batch*kv_heads into ``B`` (rows); ``G`` is the
GQA group.  Cache arrays: fine (B, Lmax, D); level-l coarse
(B, Lmax >> l, D).  Positions ``t``: (B,) int32, the index of the current
token, whose K/V must already be written by ``update_cache``.

``update_cache`` changes the cache in place and returns it.  Both entry
points go through the wrappers in ``kernels.h1d_decode_kernel``, which
run the plain version on CPU tensors and the CUDA kernel on CUDA tensors.

A sequence-sharded cache (``parallel.sp_attention.SPCache``, one slab per
shard this process holds: every shard, or on a rank its own) is decoded
inside ``sp_scope(mesh)``: every entry point below then
routes through ``parallel.sp_attention`` (per-shard partial kernels over
the owned blocks, merged with one pmax and one psum; ``tables`` carries
the tick's shard geometry, built once and shared by every layer).

The paged pool (``serve/paged_cache.py``) replaces each level's
(B, L_l, D) slab with a pool of nr-row pages (NP_l, nr, D) and hands the
decode entry points the physical page row of every block they touch as
a small per-tick table (:class:`PageTables`); the math is the dense
cache's with the block reads and writes routed through the tables.  A
:class:`QuantPagedH1DCache` stores any subset of levels as int8 pages
with one float32 absmax scale per cached row (``core.quantization``);
``update_cache_paged`` and ``decode_attend_paged`` dispatch on the pool
type, as the reference does.  Pool updates are in place too.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import resolve_device
from . import hierarchy as hc
from ..kernels import h1d_decode_kernel as dk

NEG_INF = hc.NEG_INF


class H1DCache(NamedTuple):
    k: torch.Tensor                 # (B, Lmax, D) fine keys
    v: torch.Tensor                 # (B, Lmax, Dv) fine values
    ck: Tuple[torch.Tensor, ...]    # level-l coarse keys, (B, Lmax>>l, D)
    cv: Tuple[torch.Tensor, ...]    # level-l coarse values (pairwise sums)


def init_cache(B: int, Lmax: int, D: int, Dv: int, nr: int, *,
               dtype=torch.float32, device=None) -> H1DCache:
    """Zeroed cache on ``device`` (default ``cuda``)."""
    M = hc.num_levels(Lmax, nr)
    dev = resolve_device(device)

    def z(L, d):
        return torch.zeros((B, L, d), dtype=dtype, device=dev)

    return H1DCache(k=z(Lmax, D), v=z(Lmax, Dv),
                    ck=tuple(z(Lmax >> l, D) for l in range(1, M)),
                    cv=tuple(z(Lmax >> l, Dv) for l in range(1, M)))


def prefill_cache(k, v, Lmax: int, nr: int) -> H1DCache:
    """Build a cache from a full prefix (B, Lp, D); pads to Lmax."""
    B, Lp, _ = k.shape
    pad = Lmax - Lp
    kf = torch.nn.functional.pad(k, (0, 0, 0, pad)).contiguous()
    vf = torch.nn.functional.pad(v, (0, 0, 0, pad)).contiguous()
    M = hc.num_levels(Lmax, nr)
    ck, cv = [], []
    kc, vc = kf, vf
    for _ in range(1, M):
        kc = hc.coarsen_mean(kc, axis=-2).contiguous()
        vc = hc.coarsen_sum(vc, axis=-2).contiguous()
        ck.append(kc)
        cv.append(vc)
    return H1DCache(k=kf, v=vf, ck=tuple(ck), cv=tuple(cv))


def _sp_decode_ctx(cache, tables):
    """The active SP mesh when ``cache`` is sequence-sharded, else None
    (a dense cache stays on the single-launch kernels).  A sharded cache
    outside a scope of its shard count, or without the tick's
    ``sp_tables``, raises."""
    from ..parallel import sp_attention as sp
    if not isinstance(cache, sp.SPCache):
        return None
    mesh = sp.sp_ctx()
    if mesh is None or len(mesh.shards) != len(cache.shards):
        raise ValueError(f"a cache of {len(cache.shards)} shards is decoded "
                         f"inside sp_scope(mesh) of as many shards (on a "
                         f"rank: its own one)")
    if tables is None:
        raise ValueError("a sharded cache is decoded with the tick's shard "
                         "geometry: pass tables=sp_tables(t, ...)")
    return mesh


def update_cache(cache: H1DCache, k_new, v_new, t, *, tables=None):
    """Batched in-place cache update.  k_new (B, D), v_new (B, Dv), t
    (B,) int32.  A sharded cache inside ``sp_scope(mesh)`` runs
    ``sp_update_cache`` with the tick's ``tables``: each token's
    ancestors are written on their owning shard only."""
    mesh = _sp_decode_ctx(cache, tables)
    if mesh is not None:
        from ..parallel.sp_attention import sp_update_cache
        return sp_update_cache(cache, k_new, v_new, t, mesh=mesh,
                               tables=tables)
    return dk.update_cache_fused(cache, k_new, v_new, t)


def decode_attend(cache: H1DCache, q, t, *, nr: int, softmax_scale=None,
                  tables=None) -> torch.Tensor:
    """Batched single-token attention.  q (B, G, D), t (B,) per-row
    positions.  Returns (B, G, Dv) in q.dtype.  A sharded cache inside
    ``sp_scope(mesh)`` runs ``sp_decode_attend`` with the tick's
    ``tables``."""
    mesh = _sp_decode_ctx(cache, tables)
    if mesh is not None:
        from ..parallel.sp_attention import sp_decode_attend
        return sp_decode_attend(cache, q, t, nr=nr,
                                softmax_scale=softmax_scale, mesh=mesh,
                                tables=tables)
    return dk.decode_attend_fused(cache, q, t, nr=nr,
                                  softmax_scale=softmax_scale)


# ---------------------------------------------------------------------------
# paged cache pool (serving-memory subsystem, serve/paged_cache.py)
# ---------------------------------------------------------------------------

class PagedH1DCache(NamedTuple):
    """Per-layer paged pools.  ``k``/``v``: (NP0, nr, D/Dv) fine pages;
    ``ck[l-1]``/``cv[l-1]``: (NP_l, nr, ...) level-l coarse pages.  A
    page is one pool row: ``nr`` consecutive level-l rows of ONE cache
    row (batch*kv-head).  The logical (slot, level, block) -> pool row
    map lives in ``serve.paged_cache.PagePool`` (host)."""
    k: torch.Tensor
    v: torch.Tensor
    ck: Tuple[torch.Tensor, ...]
    cv: Tuple[torch.Tensor, ...]


class PageTables(NamedTuple):
    """Per-tick device indirection tables, built on the host.

    ``attend``: (R, 2 + levels) int32 -- physical pool rows of the own
    level-0 page, the previous level-0 page and each level's ``I_l - 1``
    page (columns of masked-out bands hold any in-range row).
    ``update``: (R, 1 + levels) int32 -- physical pool rows of the
    token's ancestor pages (column l holds the page of row ``t >> l``);
    inactive engine rows point at a trash page."""
    attend: torch.Tensor
    update: torch.Tensor


class QuantPagedH1DCache(NamedTuple):
    """Quantized paged pools: the page geometry of
    :class:`PagedH1DCache`, but any subset of levels stores its pages as
    int8 with one float32 symmetric absmax scale PER CACHED ROW, scale
    arrays (NP_l, nr) beside the (NP_l, nr, D) data.  Scale arrays exist
    for every level (fp32 levels carry all-ones scales that are never
    read); which levels are int8 is read off the data dtypes
    (:func:`quant_level_flags`)."""
    k: torch.Tensor
    v: torch.Tensor
    ck: Tuple[torch.Tensor, ...]
    cv: Tuple[torch.Tensor, ...]
    ksc: torch.Tensor               # (NP0, nr) f32 per-row scales for k
    vsc: torch.Tensor               # (NP0, nr)
    cksc: Tuple[torch.Tensor, ...]  # (NP_l, nr) per coarse level
    cvsc: Tuple[torch.Tensor, ...]


pool_levels = dk.pool_levels


def quant_level_flags(pool: QuantPagedH1DCache) -> Tuple[bool, ...]:
    """Per-level "is int8" flags (index 0 = fine), from the dtypes."""
    return tuple(a.dtype == torch.int8 for a in (pool.k, *pool.ck))


def init_paged_pool(num_pages, nr: int, D: int, Dv: int, *,
                    dtype=torch.float32, device=None) -> PagedH1DCache:
    """Zeroed pools on ``device`` (default ``cuda``).  ``num_pages``:
    per-level pool sizes (index 0 = fine, index l = coarse level l); its
    length fixes the number of hierarchy levels."""
    dev = resolve_device(device)

    def z(n, d):
        return torch.zeros((n, nr, d), dtype=dtype, device=dev)

    return PagedH1DCache(k=z(num_pages[0], D), v=z(num_pages[0], Dv),
                         ck=tuple(z(n, D) for n in num_pages[1:]),
                         cv=tuple(z(n, Dv) for n in num_pages[1:]))


def init_quant_paged_pool(num_pages, nr: int, D: int, Dv: int, *,
                          dtype=torch.float32, quant=None,
                          device=None) -> QuantPagedH1DCache:
    """Zeroed quantized pools.  ``quant``: per-level bools (index 0 =
    fine); ``None`` quantizes every level.  Scales start at 1.0, so zero
    pages dequantize to exact zeros."""
    dev = resolve_device(device)
    if quant is None:
        quant = (True,) * len(num_pages)

    def data(n, d, is_q):
        return torch.zeros((n, nr, d), dtype=torch.int8 if is_q else dtype,
                           device=dev)

    def sc(n):
        return torch.ones((n, nr), dtype=torch.float32, device=dev)

    rest = list(enumerate(num_pages[1:], 1))
    return QuantPagedH1DCache(
        k=data(num_pages[0], D, quant[0]), v=data(num_pages[0], Dv, quant[0]),
        ck=tuple(data(n, D, quant[l]) for l, n in rest),
        cv=tuple(data(n, Dv, quant[l]) for l, n in rest),
        ksc=sc(num_pages[0]), vsc=sc(num_pages[0]),
        cksc=tuple(sc(n) for _, n in rest),
        cvsc=tuple(sc(n) for _, n in rest))


def update_cache_paged(pool, k_new, v_new, t, utab):
    """Paged batched append, in place.  ``k_new`` (R, D), ``v_new`` (R,
    Dv), ``t`` (R,) int32 global positions, ``utab`` (R, 1 + levels)
    int32 physical page rows (:class:`PageTables`).  The ancestor-chain
    math of :func:`update_cache`; a :class:`QuantPagedH1DCache` rewrites
    each level's sibling pair through quantize (fresh per-row scales)
    and carries the pre-quantization f32 pair upward."""
    if isinstance(pool, QuantPagedH1DCache):
        return dk.update_cache_paged_quant(pool, k_new, v_new, t, utab)
    return dk.update_cache_paged(pool, k_new, v_new, t, utab)


def decode_attend_paged(pool, q, t, bidx, *, nr: int,
                        softmax_scale=None) -> torch.Tensor:
    """Paged batched single-token attention.  ``q`` (R, G, D), ``t``
    (R,) int32, ``bidx`` (R, 2 + levels) int32 physical page rows.  The
    bands, masks and single-max combine of :func:`decode_attend`; a
    :class:`QuantPagedH1DCache` dequantizes each gathered row with its
    per-row scale before the band math."""
    if isinstance(pool, QuantPagedH1DCache):
        return dk.decode_attend_paged_quant(pool, q, t, bidx, nr=nr,
                                            softmax_scale=softmax_scale)
    return dk.decode_attend_paged(pool, q, t, bidx, nr=nr,
                                  softmax_scale=softmax_scale)


def _broadcast_t(rows: torch.Tensor, t) -> torch.Tensor:
    """The scalar position ``t`` once per row of ``rows``."""
    return torch.as_tensor(t, dtype=torch.int32, device=rows.device
                           ).expand(rows.shape[0]).contiguous()


def update_cache_uniform(cache: H1DCache, k_new, v_new, t, *,
                         tables=None) -> H1DCache:
    """k_new (B, D), v_new (B, Dv), t a scalar position shared by every
    row: broadcast per row into :func:`update_cache` (a sharded cache
    included)."""
    return update_cache(cache, k_new, v_new, _broadcast_t(k_new, t),
                        tables=tables)


def decode_attend_uniform(cache: H1DCache, q, t, *, nr: int,
                          softmax_scale=None, tables=None) -> torch.Tensor:
    """q (B, G, D), t a scalar position shared by every row: broadcast
    per row into :func:`decode_attend` (a sharded cache included)."""
    return decode_attend(cache, q, _broadcast_t(q, t), nr=nr,
                         softmax_scale=softmax_scale, tables=tables)
