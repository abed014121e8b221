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


def update_cache(cache: H1DCache, k_new, v_new, t) -> H1DCache:
    """Batched in-place cache update.  k_new (B, D), v_new (B, Dv), t
    (B,) int32."""
    return dk.update_cache_fused(cache, k_new, v_new, t)


def decode_attend(cache: H1DCache, q, t, *, nr: int,
                  softmax_scale=None) -> torch.Tensor:
    """Batched single-token attention.  q (B, G, D), t (B,) per-row
    positions.  Returns (B, G, Dv) in q.dtype."""
    return dk.decode_attend_fused(cache, q, t, nr=nr,
                                  softmax_scale=softmax_scale)


def _broadcast_t(cache: H1DCache, t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.int32, device=cache.k.device
                           ).expand(cache.k.shape[0]).contiguous()


def update_cache_uniform(cache: H1DCache, k_new, v_new, t) -> H1DCache:
    """k_new (B, D), v_new (B, Dv), t a scalar position shared by every
    row: broadcast per row into the same kernel as :func:`update_cache`."""
    return dk.update_cache_fused(cache, k_new, v_new, _broadcast_t(cache, t))


def decode_attend_uniform(cache: H1DCache, q, t, *, nr: int,
                          softmax_scale=None) -> torch.Tensor:
    """q (B, G, D), t a scalar position shared by every row: broadcast
    per row into the same kernel as :func:`decode_attend`."""
    return dk.decode_attend_fused(cache, q, _broadcast_t(cache, t), nr=nr,
                                  softmax_scale=softmax_scale)
