"""H-Transformer-1D hierarchical attention.

Port of ``repro.core.h1d_attention``.  ``q``: (B, G, L, D), ``k``/``v``:
(B, L, D) with the caller folding ``batch * kv_heads`` into B and the GQA
group into G.  Modes:

* ``causal=False`` -- the paper's encoder attention (symmetric
  coarsening of Q, K, V; Eq. 25-29): level 0 runs
  ``band_attention(mode='l0_bidir')``, each level l >= 1 coarsens the
  queries too (weighted mean) and runs ``mode='coarse_bidir'``, and its
  ``(y, dn, m)`` is prolonged back to the fine rows by
  :func:`hierarchy.interp_repeat`.
* ``causal=True, causal_mode='coarse-q'`` -- the paper-style decoder with
  coarsened queries, the same with ``l0_causal`` / ``coarse_causal``.
  Coarse query rows average future tokens of their cluster, so the
  attention weights leak future information (kept as the paper-faithful
  reference; see DESIGN.md).
* ``causal=True, causal_mode='fine-q'`` (the paper LM's serving path) --
  fine queries attend coarse keys and values, exactly consistent with
  the incremental decode in ``h1d_decode``: level 0 runs ``l0_causal``,
  each level l >= 1 ``mode='sub'`` with ``ratio=2**l``.

Keys coarsen by a weighted mean, values and weights by pairwise sums.
Each level's ``(y, dn, m)`` is folded into one running accumulator by a
log-sum-exp shift (:func:`_stream_combine`).

Inside ``parallel.sp_attention.sp_scope(mesh)`` a sequence whose local
slab ``L/d`` holds a whole ``nr``-row block runs the whole hierarchy
sharded over the mesh (``sp_h1d_attention``: local kernels, halo
epilogue, gathered deep levels; differentiable, so a training step in
the scope trains sequence-parallel).  Shorter sequences stay on the
single-launch kernels.

Differentiable end to end: ``band_attention`` carries the backward
kernels, and every max and floor here is ``torch.maximum``, which splits
the gradient of a tie 0.5/0.5 like JAX's ``lax.max`` (``torch.clamp``
would give it all to the input).  The floors are ``full_like`` tensors:
a scalar tensor made from a host value would cost a synchronizing copy
to the card at every call.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import hierarchy as hc
from ..kernels.ops import band_attention

NEG_INF = hc.NEG_INF
_MIN_M = -1e30  # clamp for row-max so fully-masked rows yield zero weight


def _stream_combine(acc, yl, dl, ml):
    """Fold one level's (Y, D, m) into the running fine-resolution
    accumulator with a log-sum-exp shift."""
    y, d, m = acc
    m_new = torch.maximum(m, ml)
    e_acc = torch.exp(m - m_new)
    e_l = torch.exp(ml - m_new)
    return (y * e_acc[..., None] + yl * e_l[..., None],
            d * e_acc + dl * e_l, m_new)


def h1d_attention(q, k, v, *, nr: int = 16, causal: bool = False,
                  causal_mode: str = "fine-q",
                  kv_weight: Optional[torch.Tensor] = None,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Hierarchical attention.  Returns (B, G, L, Dv) in ``v.dtype``.
    ``causal_mode`` ('fine-q' or 'coarse-q') matters only when
    ``causal`` is true."""
    if causal_mode not in ("fine-q", "coarse-q"):
        raise ValueError(f"unknown causal_mode {causal_mode!r}")
    B, G, L, D = q.shape
    if tuple(k.shape[:2]) != (B, L) or tuple(v.shape[:2]) != (B, L):
        raise ValueError(f"k/v must be (B, L, D): {tuple(k.shape)}, "
                         f"{tuple(v.shape)} against q {tuple(q.shape)}")
    from ..parallel.sp_attention import (sp_ctx, sp_h1d_attention,
                                         sp_shardable)
    mesh = sp_ctx()
    if mesh is not None and sp_shardable(L, mesh.d, nr):
        return sp_h1d_attention(
            q, k, v, mesh=mesh, nr=nr, causal=causal,
            causal_mode=causal_mode, kv_weight=kv_weight,
            softmax_scale=softmax_scale)
    M = hc.num_levels(L, nr)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    f32 = torch.float32
    out_dtype = v.dtype

    # the kernels take contiguous operands: lay each out once here
    q = (q.to(f32) * scale).contiguous()
    k = k.to(f32).contiguous()
    w = (torch.ones((B, L), dtype=f32, device=q.device) if kv_weight is None
         else kv_weight.to(f32).expand(B, L).contiguous())
    v = (v.to(f32) * w[..., None]).contiguous()

    if M == 0:  # single block: exact dense attention
        s = torch.einsum("bgqd,bkd->bgqk", q, k)
        allow = (w > 0)[:, None, None, :]
        if causal:
            allow = allow & hc.causal_block_mask(L, device=q.device)
        s = torch.where(allow, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        m = torch.maximum(m, torch.full_like(m, _MIN_M))
        a = torch.exp(s - m)
        den = torch.einsum("bgqk,bk->bgq", a, w)
        den = torch.maximum(den, torch.full_like(den, 1e-9))
        z = torch.einsum("bgqk,bkv->bgqv", a, v) / den[..., None]
        return z.to(out_dtype)

    acc = band_attention(q, k, v, w, nr=nr,
                         mode="l0_causal" if causal else "l0_bidir")
    fine_q = causal and causal_mode == "fine-q"
    coarse_mode = "coarse_causal" if causal else "coarse_bidir"
    kc, vc, wc = k, v, w
    qc, wq = q, w
    for l in range(1, M):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        if fine_q:
            yl, dl, ml = band_attention(q, kc, vc, wc, nr=nr, mode="sub",
                                        ratio=1 << l)
        else:
            # paper-faithful: coarsen the queries too, then prolong the
            # coarse rows' (y, dn, m) back to their 2**l fine rows
            qc, _ = hc.coarsen_weighted_mean(qc, wq)
            wq = hc.coarsen_sum(wq, axis=-1)
            yl, dl, ml = band_attention(qc, kc, vc, wc, nr=nr,
                                        mode=coarse_mode)
            rep = 1 << l
            yl = hc.interp_repeat(yl, rep, axis=-2)
            dl = hc.interp_repeat(dl, rep, axis=-1)
            ml = hc.interp_repeat(ml, rep, axis=-1)
        acc = _stream_combine(acc, yl, dl, ml)

    y, d, _ = acc
    z = y / torch.maximum(d, torch.full_like(d, 1e-9))[..., None]
    return z.to(out_dtype)


def fold_kv_heads(q, k, v):
    """(B, L, Hq, D) / (B, L, Hkv, Dk) -> the core (B*Hkv, G, L, *)
    layout: kv-heads fold into the batch dim (row ``b*Hkv + h``) and the
    GQA group size into G (kv_head = h // G).  Returns
    (qh, kh, vh, (B, Hkv, G))."""
    B, L, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    qh = q.reshape(B, L, Hkv, G, D).permute(0, 2, 3, 1, 4)
    qh = qh.reshape(B * Hkv, G, L, D)
    kh = k.permute(0, 2, 1, 3).reshape(B * Hkv, L, k.shape[-1])
    vh = v.permute(0, 2, 1, 3).reshape(B * Hkv, L, v.shape[-1])
    return qh, kh, vh, (B, Hkv, G)


def unfold_kv_heads(z, fold):
    """Inverse of :func:`fold_kv_heads` for the (B*Hkv, G, L, Dv) output:
    returns (B, L, Hq, Dv)."""
    B, Hkv, G = fold
    L = z.shape[-2]
    z = z.reshape(B, Hkv, G, L, -1).permute(0, 3, 1, 2, 4)
    return z.reshape(B, L, Hkv * G, -1)


def h1d_attention_mha(q, k, v, **kwargs) -> torch.Tensor:
    """GQA-aware multi-head wrapper over (B, L, H, D) layouts: folds
    (B, Hkv) into the core batch dim and Hq/Hkv into G.  Returns
    (B, L, Hq, Dv)."""
    B, L = q.shape[:2]
    qh, kh, vh, fold = fold_kv_heads(q, k, v)
    kw = kwargs.pop("kv_weight", None)
    if kw is not None:
        kw = kw.expand(B, L).repeat_interleave(fold[1], dim=0)
    z = h1d_attention(qh, kh, vh, kv_weight=kw, **kwargs)
    return unfold_kv_heads(z, fold)
