"""Dense reference oracles for H-Transformer-1D attention.

Port of ``repro.core.ref_attention``; plain PyTorch on any device, for
tests and ``chip_smoke.py``:

* :func:`dense_attention` -- standard O(L^2) softmax attention (the
  paper's baseline Transformer attention, Eq. 1-6); the one oracle a
  model path calls, as the body of ``attention='full'``.
* :func:`h1d_dense_oracle` -- O(L^2) *dense reconstruction* of the exact
  hierarchical approximation: builds the per-level coarse similarity
  matrices, expands them back to the fine grid (Eq. 49-51) with the
  disjoint partition masks, and normalizes.  Must match
  ``h1d_attention`` to float tolerance for every mode.  The level masks
  are numpy, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import hierarchy as hc

NEG_INF = hc.NEG_INF


def dense_attention(q, k, v, *, causal=False, kv_weight=None,
                    softmax_scale=None):
    """q: (B, G, Lq, D); k, v: (B, Lk, Dv) or (B, G, Lk, Dv).  Standard
    softmax attention with f32 scores, keys masked where ``kv_weight``
    (B, Lk) is not positive.  Supports rectangular (cross-) attention;
    ``causal`` requires Lq == Lk.  Returns v's dtype."""
    B, G, Lq, D = q.shape
    kv_g = k.ndim == 4
    Lk = k.shape[-2]
    f32 = torch.float32
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    s = torch.einsum("bgqd,bgkd->bgqk" if kv_g else "bgqd,bkd->bgqk",
                     q.to(f32), k.to(f32)) * scale
    allow = torch.ones((B, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if kv_weight is not None:
        allow = allow & (kv_weight > 0)[:, None, None, :]
    if causal:
        assert Lq == Lk, "causal dense attention requires square shapes"
        allow = allow & torch.ones((Lq, Lk), dtype=torch.bool,
                                   device=q.device).tril()
    s = torch.where(allow, s, NEG_INF)
    m = torch.clamp(s.amax(-1, keepdim=True), min=-1e30)
    a = torch.exp(s - m)
    num = torch.einsum("bgqk,bgkv->bgqv" if kv_g else "bgqk,bkv->bgqv",
                       a, v.to(f32))
    den = a.sum(-1, keepdim=True)
    return (num / torch.clamp(den, min=1e-9)).to(v.dtype)


# ---------------------------------------------------------------------------
# level masks in coarse coordinates (independent re-derivation)
# ---------------------------------------------------------------------------

def _level_mask_coarse(Lc: int, nr: int, level: int, causal: bool) -> np.ndarray:
    """Allowed-mask over coarse pairs (a, b), both at level ``level``."""
    a = np.arange(Lc)[:, None]
    b = np.arange(Lc)[None, :]
    blk_a, blk_b = a // nr, b // nr
    if level == 0:
        m = np.abs(blk_a - blk_b) <= 1
        if causal:
            m &= b <= a
    else:
        diff = blk_a - blk_b
        m = (diff == 1) if causal else (np.abs(diff) == 1)
        # exclude pairs covered at level-1: children block distance <= 1
        child_blk_a = (2 * a) // nr
        child_blk_b = (2 * b) // nr
        m &= np.abs(child_blk_a - child_blk_b) >= 2
    return m


def _level_mask_fine_q(L: int, Lc: int, nr: int, level: int) -> np.ndarray:
    """Allowed-mask over (fine query i, coarse key b) for fine-q causal."""
    span = nr * (1 << level)
    i = np.arange(L)[:, None]
    b = np.arange(Lc)[None, :]
    blk_i = i // span          # query block at this level
    blk_b = b // nr            # key block (coarse coords)
    m = (blk_i - blk_b) == 1   # strict sub-diagonal
    s_i = (i % span) < span // 2      # query in first half of its span
    s_b = (b % nr) >= nr // 2         # key in last half of its block
    m &= ~(s_i & s_b)
    return m


def _expand(x, frow: int, fcol: int):
    if frow > 1:
        x = torch.repeat_interleave(x, frow, dim=-2)
    if fcol > 1:
        x = torch.repeat_interleave(x, fcol, dim=-1)
    return x


def h1d_dense_oracle(q, k, v, *, nr=16, causal=False, causal_mode="fine-q",
                     kv_weight=None, softmax_scale=None):
    """Dense reconstruction of ``h1d_attention``: q (B, G, L, D), k (B, L,
    D), v (B, L, Dv), ``kv_weight`` (B, L) or None, the same semantics.
    Returns v's dtype (the f32 work's result)."""
    B, G, L, D = q.shape
    M = hc.num_levels(L, nr)
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    f32 = torch.float32
    dev = q.device
    q = q.to(f32) * scale
    k = k.to(f32)
    v = v.to(f32)
    w = (torch.ones((B, L), dtype=f32, device=dev) if kv_weight is None
         else torch.broadcast_to(kv_weight.to(f32), (B, L)))
    v = v * w[..., None]

    if M == 0:
        return dense_attention(q, k, v, causal=causal, kv_weight=kv_weight,
                               softmax_scale=1.0).to(v.dtype)

    fine_q = causal and causal_mode == "fine-q"
    # build the combined fine-grid log-similarity matrix; per-level masked
    # supports are disjoint by the partition rule, so elementwise max works.
    s_total = torch.full((B, G, L, L), NEG_INF, dtype=f32, device=dev)
    kc, wc, qc, wq = k, w, q, w
    for l in range(M):
        if l > 0:
            kc, _ = hc.coarsen_weighted_mean(kc, wc)
            wc = hc.coarsen_sum(wc, axis=-1)
            if not fine_q:
                qc, _ = hc.coarsen_weighted_mean(qc, wq)
                wq = hc.coarsen_sum(wq, axis=-1)
        Lc = kc.shape[-2]
        if fine_q or l == 0:
            s = torch.einsum("bgqd,bkd->bgqk", q if l else qc, kc)
            mask = (_level_mask_fine_q(L, Lc, nr, l) if l
                    else _level_mask_coarse(L, nr, 0, causal))
            s = torch.where(torch.as_tensor(mask, device=dev)[None, None],
                            s, NEG_INF)
            s = torch.where((wc > 0)[:, None, None, :], s, NEG_INF)
            s = _expand(s, 1, 1 << l)
        else:
            s = torch.einsum("bgqd,bkd->bgqk", qc, kc)
            mask = _level_mask_coarse(Lc, nr, l, causal)
            s = torch.where(torch.as_tensor(mask, device=dev)[None, None],
                            s, NEG_INF)
            s = torch.where((wc > 0)[:, None, None, :], s, NEG_INF)
            s = _expand(s, 1 << l, 1 << l)
        s_total = torch.maximum(s_total, s)

    m = torch.clamp(s_total.amax(-1, keepdim=True), min=-1e30)
    a = torch.exp(s_total - m)
    num = torch.einsum("bgqk,bkv->bgqv", a, v)
    den = torch.einsum("bgqk,bk->bgq", a, w)[..., None]
    return (num / torch.clamp(den, min=1e-9)).to(v.dtype)
