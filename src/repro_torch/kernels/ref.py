"""Dense oracle for the banded block attention kernels.

Port of ``repro.kernels.ref``: an O(L * Lk) implementation of exactly
the semantics of ``h1d_block.band_attention_fwd`` and
``band_attention_sub_fwd``, for tests and ``chip_smoke.py``; plain
PyTorch on any device, independent of the kernels' plain versions (one
masked product over every key, where those walk the band's blocks).
"""
from __future__ import annotations

import torch

from .h1d_block import band_mask, NEG_INF, _MIN_M


def band_attention_ref(q, k, v, w, *, nr: int, mode: str, ratio: int = 1):
    """q: (B, G, L, d) pre-scaled; k: (B, Lk, d); v: (B, Lk, dv); w: (B, Lk).
    Returns float32 (y, dn, m) identical to the kernels' up to summation
    order.

    For ``mode='sub'`` (fine-q causal coarse level) the key length is
    ``Lk = L / ratio``; all other modes have Lk == L (ratio ignored)."""
    B, G, L, d = q.shape
    Lk = k.shape[1]
    f32 = torch.float32
    qi = torch.arange(L, device=q.device)[:, None]
    ki = torch.arange(Lk, device=q.device)[None, :]
    allow = band_mask(qi, ki, nr, mode, Lk, ratio)            # (L, Lk)
    s = torch.einsum("bgqd,bkd->bgqk", q.to(f32), k.to(f32))
    allow = allow[None, None] & (w > 0)[:, None, None, :]
    s = torch.where(allow, s, NEG_INF)
    m = torch.clamp(s.amax(-1), min=_MIN_M)                   # (B, G, L)
    a = torch.exp(s - m[..., None])
    a = torch.where(allow, a, 0.0)
    y = torch.einsum("bgqk,bkv->bgqv", a, v.to(f32))
    dn = torch.einsum("bgqk,bk->bgq", a, w.to(f32))
    return y, dn, m
