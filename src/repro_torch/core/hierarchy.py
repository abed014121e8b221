"""Binary-tree hierarchy utilities for H-Transformer-1D attention.

Port of ``repro.core.hierarchy``.  ``nr`` is the level-0 block size; the
level-l sequence is the original coarsened ``l`` times (length
``L / 2**l``) and is cut into blocks of ``nr`` coarse tokens.  Keys
coarsen with a pairwise mean, values and key weights with a pairwise sum.
Every function here is bit-exact against its JAX counterpart on the same
float32 inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "NEG_INF",
    "validate_h1d_shape",
    "num_levels",
    "padded_length",
    "coarsen_mean",
    "coarsen_sum",
    "coarsen_weighted_mean",
    "block",
    "unblock",
    "shift_blocks",
    "quadrant_mask",
    "causal_block_mask",
    "interp_repeat",
]

NEG_INF = float(np.finfo(np.float32).min)


def padded_length(L: int, nr: int) -> int:
    """Smallest L' >= L with L' = nr * 2**k (k >= 0)."""
    if L <= nr:
        return nr
    nb = (L + nr - 1) // nr
    return nr * (1 << max(0, math.ceil(math.log2(nb))))


def validate_h1d_shape(L: int, nr: int) -> int:
    """Check L == nr * 2**k, return number of level-0 blocks."""
    if nr < 2 or nr & (nr - 1):
        raise ValueError(f"nr must be a power of two >= 2, got {nr}")
    if L % nr:
        raise ValueError(f"L={L} not a multiple of nr={nr}")
    nb = L // nr
    if nb & (nb - 1):
        raise ValueError(f"num blocks L/nr={nb} must be a power of two")
    return nb


def num_levels(L: int, nr: int) -> int:
    """Number of hierarchy levels M = log2(L / nr); 0 means single block."""
    nb = validate_h1d_shape(L, nr)
    return int(math.log2(nb)) if nb > 1 else 0


def _pairs(x: torch.Tensor, axis: int):
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // 2, 2]
    xr = x.reshape(shape)
    return xr.select(axis + 1, 0), xr.select(axis + 1, 1)


def coarsen_mean(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pairwise mean along ``axis``. Length must be even."""
    a, b = _pairs(x, axis)
    return (a + b) * 0.5


def coarsen_sum(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pairwise sum along ``axis``."""
    a, b = _pairs(x, axis)
    return a + b


def coarsen_weighted_mean(x: torch.Tensor, w: torch.Tensor):
    """Weighted pairwise mean along the token axis; returns (coarse_x,
    coarse_w).  ``x``: (B, ..., L, D); ``w``: (B, L).  Padded (weight-0)
    tokens then do not pollute coarse rows."""
    def bcast(t):
        if t.ndim < x.ndim - 1:   # insert middle broadcast dims after batch
            return t.reshape((t.shape[0],) + (1,) * (x.ndim - 1 - t.ndim)
                             + (t.shape[-1],))
        return t

    xw = coarsen_sum(x * bcast(w)[..., None], axis=-2)
    ws = coarsen_sum(w, axis=-1)
    # torch.maximum, not clamp: a weight sum of exactly 1 (a real token
    # paired with a padded one) ties with the floor, and JAX's maximum
    # splits that gradient 0.5/0.5
    wsb = bcast(ws)
    return xw / torch.maximum(wsb, torch.full_like(wsb, 1.0))[..., None], ws


def block(x: torch.Tensor, n: int, axis: int = -2) -> torch.Tensor:
    """(..., L, ...) -> (..., L//n, n, ...) along ``axis``."""
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // n, n]
    return x.reshape(shape)


def unblock(x: torch.Tensor, axis: int = -3) -> torch.Tensor:
    """Inverse of :func:`block`: merge (nb, n) axes."""
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 2] = [shape[axis] * shape[axis + 1]]
    return x.reshape(shape)


def shift_blocks(xb: torch.Tensor, offset: int,
                 block_axis: int = -3) -> torch.Tensor:
    """Return ``yb[i] = xb[i + offset]`` with zero padding out of range."""
    if offset == 0:
        return xb
    axis = block_axis % xb.ndim
    nb = xb.shape[axis]
    out = torch.zeros_like(xb)
    n = nb - abs(offset)
    if n <= 0:
        return out
    if offset > 0:
        out.narrow(axis, 0, n).copy_(xb.narrow(axis, offset, n))
    else:
        out.narrow(axis, -offset, n).copy_(xb.narrow(axis, 0, n))
    return out


def quadrant_mask(nq: int, nk: int, kind: str, device=None) -> torch.Tensor:
    """Boolean (nq, nk) mask of *allowed* entries for level >= 1 blocks.

    ``kind='sub'``: query block I attends key block I-1; excluded are
    first-half queries x last-half keys.  ``kind='super'``: query block
    I attends key block I+1; excluded are last-half queries x first-half
    keys.  ``nq`` may exceed ``nk`` (fine-query causal path)."""
    q = torch.arange(nq, device=device)[:, None]
    k = torch.arange(nk, device=device)[None, :]
    if kind == "sub":
        excl = (q < nq // 2) & (k >= nk // 2)
    elif kind == "super":
        excl = (q >= nq // 2) & (k < nk // 2)
    else:
        raise ValueError(kind)
    return ~excl


def causal_block_mask(n: int, device=None) -> torch.Tensor:
    """Lower-triangular (n, n) allowed-mask for level-0 diagonal blocks."""
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


def interp_repeat(x: torch.Tensor, factor: int,
                  axis: int = -2) -> torch.Tensor:
    """Piecewise-constant prolongation P^(l) (Eq. 38-40): repeat rows.
    ``repeat_interleave``, so autograd sums a coarse row's cotangent over
    its ``factor`` fine rows."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=axis)
