"""Banded block attention for one hierarchy level: mask, plain versions
and CUDA kernel wrappers.

Port of ``repro.kernels.h1d_block`` (Pallas TPU kernels
``band_attention_fwd`` / ``band_attention_sub_fwd``).  For one level every
query attends a band of keys under ``band_mask`` and keys with weight
``w <= 0`` are dropped; the result is the unnormalised float32 triple
``y (B, G, L, dv)``, ``dn (B, G, L)``, ``m (B, G, L)`` that
``core.h1d_attention`` folds across levels.

Modes of this slice: ``l0_causal`` (level 0) and ``sub`` (a fine-q causal
level ``l >= 1``: fine queries of length ``Lq`` against the level-l
coarse keys of length ``Lq / ratio``, ``ratio = 2**l``).  The other modes
of the reference (``l0_bidir``, ``coarse_*``) raise ``NotImplementedError``.

Each wrapper chooses by the device of its tensors: a CPU tensor takes the
plain PyTorch version (a mirror of ``ops._blocked_jnp`` /
``ops._blocked_sub_jnp``), a CUDA tensor launches the kernel in
``csrc/h1d_block.cu``.  ``<wrapper>.launches`` counts kernel launches and
``<plain>.calls`` counts runs of the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core import hierarchy as hc
from . import _build

NEG_INF = -3.0e38
_MIN_M = -1e30

MODES = ("l0_bidir", "l0_causal", "coarse_bidir", "coarse_causal")
SUB_MODE = "sub"
PORTED_MODES = ("l0_causal", SUB_MODE)

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "h1d_band_fwd": [_P] * 7 + [_I] * 6 + [_P],
    "h1d_band_sub_fwd": [_P] * 7 + [_I] * 8 + [_P],
}


def band_mask(qi, ki, nr: int, mode: str, lk: int, ratio: int = 1):
    """Allowed-mask from *global* row/col indices (broadcastable integer
    tensors).  The single source of the band structure, shared by the
    plain versions here and, line for line, by ``band_mask`` in
    ``csrc/h1d_block.cu``.

    ``mode='sub'``: ``qi`` are fine query indices, ``ki`` level-l coarse
    key indices, ``ratio = 2**l``; ``qi // ratio`` maps a fine query to
    its coarse row, after which the structure is ``coarse_causal``."""
    if mode == SUB_MODE:
        return band_mask(qi // ratio, ki, nr, "coarse_causal", lk)
    inb = (ki >= 0) & (ki < lk)
    bq = qi // nr
    bk = ki // nr
    diff = bq - bk
    if mode == "l0_bidir":
        allow = diff.abs() <= 1
    elif mode == "l0_causal":
        allow = ((diff == 0) & (ki <= qi)) | (diff == 1)
    elif mode in ("coarse_bidir", "coarse_causal"):
        half = nr // 2
        base = (diff == 1) if mode == "coarse_causal" else (diff.abs() == 1)
        sub_excl = (diff == 1) & ((qi % nr) < half) & ((ki % nr) >= half)
        sup_excl = (diff == -1) & ((qi % nr) >= half) & ((ki % nr) < half)
        allow = base & ~sub_excl & ~sup_excl
    else:
        raise ValueError(mode)
    return allow & inb


def _check_mode(mode: str) -> None:
    if mode not in PORTED_MODES:
        if mode in MODES:
            raise NotImplementedError(
                f"band mode {mode!r} is not ported yet (this slice ports "
                f"{PORTED_MODES})")
        raise ValueError(f"unknown band mode {mode!r}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def band_attention_fwd_ref(q, k, v, w, *, nr: int,
                           mode: str = "l0_causal") -> Triple:
    """Plain PyTorch level-0 band attention (mirror of
    ``repro.kernels.ops._blocked_jnp``).  q (B,G,L,d) pre-scaled, k
    (B,L,d), v (B,L,dv) pre-weighted, w (B,L)."""
    _check_mode(mode)
    if mode == SUB_MODE:
        raise ValueError("mode 'sub' goes through band_attention_sub_fwd_ref")
    band_attention_fwd_ref.calls += 1
    f32 = torch.float32
    L = q.shape[-2]
    qb = hc.block(q.to(f32), nr)                       # (B,G,NB,nr,d)
    kb = hc.block(k.to(f32), nr)                       # (B,NB,nr,d)
    vb = hc.block(v.to(f32), nr)
    wb = hc.block(w.to(f32), nr, axis=-1)              # (B,NB,nr)
    nb = qb.shape[-3]
    dev = q.device
    terms = []
    for offset in (0, -1):
        kt = hc.shift_blocks(kb, offset)
        vt = hc.shift_blocks(vb, offset)
        wt = hc.shift_blocks(wb, offset, block_axis=-2)
        qi = (torch.arange(nr, device=dev)[:, None]
              + torch.arange(nb, device=dev)[:, None, None] * nr)
        ki = qi.transpose(1, 2) + offset * nr
        allow = band_mask(qi, ki, nr, mode, L)         # (nb, nr, nr)
        s = torch.einsum("bgnqd,bnkd->bgnqk", qb, kt)
        allow = allow[None, None] & (wt > 0)[:, None, :, None, :]
        terms.append((torch.where(allow, s, NEG_INF), vt, wt))
    m = torch.clamp(torch.maximum(terms[0][0].amax(-1), terms[1][0].amax(-1)),
                    min=_MIN_M)
    y = dn = None
    for s, vt, wt in terms:
        a = torch.exp(s - m[..., None])
        yt = torch.einsum("bgnqk,bnkv->bgnqv", a, vt)
        dt = torch.einsum("bgnqk,bnk->bgnq", a, wt)
        y = yt if y is None else y + yt
        dn = dt if dn is None else dn + dt
    return (hc.unblock(y, axis=-3), hc.unblock(dn, axis=-2),
            hc.unblock(m, axis=-2))


band_attention_fwd_ref.calls = 0


def band_attention_sub_fwd_ref(q, k, v, w, *, nr: int, ratio: int) -> Triple:
    """Plain PyTorch fine-q causal level (mirror of
    ``repro.kernels.ops._blocked_sub_jnp``): fine query blocks of
    ``nq = nr * ratio`` rows against the previous coarse key block."""
    band_attention_sub_fwd_ref.calls += 1
    f32 = torch.float32
    Lk = k.shape[1]
    nq = nr * ratio
    dev = q.device
    qb = hc.block(q.to(f32), nq)                       # (B,G,NB,nq,d)
    kt = hc.shift_blocks(hc.block(k.to(f32), nr), -1)
    vt = hc.shift_blocks(hc.block(v.to(f32), nr), -1)
    wt = hc.shift_blocks(hc.block(w.to(f32), nr, axis=-1), -1, block_axis=-2)
    nb = qb.shape[-3]
    qi = (torch.arange(nq, device=dev)[:, None]
          + torch.arange(nb, device=dev)[:, None, None] * nq)
    ki = (torch.arange(nr, device=dev)[None, :]
          + (torch.arange(nb, device=dev)[:, None, None] - 1) * nr)
    allow = band_mask(qi, ki, nr, SUB_MODE, Lk, ratio)  # (nb, nq, nr)
    s = torch.einsum("bgnqd,bnkd->bgnqk", qb, kt)
    allow = allow[None, None] & (wt > 0)[:, None, :, None, :]
    s = torch.where(allow, s, NEG_INF)
    m = torch.clamp(s.amax(-1), min=_MIN_M)
    a = torch.exp(s - m[..., None])
    y = torch.einsum("bgnqk,bnkv->bgnqv", a, vt)
    dn = torch.einsum("bgnqk,bnk->bgnq", a, wt)
    return (hc.unblock(y, axis=-3), hc.unblock(dn, axis=-2),
            hc.unblock(m, axis=-2))


band_attention_sub_fwd_ref.calls = 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    return _build.library("h1d_block", _SIGNATURES)


def _outputs(q, dv):
    B, G, L, _ = q.shape
    return (torch.empty((B, G, L, dv), dtype=torch.float32, device=q.device),
            torch.empty((B, G, L), dtype=torch.float32, device=q.device),
            torch.empty((B, G, L), dtype=torch.float32, device=q.device))


def band_attention_fwd(q, k, v, w, *, nr: int,
                       mode: str = "l0_causal") -> Triple:
    """Level-0 band attention (mode ``l0_causal``).  CPU tensors take
    :func:`band_attention_fwd_ref`; CUDA tensors launch ``h1d_band_fwd``."""
    if q.device.type == "cpu":
        return band_attention_fwd_ref(q, k, v, w, nr=nr, mode=mode)
    _check_mode(mode)
    if mode == SUB_MODE:
        raise ValueError("mode 'sub' goes through band_attention_sub_fwd")
    lib = _lib()
    B, G, L, d = q.shape
    dv = v.shape[-1]
    hc.validate_h1d_shape(L, nr)
    _build.expect(q, "q", (B, G, L, d))
    _build.expect(k, "k", (B, L, d))
    _build.expect(v, "v", (B, L, dv))
    _build.expect(w, "w", (B, L))
    y, dn, m = _outputs(q, dv)
    _build.check(lib.h1d_band_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        y.data_ptr(), dn.data_ptr(), m.data_ptr(),
        B, G, L, d, dv, nr, _build.stream()), "h1d_band_fwd")
    band_attention_fwd.launches += 1
    return y, dn, m


band_attention_fwd.launches = 0


def band_attention_sub_fwd(q, k, v, w, *, nr: int, ratio: int) -> Triple:
    """Fine-q causal level (mode ``sub``).  CPU tensors take
    :func:`band_attention_sub_fwd_ref`; CUDA tensors launch
    ``h1d_band_sub_fwd``."""
    if q.device.type == "cpu":
        return band_attention_sub_fwd_ref(q, k, v, w, nr=nr, ratio=ratio)
    lib = _lib()
    B, G, Lq, d = q.shape
    Lk = k.shape[1]
    dv = v.shape[-1]
    if ratio < 2 or ratio & (ratio - 1) or Lq != Lk * ratio:
        raise ValueError(f"sub level needs ratio=2**l >= 2 and "
                         f"Lq == Lk * ratio, got {Lq=}, {Lk=}, {ratio=}")
    hc.validate_h1d_shape(Lq, nr)
    _build.expect(q, "q", (B, G, Lq, d))
    _build.expect(k, "k", (B, Lk, d))
    _build.expect(v, "v", (B, Lk, dv))
    _build.expect(w, "w", (B, Lk))
    y, dn, m = _outputs(q, dv)
    _build.check(lib.h1d_band_sub_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        y.data_ptr(), dn.data_ptr(), m.data_ptr(),
        B, G, Lq, Lk, d, dv, nr, ratio, _build.stream()), "h1d_band_sub_fwd")
    band_attention_sub_fwd.launches += 1
    return y, dn, m


band_attention_sub_fwd.launches = 0
