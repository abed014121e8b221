"""Banded block attention for one hierarchy level: mask, plain versions
and CUDA kernel wrappers.

Port of ``repro.kernels.h1d_block`` (Pallas TPU kernels
``band_attention_fwd`` / ``band_attention_sub_fwd``).  For one level every
query attends a band of keys under ``band_mask`` and keys with weight
``w <= 0`` are dropped; the result is the unnormalised float32 triple
``y (B, G, L, dv)``, ``dn (B, G, L)``, ``m (B, G, L)`` that
``core.h1d_attention`` folds across levels.

Modes: ``l0_causal`` and ``l0_bidir`` (level 0 of the causal LM and of
the bidirectional encoder), ``coarse_bidir`` and ``coarse_causal`` (a
coarse level ``l >= 1`` with coarsened queries: the encoder's and the
coarse-q decoder's) and ``sub`` (a fine-q causal level ``l >= 1``: fine
queries of length ``Lq`` against the level-l coarse keys of length
``Lq / ratio``, ``ratio = 2**l``).  A query block reads its own key
block and the one before; a bidirectional mode also the one after.

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
#: the C launcher's mode codes (``enum Mode`` in ``csrc/h1d_band.cuh``)
_MODE_CODES = {m: i for i, m in enumerate(MODES)}

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "h1d_band_fwd": [_P] * 7 + [_I] * 7 + [_P],
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
    if mode not in MODES and mode != SUB_MODE:
        raise ValueError(f"unknown band mode {mode!r}")


def band_offsets(mode: str) -> Tuple[int, ...]:
    """Key blocks a query block reads, relative to its own: the block
    itself and the one before, and in a bidirectional mode the one after
    (``ops._blocked_jnp``'s ``add(0); add(-1); if not causal: add(1)``)."""
    return (0, -1) if mode.endswith("causal") else (0, -1, 1)


def check_window(mode: str, nr: int) -> None:
    """The kernels stage at most 128 keys a row (``MAXC`` chunks of 32):
    a bidirectional mode's three-block window needs ``3 * nr <= 128``."""
    if len(band_offsets(mode)) * nr > 128:
        raise ValueError(f"mode {mode!r} reads {len(band_offsets(mode))} "
                         f"key blocks of nr={nr} a row; the kernels take "
                         f"at most 128 keys")


# ---------------------------------------------------------------------------
# launch geometry of the sub level (and coarse_causal, ratio 1)
# ---------------------------------------------------------------------------
#
# Host mirrors of what ``csrc/h1d_band.cuh`` computes for the sub-level
# kernels: query block I (nq = nr * ratio rows) reads key block I - 1
# alone; a row at position p < nq / 2 of its block ("first half") reads
# the block's first nr / 2 keys only.  A row with no live key, and a key
# block no row reads, is never read.

#: rows of a kernel tile, and the backward's most CTAs (a cluster) a block
SUB_TQ = 64
SUB_MAX_SPLIT = 8


def sub_block_flags(w, nr: int):
    """(B, ceil(Lk / nr)) int flags of each key block: 1 when a key of its
    first half has w > 0 (its query block's first-half rows are live), 2
    when any key has (the other rows are)."""
    B, Lk = w.shape
    nb = -(-Lk // nr)
    wb = torch.zeros((B, nb * nr), dtype=torch.bool, device=w.device)
    wb[:, :Lk] = w > 0
    wb = wb.view(B, nb, nr)
    return (wb[..., : nr // 2].any(-1).int() * 3) | (wb.any(-1).int() * 2)


def sub_live_rows(w, nr: int, ratio: int):
    """(B, Lq) bool: the rows of a sub level (Lq = Lk * ratio) that have a
    key with w > 0 in their band, the only rows the kernels read."""
    Lq = w.shape[1] * ratio
    nq = nr * ratio
    i = torch.arange(Lq, device=w.device)
    flags = sub_block_flags(w, nr)
    blk = i // nq - 1
    bit = torch.where(i % nq < nq // 2, 1, 2)
    f = flags[:, blk.clamp(min=0)]
    return (blk >= 0) & ((f & bit) != 0)


def sub_bwd_splits(G: int, nq: int) -> int:
    """CTAs (one cluster) over which the backward splits a block's G * nq
    rows: runs of a multiple of SUB_TQ rows, at most SUB_MAX_SPLIT."""
    if nq < SUB_TQ:
        return 1
    s, units = 1, G * (nq // SUB_TQ)
    while 2 * s <= SUB_MAX_SPLIT and units % (2 * s) == 0:
        s *= 2
    return s


def sub_pair_items(rows: int, p0: int, nq: int, nkg: int, nkgh: int):
    """(row, key group, lanes) of every item of the score pass on a tile of
    ``rows`` rows from position ``p0`` of its query block: a row pair
    against 4 keys.  First-half pairs take ``nkgh`` groups (the keys of
    the block's first half), the others ``nkg``."""
    pairs = rows // 2
    if nkgh == nkg:
        return [(2 * k, g, nkg) for k in range(pairs) for g in range(nkg)]
    hs = nq // 2
    nf = rows // 4 if hs < rows else (pairs if p0 < hs else 0)
    out = []
    for first, n, width in ((True, nf, nkgh), (False, pairs - nf, nkg)):
        for k in range(n):
            if hs < rows:
                row = (2 * (k // (hs // 2)) + (0 if first else 1)) * hs \
                    + 2 * (k % (hs // 2))
            else:
                row = 2 * k
            out += [(row, g, width) for g in range(width)]
    return out


def sub_bytes(w, *, nr: int, ratio: int, G: int, d: int, dv: int,
              backward: bool = False) -> int:
    """Bytes one sub-level call must move: q (and gy, y, and m, dn, gdn,
    gm in the backward) of the live rows, k and v of the key blocks some
    row reads, w of the blocks a query block maps to, every output once."""
    B, Lk = w.shape
    Lq = Lk * ratio
    live = int(sub_live_rows(w, nr, ratio).sum()) * G
    # the last key block has no query block after it
    blocks = int((sub_block_flags(w, nr)[:, :-1] != 0).sum())
    wread = B * max(-(-Lk // nr) - 1, 0) * nr
    if backward:
        rows_in = live * (d + 2 * dv + 4)
        out = B * G * Lq * (d + 1) + B * Lk * (d + dv + 1)
    else:
        rows_in = live * d
        out = B * G * Lq * (dv + 2)
    return 4 * (rows_in + blocks * nr * (d + dv) + wread + out)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def band_attention_fwd_ref(q, k, v, w, *, nr: int,
                           mode: str = "l0_causal") -> Triple:
    """Plain PyTorch band attention of one level in any mode but ``sub``
    (mirror of ``repro.kernels.ops._blocked_jnp``).  q (B,G,L,d)
    pre-scaled, k (B,L,d), v (B,L,dv) pre-weighted, w (B,L)."""
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
    for offset in band_offsets(mode):
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
    m = terms[0][0].amax(-1)
    for s, _, _ in terms[1:]:
        m = torch.maximum(m, s.amax(-1))
    m = torch.clamp(m, min=_MIN_M)
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
    """Band attention of one level in any mode but ``sub``.  CPU tensors
    take :func:`band_attention_fwd_ref`; CUDA tensors launch
    ``h1d_band_fwd`` (``coarse_causal`` runs the sub body at ratio 1
    there).  ``.mode_launches`` counts the launches per mode."""
    if q.device.type == "cpu":
        return band_attention_fwd_ref(q, k, v, w, nr=nr, mode=mode)
    _check_mode(mode)
    if mode == SUB_MODE:
        raise ValueError("mode 'sub' goes through band_attention_sub_fwd")
    check_window(mode, nr)
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
        B, G, L, d, dv, nr, _MODE_CODES[mode], _build.stream()),
        "h1d_band_fwd")
    band_attention_fwd.launches += 1
    counts = band_attention_fwd.mode_launches
    counts[mode] = counts.get(mode, 0) + 1
    return y, dn, m


band_attention_fwd.launches = 0
band_attention_fwd.mode_launches = {}


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
