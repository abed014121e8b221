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
``<plain>.calls`` counts runs of the plain version; while a hook or a
capture of ``analysis.contracts`` is open, a launch also hands over its
record (the CUDA grid that the launcher reports, :func:`last_grid`).  ``l0_causal`` has
two bodies there: the staged one, which holds a tile's whole key window
in shared memory (nr up to 64), and a streamed one for the windows too
wide to hold (a sliding window's nr = 1024 at d = 256), which the
wrapper takes only for the shapes the staged one refuses
(:func:`check_window_fwd`; the backward chooses the same way,
:func:`check_window_bwd`, with the host mirrors of both bodies' plans
here).  Level 0 needs whole blocks only (``L % nr == 0``); the coarse
modes need ``L = nr * 2**k``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..analysis import contracts
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
    "h1d_band_fwd_last_grid": [_P],
    "h1d_band_fwd_stream": [_P] * 7 + [_I] * 6 + [_P],
    "h1d_band_stream_smem": [_I] * 3,
    "h1d_band_sub_fwd": [_P] * 7 + [_I] * 8 + [_P],
}


def band_mask(qi, ki, nr: int, mode: str, lk: int, ratio: int = 1):
    """Allowed-mask from *global* row/col indices (broadcastable integer
    tensors).  The single source of the band structure of the plain
    versions here; the kernels test it per band with the block difference
    known (``band_admits``, held to this mask by the geometry tests).

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


def _check_length(L: int, nr: int, mode: str) -> None:
    """Level 0 (``l0_*``) needs whole blocks only, as the reference's
    kernel does (a sliding window pads L to a multiple of the window);
    a coarse mode needs ``L = nr * 2**k``."""
    if not mode.startswith("l0"):
        hc.validate_h1d_shape(L, nr)
    elif nr < 2 or nr & (nr - 1) or L % nr:
        raise ValueError(f"mode {mode!r} needs nr a power of two >= 2 and "
                         f"L % nr == 0, got L={L}, nr={nr}")


def band_offsets(mode: str) -> Tuple[int, ...]:
    """Key blocks a query block reads, relative to its own: the block
    itself and the one before, and in a bidirectional mode the one after
    (``ops._blocked_jnp``'s ``add(0); add(-1); if not causal: add(1)``)."""
    return (0, -1) if mode.endswith("causal") else (0, -1, 1)


def band_body_takes(mode: str, nr: int, d: int, dv: int) -> bool:
    """Whether the staged bodies take the level in both directions: nr a
    power of two up to ``BAND_MAX_NR`` (64) in every mode, and any d and
    dv whose smallest tiles fit the H100's shared memory: 16 rows a tile
    in the forward, dQ and dK/dV/dW passes of ``l0_causal``, ``l0_bidir``
    and ``coarse_bidir`` (``band_fwd_tq``, ``band_dkvw_tiles``);
    ``coarse_causal`` runs the sub bodies at ratio 1 (a forward tile of
    64 rows, backward tiles down to 16)."""
    if nr > BAND_MAX_NR:
        return False
    if mode in BAND_CODES:
        big = 4 * max(band_fwd_floats(mode, 16, d, dv, nr),
                      band_dq_floats(mode, 16, d, dv, nr),
                      band_dkvw_floats(mode, 1, 16, d, dv, nr))
    else:
        big = 4 * max(sub_fwd_floats(d, dv, nr, 1),
                      sub_bwd_floats(16, d, dv, nr))
    return big <= SMEM_MAX


def check_window_bwd(mode: str, nr: int, d: int, dv: int) -> str:
    """The backward body of a level (#3), as :func:`check_window_fwd`
    chooses the forward's: ``"band"`` (the staged bodies) for every shape
    they take, else ``"stream"`` in ``l0_causal`` where both passes of
    the streamed backward fit (:func:`stream_bwd_takes`); raises
    ``ValueError`` on anything else."""
    if band_body_takes(mode, nr, d, dv):
        return "band"
    if mode == "l0_causal" and stream_bwd_takes(nr, d, dv):
        return "stream"
    raise ValueError(
        f"mode {mode!r} at nr={nr}, d={d}, dv={dv}: the backward kernels "
        f"take nr <= {BAND_MAX_NR} and 16-row tiles within {SMEM_MAX} "
        f"bytes of shared memory; past that only l0_causal streams, at d, "
        f"dv <= {STREAM_MAX_D} and plans within {SMEM_MAX} bytes")


def check_window_fwd(mode: str, nr: int, d: int, dv: int) -> str:
    """The forward body of a level: ``"band"`` (the staged bodies) for
    every shape they take in both directions, else ``"stream"`` in
    ``l0_causal`` where the streamed body takes it (:func:`stream_takes`);
    raises ``ValueError`` on anything else."""
    if band_body_takes(mode, nr, d, dv):
        return "band"
    if mode == "l0_causal" and stream_takes(nr, d, dv):
        return "stream"
    raise ValueError(
        f"mode {mode!r} at nr={nr}, d={d}, dv={dv}: the staged bodies take "
        f"nr <= {BAND_MAX_NR} and 16-row tiles within {SMEM_MAX} bytes of "
        f"shared memory; past that only l0_causal streams, at d, dv <= "
        f"{STREAM_MAX_D} and a plan within {SMEM_MAX} bytes")


# ---------------------------------------------------------------------------
# launch geometry of l0_causal, l0_bidir and coarse_bidir
# ---------------------------------------------------------------------------
#
# Host mirrors of what ``csrc/h1d_band.cuh`` computes for these bodies:
# query block I reads key blocks I + off, band b at offset
# ``band_off(mode, b)``; a key block's info says which of its halves hold
# a key with w > 0, and a row with no such key that its mask admits is
# never read.  The score pass gives a row pair 2 nr / 4 lanes in two
# slots, one group of 4 keys in each of its slot's bands; key groups the
# mask masks whole are not computed.

#: mode codes of the three bodies (``enum Mode``)
BAND_CODES = {m: _MODE_CODES[m] for m in ("l0_bidir", "l0_causal",
                                          "coarse_bidir")}
BAND_TQ = 32
BAND_KEYS = 32
BAND_KV_TQ = 32
BAND_MAX_NR = 64
BAND_SLOTS = 2
FILL_CTAS = 264
SMEM_MAX = 232448


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _key_groups(n: int) -> int:
    return (n + 3) // 4


def band_count(mode: str) -> int:
    return 3 if mode == "l0_bidir" else 2


def band_off(mode: str, b: int) -> int:
    return 2 * b - 1 if mode == "coarse_bidir" else b - 1


def band_window_blocks(mode: str, tq: int, nr: int) -> int:
    return (tq // nr if tq > nr else 1) + (1 if mode == "l0_causal" else 2)


def band_block_info(w, nr: int):
    """(B, L / nr) ints of each key block: bit 0 a key of its first half
    has w > 0, bit 1 a key of its second half has; from bit 8 on the
    first key with w > 0 (nr if none)."""
    B, L = w.shape
    wb = (w > 0).view(B, L // nr, nr)
    bits = (wb[..., : nr // 2].any(-1).int()
            | (wb[..., nr // 2:].any(-1).int() * 2))
    pos = torch.arange(nr, device=w.device)
    first = torch.where(wb, pos, nr).amin(-1)
    return bits | (first << 8)


def band_row_live(mode: str, p, nr: int, prev, own, nxt):
    """Whether rows at positions ``p`` of their blocks have a key with
    w > 0 that ``band_mask`` admits, from the infos of the blocks before,
    at and after their own (0 for a block out of range)."""
    if mode == "l0_causal":
        return ((prev & 3) != 0) | (((own & 3) != 0) & ((own >> 8) <= p))
    if mode == "l0_bidir":
        return ((prev | own | nxt) & 3) != 0
    first = p < nr // 2
    return torch.where(first, ((prev & 1) != 0) | ((nxt & 3) != 0),
                       ((prev & 3) != 0) | ((nxt & 2) != 0))


def band_live_rows(w, nr: int, mode: str):
    """(B, L) bool: the rows that have a key with w > 0 in their band,
    the only rows the kernels read."""
    B, L = w.shape
    info = band_block_info(w, nr)
    pad = torch.zeros((B, 1), dtype=info.dtype, device=w.device)
    full = torch.cat([pad, info, pad], dim=1)           # blocks -1 .. NB
    i = torch.arange(L, device=w.device)
    blk = i // nr + 1
    return band_row_live(mode, i % nr, nr, full[:, blk - 1], full[:, blk],
                         full[:, blk + 1])


def band_admits(mode: str, off: int, pq, pk, nr: int):
    """``band_mask`` for rows at positions ``pq`` of their block and keys
    at positions ``pk`` of the block at offset ``off`` (a band of the
    mode) from theirs (``band_admits`` in ``csrc/h1d_band.cuh``)."""
    half = nr // 2
    if mode == "l0_causal":
        return (pk <= pq) | (off < 0)
    if mode == "coarse_bidir":
        if off < 0:
            return ~((pq < half) & (pk >= half))
        return ~((pq >= half) & (pk < half))
    return torch.ones_like(pq + pk, dtype=torch.bool)


def band_group_range(mode: str, off: int, p: int, rows: int, nr: int):
    """Key groups [lo, hi) of band offset ``off`` that ``band_mask``
    admits for some row at positions p .. p + rows - 1 of one block."""
    half = nr // 2
    lo, hi = 0, _key_groups(nr)
    if mode == "l0_causal" and off == 0:
        hi = min(hi, _key_groups(p + rows))
    if mode == "coarse_bidir" and off < 0 and p + rows <= half:
        hi = _key_groups(half)
    if mode == "coarse_bidir" and off > 0 and p >= half:
        lo = half // 4
    return lo, hi


def band_row_range(mode: str, off: int, kg: int, nr: int):
    """Positions [lo, hi) of a reader block's rows that ``band_mask``
    admits for some key of group kg of the key block at offset ``off``
    from theirs (the dK/dV/dW pass's sums)."""
    half = nr // 2
    lo, hi = 0, nr
    if mode == "l0_causal" and off == 0:
        lo = 4 * kg
    if mode == "coarse_bidir" and off < 0 and 4 * kg >= half:
        lo = half
    if mode == "coarse_bidir" and off > 0 and 4 * kg + 3 < half:
        hi = half
    return lo, hi


def lane_item(it: int, W: int):
    """(row pair, lane j among the pair's W) of item ``it`` of a score pass:
    in each warp a pair's lanes differ in lane bit 0 and the bits above
    the pair's (``lane_item`` in ``csrc/h1d_band.cuh``)."""
    if W == 1:
        return it, 0
    P, l = 32 // W, it & 31
    return (it >> 5) * P + ((l >> 1) & (P - 1)), (l & 1) | ((l >> 1) // P << 1)


def lane_xor(o: int, W: int) -> int:
    """Lane offset of the o-th xor step among a row pair's lanes."""
    return 1 if o == 1 else o * (32 // W)


def lane_groups(npairs: int, W: int) -> int:
    return -(-npairs // 32) if W == 1 else -(-(npairs * W) // 32)


def band_pair_items(mode: str, t0: int, rows: int, nr: int):
    """(item, row, lanes, [(off, kg), ...]) of every active item of the
    score pass (the forward's and the dQ pass's) on the tile of ``rows``
    rows from row t0: a row pair against group kg of the bands of its lane
    slot (W = slots * nr / 4 lanes a row pair, slot sl takes bands sl, sl
    + slots, ...), less the groups the mask masks whole for both rows."""
    nkg = _key_groups(nr)
    slots = BAND_SLOTS
    W = slots * nkg
    out = []
    for it in range(32 * lane_groups(rows // 2, W)):
        pair, j = lane_item(it, W)
        if pair >= rows // 2:
            continue
        r0, sl, kg = 2 * pair, j // nkg, j % nkg
        p = (t0 + r0) % nr
        groups = []
        for b in range(sl, band_count(mode), slots):
            off = band_off(mode, b)
            lo, hi = band_group_range(mode, off, p, 2, nr)
            if lo <= kg < hi:
                groups.append((off, kg))
        out.append((it, r0, W, groups))
    return out


def band_fwd_floats(mode: str, tq: int, d: int, dv: int, nr: int) -> int:
    nwb = band_window_blocks(mode, tq, nr)
    nkw = nwb * nr + 4
    qs = _round4(d) + 4
    as_ = band_count(mode) * 4 * _key_groups(nr) + 4
    return tq * qs + nkw * qs + nkw * _round4(dv) + tq * as_ + nkw + nwb + tq


def band_dq_floats(mode: str, tq: int, d: int, dv: int, nr: int) -> int:
    nwb = band_window_blocks(mode, tq, nr)
    nkw = nwb * nr + 4
    qs, gs = _round4(d) + 4, _round4(dv) + 4
    as_ = band_count(mode) * 4 * _key_groups(nr) + 4
    return (tq * qs + tq * gs + max(tq * gs, tq * as_) + nkw * qs + nkw * gs
            + nkw + 4 * tq + nwb + tq)


def band_row_slots(mode: str, nr: int) -> int:
    """Floats of one row's band in the backward's a / ds scratch: every
    band's key groups of 4."""
    return band_count(mode) * 4 * _key_groups(nr)


def band_dkvw_floats(mode: str, nkb: int, tq: int, d: int, dv: int,
                     nr: int) -> int:
    nk = nkb * 4 * _key_groups(nr)
    d4, dv4 = _round4(d), _round4(dv)
    qs, gs, xs = d4 + 4, dv4 + 4, 2 * band_row_slots(mode, nr) + 4
    return (nk * (d4 + dv4 + 1) + tq * qs + tq * gs + tq * xs + nkb * nr
            + tq + nkb + tq)


def band_fwd_tq(mode: str, B: int, G: int, L: int, d: int, dv: int,
                nr: int, backward: bool = False) -> int:
    """Rows a tile of the forward (or of the dQ pass): BAND_TQ, halved to
    16 while the grid has fewer than FILL_CTAS CTAs or the tile exceeds
    the shared memory; 0 when 16 rows do not fit."""
    floats = band_dq_floats if backward else band_fwd_floats
    tq = BAND_TQ
    while tq > 16 and (4 * floats(mode, tq, d, dv, nr) > SMEM_MAX
                       or B * G * -(-L // tq) < FILL_CTAS):
        tq //= 2
    return tq if 4 * floats(mode, tq, d, dv, nr) <= SMEM_MAX else 0


def band_dkvw_tiles(mode: str, B: int, L: int, d: int, dv: int, nr: int):
    """(key blocks a CTA, reader rows a chunk) of the dK/dV/dW pass; the
    rows are 0 when nothing fits."""
    nb = L // nr
    n = BAND_KEYS // nr if BAND_KEYS > nr else 1
    while n > nb:
        n //= 2
    while n > 1 and B * -(-nb // n) < FILL_CTAS:
        n //= 2
    readers = (n + (1 if mode == "l0_causal" else 2)) * nr

    def nbytes(kb, t):
        return 4 * band_dkvw_floats(mode, kb, t, d, dv, nr)
    t = BAND_KV_TQ
    while t > 16 and (t // 2 >= readers or nbytes(n, t) > SMEM_MAX):
        t //= 2
    while n > 1 and nbytes(n, t) > SMEM_MAX:
        n //= 2
    return n, (t if nbytes(n, t) <= SMEM_MAX else 0)


def band_dkvw_ctas(mode: str, L: int, nr: int, nkb: int):
    """(first key block, key blocks, reader rows [lo, hi)) of every CTA
    of the dK/dV/dW pass along one sequence."""
    nb = L // nr
    out = []
    for J0 in range(0, nb, nkb):
        nkh = min(nkb, nb - J0)
        lo = max(0, J0 - (0 if mode == "l0_causal" else 1)) * nr
        out.append((J0, nkh, (lo, min(nb, J0 + nkh + 1) * nr)))
    return out


def band_bytes(w, *, nr: int, mode: str, G: int, d: int, dv: int,
               backward: bool = False) -> int:
    """Bytes one call in ``l0_causal``, ``l0_bidir`` or ``coarse_bidir``
    must move: q (and gy, y, and m, dn, gdn, gm in the backward) of the
    live rows, k and v of the key blocks some live row reads, w, every
    output once."""
    B, L = w.shape
    live = int(band_live_rows(w, nr, mode).sum()) * G
    info = band_block_info(w, nr)
    # a key block with a key of w > 0 is read by its own block's rows, or
    # in coarse_bidir by a neighbour's
    blocks = int(((info & 3) != 0).sum()) if L // nr > 1 or \
        mode != "coarse_bidir" else 0
    if backward:
        rows_in = live * (d + 2 * dv + 4)
        out = B * G * L * (d + 1) + B * L * (d + dv + 1)
    else:
        rows_in = live * d
        out = B * G * L * (dv + 2)
    return 4 * (rows_in + blocks * nr * (d + dv) + B * L + out)


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


def sub_fwd_floats(d: int, dv: int, nr: int, ratio: int) -> int:
    """Shared floats of the sub-level forward (``sub_fwd_smem``)."""
    nq = nr * ratio
    nkw = (1 if nq >= SUB_TQ else SUB_TQ // nq) * nr + 4
    qs, as_ = _round4(d) + 4, 4 * _key_groups(nr) + 4
    return (SUB_TQ * qs + nkw * qs + nkw * _round4(dv) + SUB_TQ * as_ + nkw
            + 2 * SUB_TQ)


def sub_bwd_floats(tq: int, d: int, dv: int, nr: int) -> int:
    """Shared floats of the sub-level backward at tq rows a tile."""
    d4, dv4, nk4 = _round4(d), _round4(dv), 4 * _key_groups(nr)
    qs, gs, as_ = d4 + 4, dv4 + 4, nk4 + 4
    return (tq * qs + tq * gs + max(tq * gs, 2 * tq * as_) + nk4 * qs
            + nk4 * gs + nk4 * (d4 + dv4 + 1) + nk4 + 6 * tq)


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
# launch geometry of the streamed l0_causal body
# ---------------------------------------------------------------------------
#
# Host mirrors of ``csrc/h1d_band.cuh``'s streamed bodies: a tile of
# STREAM_TQ rows keeps its q in shared memory while the keys (I - 1) * nr
# .. its last row stream through one tile of STREAM_TK keys at a time; a
# key tile with no w > 0 is never copied.  Tiles run longest first
# (``stream_slot``).

STREAM_TQ = 64
STREAM_TK = 64
STREAM_MAX_D = 256


def stream_max_tiles(nr: int) -> int:
    """Key tiles a query tile's window spans at most."""
    return -(-(2 * nr + STREAM_TQ) // STREAM_TK)


def stream_fwd_floats(d: int, dv: int, nr: int) -> int:
    """Shared floats of the streamed body (``stream_fwd_floats``)."""
    qs, vs = _round4(d) + 4, _round4(dv)
    return (STREAM_TQ * qs + STREAM_TK * (qs + vs + 1)
            + STREAM_TQ * (STREAM_TK + 4) + STREAM_TQ
            + stream_max_tiles(nr) + 1)


def stream_takes(nr: int, d: int, dv: int) -> bool:
    """The streamed body's envelope: nr a power of two >= 2, d and dv up
    to STREAM_MAX_D, its shared-memory plan within SMEM_MAX."""
    return (nr >= 2 and nr & (nr - 1) == 0 and 1 <= d <= STREAM_MAX_D
            and 1 <= dv <= STREAM_MAX_D
            and 4 * stream_fwd_floats(d, dv, nr) <= SMEM_MAX)


# The streamed backward (``csrc/h1d_block_bwd.cu``): the dQ pass keeps a
# tile of STREAM_TQ rows' q and gy resident and streams the window once in
# tiles of STREAM_DQ_TK keys, each row listing up to STREAM_TIES tied keys;
# the dK/dV/dW pass keeps STREAM_KV_TK keys resident and streams their
# reader rows in chunks of STREAM_KV_TR.

STREAM_DQ_TK = 32
STREAM_TIES = 4
STREAM_KV_TK = 32
STREAM_KV_TR = 64


def stream_dq_tiles(nr: int) -> int:
    """Key tiles of the dQ pass a query tile's window spans at most."""
    return -(-(2 * nr + STREAM_TQ) // STREAM_DQ_TK)


def stream_dq_floats(d: int, dv: int, nr: int) -> int:
    """Shared floats of the streamed backward's dQ pass
    (``stream_dq_floats``)."""
    qs, gs = _round4(d) + 4, _round4(dv) + 4
    return (STREAM_TQ * (qs + gs) + STREAM_DQ_TK * (qs + gs + 1)
            + 2 * STREAM_TQ * (STREAM_DQ_TK + 4) + 3 * STREAM_TQ
            + STREAM_TQ * (1 + STREAM_TIES) + stream_dq_tiles(nr) + 1)


def stream_dkvw_floats(d: int, dv: int) -> int:
    """Shared floats of the streamed backward's dK/dV/dW pass
    (``stream_dkvw_floats``)."""
    qs, gs = _round4(d) + 4, _round4(dv) + 4
    return (STREAM_KV_TK * (qs + gs) + STREAM_KV_TR * (qs + gs + 3)
            + 2 * STREAM_KV_TK * (STREAM_KV_TR + 4) + STREAM_KV_TK)


def stream_bwd_takes(nr: int, d: int, dv: int) -> bool:
    """The streamed backward's envelope: the streamed forward's
    (:func:`stream_takes`), and both passes' shared-memory plans within
    SMEM_MAX."""
    return stream_takes(nr, d, dv) and 4 * max(
        stream_dq_floats(d, dv, nr), stream_dkvw_floats(d, dv)) <= SMEM_MAX


def stream_tie_lists(tie, key0: int = 0):
    """Each row's tie count and tie list as the dQ pass forms them in one
    sweep: ``tie`` is a (rows, keys) bool array of one query tile's window
    (key tiles of STREAM_DQ_TK from key ``key0``), True where an admitted
    key's score equals the row's max.  A row's 8 lanes hold keys kl + 8 t
    of a tile; per t a ballot gives each tied lane its place, the count of
    the row's earlier ties plus the tied lanes below it, so the list holds
    the first STREAM_TIES tied keys in key order.  Returns (counts, lists):
    the exact count of every row, and its list (its first STREAM_TIES
    tied keys; a row with more is rescanned in key order by the kernel)."""
    tie = np.asarray(tie, dtype=bool)
    rows, nk = tie.shape
    counts = np.zeros(rows, dtype=np.int64)
    lists = [[] for _ in range(rows)]
    for ks in range(0, nk, STREAM_DQ_TK):
        for t in range(4):
            for r in range(rows):
                ballot = 0
                for kl in range(8):
                    kk = ks + kl + 8 * t
                    if kk < nk and tie[r, kk]:
                        ballot |= 1 << kl
                for kl in range(8):
                    if ballot >> kl & 1:
                        pos = counts[r] + bin(ballot & ((1 << kl) - 1)).count(
                            "1")
                        if pos < STREAM_TIES:
                            lists[r].append(key0 + ks + kl + 8 * t)
                counts[r] += bin(ballot).count("1")
    return counts, lists


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

#: keys a plain band sums in one fp32 chain
SUM_KEYS = 32


def _band_sums(a, vt, wt):
    """``a @ v`` and ``a . w`` over one band's keys (a's last axis).  A
    band wider than SUM_KEYS keys sums chunks of SUM_KEYS apart and adds
    the chunk sums: one fp32 chain over a sliding window's 1024-key band
    is itself ~2e-5 from the exact sum (against float64 on the card),
    more than the kernels are held to.  Narrower bands are one einsum."""
    nk = a.shape[-1]
    if nk <= SUM_KEYS:
        return (torch.einsum("bgnqk,bnkv->bgnqv", a, vt),
                torch.einsum("bgnqk,bnk->bgnq", a, wt))
    ac = a.unflatten(-1, (nk // SUM_KEYS, SUM_KEYS))
    yt = torch.einsum("bgnqcj,bncjv->bgnqcv", ac,
                      vt.unflatten(-2, (nk // SUM_KEYS, SUM_KEYS)))
    dt = torch.einsum("bgnqcj,bncj->bgnqc", ac,
                      wt.unflatten(-1, (nk // SUM_KEYS, SUM_KEYS)))
    return yt.sum(-2), dt.sum(-1)


def band_attention_fwd_ref(q, k, v, w, *, nr: int,
                           mode: str = "l0_causal") -> Triple:
    """Plain PyTorch band attention of one level in any mode but ``sub``
    (mirror of ``repro.kernels.ops._blocked_jnp``).  q (B,G,L,d)
    pre-scaled, k (B,L,d), v (B,L,dv) pre-weighted, w (B,L)."""
    _check_mode(mode)
    if mode == SUB_MODE:
        raise ValueError("mode 'sub' goes through band_attention_sub_fwd_ref")
    L = q.shape[-2]
    if mode.startswith("l0"):
        _check_length(L, nr, mode)
    band_attention_fwd_ref.calls += 1
    f32 = torch.float32
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
        yt, dt = _band_sums(torch.exp(s - m[..., None]), vt, wt)
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


def last_grid(fn) -> Tuple[Tuple[int, int], ...]:
    """The (x, y) grid of each kernel that a band library's last launch
    ran, as its launcher built it: ``fn`` is the library's
    ``h1d_band_*_last_grid``."""
    g = (ctypes.c_int * 4)()
    fn(ctypes.addressof(g))
    return ((g[0], g[1]),) if g[2] == 0 else ((g[0], g[1]), (g[2], g[3]))


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
    there), or ``h1d_band_fwd_stream`` for the ``l0_causal`` shapes the
    staged body does not take (:func:`check_window_fwd`), counted under
    ``l0_causal_stream``.  ``.mode_launches`` counts the launches per
    mode."""
    if q.device.type == "cpu":
        return band_attention_fwd_ref(q, k, v, w, nr=nr, mode=mode)
    _check_mode(mode)
    if mode == SUB_MODE:
        raise ValueError("mode 'sub' goes through band_attention_sub_fwd")
    B, G, L, d = q.shape
    dv = v.shape[-1]
    body = check_window_fwd(mode, nr, d, dv)
    lib = _lib()
    _check_length(L, nr, mode)
    _build.expect(q, "q", (B, G, L, d))
    _build.expect(k, "k", (B, L, d))
    _build.expect(v, "v", (B, L, dv))
    _build.expect(w, "w", (B, L))
    y, dn, m = _outputs(q, dv)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            y.data_ptr(), dn.data_ptr(), m.data_ptr())
    if body == "stream":
        _build.check(lib.h1d_band_fwd_stream(
            *ptrs, B, G, L, d, dv, nr, _build.stream()),
            "h1d_band_fwd_stream")
        key = "l0_causal_stream"
    else:
        _build.check(lib.h1d_band_fwd(
            *ptrs, B, G, L, d, dv, nr, _MODE_CODES[mode], _build.stream()),
            "h1d_band_fwd")
        key = mode
    band_attention_fwd.launches += 1
    counts = band_attention_fwd.mode_launches
    counts[key] = counts.get(key, 0) + 1
    if contracts.ACTIVE:
        contracts.record(contracts.band_fwd(
            q, k, v, w, nr=nr, mode=mode, body=body,
            grid=last_grid(lib.h1d_band_fwd_last_grid)))
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
    if contracts.ACTIVE:
        contracts.record(contracts.sub_fwd(
            q, k, v, w, nr=nr, ratio=ratio,
            grid=last_grid(lib.h1d_band_fwd_last_grid)))
    return y, dn, m


band_attention_sub_fwd.launches = 0
