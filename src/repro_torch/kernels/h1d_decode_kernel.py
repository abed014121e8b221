"""Single-token decode on the hierarchical KV cache: plain versions and
CUDA kernel wrappers.

Port of the decode kernels of ``repro.kernels.h1d_decode_kernel``:

* :func:`decode_attend_fused` -- every cache row ``r`` (slots x kv-heads)
  attends, at its position ``t[r]``, its own level-0 block (causal), the
  previous level-0 block and one coarse block ``I_l - 1`` per level under
  the quadrant mask, with weight ``2**l`` in the denominator only; one
  max over all bands.  Returns the normalised (R, G, Dv) in ``q.dtype``.
* :func:`update_cache_fused` -- appends one token: the level-l ancestor
  row ``t >> l`` becomes the pairwise mean (k) or sum (v) of its updated
  children, for every level.  Updates the cache IN PLACE (the JAX
  version returns a new cache; PyTorch lets the port save the copy) and
  returns it.
* :func:`decode_attend_paged` / :func:`update_cache_paged` -- the same
  bodies over a paged pool (``core.h1d_decode.PagedH1DCache``): block
  reads come from the page table ``bidx`` (R, 2 + levels), the sibling
  pair of level l from page ``utab[r, l]`` at in-page pair
  ``(t >> (l+1)) & (nr/2 - 1)``.
* :func:`decode_attend_paged_quant` / :func:`update_cache_paged_quant`
  -- the int8 pool (``QuantPagedH1DCache``): rows dequantized with their
  per-row scales before the band math; the update dequantizes the pair,
  puts in the new row and requantizes both rows in place with fresh
  absmax scales, carrying the f32 pair before quantization upward.
  float32 or bfloat16 levels of a mixed pool leave their scales
  untouched.
* :func:`decode_attend_partial` / :func:`update_cache_partial` -- the
  dense bodies on ONE shard's slab of a sequence-sharded cache
  (``parallel.sp_attention``): the attend reads each band's block at the
  shard-local index ``bidx[r, band]`` (its level array holds that
  level's local rows), masks the bands the shard does not own and
  returns the unnormalised partial ``(num, den, m)`` for the cross-shard
  merge; the update writes only the rows the shard owns, at the
  shard-local position ``t_loc``, and returns the carried row of the
  first replicated level.

Each wrapper chooses by the device of its tensors: CPU tensors take the
plain version (mirrors of the jnp paths of ``core.h1d_decode``), CUDA
tensors launch the kernels in ``csrc/h1d_decode.cu``.  All four attends
(#5, #7, #8, #11) run its staged attend body, which copies only the rows
each band's mask lets through (:func:`attend_band_rows`; #5 of the block
:func:`attend_dense_blocks` names) into shared memory, laid out by
:func:`plan_attend_stages` (int8 rows with their scales, dequantized on
the read); #10 stages every level's sibling pair before its carry chain
(:func:`update_quant_smem`), and #6, #12 and #9 put every level's pair
in flight before theirs (any widths and level counts: no new limit).
Caches are float32 or bfloat16 (:data:`CACHE_DTYPES`; an int8 pool's
other levels are one of the two), as the reference keeps them in the
model's dtype.  The updates follow the reference's Pallas
update: one unrounded f32 carry chain, each stored row rounded to the
cache dtype (its jnp path rounds every level before averaging, 1-2 bf16
ulps apart from level 2 up; in fp32 the two agree bit for bit).  The
attends widen every row to f32; q, k_new and v_new are widened by the
wrappers, and an attend returns ``q.dtype`` where the reference does.
``<wrapper>.launches`` counts kernel launches (launches on bf16 levels
also under ``<wrapper>.mode_launches["bf16"]``) and ``<plain>.calls``
counts runs of the plain version; while a hook or a capture of
``analysis.contracts`` is open, a launch also hands over its record
(grid (R,): one CTA a row).  The page tables and the shard
geometry are trusted: the host builds them from
``serve.paged_cache.PagePool`` and ``parallel.sp_attention.sp_tables``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..analysis import contracts
from ..core import hierarchy as hc
from ..core import quantization as qz
from . import _build, tuning

_MIN_M = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_F = ctypes.c_float
# every entry point but the plan's ends in (..., half, stream):
# half = 1 where the cache levels hold bfloat16
_SIGNATURES = {
    "h1d_decode_attend": [_P, _P, _P, _PP, _PP, _P, _P] + [_I] * 7
                         + [_F, _I, _I, _P],
    "h1d_decode_attend_paged": [_P, _PP, _PP, _P, _P, _P] + [_I] * 6
                               + [_F, _I, _I, _P],
    "h1d_decode_attend_paged_quant": [_P, _PP, _PP, _PP, _PP, _I, _P, _P,
                                      _P] + [_I] * 6 + [_F, _I, _I, _P],
    "h1d_update_cache": [_P, _P, _P, _PP, _PP] + [_I] * 6 + [_P],
    "h1d_update_cache_paged": [_P, _P, _P, _P, _PP, _PP] + [_I] * 6 + [_P],
    "h1d_update_cache_paged_quant": [_P, _P, _P, _P, _PP, _PP, _PP, _PP]
                                    + [_I] * 7 + [_P],
    "h1d_decode_attend_partial": [_P, _PP, _PP] + [_P] * 7 + [_I] * 6
                                 + [_F, _I, _I, _P],
    "h1d_update_cache_partial": [_P, _P, _P, _P, _PP, _PP, _P, _P]
                                + [_I] * 6 + [_P],
    "h1d_decode_attend_plan": [_I] * 7 + [_P],
    "h1d_decode_last_grid": [_P],
    **_build.launch_signatures("h1d_decode"),
}

#: cache element types the kernels take (``half`` = 1 for bfloat16); an
#: int8 pool's other levels are one of them
CACHE_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    return _build.library("h1d_decode", _SIGNATURES)


def _ptrs(tensors):
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


# ---------------------------------------------------------------------------
# the staged attend's geometry (#5, #7, #8, #11) and #10's staging: host
# mirrors of csrc/h1d_decode.cu
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448      # shared memory one block may use on the H100
_THREADS = 256


def attend_band_rows(t, nr: int, nbands: int, owned=None, quantum: int = 1):
    """Rows of each band that the staged attend copies for rows at
    positions ``t`` (R,): the prefix of the band's ``nr`` rows whose keys
    the decode masks let through (``band_rows`` in the source: band 0 the
    rows up to ``t % nr``; band 1 all once ``t >= nr``; coarse band
    ``l + 1`` none before ``t >= nr << l``, then the first half while
    ``t`` is in the first half of its span, else all), 0 where ``owned``
    (R, nbands) is not set, rounded up to ``quantum`` rows.  Every key
    outside these prefixes has weight exactly 0.  Returns an (R, nbands)
    int64 numpy array."""
    t = np.asarray(t, np.int64)[:, None]
    rows = np.zeros((t.shape[0], nbands), np.int64)
    rows[:, :1] = t % nr + 1
    if nbands > 1:
        rows[:, 1:2] = np.where(t // nr >= 1, nr, 0)
    for band in range(2, nbands):
        span = nr << (band - 1)
        rows[:, band:band + 1] = np.where(
            t // span < 1, 0, np.where(t % span < span // 2, nr // 2, nr))
    if owned is not None:
        rows = np.where(np.asarray(owned) > 0, rows, 0)
    return np.where(rows > 0, np.minimum(nr, -(-rows // quantum) * quantum),
                    0)


def attend_dense_blocks(t, nr: int, Lmax: int, nbands: int):
    """Block of each band that #5 stages for rows at positions ``t`` (R,)
    of dense slabs (``dense_block`` in the source): the reference
    kernel's index maps, band 0 ``min(t // nr, Lmax // nr - 1)``, band 1
    ``max(t // nr - 1, 0)``, coarse band ``l + 1`` ``clip(t // (nr << l)
    - 1, 0, (Lmax >> l) // nr - 1)``; its first row in the level's
    (R, Lmax >> l, width) array is ``r * (Lmax >> l) + block * nr``.
    Returns an (R, nbands) int64 numpy array."""
    t = np.asarray(t, np.int64)[:, None]
    blk = np.zeros((t.shape[0], nbands), np.int64)
    blk[:, :1] = np.minimum(t // nr, Lmax // nr - 1)
    if nbands > 1:
        blk[:, 1:2] = np.maximum(t // nr - 1, 0)
    for band in range(2, nbands):
        l = band - 1
        blk[:, band:band + 1] = np.clip(t // (nr << l) - 1, 0,
                                        (Lmax >> l) // nr - 1)
    return blk


def update_pair_index(t, rows: int, level: int):
    """Sibling pair of a level of ``rows`` rows that an update at
    position ``t`` writes (``dense_pair`` in the source, shared by #6 and
    #12, and by the plain versions' ancestor walk): ancestor ``t >>
    level`` sits in pair ``min(t >> (level + 1), rows // 2 - 1)``, floored
    at 0, at row ``(t >> level) & 1`` of it.  ``t`` may be an array; a
    shard's slab takes its local position and rows.  Returns int64."""
    t = np.asarray(t, np.int64)
    return np.maximum(np.minimum(t >> (level + 1), rows // 2 - 1), 0)


class AttendStages(NamedTuple):
    stages: int          # ring slots (2 (nlev + 1) when all bands fit)
    chunk_rows: int      # rows a slot holds
    quantum: int         # staged rows are rounded up to a multiple
    smem: int            # shared memory bytes of one CTA
    resident: bool       # every band's keys and values staged at once


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _slot(cr, D, Dv, quant):
    """Floats of one ring slot: ``cr`` f32 rows, or (``quant``) at least
    an int8 block's ``cr`` scales and, 16-byte aligned after them, its
    int8 rows."""
    slot = _ceil_to(cr * max(D, Dv), 4)
    if quant:
        slot = max(slot, _ceil_to(cr, 4) + _ceil_to(-(-cr * max(D, Dv) // 4),
                                                     4))
    return slot


def _rows16(W: int) -> int:
    """Rows of W int8 values whose bytes are a multiple of 16."""
    q = 1
    while (q * W) % 16:
        q *= 2
    return q


def _attend_smem(G, D, Dv, nr, nlev, stages, cr, quant=False):
    """``attend_layout``'s sum: mbarriers, the ring, the scaled query (G
    rounded up to 4 groups past 1), scores, each warp's output partial,
    each group's max per warp and each warp's denominator (both 16-byte
    aligned), the live-band table."""
    nb = nlev + 1
    warps = _THREADS // 32
    gq = 1 if G == 1 else _ceil_to(G, 4)
    slot = _slot(cr, D, Dv, quant)
    off = _ceil_to(8 * stages, 16) + 4 * (stages * slot + gq * D + G * nb * nr)
    off = _ceil_to(_ceil_to(off, 16) + 4 * warps * G * Dv, 16)
    return off + 4 * (2 * warps * G + 6 * (nb + 1) + 3)


def attend_quantum(D: int, Dv: int, nr: int, quant: bool = False,
                   half: bool = False) -> int:
    """Rows a staged band is rounded up to, so that every bulk copy is a
    multiple of 16 bytes: f32 levels 4 where D or Dv is not a multiple of
    4 (and nr is), else 1; bf16 levels (``half``) the rows whose 2D- and
    2Dv-byte rows fill 16 bytes (1 where D and Dv are multiples of 8); a
    pool with int8 levels (``quant``) the rows whose 4-byte scales and D-
    and Dv-byte int8 rows all fill 16 bytes (4 at D = 64), which its f32
    or bf16 levels' rows fill too; each 1 where nr is not a multiple of it
    (no bulk copies then)."""
    if quant:
        q = max(4, _rows16(D), _rows16(Dv))
        return 1 if nr % q else q
    if half:
        q = max(_rows16(2 * D), _rows16(2 * Dv))
        return 1 if nr % q else q
    return 1 if (D % 4 == 0 and Dv % 4 == 0) or nr % 4 else 4


def attend_chunks(nr: int, quantum: int):
    """Rows a ring stage may hold: nr halved while a multiple of the row
    quantum (``attend_plan``'s walk)."""
    out, cr = [], nr
    while cr >= 1 and cr % quantum == 0:
        out.append(cr)
        if cr % 2:
            break
        cr //= 2
    return out


def plan_attend_stages(G: int, D: int, Dv: int, nr: int, nlev: int,
                       quant: bool = False, half: bool = False,
                       cr: int = None) -> AttendStages:
    """The staged attend's launch plan, as ``attend_plan`` in
    ``csrc/h1d_decode.cu`` computes it (``quant``: the pool has int8
    levels; ``half``: its other levels are bf16, staged in the slots f32
    rows take, so only the quantum changes): every band's keys and values
    resident (2 (nlev + 1) slots of nr rows) where that fits in
    :data:`SMEM_LIMIT`; else a ring of as many slots as fit, its chunks
    halved from nr rows while fewer than 2 fit (never below
    :func:`attend_quantum`).  Raises ``ValueError`` with the sizes where
    not even one chunk fits.  ``cr`` (the launch policy's choice,
    ``tuning``) forces the rows a chunk: resident where ``cr = nr`` and
    every band fits, else a ring of as many stages as fit; ``stages = 0``
    where none does or ``cr`` is not one of :func:`attend_chunks`."""
    nb = nlev + 1
    quantum = attend_quantum(D, Dv, nr, quant, half)
    smem = _attend_smem(G, D, Dv, nr, nlev, 2 * nb, nr, quant)
    if cr:
        if cr not in attend_chunks(nr, quantum):
            return AttendStages(0, cr, quantum, smem, False)
        if cr == nr and smem <= SMEM_LIMIT:
            return AttendStages(2 * nb, nr, quantum, smem, True)
        S = _ring_stages(G, D, Dv, nr, nlev, cr, quant)
        return AttendStages(S, cr, quantum, _attend_smem(
            G, D, Dv, nr, nlev, S, cr, quant), False)
    if smem <= SMEM_LIMIT:
        return AttendStages(2 * nb, nr, quantum, smem, True)
    cr = nr
    while True:
        S = _ring_stages(G, D, Dv, nr, nlev, cr, quant)
        if S >= 2 or cr % 2 or (cr // 2) % quantum:
            break
        cr //= 2
    if S < 1:
        raise ValueError(
            f"decode attend: G={G}, D={D}, Dv={Dv}, nr={nr}, {nlev} levels "
            f"need {_attend_smem(G, D, Dv, nr, nlev, 1, cr, quant)} bytes of "
            f"shared memory with one {cr}-row stage; the H100 gives "
            f"{SMEM_LIMIT}")
    return AttendStages(S, cr, quantum, _attend_smem(G, D, Dv, nr, nlev, S,
                                                     cr, quant), False)


def _ring_stages(G, D, Dv, nr, nlev, cr, quant):
    """Stages of ``cr`` rows that fit beside the rest of the plan."""
    most = 2 * (nlev + 1) * -(-nr // cr)
    fixed = _attend_smem(G, D, Dv, nr, nlev, 0, cr, quant)
    per = 4 * _slot(cr, D, Dv, quant) + 8
    S = 0 if fixed > SMEM_LIMIT else min(most, (SMEM_LIMIT - fixed) // per)
    while S > 0 and _attend_smem(G, D, Dv, nr, nlev, S, cr,
                                 quant) > SMEM_LIMIT:
        S -= 1
    return S


UPDATE_MAX_WIDTH = 1024     # #10: 32 columns a lane of a chain's warp
#: #10's threads: a warp a chain, 4 chains (``UPD_PARTS``) a CTA
UPDATE_QUANT_THREADS = 256
#: #6, #9, #12: shared memory their staging may take (``CHAIN_SMEM``)
CHAIN_SMEM = 48 * 1024


def update_chain_plan(D: int, Dv: int, nlev: int, paged: bool = False):
    """(threads, shared memory bytes) of #6, #9 and #12 (``launch_chain``
    in the source): a column a thread, at most 1024 and as many as
    CHAIN_SMEM stages (2 nlev floats a thread, after #9's page table row
    of nlev ints), in whole warps."""
    tab = 4 * nlev if paged else 0
    fit = (CHAIN_SMEM - tab) // (8 * nlev) // 32 * 32
    threads = min(1024, fit, -(-(D + Dv) // 32) * 32)
    return threads, 8 * nlev * threads + tab


def update_quant_smem(D: int, Dv: int, qmask: int, nlev: int,
                      half: bool = False) -> int:
    """Shared memory #10 takes for one cache row (``chain_bytes`` in the
    source): per level its k pair and its v pair as staged, two rows of
    int8, f32 or (``half``) bf16 values each; an int8 level (bit l of
    ``qmask``) also the two staged scales, the f32 pair once the carry is
    put in and each lane's absmax of both rows (2 x 32 floats); every
    part 16-byte aligned."""
    def pair(W, q8):
        return (_ceil_to(2 * W, 16) + 16 + _ceil_to(8 * W, 16) + 256 if q8
                else _ceil_to((4 if half else 8) * W, 16))
    return sum(pair(D, qmask >> l & 1) + pair(Dv, qmask >> l & 1)
               for l in range(nlev))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _block_read_rows(arr, blk, size):
    """Per-row block read: arr (R, L, D), blk (R,) -> (R, size, D)."""
    R, L, D = arr.shape
    rows = torch.arange(R, device=arr.device)
    return arr.reshape(R, L // size, size, D)[rows, blk]


def _work_dtype(x):
    """float32, or float64 for float64 operands (the plain versions
    evaluated exactly, as tests of ill-conditioned inputs need)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _attend_bands(q, t, nr: int, nbands: int, read, softmax_scale,
                  owned=None):
    """The band math shared by every plain attend: ``read(band)`` gives
    the band's keys (R, nr, D) and values (R, nr, Dv) in ``q``'s working
    dtype; masks and weights depend on ``t`` alone.  With ``owned`` (R,
    nbands) each band is also masked by its ownership bit and the
    unnormalised ``(num, den, m)`` are returned instead of the output."""
    f32 = _work_dtype(q)
    R, G, D = q.shape
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    qs = q.to(f32) * scale
    t = t.to(torch.long)
    dev = q.device
    j = torch.arange(nr, device=dev)
    blk0 = torch.div(t, nr, rounding_mode="floor")
    ones = torch.ones((R, nr), dtype=f32, device=dev)

    logits, values, weights = [], [], []
    for band in range(nbands):
        keys, vals = read(band)
        if band == 0:          # own level-0 block, causal within the block
            mask, wgt = blk0[:, None] * nr + j[None, :] <= t[:, None], ones
        elif band == 1:        # previous level-0 block
            mask, wgt = (blk0 >= 1)[:, None].expand(R, nr), ones
        else:                  # coarse level l: block I_l - 1, quadrant mask
            l = band - 1
            span = nr << l
            Il = torch.div(t, span, rounding_mode="floor")
            first_half_q = (t % span) < (span // 2)
            key_last_half = j >= nr // 2
            mask = (Il >= 1)[:, None] & ~(first_half_q[:, None]
                                          & key_last_half[None, :])
            wgt = torch.full((R, nr), float(1 << l), dtype=f32, device=dev)
        if owned is not None:
            mask = mask & (owned[:, band] > 0)[:, None]
        s = torch.einsum("bgd,bkd->bgk", qs, keys)
        logits.append(torch.where(mask[:, None, :], s, hc.NEG_INF))
        values.append(vals)
        weights.append(torch.where(mask, wgt, 0.0))

    s = torch.cat(logits, dim=-1)                      # (R, G, K)
    vcat = torch.cat(values, dim=-2)                   # (R, K, Dv)
    wcat = torch.cat(weights, dim=-1)                  # (R, K)
    m = torch.clamp(s.amax(-1, keepdim=True), min=_MIN_M)
    a = torch.exp(s - m)
    num = torch.einsum("bgk,bkv->bgv", a, vcat)
    den = torch.einsum("bgk,bk->bg", a, wcat)
    if owned is not None:
        return num, den, m[..., 0]
    return (num / torch.clamp(den, min=1e-9)[..., None]).to(q.dtype)


def decode_attend_ref(cache, q, t, *, nr: int, softmax_scale=None):
    """Plain PyTorch batched single-token attention (mirror of the jnp
    path of ``repro.core.h1d_decode.decode_attend``).  q (R, G, D), t
    (R,) positions.  Returns (R, G, Dv) in q.dtype (float64 operands are
    evaluated in float64)."""
    decode_attend_ref.calls += 1
    f32 = _work_dtype(q)
    t = t.to(torch.long)
    M = hc.num_levels(cache.k.shape[-2], nr)

    def read(band):
        if band < 2:
            blk = torch.div(t, nr, rounding_mode="floor")
            if band == 1:
                blk = torch.clamp(blk - 1, min=0)
            else:           # the kernels' clamp of an out-of-range t
                blk = torch.clamp(blk, max=cache.k.shape[-2] // nr - 1)
            k, v = cache.k, cache.v
        else:
            l = band - 1
            blk = torch.clamp(torch.div(t, nr << l, rounding_mode="floor")
                              - 1, min=0)
            k, v = cache.ck[l - 1], cache.cv[l - 1]
        return (_block_read_rows(k, blk, nr).to(f32),
                _block_read_rows(v, blk, nr).to(f32))

    return _attend_bands(q, t, nr, 2 + max(M - 1, 0), read, softmax_scale)


decode_attend_ref.calls = 0


def _carry_pair(carry, stored, sel):
    """One level of the f32 carry chain: the sibling pair (R, 2, W) as
    the reference's Pallas update holds it, widened, with the carry in
    row ``sel`` (R,) (2: in neither).  Returns (row 0, row 1)."""
    stored = stored.to(carry.dtype)
    return (torch.where((sel == 0)[:, None], carry, stored[:, 0]),
            torch.where((sel == 1)[:, None], carry, stored[:, 1]))


def _update_pairs(cache, k_new, v_new, t, owned=None):
    """The ancestor walk shared by the plain dense updates, in place, in
    the reference's Pallas numerics (``_update_kernel``): one unrounded
    f32 carry chain, each stored row rounded to the cache dtype.  At
    level l the token's ancestor ``t >> l`` sits in sibling pair
    ``min(t >> (l+1), npairs - 1)`` (the kernels' clamp, so an
    out-of-range ``t`` writes the last pair as they do) at row ``(t >>
    l) & 1``; the next level's carry is the f32 pair's mean (k) or sum
    (v).  With ``owned`` (R,) only its nonzero rows write (a non-owner
    carries its pair as stored), and the carry past the last level is
    returned in f32."""
    R = k_new.shape[0]
    rows = torch.arange(R, device=k_new.device)
    t = t.to(torch.long)
    own = None if owned is None else (owned != 0)
    f32 = _work_dtype(cache.k)
    carry_k, carry_v = k_new.to(f32), v_new.to(f32)
    nlev = 1 + len(cache.ck)
    for l, (k, v) in enumerate(zip((cache.k, *cache.ck),
                                   (cache.v, *cache.cv))):
        lo = 2 * torch.clamp(t >> (l + 1), max=k.shape[1] // 2 - 1)
        sel = (t >> l) & 1
        if own is not None:        # a non-owner puts no row in its pair
            sel = torch.where(own, sel, 2)
        pair = torch.stack((lo, lo + 1), dim=1)
        k0, k1 = _carry_pair(carry_k, k[rows[:, None], pair], sel)
        v0, v1 = _carry_pair(carry_v, v[rows[:, None], pair], sel)
        w = rows if own is None else rows[own]
        row = (lo + sel.clamp(max=1))[w]
        pick = (sel[w] == 1)[:, None]
        k[w, row] = torch.where(pick, k1[w], k0[w]).to(k.dtype)
        v[w, row] = torch.where(pick, v1[w], v0[w]).to(v.dtype)
        if owned is not None or l + 1 < nlev:
            carry_k = (k0 + k1) * 0.5                       # Eq. 25/26
            carry_v = v0 + v1                               # Eq. 27
    return carry_k, carry_v


def update_cache_ref(cache, k_new, v_new, t):
    """Plain PyTorch ancestor update, in place (mirror of the jnp
    ``repro.core.h1d_decode._update_one`` over rows, with the kernels'
    pair clamp).  k_new (R, D), v_new (R, Dv), t (R,) positions."""
    update_cache_ref.calls += 1
    _update_pairs(cache, k_new, v_new, t)
    return cache


update_cache_ref.calls = 0


def decode_attend_partial_ref(cache, q, t, bidx, owned, *, nr: int,
                              softmax_scale=None):
    """Plain partial attention on one shard's slab (mirror of
    ``repro.kernels.h1d_decode_kernel._attend_partial_kernel``).  Level l
    of ``cache`` holds that level's local rows; band ``b`` reads block
    ``bidx[:, b]`` of its level (band 0/1 the fine level, band ``b >= 2``
    coarse level ``b - 1``) and counts only where ``owned[:, b]`` is set;
    ``t`` (R,) stays global.  Returns float32 ``(num (R, G, Dv), den (R,
    G), m (R, G))``, ``m`` floored at -1e30."""
    decode_attend_partial_ref.calls += 1
    f32 = _work_dtype(q)
    ks, vs = (cache.k, *cache.ck), (cache.v, *cache.cv)
    bidx = bidx.to(torch.long)

    def read(band):
        l = max(band - 1, 0)
        return (_block_read_rows(ks[l], bidx[:, band], nr).to(f32),
                _block_read_rows(vs[l], bidx[:, band], nr).to(f32))

    return _attend_bands(q, t, nr, 1 + len(ks), read, softmax_scale,
                         owned=owned)


decode_attend_partial_ref.calls = 0


def update_cache_partial_ref(cache, k_new, v_new, t_loc, owned):
    """Plain partial ancestor update on one shard's sharded levels, in
    place (mirror of ``_update_partial_kernel``): only rows with
    ``owned != 0`` write, at the shard-local ``t_loc`` (the pair index
    clamps, the sibling parity keeps the unclamped bits).  Returns
    ``(cache, carry_k (R, D), carry_v (R, Dv))``, the pair mean / sum
    past the last level (from the unchanged pair on non-owner rows),
    rounded to the cache dtype as the reference's kernel stores it."""
    update_cache_partial_ref.calls += 1
    carry_k, carry_v = _update_pairs(cache, k_new, v_new, t_loc, owned)
    return cache, carry_k.to(cache.k.dtype), carry_v.to(cache.v.dtype)


update_cache_partial_ref.calls = 0


def pool_levels(pool):
    """Per level l = 0..M-1 of a paged pool: (k, v, k scales, v scales),
    the scales None for an fp32 level (never read, never written)."""
    ks, vs = [pool.k, *pool.ck], [pool.v, *pool.cv]
    if not hasattr(pool, "ksc"):
        return [(k, v, None, None) for k, v in zip(ks, vs)]
    kscs, vscs = [pool.ksc, *pool.cksc], [pool.vsc, *pool.cvsc]
    return [(k, v, ksc, vsc) if k.dtype == torch.int8 else (k, v, None, None)
            for k, v, ksc, vsc in zip(ks, vs, kscs, vscs)]


def _paged_attend_ref(pool, q, t, bidx, nr, softmax_scale):
    f32 = _work_dtype(q)
    lv = pool_levels(pool)
    bidx = bidx.to(torch.long)

    def deq(arr, sc, idx):
        x = arr[idx].to(f32)
        return x if sc is None else x * sc[idx][..., None]

    def read(band):
        k, v, ksc, vsc = lv[0 if band < 2 else band - 1]
        idx = bidx[:, band]
        return deq(k, ksc, idx), deq(v, vsc, idx)

    return _attend_bands(q, t, nr, 1 + len(lv), read, softmax_scale)


def decode_attend_paged_ref(pool, q, t, bidx, *, nr: int,
                            softmax_scale=None):
    """Plain paged attention (mirror of the jnp path of
    ``repro.core.h1d_decode.decode_attend_paged``): the dense bands with
    block reads through ``bidx`` (R, 2 + levels)."""
    decode_attend_paged_ref.calls += 1
    return _paged_attend_ref(pool, q, t, bidx, nr, softmax_scale)


decode_attend_paged_ref.calls = 0


def decode_attend_paged_quant_ref(pool, q, t, bidx, *, nr: int,
                                  softmax_scale=None):
    """Plain quantized paged attention (mirror of
    ``repro.core.h1d_decode._decode_attend_paged_quant_jnp``): each
    gathered int8 row times its per-row scale, then the fp32 bands."""
    decode_attend_paged_quant_ref.calls += 1
    return _paged_attend_ref(pool, q, t, bidx, nr, softmax_scale)


decode_attend_paged_quant_ref.calls = 0


def update_cache_paged_ref(pool, k_new, v_new, t, utab):
    """Plain paged ancestor update, in place, in the numerics of the
    reference's Pallas ``update_cache_paged`` (one f32 carry chain, each
    stored row rounded to the pool dtype; in fp32 the jnp path's bits).
    k_new (R, D), v_new (R, Dv), t (R,), utab (R, 1 + levels): level l's
    pair on page ``utab[:, l]`` at rows ``((t >> l) % nr) & ~1`` and the
    one after."""
    update_cache_paged_ref.calls += 1
    t = t.to(torch.long)
    utab = utab.to(torch.long)
    nr = pool.k.shape[-2]
    f32 = _work_dtype(pool.k)
    carry_k, carry_v = k_new.to(f32), v_new.to(f32)
    two = torch.arange(2, device=t.device)
    for l, (k, v) in enumerate(zip((pool.k, *pool.ck), (pool.v, *pool.cv))):
        page = utab[:, l]
        row = (t >> l) % nr
        sel = (t >> l) & 1
        pair = (row & ~1)[:, None] + two[None, :]
        k0, k1 = _carry_pair(carry_k, k[page[:, None], pair], sel)
        v0, v1 = _carry_pair(carry_v, v[page[:, None], pair], sel)
        k[page, row] = carry_k.to(k.dtype)
        v[page, row] = carry_v.to(v.dtype)
        carry_k = (k0 + k1) * 0.5                           # Eq. 25/26
        carry_v = v0 + v1                                   # Eq. 27
    return pool


update_cache_paged_ref.calls = 0


def update_cache_paged_quant_ref(pool, k_new, v_new, t, utab):
    """Plain quantized paged update, in place (mirror of
    ``repro.core.h1d_decode._update_cache_paged_quant_jnp``, and of the
    reference's Pallas ``_update_paged_quant_kernel``): every level
    rewrites its whole sibling pair -- dequantize, put in the new row,
    requantize both rows with fresh per-row scales -- and carries the f32
    pair before quantization (mean for k, sum for v).  Levels that are
    not int8 (float32, or bfloat16) write the pair rounded to their dtype
    and leave their scales untouched; the carry stays unrounded f32
    through every level."""
    update_cache_paged_quant_ref.calls += 1
    f32 = torch.float32
    t = t.to(torch.long)
    utab = utab.to(torch.long)
    nr = pool.k.shape[-2]
    R = t.shape[0]
    two = torch.arange(2, device=t.device)
    carry_k, carry_v = k_new.to(f32), v_new.to(f32)
    for l, (k, v, ksc, vsc) in enumerate(pool_levels(pool)):
        page = utab[:, l, None].expand(R, 2)
        rows2 = (((t >> l) % nr) & ~1)[:, None] + two[None, :]     # (R, 2)
        pk = k[page, rows2].to(f32)                              # (R, 2, D)
        pv = v[page, rows2].to(f32)
        if ksc is not None:
            pk = pk * ksc[page, rows2][..., None]
            pv = pv * vsc[page, rows2][..., None]
        sel = (two[None, :] == ((t >> l) & 1)[:, None])[..., None]
        pk = torch.where(sel, carry_k[:, None, :], pk)
        pv = torch.where(sel, carry_v[:, None, :], pv)
        if ksc is not None:
            qk, sk = qz.quantize_int8(pk, axis=-1)
            qv, sv = qz.quantize_int8(pv, axis=-1)
            k[page, rows2], v[page, rows2] = qk, qv
            ksc[page, rows2], vsc[page, rows2] = sk[..., 0], sv[..., 0]
        else:
            k[page, rows2] = pk.to(k.dtype)
            v[page, rows2] = pv.to(v.dtype)
        carry_k = (pk[:, 0] + pk[:, 1]) * 0.5
        carry_v = pv[:, 0] + pv[:, 1]
    return pool


update_cache_paged_quant_ref.calls = 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _elem(dtype, what: str) -> int:
    """``half`` for a cache element type the kernels take; raises for
    any other."""
    if dtype not in CACHE_DTYPES:
        raise ValueError(f"{what}: the decode kernels take float32 or "
                         f"bfloat16 caches, got {dtype}")
    return int(dtype == torch.bfloat16)


def _f32(x):
    """A kernel operand widened to float32 (exact from bfloat16)."""
    return x.to(torch.float32).contiguous()


def _count(wrapper, half: int) -> None:
    """One launch of ``wrapper``; a launch on bf16 levels also counts
    under ``mode_launches["bf16"]`` (its own row on the card)."""
    wrapper.launches += 1
    if half:
        wrapper.mode_launches["bf16"] = (
            wrapper.mode_launches.get("bf16", 0) + 1)


def _attend_tile(family, G, D, Dv, nr, nlev, quant, half):
    """The launch policy's plan of a staged attend (``tuning``): its
    config and the chunk rows the launcher takes (0: its own rule, which
    the default mirrors; :func:`plan_attend_stages` raises where no plan
    fits)."""
    cfg, src = tuning.get_policy().resolve(
        family, G=G, d=D, dv=Dv, nr=nr, levels=nlev, quant=quant,
        dtype="bfloat16" if half else "float32")
    return cfg, 0 if src == "default" else cfg["cr"]


def _update_tile(family, R, D, Dv, nlev, half):
    cfg, _ = tuning.get_policy().resolve(
        family, rows=R, d=D, dv=Dv, levels=nlev,
        dtype="bfloat16" if half else "float32")
    return cfg


def _record_launch(lib):
    """The launcher's grid of the last launch, and (read once per record)
    the shared memory it set, its kernel's registers and CTAs an SM."""
    from .h1d_block import last_grid
    return dict(grid=last_grid(lib.h1d_decode_last_grid),
                attrs=lambda: _build.last_launch(lib, "h1d_decode"))


def _check_cache(cache, R, D, Dv):
    """Validate a dense cache (every level of one element type); returns
    (Lmax, half)."""
    Lmax = cache.k.shape[-2]
    dt = cache.k.dtype
    half = _elem(dt, "cache.k")
    _build.expect(cache.k, "cache.k", (R, Lmax, D), dt)
    _build.expect(cache.v, "cache.v", (R, Lmax, Dv), dt)
    for l, (ckl, cvl) in enumerate(zip(cache.ck, cache.cv), start=1):
        _build.expect(ckl, f"cache.ck[{l - 1}]", (R, Lmax >> l, D), dt)
        _build.expect(cvl, f"cache.cv[{l - 1}]", (R, Lmax >> l, Dv), dt)
    return Lmax, half


def decode_attend_fused(cache, q, t, *, nr: int, softmax_scale=None):
    """Batched single-token attention.  q (R, G, D), t (R,) int32; the
    cache float32 or bfloat16.  CPU tensors take
    :func:`decode_attend_ref`; CUDA tensors launch ``h1d_decode_attend``
    (the staged body; a shape :func:`plan_attend_stages` cannot fit
    raises).  Returns (R, G, Dv) in ``q.dtype``, computed in f32 (a bf16
    q is widened first, as the reference's kernel widens it)."""
    if q.device.type == "cpu":
        return decode_attend_ref(cache, q, t, nr=nr,
                                 softmax_scale=softmax_scale)
    R, G, D = q.shape
    Dv = cache.v.shape[-1]
    Lmax, half = _check_cache(cache, R, D, Dv)
    M = hc.num_levels(Lmax, nr)
    if len(cache.ck) != max(M - 1, 0):
        raise ValueError(f"cache has {len(cache.ck)} coarse levels, "
                         f"Lmax={Lmax} and nr={nr} need {max(M - 1, 0)}")
    qf = _f32(q)
    _build.expect(qf, "q", (R, G, D))
    _build.expect(t, "t", (R,), torch.int32)
    cfg, cr = _attend_tile("decode_attend", G, D, Dv, nr, 1 + len(cache.ck),
                           False, bool(half))
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    out = torch.empty((R, G, Dv), dtype=torch.float32, device=q.device)
    if _build.on_meta((qf, t, cache.k, cache.v, *cache.ck, *cache.cv),
                      contracts.decode_attend, cache, q, t, nr=nr,
                      tile=tuning.tile_of(cfg)):
        return out.to(q.dtype)
    lib = _lib()
    _build.check(lib.h1d_decode_attend(
        qf.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        _ptrs(cache.ck), _ptrs(cache.cv), t.data_ptr(), out.data_ptr(),
        R, G, Lmax, D, Dv, nr, len(cache.ck), float(scale), half, cr,
        _build.stream()), "h1d_decode_attend")
    _count(decode_attend_fused, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_attend(
            cache, q, t, nr=nr, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return out.to(q.dtype)


decode_attend_fused.launches = 0
decode_attend_fused.mode_launches = {}


def update_cache_fused(cache, k_new, v_new, t):
    """In-place cache append.  k_new (R, D), v_new (R, Dv), t (R,) int32;
    the cache float32 or bfloat16 (each stored row rounded to it, the
    carry chain in f32).  CPU tensors take :func:`update_cache_ref`; CUDA
    tensors launch ``h1d_update_cache``.  Returns ``cache``."""
    if k_new.device.type == "cpu":
        return update_cache_ref(cache, k_new, v_new, t)
    R, D = k_new.shape
    Dv = v_new.shape[-1]
    Lmax, half = _check_cache(cache, R, D, Dv)
    k_new, v_new = _f32(k_new), _f32(v_new)
    _build.expect(k_new, "k_new", (R, D))
    _build.expect(v_new, "v_new", (R, Dv))
    _build.expect(t, "t", (R,), torch.int32)
    ks = [cache.k, *cache.ck]
    vs = [cache.v, *cache.cv]
    cfg = _update_tile("decode_update", R, D, Dv, len(ks), half)
    if _build.on_meta((k_new, v_new, t, *ks, *vs), contracts.decode_update,
                      cache, k_new, v_new, t, tile=tuning.tile_of(cfg)):
        return cache
    lib = _lib()
    _build.check(lib.h1d_update_cache(
        k_new.data_ptr(), v_new.data_ptr(), t.data_ptr(), _ptrs(ks),
        _ptrs(vs), R, Lmax, D, Dv, len(ks), half, _build.stream()),
        "h1d_update_cache")
    _count(update_cache_fused, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_update(
            cache, k_new, v_new, t, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return cache


update_cache_fused.launches = 0
update_cache_fused.mode_launches = {}


# ---------------------------------------------------------------------------
# paged kernel wrappers
# ---------------------------------------------------------------------------

def _check_pool(pool, nr: int, D: int, Dv: int, quant: bool):
    """Validate a paged pool's levels; returns (ks, vs, kscs, vscs,
    qmask, half).  Levels of an unquantized pool are all float32 or all
    bfloat16; a quantized pool's levels are int8 (with (NP_l, nr) f32
    scales) or, all of one type, float32 or bfloat16."""
    ks, vs = [pool.k, *pool.ck], [pool.v, *pool.cv]
    if not 1 <= len(ks) <= 32:
        raise ValueError(f"pool has {len(ks)} levels; 1..32 supported")
    kscs = vscs = None
    if quant:
        kscs, vscs = [pool.ksc, *pool.cksc], [pool.vsc, *pool.cvsc]
    plain = [k.dtype for k in ks if not (quant and k.dtype == torch.int8)]
    fdt = plain[0] if plain else torch.float32
    half = _elem(fdt, "pool levels")
    qmask = 0
    for l, (k, v) in enumerate(zip(ks, vs)):
        n = k.shape[0]
        is_q = quant and k.dtype == torch.int8
        dt = torch.int8 if is_q else fdt
        _build.expect(k, f"pool level {l} k", (n, nr, D), dt)
        _build.expect(v, f"pool level {l} v", (n, nr, Dv), dt)
        if is_q:
            qmask |= 1 << l
            _build.expect(kscs[l], f"pool level {l} k scales", (n, nr))
            _build.expect(vscs[l], f"pool level {l} v scales", (n, nr))
    return ks, vs, kscs, vscs, qmask, half


def _attend_paged_launch(fn, family, pool, q, t, bidx, nr, softmax_scale,
                         quant):
    """Validate and launch; returns (out, half, cfg, lib), lib None where
    a meta ``q`` took the meta route (its record handed over)."""
    R, G, D = q.shape
    Dv = pool.v.shape[-1]
    ks, vs, kscs, vscs, qmask, half = _check_pool(pool, nr, D, Dv, quant)
    qf = _f32(q)
    _build.expect(qf, "q", (R, G, D))
    _build.expect(t, "t", (R,), torch.int32)
    _build.expect(bidx, "bidx", (R, 1 + len(ks)), torch.int32)
    cfg, cr = _attend_tile(family, G, D, Dv, nr, len(ks), qmask != 0,
                           bool(half))
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    out = torch.empty((R, G, Dv), dtype=torch.float32, device=q.device)
    if _build.on_meta((qf, t, bidx, *ks, *vs, *(kscs or ()), *(vscs or ())),
                      getattr(contracts, family), pool, q, t, bidx, nr=nr,
                      tile=tuning.tile_of(cfg)):
        return out.to(q.dtype), half, cfg, None
    lib = _lib()
    head = (qf.data_ptr(), _ptrs(ks), _ptrs(vs))
    tail = (t.data_ptr(), bidx.data_ptr(), out.data_ptr(), R, G, D, Dv, nr,
            len(ks), float(scale), half, cr, _build.stream())
    if quant:
        err = lib.h1d_decode_attend_paged_quant(
            *head, _ptrs(kscs), _ptrs(vscs), qmask, *tail)
    else:
        err = lib.h1d_decode_attend_paged(*head, *tail)
    _build.check(err, fn)
    return out.to(q.dtype), half, cfg, lib


def decode_attend_paged(pool, q, t, bidx, *, nr: int, softmax_scale=None):
    """Paged single-token attention.  ``pool`` a ``PagedH1DCache``; q
    (R, G, D), t (R,) int32, bidx (R, 2 + levels) int32.  CPU tensors take
    :func:`decode_attend_paged_ref`; CUDA tensors launch
    ``h1d_decode_attend_paged``."""
    if q.device.type == "cpu":
        return decode_attend_paged_ref(pool, q, t, bidx, nr=nr,
                                       softmax_scale=softmax_scale)
    out, half, cfg, lib = _attend_paged_launch(
        "h1d_decode_attend_paged", "decode_attend_paged", pool, q, t, bidx,
        nr, softmax_scale, quant=False)
    if lib is None:
        return out
    _count(decode_attend_paged, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_attend_paged(
            pool, q, t, bidx, nr=nr, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return out


decode_attend_paged.launches = 0
decode_attend_paged.mode_launches = {}


def decode_attend_paged_quant(pool, q, t, bidx, *, nr: int,
                              softmax_scale=None):
    """Quantized paged attention.  ``pool`` a ``QuantPagedH1DCache``.  CPU
    tensors take :func:`decode_attend_paged_quant_ref`; CUDA tensors
    launch ``h1d_decode_attend_paged_quant``."""
    if q.device.type == "cpu":
        return decode_attend_paged_quant_ref(pool, q, t, bidx, nr=nr,
                                             softmax_scale=softmax_scale)
    out, half, cfg, lib = _attend_paged_launch(
        "h1d_decode_attend_paged_quant", "decode_attend_paged_quant", pool,
        q, t, bidx, nr, softmax_scale, quant=True)
    if lib is None:
        return out
    _count(decode_attend_paged_quant, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_attend_paged_quant(
            pool, q, t, bidx, nr=nr, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return out


decode_attend_paged_quant.launches = 0
decode_attend_paged_quant.mode_launches = {}


def _update_paged_launch(fn, family, pool, k_new, v_new, t, utab, quant):
    """Validate and launch; returns (half, cfg, lib), lib None where a
    meta ``k_new`` took the meta route (its record handed over)."""
    R, D = k_new.shape
    Dv = v_new.shape[-1]
    nr = pool.k.shape[-2]
    ks, vs, kscs, vscs, qmask, half = _check_pool(pool, nr, D, Dv, quant)
    k_new, v_new = _f32(k_new), _f32(v_new)
    _build.expect(k_new, "k_new", (R, D))
    _build.expect(v_new, "v_new", (R, Dv))
    _build.expect(t, "t", (R,), torch.int32)
    _build.expect(utab, "utab", (R, len(ks)), torch.int32)
    if nr < 2 or nr & (nr - 1):
        raise ValueError(f"nr={nr}: pages must hold a power of two >= 2 rows")
    if quant:
        if max(D, Dv) > UPDATE_MAX_WIDTH:
            raise ValueError(f"D={D}, Dv={Dv}: the int8 update takes widths "
                             f"up to {UPDATE_MAX_WIDTH} (32 columns a lane)")
        smem = update_quant_smem(D, Dv, qmask, len(ks), bool(half))
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"D={D}, Dv={Dv}, {len(ks)} levels (int8 mask {qmask:#x}): "
                f"one row's sibling pairs need {smem} bytes of shared "
                f"memory; the H100 gives {SMEM_LIMIT}")
    cfg = _update_tile(family, R, D, Dv, len(ks), half)
    if _build.on_meta((k_new, v_new, t, utab, *ks, *vs, *(kscs or ()),
                       *(vscs or ())), getattr(contracts, family), pool,
                      k_new, v_new, t, utab, tile=tuning.tile_of(cfg)):
        return half, cfg, None
    lib = _lib()
    head = (k_new.data_ptr(), v_new.data_ptr(), t.data_ptr(),
            utab.data_ptr(), _ptrs(ks), _ptrs(vs))
    tail = (R, D, Dv, nr, len(ks))
    if quant:
        err = lib.h1d_update_cache_paged_quant(
            *head, _ptrs(kscs), _ptrs(vscs), qmask, *tail, half,
            _build.stream())
    else:
        err = lib.h1d_update_cache_paged(*head, *tail, half, _build.stream())
    _build.check(err, fn)
    return half, cfg, lib


def update_cache_paged(pool, k_new, v_new, t, utab):
    """In-place paged append.  k_new (R, D), v_new (R, Dv), t (R,) int32,
    utab (R, 1 + levels) int32.  CPU tensors take
    :func:`update_cache_paged_ref`; CUDA tensors launch
    ``h1d_update_cache_paged``.  Returns ``pool``."""
    if k_new.device.type == "cpu":
        return update_cache_paged_ref(pool, k_new, v_new, t, utab)
    half, cfg, lib = _update_paged_launch(
        "h1d_update_cache_paged", "decode_update_paged", pool, k_new, v_new,
        t, utab, quant=False)
    if lib is None:
        return pool
    _count(update_cache_paged, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_update_paged(
            pool, k_new, v_new, t, utab, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return pool


update_cache_paged.launches = 0
update_cache_paged.mode_launches = {}


def update_cache_paged_quant(pool, k_new, v_new, t, utab):
    """In-place quantized paged append.  CPU tensors take
    :func:`update_cache_paged_quant_ref`; CUDA tensors launch
    ``h1d_update_cache_paged_quant``.  Returns ``pool``."""
    if k_new.device.type == "cpu":
        return update_cache_paged_quant_ref(pool, k_new, v_new, t, utab)
    half, cfg, lib = _update_paged_launch(
        "h1d_update_cache_paged_quant", "decode_update_paged_quant", pool,
        k_new, v_new, t, utab, quant=True)
    if lib is None:
        return pool
    _count(update_cache_paged_quant, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_update_paged_quant(
            pool, k_new, v_new, t, utab, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return pool


update_cache_paged_quant.launches = 0
update_cache_paged_quant.mode_launches = {}


# ---------------------------------------------------------------------------
# sequence-parallel kernel wrappers (one shard's slab)
# ---------------------------------------------------------------------------

def decode_attend_partial(cache, q, t, bidx, owned, *, nr: int,
                          softmax_scale=None):
    """Partial attention on one shard's slab.  q (R, G, D), t (R,) int32
    global positions, bidx and owned (R, 2 + levels) int32; level l of
    ``cache`` is (R, rows_l, D/Dv) with rows_l a multiple of nr.  CPU
    tensors take :func:`decode_attend_partial_ref`; CUDA tensors launch
    ``h1d_decode_attend_partial``.  Returns float32 ``(num, den, m)``."""
    if q.device.type == "cpu":
        return decode_attend_partial_ref(cache, q, t, bidx, owned, nr=nr,
                                         softmax_scale=softmax_scale)
    R, G, D = q.shape
    Dv = cache.v.shape[-1]
    ks, vs = [cache.k, *cache.ck], [cache.v, *cache.cv]
    if len(ks) > 32:
        raise ValueError(f"cache has {len(ks)} levels; 1..32 supported")
    dt = cache.k.dtype
    half = _elem(dt, "cache.k")
    rows = []
    for l, (k, v) in enumerate(zip(ks, vs)):
        n = k.shape[1]
        if n < nr or n % nr:
            raise ValueError(f"level {l} holds {n} rows, not a positive "
                             f"multiple of nr={nr}")
        _build.expect(k, f"level {l} k", (R, n, D), dt)
        _build.expect(v, f"level {l} v", (R, n, Dv), dt)
        rows.append(n)
    q = _f32(q)
    _build.expect(q, "q", (R, G, D))
    _build.expect(t, "t", (R,), torch.int32)
    _build.expect(bidx, "bidx", (R, 1 + len(ks)), torch.int32)
    _build.expect(owned, "owned", (R, 1 + len(ks)), torch.int32)
    cfg, cr = _attend_tile("decode_attend_partial", G, D, Dv, nr, len(ks),
                           False, bool(half))
    scale = softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)
    f32 = torch.float32
    num = torch.empty((R, G, Dv), dtype=f32, device=q.device)
    den = torch.empty((R, G), dtype=f32, device=q.device)
    m = torch.empty((R, G), dtype=f32, device=q.device)
    if _build.on_meta((q, t, bidx, owned, *ks, *vs),
                      contracts.decode_attend_partial, cache, q, t, bidx,
                      owned, nr=nr, tile=tuning.tile_of(cfg)):
        return num, den, m
    lib = _lib()
    _build.check(lib.h1d_decode_attend_partial(
        q.data_ptr(), _ptrs(ks), _ptrs(vs), (ctypes.c_int * len(rows))(*rows),
        t.data_ptr(), bidx.data_ptr(), owned.data_ptr(), num.data_ptr(),
        den.data_ptr(), m.data_ptr(), R, G, D, Dv, nr, len(ks), float(scale),
        half, cr, _build.stream()), "h1d_decode_attend_partial")
    _count(decode_attend_partial, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_attend_partial(
            cache, q, t, bidx, owned, nr=nr, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return num, den, m


decode_attend_partial.launches = 0
decode_attend_partial.mode_launches = {}


def update_cache_partial(cache, k_new, v_new, t_loc, owned):
    """In-place partial append on one shard's sharded levels.  k_new (R,
    D), v_new (R, Dv), t_loc and owned (R,) int32.  CPU tensors take
    :func:`update_cache_partial_ref`; CUDA tensors launch
    ``h1d_update_cache_partial``.  Returns ``(cache, carry_k,
    carry_v)``, the carries in the cache dtype."""
    if k_new.device.type == "cpu":
        return update_cache_partial_ref(cache, k_new, v_new, t_loc, owned)
    R, D = k_new.shape
    Dv = v_new.shape[-1]
    Lloc, half = _check_cache(cache, R, D, Dv)
    k_new, v_new = _f32(k_new), _f32(v_new)
    _build.expect(k_new, "k_new", (R, D))
    _build.expect(v_new, "v_new", (R, Dv))
    _build.expect(t_loc, "t_loc", (R,), torch.int32)
    _build.expect(owned, "owned", (R,), torch.int32)
    ks = [cache.k, *cache.ck]
    vs = [cache.v, *cache.cv]
    carry_k = torch.empty((R, D), dtype=cache.k.dtype, device=k_new.device)
    carry_v = torch.empty((R, Dv), dtype=cache.v.dtype, device=k_new.device)
    cfg = _update_tile("decode_update_partial", R, D, Dv, len(ks), half)
    if _build.on_meta((k_new, v_new, t_loc, owned, *ks, *vs),
                      contracts.decode_update_partial, cache, k_new,
                      v_new, t_loc, owned, tile=tuning.tile_of(cfg)):
        return cache, carry_k, carry_v
    lib = _lib()
    _build.check(lib.h1d_update_cache_partial(
        k_new.data_ptr(), v_new.data_ptr(), t_loc.data_ptr(),
        owned.data_ptr(), _ptrs(ks), _ptrs(vs), carry_k.data_ptr(),
        carry_v.data_ptr(), R, Lloc, D, Dv, len(ks), half, _build.stream()),
        "h1d_update_cache_partial")
    _count(update_cache_partial, half)
    if contracts.ACTIVE:
        contracts.record(contracts.decode_update_partial(
            cache, k_new, v_new, t_loc, owned, tile=tuning.tile_of(cfg),
            **_record_launch(lib)))
    return cache, carry_k, carry_v


update_cache_partial.launches = 0
update_cache_partial.mode_launches = {}
