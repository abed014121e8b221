"""Backward of the banded block attention: plain versions and CUDA kernel
wrappers.

Port of ``repro.kernels.h1d_block_bwd`` (Pallas TPU kernels
``band_attention_bwd`` / ``band_attention_sub_bwd``).  Flash-style
recompute: only the forward's inputs ``(q, k, v, w)`` and outputs
``(y, dn, m)`` are saved; the banded scores are recomputed.  Given the
cotangents ``(gy, gdn, gm)`` of ``(y, dn, m)``, per query row ``i``::

    delta_i = gy_i . y_i + gdn_i * dn_i,    gmh_i = gm_i - delta_i
    a_ij    = exp(s_ij - m_i),              da_ij = gy_i . v_j + gdn_i w_j
    ds_ij   = a_ij da_ij + (gmh_i / c_i) 1[s_ij == m_i]
    dq_i = sum_j ds_ij k_j,  dk_j = sum_{g,i} ds_ij q_i,
    dv_j = sum_{g,i} a_ij gy_i,  dw_j = sum_{g,i} a_ij gdn_i

``c_i`` counts the keys of row i's band that tie at the max (JAX's
``reduce_max`` VJP splits the max's cotangent equally among them); the
per-row scale ``gmn_i = gmh_i / c_i`` (0 for a fully masked row) is
returned beside the four gradients.  The kernels find the ties as
``s_ij == m_i``: they recompute ``s`` with the forward's own FMA chain,
so their ``s`` max is ``m`` bit for bit.  The plain versions take the
ties at the row max of their own recomputed scores, which on the CPU
path (plain forward, plain backward) is the saved ``m`` bit for bit too;
handed a kernel forward's ``m``, whose scores another summation order
rounded, they still route the max's cotangent to the row's argmax
instead of dropping it where the two differ in the last bit.  Every mode of the forward:
``band_attention_bwd`` takes the four band modes, ``band_attention_sub_bwd``
the fine-q ``sub`` level.

Each wrapper chooses by the device of its tensors: a CPU tensor takes the
plain PyTorch version (the same block layout and einsums as
``h1d_block.band_attention_fwd_ref`` / ``_sub_fwd_ref``, so its
recomputed scores are bit for bit the plain forward's), a CUDA tensor
launches the kernels in ``csrc/h1d_block_bwd.cu``.  ``<wrapper>.launches``
counts kernel launches and ``<plain>.calls`` runs of the plain version;
while a hook or a capture of ``analysis.contracts`` is open, a launch
also hands over its record (the CUDA grids that the launcher reports,
:func:`h1d_block.last_grid`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..analysis import contracts
from ..core import hierarchy as hc
from . import _build
# the module, not its names: core -> kernels.ops -> here runs while
# h1d_block is still being imported
from . import h1d_block as hb

#: (dq, dk, dv, dw, gmn)
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "h1d_band_bwd": [_P] * 16 + [_I] * 7 + [_P],
    "h1d_band_bwd_last_grid": [_P],
    "h1d_band_bwd_stream": [_P] * 15 + [_I] * 6 + [_P],
    "h1d_band_bwd_stream_smem": [_I] * 4,
    "h1d_band_sub_bwd": [_P] * 15 + [_I] * 8 + [_P],
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _gmh(y, dn, gy, gdn, gm):
    """The cotangent reaching the row max: gm - (gy . y + gdn * dn)."""
    return gm - ((gy * y).sum(-1) + gdn * dn)


def _row_max(scores):
    """The clamped row max over all bands of a row, as the forward forms
    ``m``, from the plain backward's recomputed masked scores."""
    top = scores[0].amax(-1)
    for s in scores[1:]:
        top = torch.maximum(top, s.amax(-1))
    return torch.clamp(top, min=hb._MIN_M)


def _score_grads(s, mb, top, gyb, gdnb, vt, wt):
    """(a, ind, da) of one band from its masked scores, the saved row max
    ``mb`` and the recomputed one ``top`` (where the ties are taken)."""
    a = torch.exp(s - mb[..., None])
    ind = (s == top[..., None]).to(torch.float32)
    da = (torch.einsum("bgnqv,bnkv->bgnqk", gyb, vt)
          + gdnb[..., None] * wt[:, None, :, None, :])
    return a, ind, da


def _row_scale(gmhb, inds):
    """gmn = gmh / c with c the row's tie count over all its bands."""
    count = sum(ind.sum(-1) for ind in inds)
    return torch.where(count > 0, gmhb / torch.clamp(count, min=1.0),
                       torch.zeros_like(gmhb))


def _key_grads(ds, a, qb, gyb, gdnb):
    return (torch.einsum("bgnqk,bgnqd->bnkd", ds, qb),
            torch.einsum("bgnqk,bgnqv->bnkv", a, gyb),
            torch.einsum("bgnqk,bgnq->bnk", a, gdnb))


def band_attention_bwd_ref(q, k, v, w, y, dn, m, gy, gdn, gm, *, nr: int,
                           mode: str = "l0_causal") -> Grads:
    """Plain PyTorch backward of one level in any mode but ``sub``, on
    the block layout of ``band_attention_fwd_ref``: the band of query
    block n is key block n (offset 0), key block n-1 (offset -1) and, in
    a bidirectional mode, key block n+1 (offset +1)."""
    hb._check_mode(mode)
    if mode == hb.SUB_MODE:
        raise ValueError("mode 'sub' goes through band_attention_sub_bwd_ref")
    band_attention_bwd_ref.calls += 1
    f32 = torch.float32
    L = q.shape[-2]
    dev = q.device
    qb = hc.block(q.to(f32), nr)                       # (B,G,NB,nr,d)
    kb = hc.block(k.to(f32), nr)                       # (B,NB,nr,d)
    vb = hc.block(v.to(f32), nr)
    wb = hc.block(w.to(f32), nr, axis=-1)              # (B,NB,nr)
    gyb = hc.block(gy.to(f32), nr)
    gdnb = hc.block(gdn.to(f32), nr, axis=-1)
    mb = hc.block(m, nr, axis=-1)
    gmhb = hc.block(_gmh(y, dn, gy.to(f32), gdn.to(f32), gm.to(f32)), nr,
                    axis=-1)
    nb = qb.shape[-3]
    terms = []
    for offset in hb.band_offsets(mode):
        kt = hc.shift_blocks(kb, offset)
        vt = hc.shift_blocks(vb, offset)
        wt = hc.shift_blocks(wb, offset, block_axis=-2)
        qi = (torch.arange(nr, device=dev)[:, None]
              + torch.arange(nb, device=dev)[:, None, None] * nr)
        ki = qi.transpose(1, 2) + offset * nr
        allow = hb.band_mask(qi, ki, nr, mode, L)
        s = torch.einsum("bgnqd,bnkd->bgnqk", qb, kt)
        allow = allow[None, None] & (wt > 0)[:, None, :, None, :]
        terms.append((offset, kt, vt, wt, torch.where(allow, s, hb.NEG_INF)))
    top = _row_max([t[-1] for t in terms])
    bands = [(offset, kt, *_score_grads(s, mb, top, gyb, gdnb, vt, wt))
             for offset, kt, vt, wt, s in terms]
    gmn = _row_scale(gmhb, [ind for *_, ind, _ in bands])
    dq = dk = dv = dw = None
    for offset, kt, a, ind, da in bands:
        ds = a * da + gmn[..., None] * ind
        dqt = torch.einsum("bgnqk,bnkd->bgnqd", ds, kt)
        # key block n+offset fed query block n: shift its gradient back
        dkt, dvt, dwt = (hc.shift_blocks(t, -offset, block_axis=ax)
                         for t, ax in zip(_key_grads(ds, a, qb, gyb, gdnb),
                                          (-3, -3, -2)))
        if dq is None:
            dq, dk, dv, dw = dqt, dkt, dvt, dwt
        else:
            dq, dk, dv, dw = dq + dqt, dk + dkt, dv + dvt, dw + dwt
    return (hc.unblock(dq, axis=-3), hc.unblock(dk, axis=-3),
            hc.unblock(dv, axis=-3), hc.unblock(dw, axis=-2),
            hc.unblock(gmn, axis=-2))


band_attention_bwd_ref.calls = 0


def band_attention_sub_bwd_ref(q, k, v, w, y, dn, m, gy, gdn, gm, *,
                               nr: int, ratio: int) -> Grads:
    """Plain PyTorch backward of the fine-q causal level on the block
    layout of ``band_attention_sub_fwd_ref``: fine query blocks of
    ``nq = nr * ratio`` rows against the previous coarse key block."""
    band_attention_sub_bwd_ref.calls += 1
    f32 = torch.float32
    Lk = k.shape[1]
    nq = nr * ratio
    dev = q.device
    qb = hc.block(q.to(f32), nq)                       # (B,G,NB,nq,d)
    kt = hc.shift_blocks(hc.block(k.to(f32), nr), -1)
    vt = hc.shift_blocks(hc.block(v.to(f32), nr), -1)
    wt = hc.shift_blocks(hc.block(w.to(f32), nr, axis=-1), -1, block_axis=-2)
    gyb = hc.block(gy.to(f32), nq)
    gdnb = hc.block(gdn.to(f32), nq, axis=-1)
    mb = hc.block(m, nq, axis=-1)
    gmhb = hc.block(_gmh(y, dn, gy.to(f32), gdn.to(f32), gm.to(f32)), nq,
                    axis=-1)
    nb = qb.shape[-3]
    qi = (torch.arange(nq, device=dev)[:, None]
          + torch.arange(nb, device=dev)[:, None, None] * nq)
    ki = (torch.arange(nr, device=dev)[None, :]
          + (torch.arange(nb, device=dev)[:, None, None] - 1) * nr)
    allow = hb.band_mask(qi, ki, nr, hb.SUB_MODE, Lk, ratio)
    s = torch.einsum("bgnqd,bnkd->bgnqk", qb, kt)
    allow = allow[None, None] & (wt > 0)[:, None, :, None, :]
    s = torch.where(allow, s, hb.NEG_INF)
    a, ind, da = _score_grads(s, mb, _row_max([s]), gyb, gdnb, vt, wt)
    gmn = _row_scale(gmhb, [ind])
    ds = a * da + gmn[..., None] * ind
    dq = torch.einsum("bgnqk,bnkd->bgnqd", ds, kt)
    # coarse key block n-1 fed fine query block n
    dk, dv, dw = (hc.shift_blocks(t, 1, block_axis=ax)
                  for t, ax in zip(_key_grads(ds, a, qb, gyb, gdnb),
                                   (-3, -3, -2)))
    return (hc.unblock(dq, axis=-3), hc.unblock(dk, axis=-3),
            hc.unblock(dv, axis=-3), hc.unblock(dw, axis=-2),
            hc.unblock(gmn, axis=-2))


band_attention_sub_bwd_ref.calls = 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    return _build.library("h1d_block_bwd", _SIGNATURES)


def _operands(q, k, v, w, y, dn, m, gy, gdn, gm, Lq, Lk):
    """Validate the saved tensors and the cotangents (made contiguous:
    autograd may hand over strided ones); returns the cotangents."""
    B, G, _, d = q.shape
    dv = v.shape[-1]
    gy, gdn, gm = gy.contiguous(), gdn.contiguous(), gm.contiguous()
    for t, name, shape in ((q, "q", (B, G, Lq, d)), (k, "k", (B, Lk, d)),
                           (v, "v", (B, Lk, dv)), (w, "w", (B, Lk)),
                           (y, "y", (B, G, Lq, dv)), (dn, "dn", (B, G, Lq)),
                           (m, "m", (B, G, Lq)), (gy, "gy", (B, G, Lq, dv)),
                           (gdn, "gdn", (B, G, Lq)), (gm, "gm", (B, G, Lq))):
        _build.expect(t, name, shape)
    return gy, gdn, gm


def _outputs(q, k, v):
    dq = torch.empty_like(q)
    gmn = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    return dq, torch.empty_like(k), torch.empty_like(v), \
        torch.empty(k.shape[:-1], dtype=torch.float32, device=k.device), gmn


def band_attention_bwd(q, k, v, w, y, dn, m, gy, gdn, gm, *, nr: int,
                       mode: str = "l0_causal") -> Grads:
    """Backward of one level in any mode but ``sub``.  CPU tensors take
    :func:`band_attention_bwd_ref`; CUDA tensors launch ``h1d_band_bwd``
    (a dQ kernel, which also writes each row's a and ds to a scratch
    tensor, then a dK/dV/dW kernel that sums them; ``coarse_causal`` runs
    the sub level's one fused kernel at ratio 1), or
    ``h1d_band_bwd_stream`` for the ``l0_causal`` shapes the staged
    bodies do not take (:func:`h1d_block.check_window_bwd`: a dQ kernel
    and a dK/dV/dW kernel that each recompute the scores, no scratch),
    counted under ``l0_causal_stream``.  Returns (dq, dk, dv, dw, gmn).
    ``.mode_launches`` counts the launches per mode."""
    if q.device.type == "cpu":
        return band_attention_bwd_ref(q, k, v, w, y, dn, m, gy, gdn, gm,
                                      nr=nr, mode=mode)
    hb._check_mode(mode)
    if mode == hb.SUB_MODE:
        raise ValueError("mode 'sub' goes through band_attention_sub_bwd")
    B, G, L, d = q.shape
    body = hb.check_window_bwd(mode, nr, d, v.shape[-1])
    lib = _lib()
    hb._check_length(L, nr, mode)
    gy, gdn, gm = _operands(q, k, v, w, y, dn, m, gy, gdn, gm, L, L)
    out = _outputs(q, k, v)
    dq, dk, dv, dw, gmn = out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            y.data_ptr(), dn.data_ptr(), m.data_ptr(), gy.data_ptr(),
            gdn.data_ptr(), gm.data_ptr(), dq.data_ptr(), gmn.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr())
    if body == "stream":
        _build.check(lib.h1d_band_bwd_stream(
            *ptrs, B, G, L, d, v.shape[-1], nr, _build.stream()),
            "h1d_band_bwd_stream")
        key = "l0_causal_stream"
    else:
        # the dQ pass hands a and ds of every row's band to the dK/dV/dW
        # pass
        dsa = (torch.empty((B, G, L, 2 * hb.band_row_slots(mode, nr)),
                           dtype=torch.float32, device=q.device)
               if mode in hb.BAND_CODES else None)
        _build.check(lib.h1d_band_bwd(
            *ptrs, None if dsa is None else dsa.data_ptr(),
            B, G, L, d, v.shape[-1], nr, hb._MODE_CODES[mode],
            _build.stream()), "h1d_band_bwd")
        key = mode
    band_attention_bwd.launches += 1
    counts = band_attention_bwd.mode_launches
    counts[key] = counts.get(key, 0) + 1
    if contracts.ACTIVE:
        contracts.record(contracts.band_bwd(
            q, k, v, w, nr=nr, mode=mode, body=body,
            grid=hb.last_grid(lib.h1d_band_bwd_last_grid)))
    return out


band_attention_bwd.launches = 0
band_attention_bwd.mode_launches = {}


def band_attention_sub_bwd(q, k, v, w, y, dn, m, gy, gdn, gm, *, nr: int,
                           ratio: int) -> Grads:
    """Fine-q causal level backward (mode ``sub``).  CPU tensors take
    :func:`band_attention_sub_bwd_ref`; CUDA tensors launch
    ``h1d_band_sub_bwd`` (one fused kernel: dq, gmn and the key block's
    dk, dv, dw from one recomputation of each score).  Returns (dq, dk,
    dv, dw, gmn)."""
    if q.device.type == "cpu":
        return band_attention_sub_bwd_ref(q, k, v, w, y, dn, m, gy, gdn, gm,
                                          nr=nr, ratio=ratio)
    lib = _lib()
    B, G, Lq, d = q.shape
    Lk = k.shape[1]
    if ratio < 2 or ratio & (ratio - 1) or Lq != Lk * ratio:
        raise ValueError(f"sub level needs ratio=2**l >= 2 and "
                         f"Lq == Lk * ratio, got {Lq=}, {Lk=}, {ratio=}")
    hc.validate_h1d_shape(Lq, nr)
    gy, gdn, gm = _operands(q, k, v, w, y, dn, m, gy, gdn, gm, Lq, Lk)
    out = _outputs(q, k, v)
    dq, dk, dv, dw, gmn = out
    _build.check(lib.h1d_band_sub_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        y.data_ptr(), dn.data_ptr(), m.data_ptr(), gy.data_ptr(),
        gdn.data_ptr(), gm.data_ptr(), dq.data_ptr(), gmn.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        B, G, Lq, Lk, d, v.shape[-1], nr, ratio, _build.stream()),
        "h1d_band_sub_bwd")
    band_attention_sub_bwd.launches += 1
    if contracts.ACTIVE:
        contracts.record(contracts.sub_bwd(
            q, k, v, w, nr=nr, ratio=ratio,
            grid=hb.last_grid(lib.h1d_band_bwd_last_grid)))
    return out


band_attention_sub_bwd.launches = 0
