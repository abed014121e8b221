"""Mamba2 mixer with the SSD (state-space duality) chunked algorithm.

Port of ``repro.models.ssm``.  Shapes follow Dao & Gu (2024)::

  x  : (B, S, H, Ph)   -- H heads of head-dim Ph (d_inner = H * Ph)
  dt : (B, S, H)       -- softplus-activated step sizes
  A  : (H,)            -- negative decay rates
  Bm, Cm : (B, S, G, N) -- input/output projections (G groups, state N)

``ssd_chunked`` computes the exact linear recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T; y_t = C_t h_t`` in chunks:
a quadratic attention-like term inside each chunk plus a scan over the
chunks' states.  ``ssd_reference`` is the per-step oracle, ``ssd_step``
the O(1) decode update.  The SSD runs in float32 whatever the model's
dtype (x, dt, B and C are widened) and returns y in x's dtype.  A head
``h`` reads group ``h // (H / G)`` of B and C: the heads are split as
(G, H / G) in every product, so B and C are broadcast, never copied per
head (the reference repeats them).  The reference has no Pallas kernel
here, and neither has the port: the SSD is plain PyTorch, every call
inside a profiler range ``ssd``.

A layer's decode state is :class:`SSMState`: ``h`` (B, H, N, Ph) in
float32 and ``conv``, the last ``W - 1`` inputs of the causal
convolution, (B, W - 1, conv_dim) in the model's dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .common import (ModelConfig, dense, dense_init, norm_init, rmsnorm,
                     shard_if_divisible)

#: the profiler range of the SSD core (``ssd_chunked``, ``ssd_step``)
SSD_RANGE = "ssd"


class SSMState(NamedTuple):
    h: torch.Tensor          # (B, H, N, Ph) float32
    conv: torch.Tensor       # (B, W - 1, conv_dim), the model's dtype


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _segsum(x):
    """x: (..., Q).  Returns (..., Q, Q) with out[i, j] = sum_{j<t<=i} x_t
    for i >= j, -inf otherwise (log of the decay matrix).  The mask is
    applied before any ``exp``, so the backward never meets inf * 0."""
    Q = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """Returns (y (B, S, H, Ph) in x's dtype, h_final (B, H, N, Ph)
    float32).  h0: optional initial state (B, H, N, Ph)."""
    Bsz, S, H, Ph = x.shape
    G, N = Bm.shape[-2:]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    R = H // G
    f32 = torch.float32
    with record_function(SSD_RANGE):
        xc = x.reshape(Bsz, nc, chunk, G, R, Ph).to(f32)
        dtc = dt.reshape(Bsz, nc, chunk, G, R).to(f32)
        Bc = Bm.reshape(Bsz, nc, chunk, G, N).to(f32)
        Cc = Cm.reshape(Bsz, nc, chunk, G, N).to(f32)

        dA = dtc * A.to(f32).reshape(G, R)          # (B, nc, Q, G, R) <= 0
        dA_cs = torch.cumsum(dA, dim=2)             # within-chunk cumsum

        # ---- intra-chunk (diagonal) term --------------------------------
        Ldec = torch.exp(_segsum(dA.permute(0, 1, 3, 4, 2)))  # (B,nc,G,R,Q,Q)
        scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)   # one per group
        m = scores[:, :, :, None] * Ldec
        m = m * dtc.permute(0, 1, 3, 4, 2)[:, :, :, :, None, :]
        y_diag = torch.einsum("bcgrqk,bckgrp->bcqgrp", m, xc)
        del m, Ldec, scores

        # ---- chunk states -------------------------------------------------
        decay_states = torch.exp(dA_cs[:, :, -1:] - dA_cs)   # (B,nc,Q,G,R)
        xw = xc * (decay_states * dtc)[..., None]
        states = torch.einsum("bcqgn,bcqgrp->bcgrnp", Bc, xw)  # (B,nc,G,R,N,P)
        del xw

        # ---- inter-chunk scan (the reference's lax.scan) ------------------
        chunk_decay = torch.exp(dA_cs[:, :, -1])               # (B, nc, G, R)
        h = (torch.zeros((Bsz, G, R, N, Ph), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32).reshape(Bsz, G, R, N, Ph))
        h_prevs = []
        for c in range(nc):
            h_prevs.append(h)
            h = h * chunk_decay[:, c, ..., None, None] + states[:, c]
        h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,G,R,N,P)
        del states

        # ---- inter-chunk (off-diagonal) output ----------------------------
        y_off = torch.einsum("bcqgn,bcgrnp->bcqgrp", Cc, h_prevs)
        y_off = y_off * torch.exp(dA_cs)[..., None]
        y = (y_diag + y_off).reshape(Bsz, S, H, Ph)
    return y.to(x.dtype), h.reshape(Bsz, H, N, Ph)


def ssd_reference(x, dt, A, Bm, Cm, *, h0=None):
    """Naive per-step recurrence (oracle).  Returns (y, h_final)."""
    Bsz, S, H, Ph = x.shape
    G, N = Bm.shape[-2:]
    f32 = torch.float32
    h = (torch.zeros((Bsz, H, N, Ph), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(S):
        y, h = _step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), h


def _step(h, xt, dtt, A, Bt, Ct):
    """One step of the recurrence in float32: (y (B, H, Ph) float32,
    h (B, H, N, Ph))."""
    Bsz, H, Ph = xt.shape
    G, N = Bt.shape[1:]
    R = H // G
    f32 = torch.float32
    dtf = dtt.to(f32)
    dec = torch.exp(dtf * A.to(f32))                          # (B, H)
    upd = (Bt.to(f32)[:, :, None, :, None]
           * dtf.reshape(Bsz, G, R)[..., None, None]
           * xt.to(f32).reshape(Bsz, G, R, 1, Ph))           # (B,G,R,N,P)
    h = h * dec[..., None, None] + upd.reshape(Bsz, H, N, Ph)
    y = torch.einsum("bgn,bgrnp->bgrp", Ct.to(f32),
                     h.reshape(Bsz, G, R, N, Ph))
    return y.reshape(Bsz, H, Ph), h


def ssd_step(h, xt, dtt, A, Bt, Ct):
    """Single decode step.  h: (B, H, N, Ph); xt: (B, H, Ph); dtt: (B, H);
    Bt/Ct: (B, G, N).  Returns (y (B, H, Ph) in xt's dtype, h)."""
    with record_function(SSD_RANGE):
        y, h = _step(h, xt, dtt, A, Bt, Ct)
    return y.to(xt.dtype), h


# ---------------------------------------------------------------------------
# Mamba2 mixer layer
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ModelConfig):
    """(d_inner, H, G, N, conv_dim); G is 1, as in the reference."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    G = 1
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * G * N
    return d_inner, H, G, N, conv_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                *, tp: Optional[int] = None):
    """The mixer's parameters, drawn on the CPU from ``gen``.  ``A_log``,
    ``D`` and ``dt_bias`` are float32 in every model dtype, as in the
    reference.  Specs: ``in_proj``'s output and ``out_proj``'s input and
    the convolution's channels over ``"model"`` where ``tp`` divides
    them; the per-head vectors and the norm replicated."""
    d = cfg.d_model
    d_inner, H, G, N, conv_dim = mamba2_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * G * N + H
    f32 = torch.float32
    p, s = {}, {}
    p["in_proj"], s["in_proj"] = dense_init(gen, d, d_in_proj, dtype=dtype,
                                            tp=tp)
    p["out_proj"], s["out_proj"] = dense_init(
        gen, d_inner, d, dtype=dtype, in_shard=True, out_shard=False, tp=tp)
    conv_ax = shard_if_divisible(conv_dim, tp)
    p.update({
        "conv_w": torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                              dtype=dtype) * 0.1,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype),
        "A_log": torch.log(torch.linspace(1.0, float(H), H, dtype=f32)),
        "D": torch.ones((H,), dtype=f32),
        "dt_bias": torch.zeros((H,), dtype=f32),
    })
    s.update({"conv_w": (None, conv_ax), "conv_b": (conv_ax,),
              "A_log": (None,), "D": (None,), "dt_bias": (None,)})
    p["norm"], s["norm"] = norm_init(d_inner, dtype)
    return p, s


def _split_in_proj(cfg: ModelConfig, zxbcdt):
    """(z, xBC, dt): the gate, the convolution's input (x, B and C side
    by side, as the reference concatenates them) and the step sizes;
    views of ``zxbcdt``."""
    d_inner, H, G, N, _ = mamba2_dims(cfg)
    c = 2 * d_inner + 2 * G * N
    return zxbcdt[..., :d_inner], zxbcdt[..., d_inner:c], zxbcdt[..., c:]


def _causal_conv(u, w, b, prev=None):
    """Depthwise causal conv in u's dtype.  u: (B, S, C); w: (W, C);
    prev: (B, W-1, C).  Returns (silu(conv + b), the last W-1 inputs):
    the reference's sum of W shifted products, in its order."""
    W = w.shape[0]
    if prev is None:
        prev = torch.zeros((u.shape[0], W - 1, u.shape[-1]), dtype=u.dtype,
                           device=u.device)
    up = torch.cat([prev, u], dim=1)
    S = u.shape[1]
    out = sum(up[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out + b), up[:, up.shape[1] - (W - 1):].clone()


def _chunk_len(cfg: ModelConfig, S: int) -> int:
    """The reference's chunk rule: ``min(ssm_chunk, S)``, else the gcd
    with S (1 for a length that shares no factor with the chunk)."""
    chunk = min(cfg.ssm_chunk, S)
    if S % chunk:
        chunk = math.gcd(S, chunk) or 1
    return chunk


def _xbc(cfg: ModelConfig, xbc, lead):
    """Split the convolution's output into x (lead, H, Ph), B and C
    (lead, G, N)."""
    d_inner, H, G, N, _ = mamba2_dims(cfg)
    xh = xbc[..., :d_inner].reshape(*lead, H, cfg.ssm_head_dim)
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(*lead, G, N)
    Cm = xbc[..., d_inner + G * N:].reshape(*lead, G, N)
    return xh, Bm, Cm


def _out(p, y, xh, z, d_inner: int):
    """The skip term, the gated norm and the output projection."""
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(*z.shape[:-1], d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return dense(p["out_proj"], y)


def mamba2_apply(p, cfg: ModelConfig, x, *, h0=None, conv0=None,
                 return_state=False):
    """x: (B, S, d).  Returns out, or (out, SSMState) with
    ``return_state``."""
    B, S, d = x.shape
    d_inner = mamba2_dims(cfg)[0]
    z, xbc, dt = _split_in_proj(cfg, dense(p["in_proj"], x))
    xbc, conv_state = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype), conv0)
    xh, Bm, Cm = _xbc(cfg, xbc, (B, S))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h = ssd_chunked(xh, dt, A, Bm, Cm, chunk=_chunk_len(cfg, S), h0=h0)
    out = _out(p, y, xh, z, d_inner)
    if return_state:
        return out, SSMState(h, conv_state)
    return out


def mamba2_decode(p, cfg: ModelConfig, x, state):
    """Single-token decode.  x: (B, 1, d); state: SSMState (or the
    reference's (h, conv) pair).  Returns (out (B, 1, d), SSMState)."""
    B = x.shape[0]
    d_inner = mamba2_dims(cfg)[0]
    h, conv_prev = state
    z, xbc, dt = _split_in_proj(cfg, dense(p["in_proj"], x))
    xbc, conv_state = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype), conv_prev)
    xh, Bm, Cm = _xbc(cfg, xbc[:, 0], (B,))
    dt = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h = ssd_step(h, xh, dt, A, Bm, Cm)
    return _out(p, y, xh, z, d_inner), SSMState(h, conv_state)
