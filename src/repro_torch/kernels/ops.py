"""``band_attention``: one hierarchy level of banded block attention,
differentiable.

Port of ``repro.kernels.ops.band_attention`` and its custom VJP.  The
backend is chosen by the tensors' device, not by an option: a CPU tensor
runs the plain PyTorch versions, a CUDA tensor the hand-written kernels
(``h1d_block`` forward, ``h1d_block_bwd`` backward).  There is no
fallback from a kernel to a plain version.

One ``torch.autograd.Function`` for the four band modes and one for
``sub`` wrap the forward: each saves the inputs and the outputs ``(q, k,
v, w, y, dn, m)`` -- the whole residual, as the reference's ``_fwd`` --
and its backward returns ``(dq, dk, dv, dw)``.  All three outputs are
differentiable (``_stream_combine`` consumes ``m``).  The forward and backward callables are looked up as
module attributes at call time, so rerouting ``h1d_block.<name>`` /
``h1d_block_bwd.<name>`` reroutes this path too.

Inside ``parallel.sp_attention.sp_scope(mesh)`` a level whose local
query slab holds a whole query block runs sharded over the mesh
(``sp_band_attention``, differentiable); shorter shapes stay on the
single-launch kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import h1d_block, h1d_block_bwd


def _tile(tq):
    """``tq=`` only where a caller set one: a rerouted callable (a plain
    version in place of a wrapper) takes no tile."""
    return {} if tq is None else {"tq": tq}


class _Band(torch.autograd.Function):
    """One level in a band mode (``l0_*`` or ``coarse_*``); the mode and
    the tile are non-differentiable arguments, as ``nr`` is."""

    @staticmethod
    def forward(ctx, q, k, v, w, nr, mode, tq):
        y, dn, m = h1d_block.band_attention_fwd(q, k, v, w, nr=nr, mode=mode,
                                                **_tile(tq))
        ctx.save_for_backward(q, k, v, w, y, dn, m)
        ctx.nr, ctx.mode, ctx.tq = nr, mode, tq
        return y, dn, m

    @staticmethod
    def backward(ctx, gy, gdn, gm):
        dq, dk, dv, dw, _ = h1d_block_bwd.band_attention_bwd(
            *ctx.saved_tensors, gy, gdn, gm, nr=ctx.nr, mode=ctx.mode,
            **_tile(ctx.tq))
        return dq, dk, dv, dw, None, None, None


class _BandSub(torch.autograd.Function):
    """A fine-q causal level l >= 1, mode ``sub`` with ``ratio = 2**l``."""

    @staticmethod
    def forward(ctx, q, k, v, w, nr, ratio, tq):
        y, dn, m = h1d_block.band_attention_sub_fwd(q, k, v, w, nr=nr,
                                                    ratio=ratio, **_tile(tq))
        ctx.save_for_backward(q, k, v, w, y, dn, m)
        ctx.nr, ctx.ratio, ctx.tq = nr, ratio, tq
        return y, dn, m

    @staticmethod
    def backward(ctx, gy, gdn, gm):
        dq, dk, dv, dw, _ = h1d_block_bwd.band_attention_sub_bwd(
            *ctx.saved_tensors, gy, gdn, gm, nr=ctx.nr, ratio=ctx.ratio,
            **_tile(ctx.tq))
        return dq, dk, dv, dw, None, None, None


def band_attention(q, k, v, w, *, nr: int, mode: str, ratio: int = 1,
                   tq: Optional[int] = None) -> h1d_block.Triple:
    """Returns float32 ``(y, dn, m)`` for one level.  ``mode='sub'``
    (with ``ratio=2**l``) is the fine-q causal coarse level: ``q`` keeps
    the fine length while ``k``/``v``/``w`` are ``ratio`` times coarser.
    The four band modes (``l0_causal``, ``l0_bidir``, ``coarse_causal``,
    ``coarse_bidir``) keep one length for queries and keys; an unknown
    mode raises ``ValueError``.  ``tq`` overrides the launch policy's
    tile of the kernels (``kernels.tuning``; logged as ``override``): the
    forward's rows a tile and the backward's dQ rows, legalized to the
    largest tile at or below it; a candidate's fields (a dict) force a
    backward candidate whole.  The CPU path ignores it."""
    from ..parallel.sp_attention import (sp_band_attention, sp_ctx,
                                         sp_shardable)
    mesh = sp_ctx()
    if mesh is not None and sp_shardable(q.shape[-2], mesh.d, nr, mode,
                                         ratio):
        return sp_band_attention(q, k, v, w, nr=nr, mode=mode, ratio=ratio,
                                 mesh=mesh)
    if mode == h1d_block.SUB_MODE:
        return _BandSub.apply(q, k, v, w, nr, ratio, tq)
    h1d_block._check_mode(mode)
    return _Band.apply(q, k, v, w, nr, mode, tq)

