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

import torch

from . import h1d_block, h1d_block_bwd


class _Band(torch.autograd.Function):
    """One level in a band mode (``l0_*`` or ``coarse_*``); the mode is a
    non-differentiable argument, as ``nr`` is."""

    @staticmethod
    def forward(ctx, q, k, v, w, nr, mode):
        y, dn, m = h1d_block.band_attention_fwd(q, k, v, w, nr=nr, mode=mode)
        ctx.save_for_backward(q, k, v, w, y, dn, m)
        ctx.nr, ctx.mode = nr, mode
        return y, dn, m

    @staticmethod
    def backward(ctx, gy, gdn, gm):
        dq, dk, dv, dw, _ = h1d_block_bwd.band_attention_bwd(
            *ctx.saved_tensors, gy, gdn, gm, nr=ctx.nr, mode=ctx.mode)
        return dq, dk, dv, dw, None, None


class _BandSub(torch.autograd.Function):
    """A fine-q causal level l >= 1, mode ``sub`` with ``ratio = 2**l``."""

    @staticmethod
    def forward(ctx, q, k, v, w, nr, ratio):
        y, dn, m = h1d_block.band_attention_sub_fwd(q, k, v, w, nr=nr,
                                                    ratio=ratio)
        ctx.save_for_backward(q, k, v, w, y, dn, m)
        ctx.nr, ctx.ratio = nr, ratio
        return y, dn, m

    @staticmethod
    def backward(ctx, gy, gdn, gm):
        dq, dk, dv, dw, _ = h1d_block_bwd.band_attention_sub_bwd(
            *ctx.saved_tensors, gy, gdn, gm, nr=ctx.nr, ratio=ctx.ratio)
        return dq, dk, dv, dw, None, None


def band_attention(q, k, v, w, *, nr: int, mode: str,
                   ratio: int = 1) -> h1d_block.Triple:
    """Returns float32 ``(y, dn, m)`` for one level.  ``mode='sub'``
    (with ``ratio=2**l``) is the fine-q causal coarse level: ``q`` keeps
    the fine length while ``k``/``v``/``w`` are ``ratio`` times coarser.
    The four band modes (``l0_causal``, ``l0_bidir``, ``coarse_causal``,
    ``coarse_bidir``) keep one length for queries and keys; an unknown
    mode raises ``ValueError``."""
    from ..parallel.sp_attention import (sp_band_attention, sp_ctx,
                                         sp_shardable)
    mesh = sp_ctx()
    if mesh is not None and sp_shardable(q.shape[-2], mesh.d, nr, mode,
                                         ratio):
        return sp_band_attention(q, k, v, w, nr=nr, mode=mode, ratio=ratio,
                                 mesh=mesh)
    if mode == h1d_block.SUB_MODE:
        return _BandSub.apply(q, k, v, w, nr, ratio)
    h1d_block._check_mode(mode)
    return _Band.apply(q, k, v, w, nr, mode)

