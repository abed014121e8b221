"""``band_attention``: one hierarchy level of banded block attention.

Port of ``repro.kernels.ops.band_attention`` for the forward pass.  The
backend is chosen by the tensors' device, not by an option: a CPU tensor
runs the plain PyTorch version, a CUDA tensor the hand-written kernel
(``h1d_block``).  There is no fallback from the kernel to the plain
version.  Gradients (the reference's custom VJP) come with the training
slice.
"""
from __future__ import annotations

from . import h1d_block


def band_attention(q, k, v, w, *, nr: int, mode: str,
                   ratio: int = 1) -> h1d_block.Triple:
    """Returns float32 ``(y, dn, m)`` for one level.  ``mode='sub'``
    (with ``ratio=2**l``) is the fine-q causal coarse level: ``q`` keeps
    the fine length while ``k``/``v``/``w`` are ``ratio`` times coarser."""
    if mode == h1d_block.SUB_MODE:
        return h1d_block.band_attention_sub_fwd(q, k, v, w, nr=nr,
                                                ratio=ratio)
    return h1d_block.band_attention_fwd(q, k, v, w, nr=nr, mode=mode)
