"""Symmetric int8 quantization: the rounding rule of
``repro.core.quantization``, in PyTorch.

One rule for every int8 surface of the port -- the gradient compressor
(``optim/compression.py``) now, the int8 KV pages of paged serving
later::

    scale = max(|x|, EPS) * (1/127)   (a multiply by the float32 constant,
                                       never a divide)
    q     = clip(round(x / scale), -127, 127)  as int8
    deq   = float32(q) * scale

``torch.round`` rounds half to even, as ``jnp.round``; -128 is never
produced.  ``axis=None`` gives one scale per tensor, an int or tuple one
scale per slice along the remaining axes (kept as size-1 dims).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

QMAX = 127.0
RECIP_QMAX = 1.0 / 127.0
EPS = 1e-12

Axis = Optional[Union[int, Tuple[int, ...]]]


def int8_scale(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """Symmetric absmax scale of ``x`` over ``axis`` (keepdims)."""
    ax = x.abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
    # a float32 tensor times a Python float multiplies in float32 by the
    # constant rounded to float32, as JAX's weakly typed constant
    return torch.clamp(amax, min=EPS) * RECIP_QMAX


def quantize_int8(x: torch.Tensor, axis: Axis = None,
                  scale: Optional[torch.Tensor] = None):
    """Returns ``(q int8, scale float32)``; ``scale``, where given, is
    used in place of ``x``'s own (a shard of a tensor quantized with the
    whole tensor's)."""
    x = x.to(torch.float32)
    if scale is None:
        scale = int8_scale(x, axis=axis)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
