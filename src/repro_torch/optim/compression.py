"""Gradient compression with error feedback.

Port of ``repro.optim.compression``: ``int8_compress`` (one int8 scale per
tensor, the rounding rule of ``core.quantization``) and ``topk_compress``
(keep the top ``frac`` of entries by magnitude), each carrying what it
dropped to the next step in an error-feedback residual, so the sum of
compressed gradients tracks the sum of true ones.  Each returns the
compressed-then-decompressed gradients (what a reduction across pods
would sum) and the new residual.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..core.quantization import dequantize_int8, quantize_int8
from ..tree import tree_leaves, tree_map, tree_unflatten_like


class EFState(NamedTuple):
    residual: Any


def init_error_feedback(params) -> EFState:
    return EFState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _compress(one, grads, ef: EFState) -> Tuple[Any, EFState]:
    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(ef.residual))]
    return (tree_unflatten_like(grads, [o[0] for o in out]),
            EFState(tree_unflatten_like(grads, [o[1] for o in out])))


def int8_compress(grads, ef: EFState) -> Tuple[Any, EFState]:
    def one(g, r):
        x = g.to(torch.float32) + r
        deq = dequantize_int8(*quantize_int8(x))
        return deq.to(g.dtype), x - deq
    return _compress(one, grads, ef)


def topk_compress(grads, ef: EFState, frac: float = 0.05
                  ) -> Tuple[Any, EFState]:
    def one(g, r):
        x = g.to(torch.float32) + r
        flat = x.reshape(-1)
        k = max(1, int(flat.shape[0] * frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        kept = torch.where(x.abs() >= thresh, x, torch.zeros_like(x))
        return kept.to(g.dtype), x - kept
    return _compress(one, grads, ef)
