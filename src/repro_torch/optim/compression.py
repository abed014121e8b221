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

from ..core.quantization import dequantize_int8, int8_scale, quantize_int8
from ..tree import tree_leaves, tree_map, tree_unflatten_like


class EFState(NamedTuple):
    residual: Any


def init_error_feedback(params) -> EFState:
    return EFState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _compress(one, grads, ef: EFState, flags=None) -> Tuple[Any, EFState]:
    leaves = tree_leaves(grads)
    flags = flags or (False,) * len(leaves)
    out = [one(g, r, f) for g, r, f in zip(leaves, tree_leaves(ef.residual),
                                           flags)]
    return (tree_unflatten_like(grads, [o[0] for o in out]),
            EFState(tree_unflatten_like(grads, [o[1] for o in out])))


def int8_compress(grads, ef: EFState, shards=None) -> Tuple[Any, EFState]:
    """``shards`` (``parallel.tensor.LeafShards``): a leaf split over a
    model axis takes the scale of the whole leaf, the pmax of its
    shards' scales, as one process would take it."""
    def one(g, r, split):
        x = g.to(torch.float32) + r
        scale = shards.pmax(int8_scale(x)) if split else None
        deq = dequantize_int8(*quantize_int8(x, scale=scale))
        return deq.to(g.dtype), x - deq
    return _compress(one, grads, ef, shards.flags if shards else None)


def topk_compress(grads, ef: EFState, frac: float = 0.05
                  ) -> Tuple[Any, EFState]:
    def one(g, r, _):
        x = g.to(torch.float32) + r
        flat = x.reshape(-1)
        k = max(1, int(flat.shape[0] * frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        kept = torch.where(x.abs() >= thresh, x, torch.zeros_like(x))
        return kept.to(g.dtype), x - kept
    return _compress(one, grads, ef)
