"""Optimizers on tensor trees: AdamW and Adafactor, with global-norm
clipping and learning-rate schedules.

Port of ``repro.optim.adamw``: the same (init, update) convention and the
same float32 arithmetic, step for step::

    opt = adamw(lr_schedule, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Each optimizer also has an in-place form, ``state = opt.update_(grads,
state, params)``, what the reference's donated train step lets XLA do:
it clips ``grads`` in place and writes the moments and ``params`` in
place, leaf by leaf, so no second tree of moments, updates or parameters
ever exists.  It runs the functional update's expressions on the same
operands, so it gives the same bits; AdamW takes a leaf of more than
``CHUNK_ELEMS`` entries in row chunks (the arithmetic is elementwise),
which bounds its temporaries.

Parameters, gradients and states are trees of tensors (``repro_torch.
tree``); step counters are int32 scalars on the parameters' device, so a
step never waits on the host.  Weight decay applies to every leaf, norms
included, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten_like

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params) -> (updates, state)
    update_: Callable     # (grads, state, params) -> state, in place


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree, shards=None) -> torch.Tensor:
    """The L2 norm over every leaf.  ``shards``
    (``parallel.tensor.LeafShards``): the squares of the leaves split
    over a model axis are summed over it, each replicated leaf counted
    once, so every rank gets the whole tree's norm."""
    sq = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    if shards is None:
        return torch.sqrt(sum(sq))
    split = [s for s, f in zip(sq, shards.flags) if f]
    whole = [s for s, f in zip(sq, shards.flags) if not f]
    return torch.sqrt(sum(whole) + shards.psum(sum(split) + torch.zeros(
        (), dtype=F32, device=sq[0].device)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float, shards=None):
    norm = global_norm(grads, shards)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def clip_by_global_norm_(grads, max_norm: float, shards=None):
    """:func:`clip_by_global_norm` in place: scales every leaf of
    ``grads`` and returns (grads, norm)."""
    norm = global_norm(grads, shards)
    scale = _clip_scale(norm, max_norm)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_schedule(peak_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * step / max(warmup, 1)
        dec = peak_lr * torch.clamp(1.0 - (step - warmup)
                                    / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm, dec)
    return lr


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _per_leaf(upd, grads, *trees):
    """Apply ``upd(g, *leaves)`` -> (update, *new_leaves) leaf by leaf and
    return the update tree and one new tree per entry of ``trees``."""
    flat = [tree_leaves(t) for t in (grads, *trees)]
    out = [upd(*leaves) for leaves in zip(*flat)]
    return [tree_unflatten_like(grads, [o[i] for o in out])
            for i in range(len(out[0]))]


#: the most entries of a leaf that an in-place AdamW update takes at once
#: (64 MiB an f32 temporary); gemma3-4b's 262144 x 2560 embedding takes
#: 41 row chunks in place of 2.5 GiB temporaries
CHUNK_ELEMS = 1 << 24


def _row_chunks(p: torch.Tensor):
    """Index expressions covering ``p``: ``...`` for a leaf of at most
    CHUNK_ELEMS entries or on the meta device (no temporaries there),
    else slices of its leading axis."""
    if p.ndim == 0 or p.numel() <= CHUNK_ELEMS or p.device.type == "meta":
        return (...,)
    rows = max(1, CHUNK_ELEMS // (p.numel() // p.shape[0]))
    return tuple(slice(i, i + rows) for i in range(0, p.shape[0], rows))


def _leaf_(upd, idx, g, p, moments):
    """One in-place step of ``upd`` on ``p[idx]`` and its moments; its
    temporaries die on return, before the next chunk or leaf."""
    u, *new = upd(g[idx], *(m[idx] for m in moments), p[idx])
    for m, n in zip(moments, new):
        m[idx].copy_(n)
    p[idx].add_(u.to(p.dtype))


@torch.no_grad()
def _per_leaf_(upd, grads, params, *trees, chunked: bool):
    """Apply ``upd(g, *leaves, p)`` -> (update, *new_leaves) leaf by leaf
    in place: each new leaf is copied into its tree's leaf and the update
    added to ``p`` as :func:`apply_updates` adds it.  ``chunked`` runs a
    large leaf (and its moments, of its shape) in :func:`_row_chunks`."""
    flat = [tree_leaves(t) for t in (grads, params, *trees)]
    for g, p, *moments in zip(*flat):
        for idx in (_row_chunks(p) if chunked else (...,)):
            _leaf_(upd, idx, g, p, moments)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adamw(lr: Callable, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm: Optional[float] = 1.0, shards=None) -> Optimizer:
    """``shards`` (``parallel.tensor.LeafShards``): the parameters are
    this rank's shards of a model axis, and the clip takes the whole
    tree's norm (:func:`global_norm`); the update is elementwise."""
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=F32)
        return AdamWState(_step0(params), tree_map(zeros, params),
                          tree_map(zeros, params))

    def leaf_update(step):
        stepf = step.to(F32)
        lr_t = lr(step)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf

        def upd(g, m, v, p):
            g = g.to(F32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = -(lr_t * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                          + weight_decay * p.to(F32)))
            return u, m, v
        return upd

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, shards)
        step = state.step + 1
        updates, mu, nu = _per_leaf(leaf_update(step), grads, state.mu,
                                    state.nu, params)
        return updates, AdamWState(step, mu, nu)

    def update_(grads, state, params):
        if clip_norm is not None:
            clip_by_global_norm_(grads, clip_norm, shards)
        step = state.step + 1
        _per_leaf_(leaf_update(step), grads, params, state.mu, state.nu,
                   chunked=True)
        return AdamWState(step, state.mu, state.nu)

    return Optimizer(init, update, update_)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any     # row factors (or the full v below 2-D)
    vc: Any     # column factors


def adafactor(lr: Callable, decay=0.8, eps=1e-30,
              clip_threshold=1.0) -> Optimizer:
    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def vr_init(p):
            shape = p.shape[:-1] if _factored(p) else p.shape
            return torch.zeros(shape, dtype=F32, device=p.device)

        def vc_init(p):
            shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else (1,)
            return torch.zeros(shape, dtype=F32, device=p.device)

        return AdafactorState(_step0(params), tree_map(vr_init, params),
                              tree_map(vc_init, params))

    def leaf_update(step):
        stepf = step.to(F32)
        beta = 1.0 - stepf ** (-decay)
        lr_t = lr(step)

        def upd(g, vr, vc, p):
            g = g.to(F32)
            g2 = g * g + eps
            if _factored(p):
                vr = beta * vr + (1 - beta) * g2.mean(dim=-1)
                vc = beta * vc + (1 - beta) * g2.mean(dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                )[..., None]
                cfac = torch.rsqrt(vc)[..., None, :]
                u = g * rfac * cfac
            else:
                vr = beta * vr + (1 - beta) * g2
                u = g * torch.rsqrt(vr)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr_t * u, vr, vc
        return upd

    def update(grads, state, params):
        step = state.step + 1
        updates, vr, vc = _per_leaf(leaf_update(step), grads, state.vr,
                                    state.vc, params)
        return updates, AdafactorState(step, vr, vc)

    def update_(grads, state, params):
        # the factored moments are small and the update's RMS spans the
        # whole leaf: one pass a leaf
        step = state.step + 1
        _per_leaf_(leaf_update(step), grads, params, state.vr, state.vc,
                   chunked=False)
        return AdafactorState(step, state.vr, state.vc)

    return Optimizer(init, update, update_)
