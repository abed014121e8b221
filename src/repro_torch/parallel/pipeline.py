"""GPipe-style pipeline parallelism.

Port of ``repro.parallel.pipeline``.  Layers split into S contiguous
stages; M microbatches flow through; each tick every stage applies its
layers and hands its activation to the next stage.  The bubble fraction
is (S-1)/(M+S-1).

``pipeline_apply`` is model-agnostic: it takes stacked per-stage
parameters (leading dim S) and a per-stage ``fn(stage_params, x) -> x``
that keeps the shape of ``x``.  The mesh is a one-axis
:class:`~repro_torch.parallel.sp_attention.SPMesh`
(``launch.mesh.make_mesh((S,), ("stage",))``) in one of its two forms:

* one process: every stage in this process on one device, and the
  reference's ``ppermute`` becomes taking the neighbour's tensor;
* ranks: rank s holds stage s and the schedule is the reference's,
  collectives and all (``parallel/group.py``): the microbatch stream is
  scattered by rank and all-gathered, the activations move one rank on
  in a ring ``ppermute`` each tick, and a final ``psum`` broadcasts the
  last stage's outputs (zeros elsewhere), split back by rank and
  gathered for the caller.

In both, a stage applies ``fn`` only on the ticks it holds a microbatch
(the reference's stages also run on the bubble's zeros and drop the
result): each microbatch passes through each stage once, so every kernel
inside ``fn`` launches as often as in the sequential application (on a
rank, M times: its own stage's).  Every step is out of place or an
autograd Function, so autograd carries gradients through the pipeline;
on ranks, the gradient of ``x`` is whole on every rank and that of a
stacked leaf lands in row s on rank s (each rank owns its stage).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..tree import tree_map
from . import group as grp
from .sp_attention import SPMesh


def pipeline_apply(fn: Callable, stage_params: Any, x: torch.Tensor, *,
                   mesh: SPMesh, axis: str = "stage") -> torch.Tensor:
    """x: (M, B_m, ...) microbatched input (M a multiple of S), the same
    on every rank.  ``stage_params`` leaves have leading dim S = the
    mesh's shards.  Returns (M, B_m, ...): the last stage's outputs, in
    order (on every rank)."""
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    S = mesh.d
    M = x.shape[0]
    assert M % S == 0, (M, S)
    if mesh.group is not None:
        return _pipeline_ranks(fn, stage_params, x, mesh.group)
    params = [tree_map(lambda p, s=s: p[s], stage_params) for s in range(S)]
    state = [None] * S        # the activation each stage holds this tick
    outs = [None] * M
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (if any)
        if t < M:
            state[0] = x[t]
        # every stage holding a microbatch applies its layers
        state = [None if h is None else fn(params[s], h)
                 for s, h in enumerate(state)]
        # the last stage emits microbatch t - (S - 1)
        if t >= S - 1:
            outs[t - (S - 1)] = state[S - 1]
        # shift all states one stage forward
        state = [None] + state[:-1]
    return torch.stack(outs)


def _pipeline_ranks(fn, stage_params, x, g: grp.RankGroup):
    """The reference's ``run`` body on rank ``g.rank``, stage s.  Every
    collective's output stays in every rank's graph (``torch.where``
    where the reference has ``jnp.where``, never a dropped tensor; the
    starting state is a leaf that takes a gradient, so a rank whose
    first ticks are bubbles still sends and receives one), and every
    rank runs every collective's backward, in the same order."""
    S, s = g.world, g.rank
    M = x.shape[0]
    params = tree_map(lambda p: p[s], stage_params)
    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == S - 1, device=x.device)
    # every stage sees the whole microbatch stream, in order
    xs = grp.all_gather(grp.scatter(x, g, 0), g, 0, "sum")
    state = torch.zeros_like(xs[0]).requires_grad_(torch.is_grad_enabled())
    outs = []
    for t in range(M + S - 1):
        if t < M:       # stage 0 ingests microbatch t
            state = torch.where(first, xs[t], state)
        # stage s holds microbatch t - s on ticks s .. s + M - 1
        if 0 <= t - s < M:
            state = fn(params, state)
        if t >= S - 1:  # the last stage emits microbatch t - (S - 1)
            outs.append(state)
        state = grp.ppermute(state, g, 1, cyclic=True)
    # the last stage's outputs (zeros elsewhere) to every rank, split back
    # by rank, and gathered for the caller
    out = grp.psum(torch.where(last, torch.stack(outs), 0.0), g)
    return grp.all_gather(out.chunk(S, 0)[s], g, 0, "slice")
