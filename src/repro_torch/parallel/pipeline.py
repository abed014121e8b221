"""GPipe-style pipeline parallelism.

Port of ``repro.parallel.pipeline``.  Layers split into S contiguous
stages; M microbatches flow through; each tick every stage applies its
layers and hands its activation to the next stage.  The bubble fraction
is (S-1)/(M+S-1).

``pipeline_apply`` is model-agnostic: it takes stacked per-stage
parameters (leading dim S) and a per-stage ``fn(stage_params, x) -> x``.
The mesh is a one-axis :class:`~repro_torch.parallel.sp_attention.SPMesh`
(``launch.mesh.make_mesh((S,), ("stage",))``) whose stages all sit on one
device, so the reference's ``ppermute`` becomes taking the neighbour's
tensor.  The schedule is the reference's tick by tick, but a stage
applies ``fn`` only on the ticks it holds a microbatch (the reference's
stages also run on the bubble's zeros and drop the result): each
microbatch passes through each stage once, so every kernel inside
``fn`` launches as often as in the sequential application.  Every step
is out of place, so autograd carries gradients through the pipeline.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..tree import tree_map
from .sp_attention import SPMesh


def pipeline_apply(fn: Callable, stage_params: Any, x: torch.Tensor, *,
                   mesh: SPMesh, axis: str = "stage") -> torch.Tensor:
    """x: (M, B_m, ...) microbatched input (M a multiple of S).
    ``stage_params`` leaves have leading dim S = the mesh's shards.
    Returns (M, B_m, ...): the last stage's outputs, in order."""
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    S = mesh.d
    M = x.shape[0]
    assert M % S == 0, (M, S)
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
