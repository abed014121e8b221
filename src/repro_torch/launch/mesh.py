"""Mesh construction for sequence-parallel serving.

Port of ``repro.launch.mesh.make_mesh`` for the one axis the port
shards: every shard of the mesh sits on one device (the reference's
fabricated host devices share one CPU the same way)."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.parallel.sp_attention import SPMesh


def make_mesh(shape, axes, device=None) -> SPMesh:
    """A ``shape[0]``-way :class:`SPMesh` over axis ``axes[0]``, every
    shard on ``resolve_device(device)`` (``cuda`` unless ``device`` says
    otherwise; raises without a card)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != 1 or len(axes) != 1:
        raise NotImplementedError(f"a mesh of one axis, got shape {shape} "
                                  f"over axes {axes}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return SPMesh(axis=axes[0], devices=(dev,) * shape[0])
