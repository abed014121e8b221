"""Mesh construction: the production mesh description and the one-axis
mesh the port runs on.

Port of ``repro.launch.mesh``.  :func:`make_production_mesh` describes
an H100 fleet for the sharding rules, the dry run and the roofline (a
:class:`~repro_torch.parallel.sharding.Mesh`: axes and sizes, no
devices).  :func:`make_mesh` builds the one-axis
:class:`~repro_torch.parallel.sp_attention.SPMesh` that sequence-parallel
serving and training and the pipeline run on: one shard a process inside
an initialised process group (``parallel.group``, ``torchrun``), else
every shard in this process on one device (the reference's fabricated
host devices share one CPU the same way)."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.parallel import group
from repro_torch.parallel.sharding import Mesh, abstract_mesh
from repro_torch.parallel.sp_attention import SPMesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``(32, 8)`` over ``("data", "model")``: 256 H100s, tensor
    parallelism inside one 8-card NVLink node and data parallelism across
    the 32 nodes; ``multi_pod`` doubles it, ``(2, 32, 8)`` over ``("pod",
    "data", "model")``.  The reference's TPU mesh is ``(16, 16)``: a TPU
    pod's torus carries TP over 16 chips, while an H100's NVLink domain is
    its node of 8, past which traffic leaves for the slower network."""
    if multi_pod:
        return abstract_mesh((2, 32, 8), ("pod", "data", "model"))
    return abstract_mesh((32, 8), ("data", "model"))


def make_mesh(shape, axes, device=None) -> SPMesh:
    """A ``shape[0]``-way :class:`SPMesh` over axis ``axes[0]``.  Inside a
    process group (``parallel.group.current()``) of ``shape[0]`` ranks it
    is the rank form, this rank's shard on the group's device; else every
    shard sits on ``resolve_device(device)`` in this process (``cuda``
    unless ``device`` says otherwise; raises without a card).  A mesh of
    more than one axis (tensor parallelism over ``DATAxMODEL``) raises."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != 1 or len(axes) != 1:
        raise NotImplementedError(
            f"a mesh of one axis, got shape {shape} over axes {axes}: "
            f"tensor parallelism over a DATAxMODEL mesh is not ported; the "
            f"port shards the sequence, one shard a process under torchrun "
            f"or every shard in one process")
    g = group.current()
    if g is not None:
        if shape[0] != g.world:
            raise ValueError(f"a {shape[0]}-way mesh in a group of {g.world} "
                             f"ranks: the rank form runs one shard a rank")
        dev = None if device is None else resolve_device(device)
        if dev is not None and (dev.type != g.device.type or dev.index
                                not in (None, g.device.index)):
            raise ValueError(f"this rank's shard sits on {g.device}, not "
                             f"{dev}")
        return SPMesh(axis=axes[0], devices=(g.device,), group=g)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return SPMesh(axis=axes[0], devices=(dev,) * shape[0])


#: the card the roofline's terms are for, at the power limit of PERF.md's
#: runs: NVIDIA H100 80GB HBM3, 700 W (SXM5).  Datasheet figures, not
#: measurements: dense BF16 tensor-core peak and HBM3 bandwidth.  No
#: link bandwidth: the port computes no collective term yet.
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989.4e12    # FLOP/s, dense
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # bytes, the 80 GB of the card's name
