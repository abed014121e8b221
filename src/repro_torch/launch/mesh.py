"""Mesh construction: the production mesh description and the meshes
the port runs on.

Port of ``repro.launch.mesh``.  :func:`make_production_mesh` describes
an H100 fleet for the sharding rules, the dry run and the roofline (a
:class:`~repro_torch.parallel.sharding.Mesh`: axes and sizes, no
devices).  :func:`make_mesh` builds the one-axis
:class:`~repro_torch.parallel.sp_attention.SPMesh` that sequence-parallel
serving and training and the pipeline run on: one shard a process inside
an initialised process group (``parallel.group``, ``torchrun``), else
every shard in this process on one device (the reference's fabricated
host devices share one CPU the same way); and the ``DATAxMODEL``
:class:`~repro_torch.parallel.tensor.RankMesh` that tensor- and
data-parallel training runs on, one shard a process."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.parallel import group
from repro_torch.parallel.sharding import Mesh, abstract_mesh
from repro_torch.parallel.sp_attention import SPMesh
from repro_torch.parallel.tensor import RankMesh


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


def make_mesh(shape, axes, device=None):
    """A ``shape[0]``-way :class:`SPMesh` over axis ``axes[0]``.  Inside a
    process group (``parallel.group.current()``) of ``shape[0]`` ranks it
    is the rank form, this rank's shard on the group's device; else every
    shard sits on ``resolve_device(device)`` in this process (``cuda``
    unless ``device`` says otherwise; raises without a card).

    ``shape = (D, M)`` over ``("data", "model")`` is a :class:`RankMesh`
    inside a group of ``D * M`` ranks: rank r at ``(r // M, r % M)``, its
    model row on adjacent ranks (``parallel.group.axis_groups``).  Outside
    a group only the 1x1 mesh stands (one process, no collective); any
    other raises."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) == 2 and axes == ("data", "model"):
        return _rank_mesh(shape, device)
    if len(shape) != 1 or len(axes) != 1:
        raise ValueError(f"a mesh of one axis or a DATAxMODEL mesh over "
                         f"('data', 'model'), got shape {shape} over axes "
                         f"{axes}")
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
    return SPMesh(axis=axes[0], devices=(_here(device),) * shape[0])


def _here(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _rank_mesh(shape, device) -> RankMesh:
    D, M = (int(n) for n in shape)
    if D < 1 or M < 1:
        raise ValueError(f"a {D}x{M} mesh")
    g = group.current()
    if g is None:
        if D * M > 1:
            raise NotImplementedError(
                f"a {D}x{M} DATAxMODEL mesh runs one shard a process: start "
                f"{D * M} ranks under torchrun (python -m "
                f"torch.distributed.run --nproc-per-node {D * M} ...); one "
                f"process runs the 1x1 mesh only")
        return RankMesh((1, 1), _here(device))
    if D * M != g.world:
        raise ValueError(f"a {D}x{M} DATAxMODEL mesh in a group of {g.world} "
                         f"ranks: it runs one shard a rank, {D * M} ranks")
    if device is not None and resolve_device(device).type != g.device.type:
        raise ValueError(f"this rank's shard sits on {g.device}, not "
                         f"{device}")
    data, model = group.axis_groups(g, (D, M))
    return RankMesh((D, M), g.device, data=data if D > 1 else None,
                    model=model if M > 1 else None)


#: the card the roofline's terms are for, at the power limit of PERF.md's
#: runs: NVIDIA H100 80GB HBM3, 700 W (SXM5).  Datasheet figures, not
#: measurements: dense BF16 tensor-core peak and HBM3 bandwidth.  No
#: link bandwidth: the port computes no collective term yet.
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989.4e12    # FLOP/s, dense
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # bytes, the 80 GB of the card's name
