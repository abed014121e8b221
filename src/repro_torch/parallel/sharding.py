"""Sharding rules: logical-to-mesh mapping for params, batches and caches.

Port of ``repro.parallel.sharding``.  Mesh axes: ``("pod", "data",
"model")`` (several pods) or ``("data", "model")`` (one pod).

* params      -- specs come from the model init (``specs=True``:
                 divisibility-aware TP, experts over ``"model"``);
                 axes absent from the mesh are dropped.
* train batch -- leading batch dim over ("pod", "data") (DP).
* decode      -- cache leading dim over the DP axes when the batch is
                 large; for batch-1 long-context decode the *sequence*
                 axis of a cache leaf shards over ``"data"`` (SP) and its
                 leading dim over ``"model"`` when divisible.

No compiler partitions the port's program, so a :class:`Mesh` here is a
description -- axis names and sizes, no devices -- and a sharding is a
:class:`NamedSharding` of a mesh and a spec: a plain tuple with one
entry per dimension, ``None``, an axis name or a tuple of axis names
(``()`` replicated), the entries of the reference's ``PartitionSpec``.
:func:`shard_shape` and :func:`per_device_bytes` read what one card
holds (``launch.dryrun``).  The reference's ``axis_type_kwargs`` is a
shim over JAX versions' mesh constructors and has no counterpart.

:func:`shard_params` cuts one rank's shards of a parameter tree from
the whole tree by its specs, on a ``parallel.tensor.RankMesh`` (one
shard a process), and :func:`unshard_params` all-gathers them back.
The fused ``wkv`` (k and v in one ``(d, 2 hkv hd)`` projection) splits
by head: rank m holds the k columns of its kv heads and the v columns
of the same heads, ``[K_m | V_m]``, so that ``models/attention.py``'s
``torch.chunk(..., 2)`` still parts k from v on a shard (a contiguous
split would give rank 0 all of k and rank 1 all of v).  A card holds
the same bytes either way, so :func:`per_device_bytes` reads the specs
alone.

The port's decode caches are per layer (the reference stacks a scanned
model's caches on a leading layer axis), so the layer offset of the
cache rule is always 0; every leaf of a cache tree -- ``H1DCache``
levels, a sliding-window layer's rolling ``{"k", "v", "pos"}``, an
``SSMState``, an ``SPCache``'s slabs -- takes the rule by its own shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..tree import tree_map

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh by its axes alone: ``axis_names`` and their sizes
    ``axis_sizes`` (the reference's ``AbstractMesh``)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} "
                             "differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.axis_sizes)


def abstract_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


class NamedSharding(NamedTuple):
    """A mesh and the spec of one array on it."""
    mesh: Mesh
    spec: Spec


def _entry(ax):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: a
    tuple of one axis is that axis, an empty one None."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


def named(mesh: Mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(_entry(ax) for ax in spec))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def tp_axis(mesh: Mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def tp_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def is_spec(x) -> bool:
    """A spec leaf of a spec tree: a tuple (dicts and lists are the
    tree's containers)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_specs(fn, specs):
    """``fn`` over the spec leaves of ``specs`` (dicts and lists)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v) for v in specs]
    if is_spec(specs):
        return fn(specs)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def param_shardings(mesh: Mesh, specs: Any):
    """Model init specs -> a tree of :class:`NamedSharding` (axes absent
    from the mesh dropped)."""
    names = set(mesh.axis_names)

    def fix(spec: Spec) -> NamedSharding:
        clean = []
        for ax in spec:
            if ax is None:
                clean.append(None)
            elif isinstance(ax, str):
                clean.append(ax if ax in names else None)
            else:
                clean.append(tuple(a for a in ax if a in names))
        return named(mesh, clean)

    return map_specs(fix, specs)


def batch_shardings(mesh: Mesh, batch_tree: Any):
    """Leading dim of every batch leaf over the DP axes."""
    bd = dp_axes(mesh)

    def one(leaf):
        return named(mesh, (bd,) + (None,) * (leaf.dim() - 1))

    return tree_map(one, batch_tree)


def cache_shardings(mesh: Mesh, cache_tree: Any, *, batch: int,
                    kv_heads: int, long_context: bool):
    """Decode-cache shardings (see the module docstring).

    Heuristic per leaf: batch-major leaves shard dim 0 over DP (and over
    ``"model"`` too when it divides); in long-context (batch 1) mode the
    longest axis past dim 0 shards over ``"data"`` (sequence
    parallelism) and dim 0 over ``"model"`` when it divides.  ``batch``
    and ``kv_heads`` are the reference's arguments, which its rule does
    not read either."""
    bd = dp_axes(mesh)
    dsz = dp_size(mesh)
    tsz = tp_size(mesh)

    def one(leaf: torch.Tensor) -> NamedSharding:
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return replicated(mesh)
        spec: list = [None] * nd
        if not long_context:
            # dim 0 over the DP axes only: the decode compute (q from the
            # batch-sharded tokens) lives on DP
            if tsz > 1 and shape[0] % (dsz * tsz) == 0:
                spec[0] = bd + ("model",)
                return named(mesh, spec)
            if shape[0] % dsz == 0:
                spec[0] = bd
                return named(mesh, spec)
            return replicated(mesh)
        # long context: SP over the sequence axis
        if shape[0] % tsz == 0 and tsz > 1:
            spec[0] = "model"
        if nd >= 2:
            seq_ax = 1 + max(range(nd - 1), key=lambda i: (shape[1 + i], -i))
            if shape[seq_ax] % mesh.shape.get("data", 1) == 0:
                spec[seq_ax] = "data"
        return named(mesh, spec)

    return tree_map(one, cache_tree)


def _spec_of(s) -> Spec:
    return s.spec if isinstance(s, NamedSharding) else s


def shard_shape(shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape one device holds of an array of ``shape`` under ``spec``
    (a spec or a :class:`NamedSharding`): each sharded dim divided by
    the product of its axes' sizes, rounded up as a padded shard is."""
    spec = _spec_of(spec)
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        k = math.prod(mesh.shape.get(a, 1) for a in axes)
        out.append(-(-int(n) // k))
    return tuple(out)


def per_device_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta ones included)
    under ``specs``: a tree of its structure whose leaves are specs or
    :class:`NamedSharding` s (an init's spec tree, or what the rules
    above return); one sharding stands for every leaf below it."""
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in leaf_shardings(tree, specs))


def leaf_shardings(tree, specs) -> list:
    """(tensor, spec) pairs of ``tree``'s tensor leaves, walked beside
    ``specs`` (as :func:`per_device_bytes` reads them)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if not isinstance(tree, (dict, list, tuple)):
        return []               # a Python number: held by the host
    if isinstance(specs, NamedSharding):
        from ..tree import tree_leaves
        return [(t, specs) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)]
    if isinstance(tree, dict):
        return [p for k in tree for p in leaf_shardings(tree[k], specs[k])]
    if hasattr(tree, "_fields"):
        return [p for f in tree._fields
                for p in leaf_shardings(getattr(tree, f), getattr(specs, f))]
    if len(tree) != len(specs):
        raise ValueError(f"{len(tree)} subtrees but {len(specs)} specs")
    return [p for t, s in zip(tree, specs) for p in leaf_shardings(t, s)]


# ---------------------------------------------------------------------------
# one rank's shards of a parameter tree
# ---------------------------------------------------------------------------

def spec_leaves(specs) -> list:
    """The spec leaves of an init's spec tree in the order
    ``tree_leaves`` walks its parameters (dict keys sorted, lists in
    order)."""
    if is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for x in specs for s in spec_leaves(x)]


def _model_dims(spec) -> list:
    dims = []
    for i, ax in enumerate(spec):
        if ax == "model":
            dims.append(i)
        elif ax is not None and ax != ():
            raise NotImplementedError(
                f"spec {spec}: one shard a process splits leaves over "
                f"'model' only")
    return dims


def _parts(path: str, dim: int, ndim: int) -> int:
    """How many parts the split axis ``dim`` of the leaf at ``path``
    fuses, each cut on its own: 2 for ``wkv``'s output axis (k's heads,
    then v's, so rank m takes ``[K_m | V_m]``), 1 for any other."""
    return 2 if dim == ndim - 1 and path.split("/")[-2:-1] == ["wkv"] else 1


def _cut(path, t, spec, M, m):
    for dim in _model_dims(spec):
        k = _parts(path, dim, t.dim())
        t = torch.cat([torch.chunk(part, M, dim)[m]
                       for part in torch.chunk(t, k, dim)], dim)
    return t.contiguous()


def shard_params(params, specs, mesh):
    """This rank's shards of ``params`` (the whole tree, every rank's
    draw from the same seed) under the init's ``specs`` on ``mesh`` (a
    ``parallel.tensor.RankMesh``): each axis over ``"model"`` cut into
    M equal parts, part m kept (``wkv`` part by part, :func:`_parts`);
    replicated leaves as they are."""
    from ..tree import tree_flatten_with_paths, tree_unflatten_like
    M, m = mesh.M, mesh.coords[1]
    flat = tree_flatten_with_paths(params)
    sl = spec_leaves(specs)
    return tree_unflatten_like(params, [
        _cut(path, t, s, M, m) if M > 1 else t
        for (path, t), s in zip(flat, sl)])


@torch.no_grad()
def unshard_params(params, specs, mesh):
    """The whole tree from every rank's shards (:func:`shard_params`'
    inverse): an all-gather over the model group for each split leaf,
    the same on every rank."""
    from ..tree import tree_flatten_with_paths, tree_unflatten_like
    from . import group as grp
    g = mesh.model
    flat = tree_flatten_with_paths(params)
    if g is None:
        return params
    out = []
    for (path, t), spec in zip(flat, spec_leaves(specs)):
        for dim in _model_dims(spec):
            k = _parts(path, dim, t.dim())
            t = torch.cat([grp.all_gather(part, g, dim, grad="slice")
                           for part in torch.chunk(t, k, dim)], dim)
        out.append(t)
    return tree_unflatten_like(params, out)
