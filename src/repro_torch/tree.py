"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port keeps parameters and optimizer states as plain nested
containers, as the JAX package keeps pytrees.  The traversal order is
JAX's: dict keys sorted, sequences in order, ``None`` an empty subtree.
Paths name a leaf as the JAX checkpoint does (``"/"``-joined dict keys
and list indices, ``".field"`` for a NamedTuple field), so the two
packages write the same manifest for the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    """(path component, child) pairs of a container in JAX's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree, values):
    """A container of ``tree``'s type holding ``values`` in the order of
    :func:`_children`."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def tree_map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *leaves_of_rest)`` over ``tree`` and trees of the
    same structure ``rest``; containers are rebuilt, ``None`` stays."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree, *rest)
    rest_kids = [[c for _, c in _children(r)] for r in rest]
    return _rebuild(tree, [
        tree_map_with_path(fn, child, *(rk[i] for rk in rest_kids),
                           prefix=f"{prefix}/{name}" if prefix else name)
        for i, (name, child) in enumerate(kids)])


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and ``rest``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's order."""
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten_like(like, leaves):
    """A tree of the structure of ``like`` holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
