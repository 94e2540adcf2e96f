"""Nested-dict parameter trees.

Parameters are nested dicts of tensors (the reference's pytrees). Leaves
are visited in sorted-key order, which is JAX's flattening order for
dicts: the compression layout (federated/compression.py) concatenates
leaves in this order, so a client's quantizer rows line up with the
reference's row for row.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np


def leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts/tuples/lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree shaped like `like` holding `flat` (in `leaves` order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            items = [build(x) for x in t]
            # A NamedTuple (an optimizer state) takes its fields one by one.
            return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied leafwise over trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                  *map(leaves, rest))])


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """fn(path, leaf) applied leafwise: `path` is the tuple of keys from
    the root (a dict's key, a NamedTuple's field name, a tuple's or list's
    index), as jax.tree_util.tree_map_with_path's DictKey.key /
    GetAttrKey.name / SequenceKey.idx."""

    def walk(t, path: Tuple):
        if isinstance(t, dict):
            return {k: walk(t[k], path + (k,)) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            if hasattr(t, "_fields"):
                return type(t)(*(walk(x, path + (f,))
                                 for f, x in zip(t._fields, t)))
            return type(t)(walk(x, path + (i,)) for i, x in enumerate(t))
        return fn(path, t)

    return walk(tree, ())


def leaves_with_path(tree: Any) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in `leaves` order (tree_map_with_path's paths)."""
    out: List = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def tree_bytes(tree: Any) -> int:
    """Total bytes across all leaves (anything with .shape and .dtype
    whose dtype has an itemsize)."""
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in leaves(tree))


def structure(tree: Any) -> str:
    """The tree's shape without its leaves, as a string: dict keys (sorted),
    tuple and list lengths, and `*` for each leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(structure(t) for t in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"
