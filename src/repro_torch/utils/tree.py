"""Nested-dict parameter trees.

Parameters are nested dicts of tensors (the reference's pytrees). Leaves
are visited in sorted-key order, which is JAX's flattening order for
dicts: the compression layout (federated/compression.py) concatenates
leaves in this order, so a client's quantizer rows line up with the
reference's row for row.
"""
from __future__ import annotations

from typing import Any, Callable, List

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
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied leafwise over trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                  *map(leaves, rest))])


def tree_bytes(tree: Any) -> int:
    """Total bytes across all leaves (anything with .shape and .dtype
    whose dtype has an itemsize)."""
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in leaves(tree))
