"""Minimal functional optimizer API (the reference's optax-style pair)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

from repro_torch.utils.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
