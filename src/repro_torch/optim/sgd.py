"""SGD (+momentum) — the paper's local optimizer (mini-batch SGD)."""
from __future__ import annotations

import torch

from repro_torch.optim.api import Optimizer
from repro_torch.utils.tree import tree_map


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        del params
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_state = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lr * m, new_state), new_state

    return Optimizer(init=init, update=update)
