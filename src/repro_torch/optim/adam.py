"""AdamW from scratch (the optimizer of the LLM-architecture federated
configs). Port of repro/optim/adam.py: an int32 step, the bias
corrections in float32, decoupled weight decay."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.api import Optimizer
from repro_torch.utils.tree import leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: object
    nu: object


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdamState(
            step=torch.zeros((), dtype=torch.int32,
                             device=leaves(params)[0].device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(grads, state, params=None):
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1 - torch.pow(torch.full_like(t, b2), t)

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr * weight_decay * p
            return u

        if params is None:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        else:
            updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)
