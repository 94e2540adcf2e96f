"""Parameter-server side (Alg. 1 line 5): weighted aggregation + broadcast.

Port of repro/federated/server.py. The reference's FedAvg mean
(utils/tree.py `tree_weighted_mean`) normalises the weights in float32
and folds over the clients in order; here the fold is one fold matmul over
the stacked deltas (mesh_rounds._weighted_client_sum): each output is one
fma chain over the clients, as in the stacked rounds' FedAvg.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from repro_torch.federated.mesh_rounds import _weighted_client_sum
from repro_torch.optim.api import apply_updates
from repro_torch.utils.tree import leaves, tree_map


def aggregate_updates(global_params: Any, deltas: List[Any],
                      data_sizes: Sequence[int]) -> Any:
    """FedAvg: w <- w + sum_m (D_m / D) * delta_m (Eq. 2 weighting)."""
    w = torch.as_tensor(np.asarray(data_sizes, np.float64),
                        device=leaves(global_params)[0].device
                        ).to(torch.float32)
    w = w / torch.sum(w)
    mean_delta = tree_map(
        lambda *ds: _weighted_client_sum(w, torch.stack(ds))[0], *deltas)
    return apply_updates(global_params, mean_delta)


def broadcast(global_params: Any, n_devices: int) -> List[Any]:
    """Broadcast the global model: one reference a client (nothing writes
    into a model's tensors, so no copies are needed)."""
    return [global_params for _ in range(n_devices)]
