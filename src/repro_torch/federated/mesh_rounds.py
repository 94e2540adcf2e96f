"""The DEFL round step: Algorithm 1's round over a stacked client axis.

Port of repro/federated/mesh_rounds.py for one device, dense and fully
participating: clients are a stacked leading axis C on every param and
optimizer leaf. One round = V local SGD steps per client (batched over C
with torch.func.vmap) + weighted FedAvg + broadcast back to all C rows.

Aggregation modes:
  'allreduce'       the weighted FedAvg mean in float32 (paper-faithful).
  'int8_stochastic' every client's delta goes through the int8
                    stochastic-rounding quantize/dequantize roundtrip of
                    federated/compression.py (one kernel launch for all
                    clients), then weighted FedAvg of the reconstructions.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import grad_and_value, vmap

from repro_torch.federated import compression
from repro_torch.optim.api import Optimizer, apply_updates
from repro_torch.utils.tree import tree_map


def local_steps_fn(loss_fn: Callable, opt: Optimizer):
    """(params_C, opt_C, batches) -> (params_C', opt_C', mean_loss (C,)).

    batches leaves are (C, V, ...): client c takes V SGD steps on its own
    batches. The V-step loss mean is a left fold, as in the reference."""
    grad_C = vmap(grad_and_value(loss_fn))

    def run(params, opt_state, batches):
        V = next(iter(batches.values())).shape[1]
        total = 0.0
        for v in range(V):
            grads, loss = grad_C(params, {k: b[:, v] for k, b in batches.items()})
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            total = total + loss
        return params, opt_state, total / V

    return run


def _weighted_client_sum(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_c w_c x_c over the leading client axis, in float32."""
    w = weights.to(torch.float32).reshape((weights.shape[0],) + (1,) * (x.dim() - 1))
    return torch.sum(w * x.to(torch.float32), dim=0)


def _weighted_mean_bcast(stacked, weights):
    """sum_c w_c x_c, broadcast back to all C rows (as a view)."""
    return tree_map(
        lambda x: _weighted_client_sum(weights, x).to(x.dtype)[None].expand_as(x),
        stacked)


def _int8_stochastic_mean_bcast(new_params, old_params, weights, u):
    """Every client's delta through the int8 quantize/dequantize
    roundtrip (u: the (C, rows, 1024) rounding noise), then the weighted
    mean of the reconstructions added to the old global model (client
    row 0: all rows are equal before the round) and broadcast."""
    deltas = tree_map(lambda n, o: n - o, new_params, old_params)
    rec = compression.decompress_update(compression.compress_update(deltas, u))

    def agg(r, old):
        mean = _weighted_client_sum(weights, r.reshape(r.shape[0], -1))
        out = old[0].reshape(-1).to(torch.float32) + mean
        return out.reshape(old.shape[1:]).to(old.dtype)[None].expand_as(old)

    return tree_map(agg, rec, old_params)


def build_round_step(loss_fn: Callable, opt: Optimizer,
                     aggregation: str = "allreduce"):
    """round_step(params_C, opt_C, batches, weights, u=None) ->
    (params_C', opt_C', per_client_loss (C,)), batches leaves (C, V, ...),
    weights (C,) FedAvg weights summing to 1; u is the quantizer noise,
    needed by 'int8_stochastic'."""
    if aggregation not in ("allreduce", "int8_stochastic"):
        raise ValueError(aggregation)
    local = local_steps_fn(loss_fn, opt)

    def round_step(params_C, opt_C, batches, weights, u=None):
        new_p, new_s, losses = local(params_C, opt_C, batches)
        if aggregation == "allreduce":
            agg_p = _weighted_mean_bcast(new_p, weights)
        else:
            agg_p = _int8_stochastic_mean_bcast(new_p, params_C, weights, u)
        return agg_p, new_s, losses

    return round_step


def build_round_chunk(loss_fn: Callable, opt: Optimizer, n_clients: int,
                      compress: bool, batch_from: Callable, noise: Callable,
                      rows: int):
    """A chunk of rounds with no host synchronisation inside:
    chunk_step(params_C, opt_C, generator, weights, data, idx) ->
    (params_C', opt_C', losses) with idx (R, C, V, B) the global sample
    indices of R rounds, gathered on the device from `data` by
    `batch_from`, and losses the (R,) per-round train losses on the device
    (the unweighted client mean, as the reference's scan path reports).

    With compress, each round draws its quantizer noise as ONE
    noise(generator, (C, rows, 1024)) call before aggregation."""
    step = build_round_step(
        loss_fn, opt, "int8_stochastic" if compress else "allreduce")

    def chunk_step(params_C, opt_C, generator, weights, data: Dict, idx):
        losses = []
        for r in range(idx.shape[0]):
            u = (noise(generator, (n_clients, rows, compression.ROW))
                 if compress else None)
            params_C, opt_C, per_client = step(
                params_C, opt_C, batch_from(data, idx[r]), weights, u)
            losses.append(per_client.mean())
        return params_C, opt_C, torch.stack(losses)

    return chunk_step


def replicate_clients(tree, n_clients: int):
    """Identical client copies on a new leading axis (views)."""
    return tree_map(lambda x: x[None].expand((n_clients, *x.shape)), tree)
