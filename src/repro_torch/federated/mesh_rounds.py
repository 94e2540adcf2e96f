"""The DEFL round step: Algorithm 1's round over a stacked client axis.

Port of repro/federated/mesh_rounds.py for one device, dense and fully
participating: clients are a stacked leading axis C on every param and
optimizer leaf. One round = V local SGD steps per client (batched over C
with torch.func.vmap) + weighted FedAvg + broadcast back to all C rows.
A fleet of S runs (Simulator.run_fleet) folds its members into that axis
(S*C rows, members major) where the reference vmaps its compiled chunk
over a member axis; each member still averages only its own C clients.

Aggregation modes:
  'allreduce'       the weighted FedAvg mean in float32 (paper-faithful).
  'int8_stochastic' every client's delta goes through the int8
                    stochastic-rounding quantize/dequantize roundtrip of
                    federated/compression.py (one kernel launch for all
                    clients of all members), then weighted FedAvg of the
                    reconstructions.
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
    """sum_c w_c x_c over each member's C clients, in float32: x is
    (S*C, ...) with members major, weights (C,); the result is (S, ...)."""
    C = weights.shape[0]
    x = x.reshape(-1, C, *x.shape[1:]).to(torch.float32)
    w = weights.to(torch.float32).reshape((1, C) + (1,) * (x.dim() - 2))
    return torch.sum(w * x, dim=1)


def _bcast_members(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(S, ...) member values onto all C rows of each member of the
    (S*C, ...) `like` (a view for one member)."""
    S = m.shape[0]
    return (m.to(like.dtype)[:, None]
            .expand(S, like.shape[0] // S, *m.shape[1:]).reshape(like.shape))


def _weighted_mean_bcast(stacked, weights):
    """Each member's sum_c w_c x_c, broadcast back to its C rows."""
    return tree_map(
        lambda x: _bcast_members(_weighted_client_sum(weights, x), x),
        stacked)


def _int8_stochastic_mean_bcast(new_params, old_params, weights, u):
    """Every client's delta through the int8 quantize/dequantize
    roundtrip (u: the (S*C, rows, 1024) rounding noise; all clients of
    all members in one launch), then each member's weighted mean of the
    reconstructions added to its old global model (its first client row:
    all its rows are equal before the round) and broadcast."""
    deltas = tree_map(lambda n, o: n - o, new_params, old_params)
    rec = compression.decompress_update(compression.compress_update(deltas, u))
    C = weights.shape[0]

    def agg(r, old):
        mean = _weighted_client_sum(weights, r.reshape(r.shape[0], -1))
        glob = old.reshape(-1, C, mean.shape[1])[:, 0].to(torch.float32)
        out = (glob + mean).reshape(-1, *old.shape[1:])
        return _bcast_members(out, old)

    return tree_map(agg, rec, old_params)


def build_round_step(loss_fn: Callable, opt: Optimizer,
                     aggregation: str = "allreduce"):
    """round_step(params_C, opt_C, batches, weights, u=None) ->
    (params_C', opt_C', per_client_loss). The leading axis of params_C,
    opt_C and batches (leaves (N, V, ...)) holds S members of C clients
    each, members major (N = S*C; S = 1 for one run); weights are the
    (C,) FedAvg weights summing to 1, shared by the members; u is the
    (N, rows, 1024) quantizer noise, needed by 'int8_stochastic'."""
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


def build_fleet_chunk(loss_fn: Callable, opt: Optimizer, n_clients: int,
                      compress: bool, batch_from: Callable, noise: Callable,
                      rows: int):
    """A chunk of rounds for S members (fleet runs; S = 1 for one run)
    with no host synchronisation inside:
    chunk_step(params, opt_state, generators, weights, data, idx) ->
    (params', opt_state', losses). The members are folded into the client
    axis: params and opt_state leaves are (S*C, ...), members major, so
    each round is ONE vmap(grad_and_value) over all S*C clients and one
    per-member weighted FedAvg. idx (R, S*C, V, B) holds the global sample
    indices of R rounds, gathered on the device from `data` by
    `batch_from`; losses are the (S, R) per-round train losses on the
    device (each member's unweighted client mean, as the reference's scan
    path reports).

    With compress, each round draws member s's quantizer noise as one
    noise(generators[s], (C, rows, 1024)) call, in member order (the
    draws a run of that member alone makes), and quantizes all S*C
    clients' updates in ONE kernel launch."""
    step = build_round_step(
        loss_fn, opt, "int8_stochastic" if compress else "allreduce")

    def chunk_step(params, opt_state, generators, weights, data: Dict, idx):
        losses = []
        for r in range(idx.shape[0]):
            u = None
            if compress:
                us = [noise(g, (n_clients, rows, compression.ROW))
                      for g in generators]
                u = us[0] if len(us) == 1 else torch.cat(us)
            params, opt_state, per_client = step(
                params, opt_state, batch_from(data, idx[r]), weights, u)
            losses.append(per_client.reshape(-1, n_clients).mean(dim=1))
        return params, opt_state, torch.stack(losses, dim=1)

    return chunk_step


def replicate_clients(tree, n_clients: int):
    """Identical client copies on a new leading axis (views)."""
    return tree_map(lambda x: x[None].expand((n_clients, *x.shape)), tree)
