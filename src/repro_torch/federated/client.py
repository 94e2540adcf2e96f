"""Client-side local computation (Alg. 1 line 3) and batch scheduling.

Port of repro/federated/client.py: one client's V local SGD steps
(`make_local_update`, `client_round`) and the stacking helpers that feed
the simulator's backends, for a dense population (every client every
round) and for sampled cohorts (`stack_cohort_batches`,
`stack_cohort_indices`: lane k of a round holds client cohort[k]). Every
helper consumes the client iterators round by round, client (lane) by
client, step by step — the reference's order — so the per-client loop,
the batched round and the chunked path all draw the same batches.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.federated import mesh_rounds
from repro_torch.optim.api import Optimizer
from repro_torch.utils.tree import tree_map


def make_local_update(value_and_grad: Callable, opt: Optimizer):
    """One client's V-step local update: local_update(params, opt_state,
    batches) -> (params', opt_state', losses (V,)), batches leaves (V,
    ...). It runs the simulator's stacked value_and_grad(params_N,
    batch_N) -> (grads_N, loss (N,)) on a one-row stack (N = 1), the steps
    of mesh_rounds.local_steps: so on the card a client's numbers here are
    its row of a stacked round (the CNN's products are fold matmuls, whose
    rows do not depend on the rows beside them)."""

    def local_update(params, opt_state, batches):
        one = lambda x: x[None]  # noqa: E731
        p, s, losses = mesh_rounds.local_steps(
            value_and_grad, opt, tree_map(one, params),
            tree_map(one, opt_state), tree_map(one, batches))
        first = lambda x: x[0]  # noqa: E731
        return (tree_map(first, p), tree_map(first, s),
                torch.stack([loss[0] for loss in losses]))

    return local_update


def client_round(local_update, global_params, opt_state, batches_stacked,
                 ) -> Tuple[Any, Any, torch.Tensor]:
    """One client's round: start at the global model, work V steps, return
    the local model update (delta), the optimizer state and the V
    losses."""
    new_params, opt_state, losses = local_update(
        global_params, opt_state, batches_stacked)
    delta = tree_map(lambda n, g: n - g, new_params, global_params)
    return delta, opt_state, losses


def stack_batches(batches: List[Dict]) -> Dict:
    """[batch, ...] (length V) -> a host tree with a leading V axis."""
    return tree_map(lambda *xs: np.stack(xs), *batches)


def stack_client_batches(iterators: List, V: int) -> Dict:
    """One round of batches for all M clients -> a host tree with leading
    (M, V) axes: the batched round's single upload. Consumes each
    iterator in the per-client loop's order."""
    per_client = [stack_batches([it.next_batch() for _ in range(V)])
                  for it in iterators]
    return stack_batches(per_client)


def stack_chunk_batches(iterators: List, rounds: int, V: int) -> Dict:
    """A whole chunk of rounds -> a host tree with leading (R, M, V) axes:
    the chunked path's data for sources without the index protocol
    (one upload a chunk). Consumes each iterator round by round in
    `stack_client_batches` order, so a chunked run sees the batch stream
    of R per-round runs."""
    return stack_batches([stack_client_batches(iterators, V)
                          for _ in range(rounds)])


def stack_chunk_indices(iterators: List, rounds: int, V: int) -> np.ndarray:
    """A whole chunk of batch *indices* -> (R, M, V, B) int32. Only the
    indices cross the host->device boundary; the samples are gathered on
    the device (BatchIterator.batch_from). Iterators are consumed round
    by round, client by client, step by step — the reference's order, so
    the drawn batches are the reference's."""
    out = np.empty(
        (rounds, len(iterators), V, iterators[0].batch_size), np.int32)
    for r in range(rounds):
        for c, it in enumerate(iterators):
            for v in range(V):
                out[r, c, v] = it.next_indices()
    return out


def _client_iter(source, m: int):
    """Client m's iterator from either data source: a ClientDataPool (lazy,
    population-scale) or a dense iterator list."""
    return source.client(m) if hasattr(source, "client") else source[m]


def stack_cohort_batches(source, cohort: np.ndarray, V: int) -> Dict:
    """One sampled round of batches -> a host tree with leading (K, V)
    axes: lane k holds client cohort[k]'s next V batches. Lanes are
    consumed in ascending-cohort (lane) order, so at K = M (cohort ==
    arange(M)) this consumes every iterator exactly like
    `stack_client_batches`."""
    return stack_batches([
        stack_batches([_client_iter(source, int(m)).next_batch()
                       for _ in range(V)])
        for m in np.asarray(cohort)])


def stack_cohort_indices(source, cohorts: np.ndarray, V: int) -> np.ndarray:
    """A sampled chunk of batch indices -> (R, K, V, B) int32: round r's
    lane k draws from client cohorts[r, k]'s stream. Only participating
    clients' iterators advance (absent clients keep their batch cursor and
    re-enter later where they left off); per round, lanes are consumed in
    ascending order, so at K = M this is `stack_chunk_indices` over the
    full iterator list, draw for draw."""
    cohorts = np.asarray(cohorts)
    R, K = cohorts.shape
    bs = (source.batch_size if hasattr(source, "batch_size")
          else source[0].batch_size)
    out = np.empty((R, K, V, bs), np.int32)
    for r in range(R):
        for k in range(K):
            it = _client_iter(source, int(cohorts[r, k]))
            for v in range(V):
                out[r, k, v] = it.next_indices()
    return out
