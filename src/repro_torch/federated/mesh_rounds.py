"""The DEFL round step: Algorithm 1's round over a stacked client axis.

Port of repro/federated/mesh_rounds.py for one device: clients are a
stacked leading axis C on every param and optimizer leaf. One round = V
local SGD steps per client (batched over C by a stacked value-and-grad:
the CNN's own, cnn.cnn_value_and_grad, or torch.func.vmap of a loss) +
weighted FedAvg + broadcast back to all C rows. A fleet of S runs
(Simulator.run_fleet) folds its members into that axis (S*C rows, members
major) where the reference vmaps its compiled chunk over a member axis;
each member still averages only its own C clients.

A Study group (federated/study.py) folds members with different (b, V)
plans the same way, padded into the group's (V_env, B_env) envelope and
stacked by V, largest first: local step v runs only on the lanes whose
member still steps, a prefix of the stack, trimmed to their largest b,
and a per-row mask drops a padded sample's loss (envelope_schedule,
envelope_local_steps_fn, build_fleet_chunk(envelope=True)).

Under a scenario the round is masked: a per-round (S*C,) participation
mask renormalises each member's FedAvg weights over its participating
clients, dropped clients keep their pre-round params and optimizer state,
and the fault layer's guard and quorum gate act on the same mask (see
build_round_step and build_fleet_chunk). The reference's in-graph float32
Eq. 8 clock (`_masked_clock`) and its in-graph uplink bits are not
ported: nothing in the port reads them, because the records take the
clock and the bits from the float64 host model (core/delay.py).

Sampled participation (Simulator(cohort=K)) runs the same round over K
lanes, each round occupied by a freshly drawn cohort of the M-client
population: lanes change owners every round, so the per-lane FedAvg
sizes arrive as one (S, K) row a round instead of a chunk constant
(build_fleet_chunk's (R, S, K) weights). At K = M the rows equal the dense
constant and the ops are the same, so the result is the dense result bit
for bit.

The asynchronous backend (Simulator(backend='async'), build_async_chunk)
runs arrival events instead of rounds: one client a event, popped from a
device-side finish-time array, its update staleness-weighted into a
buffer that fires an aggregation every K kept updates.

Aggregation modes (the reference's five):
  'allreduce'          the weighted FedAvg mean in float32
                       (paper-faithful), every lane on this process.
  'allreduce_shardmap' the client axis sharded over the ranks of the
                       default process group (sharding/collectives.py):
                       each rank folds the weighted sum of its own lanes,
                       one all_reduce adds the partials, each rank
                       broadcasts the sum onto its rows (the reference's
                       `_psum_shardmap_sync`). Simulator(shard_clients=
                       True) runs it.
  'int8_shardmap'      sharded too: each lane's delta quantized to int8
                       per row (scale absmax/127), the int8 codes and
                       float32 scales all-gathered, dequantized and
                       combined after the gather (`_int8_shardmap_sync`).
  'int8_gather'        the same quantization on one process, contracted
                       over the C lanes (`_int8_gather_mean_bcast`).
  'int8_stochastic'    every client's delta goes through the int8
                       stochastic-rounding quantize/dequantize roundtrip
                       of federated/compression.py (one kernel launch for
                       all clients of all members), then weighted FedAvg
                       of the reconstructions.
The two deterministic int8 modes quantize in plain torch, as the
reference does in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.federated import compression
from repro_torch.kernels.fold_matmul.ops import fold_matmul
from repro_torch.optim.api import Optimizer, apply_updates
from repro_torch.sharding import collectives
from repro_torch.utils import spans
from repro_torch.utils.tree import leaves, tree_map, unflatten

AGGREGATIONS = ("allreduce", "allreduce_shardmap", "int8_shardmap",
                "int8_gather", "int8_stochastic")
# The modes whose round runs on this rank's lanes of the client axis.
SHARDED = ("allreduce_shardmap", "int8_shardmap")


def vmapped_value_and_grad(loss_fn: Callable,
                           masked_loss_fn: Optional[Callable] = None):
    """The stacked value-and-grad of a per-client loss by torch.func.vmap:
    (params_N, batch_N, sample_mask=None, n=None) -> (grads_N, loss (N,)),
    over loss_fn(params, batch), or with a sample mask over
    masked_loss_fn(params, batch, sample_mask, n)."""
    plain = vmap(grad_and_value(loss_fn))
    masked = (None if masked_loss_fn is None
              else vmap(grad_and_value(masked_loss_fn)))

    def value_and_grad(params, batch, sample_mask=None, n=None):
        if sample_mask is None:
            return plain(params, batch)
        return masked(params, batch, sample_mask, n)

    return value_and_grad


def local_steps(value_and_grad: Callable, opt: Optimizer, params,
                opt_state, batches):
    """V SGD steps of every stacked client on its own batches (leaves (C,
    V, ...)): (params_C', opt_C', [loss (C,) of each step])."""
    losses = []
    for v in range(next(iter(batches.values())).shape[1]):
        grads, loss = value_and_grad(
            params, {k: b[:, v] for k, b in batches.items()})
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
    return params, opt_state, losses


def fold_mean(losses) -> torch.Tensor:
    """The mean of a sequence of loss tensors as a left fold, as in the
    reference: ((0 + l_0) + l_1) + ... over len(losses), elementwise."""
    total = 0.0
    for loss in losses:
        total = total + loss
    # Over a tensor: a Python number would make CUDA multiply by its
    # rounded reciprocal, an ulp away from the envelope form's division
    # by v_count.
    return total / torch.full_like(total, len(losses))


def local_steps_fn(value_and_grad: Callable, opt: Optimizer):
    """(params_C, opt_C, batches) -> (params_C', opt_C', mean_loss (C,)).

    batches leaves are (C, V, ...): client c takes V SGD steps on its own
    batches; value_and_grad(params_C, batch) gives every client's gradient
    and loss at once (vmapped_value_and_grad, or a model's own stacked
    form such as cnn.cnn_value_and_grad). The V-step loss mean is a left
    fold (fold_mean)."""

    def run(params, opt_state, batches):
        params, opt_state, losses = local_steps(value_and_grad, opt, params,
                                                opt_state, batches)
        return params, opt_state, fold_mean(losses)

    return run


def envelope_schedule(v_mask: np.ndarray, rows: np.ndarray):
    """The envelope's local steps as host data: [(n_v, b_v)] for v <
    V_env, from the host arrays of a group's env (no device read). v_mask
    (N, V_env) bool marks each lane's own steps and rows (N,) the sample
    rows its steps compute (its b, or B_env when the envelope is forced).
    The lanes live at step v must be the prefix [:n_v] of the stack (the
    Study stacks its members by V, largest first); b_v is their largest
    rows, 0 where no lane steps."""
    n = v_mask.sum(axis=0)
    if not np.array_equal(v_mask, np.arange(len(rows))[:, None] < n):
        raise ValueError("envelope lanes that step must be a prefix of the "
                         "stack at every step: stack the members by V, "
                         "largest first")
    widest = np.maximum.accumulate(rows)
    return [(int(k), int(widest[k - 1]) if k else 0) for k in n]


def envelope_local_steps_fn(value_and_grad: Callable, opt: Optimizer):
    """`local_steps_fn` over a padded (V_env, B_env) shape envelope: the
    Study runs arms with different (b, V) plans as one folded fleet by
    padding every member to its group's envelope.

    (params_C, opt_C, batches, env) -> (params_C', opt_C', mean_loss (N,)).
    batches leaves are (N, V_env, B_env, ...), each row's real V x b
    draws zero-padded along both axes; value_and_grad(params, batch,
    sample_mask, n) differentiates the masked loss
    (models.cnn.cnn_loss_masked). env holds one row a client (N = S*C,
    each member's values repeated over its C clients):
      v_mask      (N, V_env) host bool, True on the member's own local
                  steps
      rows        (N,) host int, the sample rows its steps compute
      sample_mask (N, B_env) 1.0 on the member's b samples
      n_samples   (N,) b, and v_count (N,) V, as float32
    Step v computes only the live lanes, the prefix [:n_v] of the stack,
    on their first b_v rows (envelope_schedule): parameters, optimizer
    state, batch, sample mask and n_samples are views of those rows, and
    the step's result is written into the first n_v rows of the round's
    output state, whose other rows keep their values bit for bit. The
    output never aliases the input state, which the aggregation reads. A
    group whose members share one plan steps every lane at B_env rows,
    as a fleet does. The loss fold adds each live lane's step loss (a dead
    step adds nothing) and divides by the member's own V (never by
    V_env).

    Counters (utils/spans, recorded only under a profiler), host
    arithmetic over the schedule: fl.envelope.sample_steps, the sum of
    n_v x b_v over the computed steps, and fl.envelope.full_sample_steps,
    N x V_env x B_env, what the padded envelope holds."""

    def run(params, opt_state, batches, env):
        steps = envelope_schedule(env["v_mask"], env["rows"])
        N = len(env["rows"])
        spans.count("fl.envelope.sample_steps", sum(n * b for n, b in steps))
        spans.count("fl.envelope.full_sample_steps",
                    N * len(steps) * env["sample_mask"].shape[1])
        inputs = {id(x) for x in leaves((params, opt_state))}

        def put(out, new, n):
            # The round's input is the aggregation's: write into a copy.
            if id(out) in inputs:
                out = out.clone(memory_format=torch.contiguous_format)
            out[:n].copy_(new)
            return out

        total = env["v_count"].new_zeros(N)
        for v, (n, b) in enumerate(steps):
            if n == 0:
                continue  # no lane steps
            p, s = ((params, opt_state) if n == N else
                    tree_map(lambda x: x[:n], (params, opt_state)))
            grads, loss = value_and_grad(
                p, {k: x[:n, v, :b] for k, x in batches.items()},
                env["sample_mask"][:n, :b], env["n_samples"][:n])
            updates, new_s = opt.update(grads, s, p)
            new_p = apply_updates(p, updates)
            if n == N:
                params, opt_state = new_p, new_s
            else:
                params, opt_state = tree_map(
                    lambda o, x: put(o, x, n), (params, opt_state),
                    (new_p, new_s))
            total[:n] += loss
        return params, opt_state, total / env["v_count"]

    return run


def _participation_weights(sizes: torch.Tensor, mask: torch.Tensor):
    """FedAvg weights renormalised over each member's participating
    clients: sizes (C,) raw data sizes shared by the members, or (S, C)
    one row a member (sampled cohorts: lane c holds another client in each
    member), mask (S*C,) 1.0 where the update arrived -> ((S, C) weights,
    (S,) any participant).

    Each member has its own mask, so the weights are (S, C), one row a
    member, where the dense path shares one (C,) vector. Dropped clients
    get weight exactly 0 (their rows are also reset to pre-round values
    before the sum, so they add an exact +0.0); a zero-participation
    member divides by 1 instead of 0 and keeps its old params
    (`_keep_old_params`)."""
    C = sizes.shape[-1]
    wm = sizes.to(torch.float32) * mask.to(torch.float32).reshape(-1, C)
    s = torch.sum(wm, dim=1, keepdim=True)
    any_p = s > 0
    return wm / torch.where(any_p, s, 1.0), any_p[:, 0]


def _rows(flags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(S,) member flags as a (S*C, 1, ...) row selector for x."""
    return flags.repeat_interleave(x.shape[0] // flags.shape[0]).reshape(
        (x.shape[0],) + (1,) * (x.dim() - 1))


def _keep_old_params(agg_p, old_params, any_p: torch.Tensor):
    """Zero-participation guard, per member: a member whose round had no
    participant keeps all its rows' old params."""
    return tree_map(lambda a, o: torch.where(_rows(any_p, a), a, o.to(a.dtype)),
                    agg_p, old_params)


def _select_participating_state(new, old, mask: torch.Tensor):
    """Per-client select: dropped clients (mask 0) keep their pre-round
    rows. torch.where and never mask * x: 0 * NaN is NaN."""
    def sel(n, o):
        m = mask.reshape((mask.shape[0],) + (1,) * (n.dim() - 1))
        return torch.where(m > 0, n, o)

    return tree_map(sel, new, old)


def _guard_clients(guard, new_p, params_C, losses, mask):
    """Divergence-guard sanitation of the per-client updates (fault
    layer): guard is the static (max_norm, reject_nonfinite) pair of
    faults.FaultModel.guard_spec. Per client the update's L2 norm over all
    leaves decides: a non-finite norm or loss, with reject, drops the
    client from the round (folded into the mask; the caller resets its
    row to its pre-round state); a norm above max_norm scales the delta
    back to max_norm (the optimizer state keeps the raw step).

    The squares are summed in float32 leaf by leaf, in the reference's
    leaf order; within a leaf the two frameworks may sum in another
    order, so a clip decision within an ulp of max_norm can differ
    between them (tests/test_torch_faults.py holds norms well away
    from it). Returns (new_p, mask'); mask None is full participation."""
    max_norm, reject = guard
    deltas = tree_map(lambda n, o: n.to(torch.float32) - o.to(torch.float32),
                      new_p, params_C)
    sq = torch.zeros(losses.shape[0], dtype=torch.float32,
                     device=losses.device)
    for d in leaves(deltas):
        sq = sq + torch.sum(d.reshape(d.shape[0], -1) ** 2, dim=1)
    norm = torch.sqrt(sq)
    finite = torch.isfinite(norm) & torch.isfinite(losses)
    if max_norm < float("inf"):
        # A tensor over a tensor: a Python float over a tensor would
        # multiply by the reciprocal, an extra rounding the reference has
        # not.
        ratio = torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-12)
        scale = torch.where(finite, torch.clamp(ratio, max=1.0), 1.0)

        def clip(o, d):
            s = scale.reshape((scale.shape[0],) + (1,) * (d.dim() - 1))
            return (o.to(torch.float32) + d * s).to(o.dtype)

        new_p = tree_map(clip, params_C, deltas)
    if reject:
        ok = finite.to(torch.float32)
        mask = ok if mask is None else mask * ok
    return new_p, mask


def _weighted_client_sum(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_c w_c x_c over each member's C clients, in float32: x is
    (S*C, ...) with members major; weights (C,) shared by the members, or
    (S, C) with one row a member (a scenario's renormalised weights); the
    result is (S, ...). One fma chain over c = 0..C-1 (fold_matmul), so a
    member's sum does not depend on how many members share the call."""
    C = weights.shape[-1]
    S = x.shape[0] // C
    xs = x.reshape(S, C, -1).to(torch.float32)
    w = weights.to(torch.float32).reshape(-1, 1, C).expand(S, 1, C)
    return fold_matmul(w, xs).reshape(S, *x.shape[1:])


def _client_sum(x: torch.Tensor, C: int) -> torch.Tensor:
    """(S*C,) per-client values -> (S,) each member's sum over its C
    clients, one fma chain (fold_matmul), so a member's reported loss does
    not depend on the members beside it."""
    x = x.to(torch.float32).reshape(-1, C, 1)
    return fold_matmul(x.new_ones(()).expand(x.shape[0], 1, C), x)[:, 0, 0]


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


def _gather_members(x: torch.Tensor, S: int, group=None) -> torch.Tensor:
    """(S*Cl, ...) rows of this rank's Cl lanes of S members, members
    major -> (S*C, ...) the rows of every rank's lanes, members major: one
    all_gather along the lane axis."""
    lanes = collectives.gather_rows(x.reshape(S, -1, *x.shape[1:]), dim=1,
                                    group=group)
    return lanes.reshape(-1, *x.shape[1:])


def _psum_mean_bcast(stacked, weights, group=None):
    """The reference's `_psum_shardmap_sync`: each rank folds the weighted
    sum of its own lanes (weights: this rank's (Cl,) or (S, Cl) columns;
    `_weighted_client_sum`, one fma chain over its lanes), ONE all_reduce
    adds every leaf's partial (collectives.sum_partials), and each member's
    sum is broadcast onto its rows. In a world of one the partial is the
    unsharded sum and the all_reduce leaves it as it is, bit for bit."""
    xs = leaves(stacked)
    sums = collectives.sum_partials(
        [_weighted_client_sum(weights, x) for x in xs], group)
    return unflatten(stacked, [_bcast_members(m, x)
                               for m, x in zip(sums, xs)])


def _int8_rows(x: torch.Tensor):
    """The reference's deterministic int8 quantization of each row of x
    (N, P) float32: (codes int8 (N, P), scales float32 (N, 1)) with scale =
    absmax / 127 (1 where absmax = 0) and codes clip(round(x / scale),
    -127, 127); torch.round rounds half to even, as jnp.round. Tensor over
    tensor: a true division, as the reference's (a Python float would make
    CUDA multiply by its reciprocal)."""
    absmax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        1.0)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def _int8_mean_bcast(new_params, old_params, weights, gather_S=None,
                     group=None):
    """The reference's `_int8_gather_mean_bcast` and, with gather_S (the
    member count), its `_int8_shardmap_sync`: each lane's delta quantized
    per row (`_int8_rows`; a dropped lane's row was reset, so it sends
    zeros), with gather_S the int8 codes and float32 scales all-gathered
    over the ranks (int8 on the wire), then dequantized, combined with the
    full (C,) or (S, C) weights (`_weighted_client_sum`) and added to each
    member's old global model (its first row: all its rows are equal
    before the round), broadcast onto its rows."""
    def agg(new, old):
        delta = (new - old).to(torch.float32)
        codes, scale = _int8_rows(delta.reshape(delta.shape[0], -1))
        if gather_S is not None:
            codes = _gather_members(codes, gather_S, group)
            scale = _gather_members(scale, gather_S, group)
        mean = _weighted_client_sum(weights, codes.to(torch.float32) * scale)
        glob = old.reshape(mean.shape[0], -1, mean.shape[1])[:, 0]
        out = (glob.to(torch.float32) + mean).reshape(-1, *old.shape[1:])
        return _bcast_members(out, new)

    return tree_map(agg, new_params, old_params)


def _gather_round(losses, mask, S: int, group=None):
    """The cross-rank inputs of a sharded round, gathered before anything
    reads them, as the reference's global arrays under GSPMD: each lane's
    loss and, under a scenario, its post-guard participation flag, in one
    all_gather. (S*Cl,) each -> (S*C,) each."""
    if mask is None:
        return _gather_members(losses, S, group), None
    both = _gather_members(
        torch.stack([losses, mask.to(torch.float32)], dim=1), S, group)
    return both[:, 0], both[:, 1]


def _int8_stochastic_mean_bcast(new_params, old_params, weights, u):
    """Every client's delta through the int8 quantize/dequantize
    roundtrip (u: the (S*C, rows, 1024) rounding noise; all clients of
    all members in one launch), then each member's weighted mean of the
    reconstructions added to its old global model (its first client row:
    all its rows are equal before the round) and broadcast. A dropped or
    rejected client's row was reset to its pre-round state, so it sends
    an all-zero delta, never a NaN."""
    deltas = tree_map(lambda n, o: n - o, new_params, old_params)
    rec = compression.decompress_update(compression.compress_update(deltas, u))
    C = weights.shape[-1]

    def agg(r, old):
        mean = _weighted_client_sum(weights, r.reshape(r.shape[0], -1))
        glob = old.reshape(-1, C, mean.shape[1])[:, 0].to(torch.float32)
        out = (glob + mean).reshape(-1, *old.shape[1:])
        return _bcast_members(out, old)

    return tree_map(agg, rec, old_params)


def build_round_step(value_and_grad: Callable, opt: Optimizer,
                     aggregation: str = "allreduce", guard=None,
                     envelope: bool = False, group=None):
    """round_step(params_C, opt_C, batches, weights, u=None, mask=None,
    env=None) -> (params_C', opt_C', per_client_loss, mask'). The leading
    axis of params_C, opt_C and batches (leaves (N, V, ...)) holds S
    members of C clients each, members major (N = S*C; S = 1 for one run);
    u is the (N, rows, 1024) quantizer noise, needed by 'int8_stochastic'.
    `aggregation` is one of AGGREGATIONS (the module docstring).

    Without a mask, weights are the (C,) FedAvg weights summing to 1,
    shared by the members. With a (N,) participation mask (a scenario's
    round), weights are the raw data sizes, (C,) or (S, C) one row a
    member (a sampled round's cohort sizes), renormalised per member
    over its participating clients; dropped clients keep their pre-round
    params and optimizer state and report loss 0; a member with no
    participant keeps its old params. guard (faults.FaultModel.guard_spec,
    or None) sanitises the updates first and folds its rejections into the
    mask (`_guard_clients`), which comes back as mask'.

    The order is the reference's (mesh_rounds.py:447-469): guard, then
    reset the dropped rows to their pre-round state, then compress, so a
    dropped or rejected client sends the quantize kernel an all-zero delta
    and never a NaN.

    The sharded modes (SHARDED) run on this rank's lanes of the default
    process group's client axis (`group`: another group, for tests): the
    tensors hold N = S*Cl rows, Cl = C/n of each member's C lanes
    (collectives.lane_slice), while weights stay whole, (C,) or (S, C).
    The guard and the resets act on the local rows; then every lane's loss
    and post-guard mask are gathered (`_gather_round`), so the
    renormalised weights, the quorum count and the loss fold read all C
    lanes as the unsharded round does: a lane rejected on one rank changes
    every rank's weights. per_client_loss and mask' come back whole, (S*C,).

    value_and_grad(params_N, batch_N[, sample_mask, n]) is the stacked
    clients' gradient and loss (local_steps_fn). envelope=True runs the
    Study's (V, b) envelope form: batches leaves are (N, V_env, B_env,
    ...) and env holds the per-row envelope masks
    (envelope_local_steps_fn)."""
    if aggregation not in AGGREGATIONS:
        raise ValueError(aggregation)
    sharded = aggregation in SHARDED
    if envelope:
        local = envelope_local_steps_fn(value_and_grad, opt)
    else:
        plain = local_steps_fn(value_and_grad, opt)
        local = lambda p, s, b, env: plain(p, s, b)  # noqa: E731

    def round_step(params_C, opt_C, batches, weights, u=None, mask=None,
                   env=None):
        # The paper's work (the local steps) and talk (everything after
        # them) as device spans, recorded only under a profiler.
        with spans.device_span("fl.round.local", weights):
            new_p, new_s, losses = local(params_C, opt_C, batches, env)
        with spans.device_span("fl.round.aggregate", weights):
            if guard is not None:
                new_p, mask = _guard_clients(guard, new_p, params_C, losses,
                                             mask)
            if mask is not None:
                new_p = _select_participating_state(new_p, params_C, mask)
                new_s = _select_participating_state(new_s, opt_C, mask)
                losses = torch.where(mask > 0, losses, 0.0)
            lanes, S = slice(None), None
            if sharded:
                lanes = collectives.lane_slice(weights.shape[-1], group)
                S = losses.shape[0] // (lanes.stop - lanes.start)
                losses, mask = _gather_round(losses, mask, S, group)
            any_p = None
            if mask is not None:
                weights, any_p = _participation_weights(weights, mask)
            if aggregation == "allreduce":
                agg_p = _weighted_mean_bcast(new_p, weights)
            elif aggregation == "allreduce_shardmap":
                agg_p = _psum_mean_bcast(new_p, weights[..., lanes], group)
            elif aggregation == "int8_stochastic":
                agg_p = _int8_stochastic_mean_bcast(new_p, params_C, weights,
                                                    u)
            else:
                agg_p = _int8_mean_bcast(new_p, params_C, weights, S, group)
            if any_p is not None:
                agg_p = _keep_old_params(agg_p, params_C, any_p)
            return agg_p, new_s, losses, mask

    return round_step


def build_fleet_round(value_and_grad: Callable, opt: Optimizer,
                      n_clients: int, compress: bool, noise: Callable,
                      rows: int, guard=None, quorum=None,
                      envelope: bool = False, shard: bool = False):
    """One round for S members folded into the client axis:
    round_fn(params, opt_state, generators, weights, batches, mask=None,
    env=None) -> (params', opt_state', ys). params and opt_state leaves
    are (S*C, ...), members major, so the round is ONE value_and_grad call
    over all S*C clients and one per-member weighted FedAvg; batches
    leaves are (S*C, V, B, ...).

    weights are those of build_round_step: (C,), or with a mask also
    (S, C), one row of cohort sizes a member (sampled participation).

    ys holds device tensors: 'loss' (S,), each member's train loss.
    Without a mask it is the unweighted client mean, as the reference's
    batched and scan paths report. With mask (S*C,), a scenario's
    participation (weights are then the raw sizes, see build_round_step),
    it is the mean over the post-guard participants, NaN on a round
    without one, and ys adds 'n_participants' (S,), 'finite' (S, C) (each
    client's loss finite: the DivergenceError diagnostic) and, with
    quorum, 'rejected' (S,).

    quorum (count, policy) gates each member's round on its post-guard
    participation: below count raises 'rejected', and under 'reject' the
    member's params and optimizer state keep their pre-round values bit
    for bit while its noise generator still advances (the reference's key
    advances too: mesh_rounds.py:681-690).

    With compress, the round draws member s's quantizer noise as one
    noise(generators[s], (C, rows, 1024)) call, in member order (the
    draws a run of that member alone makes), and quantizes all S*C
    clients' updates in ONE kernel launch.

    envelope=True is the Study's group round: the members may run
    different (b, V) plans padded into one (V_env, B_env) envelope
    (batches leaves (S*C, V_env, B_env, ...), padded entries 0), and env
    holds their per-row envelope masks (envelope_local_steps_fn).

    shard=True shards the client axis over the default process group
    ('allreduce_shardmap', no compression): params, opt_state, batches and
    mask hold this rank's Cl = C / n lanes of each member (S*Cl rows),
    weights stay whole, and ys are every rank's same values, read from the
    gathered losses and masks (build_round_step)."""
    step = build_round_step(
        value_and_grad, opt,
        "int8_stochastic" if compress
        else "allreduce_shardmap" if shard else "allreduce",
        guard, envelope)
    C = n_clients

    def round_fn(params, opt_state, generators, weights, batches, mask=None,
                 env=None):
        u = None
        if compress:
            # The quantizer noise is part of the round's talk.
            with spans.device_span("fl.round.aggregate", weights):
                us = [noise(g, (C, rows, compression.ROW))
                      for g in generators]
                u = us[0] if len(us) == 1 else torch.cat(us)
        new_p, new_s, per_client, m_eff = step(
            params, opt_state, batches, weights, u, mask, env)
        if mask is None:
            total = _client_sum(per_client, C)
            # Over a tensor, as the masked form divides by its count: a
            # Python number would make CUDA multiply by its reciprocal.
            return new_p, new_s, {"loss": total / torch.full_like(total, C)}
        msk = m_eff.reshape(-1, C)
        n = torch.sum(msk, dim=1)
        loss = (_client_sum(torch.where(m_eff > 0, per_client, 0.0), C)
                / torch.where(n > 0, n, 1.0))
        ys = {"loss": torch.where(n > 0, loss, float("nan")),
              "n_participants": n,
              "finite": torch.isfinite(per_client).reshape(-1, C)}
        if quorum is not None:
            rejected = n < quorum[0]
            ys["rejected"] = rejected
            if quorum[1] == "reject":
                keep = lambda nw, old: torch.where(  # noqa: E731
                    _rows(rejected, nw), old.to(nw.dtype), nw)
                new_p = tree_map(keep, new_p, params)
                new_s = tree_map(keep, new_s, opt_state)
        return new_p, new_s, ys

    return round_fn


def build_fleet_chunk(value_and_grad: Callable, opt: Optimizer,
                      n_clients: int,
                      compress: bool, batch_from: Optional[Callable],
                      noise: Callable, rows: int, guard=None, quorum=None,
                      envelope: bool = False, shard: bool = False):
    """A chunk of rounds of `build_fleet_round` for S members (fleet runs;
    S = 1 for one run) with no host synchronisation inside:
    chunk_step(params, opt_state, generators, weights, data, idx,
    mask=None, env=None) -> (params', opt_state', ys).

    With idx (R, S*C, V, B), the global sample indices of R rounds, each
    round's batches are gathered on the device from `data` (the dataset
    uploaded once) by `batch_from`. With idx None, `data` holds the
    chunk's batches themselves, leaves (R, S*C, V, B, ...), stacked on the
    host (client.stack_chunk_batches) and uploaded in one transfer: the
    path of data sources without the index protocol. mask is (R, S*C) or
    None, and ys stacks each round's outputs along axis 1 ('loss' (S, R),
    and so on).

    weights is one (C,) vector for every round, or (R, S, C): one row of
    raw sizes a round and member, the cohort form of sampled participation
    (n_clients = K lanes, which change owners every round). shard: this
    rank's lanes only (build_fleet_round), idx and mask (R, S*Cl, ...)."""
    round_fn = build_fleet_round(value_and_grad, opt, n_clients, compress,
                                 noise, rows, guard, quorum, envelope, shard)

    def chunk_step(params, opt_state, generators, weights, data: Dict, idx,
                   mask=None, env=None):
        per_round = weights.dim() == 3
        ys: Dict[str, list] = {}
        n_rounds = (idx.shape[0] if idx is not None
                    else leaves(data)[0].shape[0])
        for r in range(n_rounds):
            batches = (batch_from(data, idx[r]) if idx is not None
                       else tree_map(lambda x: x[r], data))
            params, opt_state, y = round_fn(
                params, opt_state, generators,
                weights[r] if per_round else weights, batches,
                None if mask is None else mask[r], env)
            for k, v in y.items():
                ys.setdefault(k, []).append(v)
        return params, opt_state, {k: torch.stack(v, dim=1)
                                   for k, v in ys.items()}

    return chunk_step


def build_async_chunk(value_and_grad: Callable, opt: Optimizer,
                      n_clients: int, spec, batch_from: Optional[Callable],
                      compress: bool = False, noise: Optional[Callable] = None,
                      rows: Optional[int] = None):
    """A chunk of the asynchronous server's arrival events
    (Simulator(backend='async')), the counterpart of the reference's
    build_async_chunk (mesh_rounds.py:702): each event pops the earliest
    finisher of a (C,) float32 finish-time array with torch.argmin (first
    minimum, as np.argmin: the host twin's contract, events.twin_step).

    chunk_step(params_C, opt_C, gen, async_c, sizes, data, xs) ->
    (params_C', opt_C', async_c', ys). params_C and opt_C keep the
    synchronous layout, but row c is the snapshot client c was DISPATCHED
    with (rows differ between aggregations). `gen` is the run's quantizer
    generator (compress only), `sizes` the (C,) raw float32 data sizes,
    `data` the device-resident dataset (with `batch_from`) or None.

    async_c, the carry (SimState.async_c), holds device tensors:
      params_g   the server's global model (unstacked tree)
      buf        the staleness-weighted delta buffer (float32 tree)
      buf_w      float32 sum of the buffered weights
      cnt        int32 count of buffered updates
      loss_sum   float32 sum of the buffered updates' local losses
      t_finish   (C,) float32 finish time of each client's dispatch; +inf
                 marks a client blocked until the aggregation acks it
      t_next     (C,) float32 service time of a blocked client's next
                 dispatch, applied at its release
      now        float32 event clock (arrival time of the last event)
      version    int32 server aggregation count
      version_C  (C,) int32 server version each client was dispatched at
      drop_C     (C,) float32 1.0 where the in-flight update will be lost

    xs, one row an event, on the device: 't_svc' (E, C) float32 service
    times of the dispatch handed out at the event, 'drop_next' (E, C) its
    loss flags (only the arriving client's column is read), and the
    arriving client's V batches: 'idx' (E, V, B) gather indices into
    `data`, or 'batches' leaves (E, V, B, ...). An optional host bool
    array 'valid' (E,) marks the events to run: the reference runs every
    padded event and masks its writes, the port skips it, which is that
    no-op exactly (params, optimizer state, carry and generator
    unchanged). ys stacks each run event's 't_event', 'client', 'dropped',
    'agg', 'loss_agg' (NaN off an aggregation), 'staleness', 'version' and
    'cnt' along axis 0.

    Per event: client c runs V local steps from its snapshot
    (local_steps_fn on a one-row stack, as a 'loop' client: on the card
    every product a fold matmul at batch 1); with compress its delta
    takes one noise(gen, (1, rows, 1024)) draw and one quantize launch;
    the weight is w = staleness_weight(version - version_C[c]) *
    sizes[c]; a kept update adds takef * (w * delta) to the buffer (+0.0
    exactly when dropped) and the K-th fires params_g += buf / buf_w
    ('fedbuff') or mixes (1 - lr w) params_g + lr w new ('fedasync').
    Re-dispatch is ack-at-aggregation: a kept update's client blocks until
    the aggregation that consumes it, then restarts from the fresh
    aggregate at the fill instant (now + t_next); a dropped update's
    client restarts at once from the current model (now + t_svc[c]).

    Nothing in a chunk synchronises with the host: the pop is a 0-dim
    device index (index_select, torch.where), every constant a Python
    scalar, and no tensor is built from host data; the caller uploads xs
    before and fetches ys after. No input tensor is written in place."""
    from repro_torch.federated import events

    local = local_steps_fn(value_and_grad, opt)
    K = int(spec.buffer_size)
    fedasync = spec.mode == "fedasync"
    lr = float(np.float32(spec.server_lr))
    C = n_clients

    def chunk_step(params_C, opt_C, gen, async_c, sizes, data, xs):
        sizes_f32 = sizes.to(torch.float32)
        lanes = torch.arange(C, device=sizes.device)
        a = dict(async_c)
        ys: Dict[str, list] = {}
        n = xs["t_svc"].shape[0]
        valid = xs.get("valid")
        for e in range(n):
            if valid is not None and not valid[e]:
                continue
            t_finish = a["t_finish"]
            c = torch.argmin(t_finish)
            c1 = c.reshape(1)
            at_c = lambda t: t.index_select(0, c1).reshape(())  # noqa: E731
            now = at_c(t_finish)
            onehot = lanes == c
            p_c = tree_map(lambda t: t.index_select(0, c1), params_C)
            s_c = tree_map(lambda t: t.index_select(0, c1), opt_C)
            if "idx" in xs:
                batches = batch_from(data, xs["idx"][e:e + 1])
            else:
                batches = tree_map(lambda x: x[e:e + 1], xs["batches"])
            new_p, new_s, loss = local(p_c, s_c, batches)
            loss = loss.reshape(())
            delta = tree_map(
                lambda n_, o: n_.to(torch.float32) - o.to(torch.float32),
                new_p, p_c)
            if compress:
                u = noise(gen, (1, rows, compression.ROW))
                delta = compression.decompress_update(
                    compression.compress_update(delta, u))
            drop = at_c(a["drop_C"])
            stale = (a["version"] - at_c(a["version_C"])).to(torch.float32)
            ws = events.staleness_weight(spec, stale)
            w = ws * at_c(sizes_f32)
            take = drop == 0
            takef = take.to(torch.float32)
            # The buffer entry: an exact +0.0 when dropped.
            buf = tree_map(lambda b, d: b + takef * (w * d[0]),
                           a["buf"], delta)
            buf_w = a["buf_w"] + takef * w
            cnt = a["cnt"] + take.to(torch.int32)
            loss_sum = a["loss_sum"] + takef * loss
            fill = take if fedasync else take & (cnt >= K)
            if fedasync:
                am = torch.where(fill, lr * ws, 0.0)
                params_g = tree_map(
                    lambda g, n_: ((1.0 - am) * g.to(torch.float32)
                                   + am * n_[0].to(torch.float32)
                                   ).to(g.dtype),
                    a["params_g"], new_p)
            else:
                denom = torch.where(fill, buf_w, 1.0)
                params_g = tree_map(
                    lambda g, b: torch.where(
                        fill, g.to(torch.float32) + b / denom,
                        g.to(torch.float32)).to(g.dtype),
                    a["params_g"], buf)
            version = a["version"] + fill.to(torch.int32)
            loss_agg = torch.where(
                fill, loss_sum / torch.clamp(cnt.to(torch.float32), min=1.0),
                float("nan"))
            # The aggregation drains the buffer.
            buf = tree_map(lambda b: torch.where(fill, 0.0, b), buf)
            buf_w = torch.where(fill, 0.0, buf_w)
            cnt = torch.where(fill, 0, cnt).to(torch.int32)
            loss_sum = torch.where(fill, 0.0, loss_sum)
            # Ack-at-aggregation re-dispatch. Every time write is a float32
            # add of float32 tensors (now + t_svc[c], now + t_next), the
            # twin's np.float32 adds.
            t_svc = xs["t_svc"][e]
            t_next = torch.where(onehot & take, t_svc, a["t_next"])
            t_fin = torch.where(
                onehot, torch.where(take, float("inf"), now + t_svc),
                t_finish)
            release = fill & torch.isinf(t_fin)  # includes c itself
            t_fin = torch.where(release, now + t_next, t_fin)
            version_C = torch.where(onehot | release, version, a["version_C"])
            # A dropped update's client rebinds to the current model, every
            # released client to the fresh aggregate (fill is False on a
            # drop, so params_g is the right model for both).
            bind = release | (onehot & ~take)
            params_C = tree_map(
                lambda t, g: torch.where(
                    bind.reshape((-1,) + (1,) * (t.dim() - 1)),
                    g.to(t.dtype), t),
                params_C, params_g)
            opt_C = tree_map(
                lambda t, n_: torch.where(
                    onehot.reshape((-1,) + (1,) * (t.dim() - 1)),
                    n_.to(t.dtype), t),
                opt_C, new_s)
            a = {"params_g": params_g, "buf": buf, "buf_w": buf_w,
                 "cnt": cnt, "loss_sum": loss_sum, "t_finish": t_fin,
                 "t_next": t_next, "now": now, "version": version,
                 "version_C": version_C,
                 "drop_C": torch.where(onehot, xs["drop_next"][e],
                                       a["drop_C"])}
            y = {"t_event": now, "client": c.to(torch.int32),
                 "dropped": drop, "agg": fill, "loss_agg": loss_agg,
                 "staleness": torch.where(take, stale, 0.0),
                 "version": version, "cnt": cnt}
            for k, v in y.items():
                ys.setdefault(k, []).append(v)
        return params_C, opt_C, a, {k: torch.stack(v)
                                    for k, v in ys.items()}

    return chunk_step


def replicate_clients(tree, n_clients: int):
    """Identical client copies on a new leading axis (views)."""
    return tree_map(lambda x: x[None].expand((n_clients, *x.shape)), tree)
