"""Algorithm 1 (DEFL): plan construction.

Ties together the delay models (core/delay.py) and the KKT solution
(core/kkt.py) into an executable federated training plan: the optimized
(b*, theta*, V*) plus the predicted round/overall times. Copy of
`make_plan` (with partial participation and cohorts), its batched form
`make_plan_batch` over `PlanRequest`s (the Study's `plans()`),
`deadline_plan`, `async_plan` (the plan of the asynchronous backend),
`plan_to_fedconfig` and `fixed_plan` of repro/core/defl.py.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import FedConfig, WirelessConfig
from repro_torch.core import delay, kkt


@dataclass(frozen=True)
class DEFLPlan:
    """The algorithm's inputs for a concrete system (Alg. 1 line 0)."""

    b: int  # b* (power-of-two quantized)
    theta: float  # theta*
    V: int  # V = nu log(1/theta)
    H_pred: float  # predicted communication rounds (Eq. 12)
    T_cm: float  # round uplink time (Eq. 7)
    T_cp: float  # per-iteration compute time at b* (Eq. 5)
    T_round: float  # Eq. 8
    overall_pred: float  # Eq. 13
    update_bits: float
    solution: kkt.DelaySolution
    problem: kkt.DelayProblem


def make_plan(
    fed: FedConfig,
    pop: delay.DevicePopulation,
    update_bits: float,
    wireless: Optional[WirelessConfig] = None,
    method: str = "closed_form",
    participation: float = 1.0,
    cohort_size: Optional[int] = None,
) -> DEFLPlan:
    """Solve the paper's optimization for a device population: the KKT
    problem solved by `kkt.solve(method=)` ('closed_form' is Eq. 29),
    quantized to a power-of-two batch.

    update_bits: local model update size s in bits (actual parameter
    bytes; int8 compression divides it by 4 here).
    participation: expected fraction of clients whose update arrives each
    round (scenarios with dropout / link failure): the Eq. 12 round-count
    model sees the effective M = round(participation * M) >= 1.
    cohort_size: K-client cohorts drawn from the population each round;
    Eq. 12's effective M is then based on K while the Eq. 5/7 straggler
    maxes stay population-wide (any client can be drawn)."""
    prob, T_cm, update_bits = _plan_problem(
        fed, pop, update_bits, wireless, participation, cohort_size)
    sol = kkt.solve(prob, method=method).quantized(prob)
    return _assemble_plan(sol, prob, T_cm, update_bits)


def _plan_problem(fed, pop, update_bits, wireless, participation=1.0,
                  cohort_size=None):
    """The Alg. 1 problem setup: wire size -> Eq. 7 uplink straggler max,
    bottleneck compute slope, participation-scaled effective M."""
    wireless = wireless or WirelessConfig()
    if fed.compress_updates:
        update_bits = update_bits / 4.0  # fp32 -> int8 quantized updates
    T_cm = delay.round_comm_time(update_bits, wireless, pop.p, pop.h)
    g = float(max(pop.G / pop.f))  # bottleneck compute slope (s per batch unit)
    M_base = fed.n_devices if cohort_size is None else int(cohort_size)
    M_eff = max(1, int(round(M_base * participation)))
    prob = kkt.DelayProblem(
        T_cm=T_cm, g=g, M=M_eff, eps=fed.epsilon, nu=fed.nu, c=fed.c)
    return prob, T_cm, update_bits


def _assemble_plan(sol: kkt.DelaySolution, prob: kkt.DelayProblem,
                   T_cm: float, update_bits: float) -> DEFLPlan:
    return DEFLPlan(
        b=int(sol.b),
        theta=sol.theta,
        V=sol.V,
        H_pred=sol.H,
        T_cm=T_cm,
        T_cp=sol.T_cp,
        T_round=sol.T_round,
        overall_pred=sol.overall,
        update_bits=update_bits,
        solution=sol,
        problem=prob,
    )


@dataclass(frozen=True, eq=False)
class PlanRequest:
    """One arm's Alg. 1 solve in value form — the batchable unit of
    `make_plan_batch`. Field-for-field the `make_plan` signature."""

    fed: FedConfig
    pop: delay.DevicePopulation
    update_bits: float
    wireless: Optional[WirelessConfig] = None
    method: str = "closed_form"
    participation: float = 1.0
    cohort_size: Optional[int] = None


def make_plan_batch(requests: Sequence[PlanRequest]) -> List[DEFLPlan]:
    """`make_plan` over N requests with the KKT stage batched: requests
    sharing a method are solved by ONE vectorized `kkt.solve_batch`
    dispatch instead of N scalar solves. Each returned plan is
    bit-identical to `make_plan(**request)` — solve_batch's closed form
    is elementwise-exact and the problem setup/assembly code is shared
    verbatim (tests/test_torch_plan_batch.py holds the identity).
    """
    reqs = list(requests)
    pieces = [
        _plan_problem(r.fed, r.pop, r.update_bits, r.wireless,
                      r.participation, r.cohort_size)
        for r in reqs]
    by_method = {}
    for i, r in enumerate(reqs):
        by_method.setdefault(r.method, []).append(i)
    plans: List[Optional[DEFLPlan]] = [None] * len(reqs)
    for method, idxs in by_method.items():
        sols = kkt.solve_batch([pieces[i][0] for i in idxs], method=method)
        for i, sol in zip(idxs, sols):
            prob, T_cm, bits = pieces[i]
            plans[i] = _assemble_plan(sol.quantized(prob), prob, T_cm, bits)
    return plans


def deadline_plan(
    fed: FedConfig,
    pop: delay.DevicePopulation,
    update_bits: float,
    deadline: float,
    wireless: Optional[WirelessConfig] = None,
    participation: float = 1.0,
    b_max: float = 64.0,
    cohort_size: Optional[int] = None,
    spare: int = 0,
) -> DEFLPlan:
    """Deadline-aware Algorithm 1: re-derive (b, V) when the server
    truncates every round at `deadline` seconds (faults.FaultModel).

    The Eq. 8 round cost saturates at min(deadline, T_cm + V*T_cp), and
    clients whose V*t_cp^m + t_cm^m exceeds the deadline drop out of
    Eq. 12's effective M. The objective is not smooth, so this sweeps the
    quantized decision space exactly (b in {2^n} up to b_max, alpha on a
    log grid) and keeps the point of least H * min(D, T) among those where
    at least one client finishes in time; ValueError when none does.
    cohort_size and spare (K + spare candidates a round, the K
    feasible-fastest kept) scale the effective M as in the reference.
    """
    if spare and cohort_size is None:
        raise ValueError("spare over-provisioning requires cohort_size=K")
    if spare < 0:
        raise ValueError(f"spare must be >= 0, got {spare}")
    wireless = wireless or WirelessConfig()
    if fed.compress_updates:
        update_bits = update_bits / 4.0
    t_cm_m = delay.per_client_uplink_time(update_bits, wireless, pop.p, pop.h)
    T_cm = float(np.max(t_cm_m))
    g = float(max(pop.G / pop.f))
    slopes = np.asarray(pop.G, np.float64) / np.asarray(pop.f, np.float64)
    M_base = fed.n_devices if cohort_size is None else int(cohort_size)

    n_pow = max(int(np.floor(np.log2(b_max))), 0)
    bs = 2.0 ** np.arange(0, n_pow + 1)
    als = np.geomspace(1.0 / fed.nu, 20.0, 96)

    best, best_J = None, np.inf
    for b in bs:
        for alpha in als:
            V = max(int(round(fed.nu * alpha)), 1)
            finish = V * slopes * b + t_cm_m  # per-client round span
            feas = finish <= deadline
            if not feas.any():
                continue
            if cohort_size is None or spare == 0:
                M_eff = max(1, int(round(
                    M_base * participation * feas.mean())))
            else:
                exp_feas = (cohort_size + spare) * feas.mean()
                M_eff = max(1, int(round(
                    min(float(M_base), exp_feas) * participation)))
            H = kkt.communication_rounds_alpha(
                b, alpha, M_eff, fed.epsilon, fed.nu, fed.c)
            T = min(deadline, T_cm + fed.nu * alpha * g * b)
            J = H * T
            if J < best_J:
                best, best_J = (float(b), float(alpha), M_eff), J
    if best is None:
        raise ValueError(
            f"deadline {deadline:.4g}s is infeasible: no client can finish "
            "even one local iteration + upload inside it at any batch size")
    b, alpha, M_eff = best
    prob = kkt.DelayProblem(
        T_cm=T_cm, g=g, M=M_eff, eps=fed.epsilon, nu=fed.nu, c=fed.c)
    sol = kkt.evaluate(prob, b, alpha, method="deadline_grid")
    return DEFLPlan(
        b=int(sol.b), theta=sol.theta, V=sol.V, H_pred=sol.H, T_cm=T_cm,
        T_cp=sol.T_cp,
        T_round=min(deadline, sol.T_round),
        overall_pred=sol.H * min(deadline, sol.T_round),
        update_bits=update_bits, solution=sol, problem=prob)


def async_plan(
    fed: FedConfig,
    pop: delay.DevicePopulation,
    update_bits: float,
    buffer_size: int,
    wireless: Optional[WirelessConfig] = None,
    b_max: float = 64.0,
) -> DEFLPlan:
    """Alg. 1 re-derived for buffered asynchronous aggregation
    (backend='async', events.AsyncSpec(buffer_size=K)).

    Two terms of the synchronous objective change:

      * Eq. 8's round time is a straggler MAX (T_cm + nu alpha T_cp at
        the slowest device). Under ack-at-aggregation every accepted
        client is re-dispatched at an aggregation instant, so in steady
        state client m contributes updates as a renewal process at rate
        1/s_m with service span s_m = V t_cp_m + t_cm_m. The buffer
        fills after K arrivals from the pooled process: the expected
        aggregation period is T_agg = K / sum_m (1/s_m) — K over the
        HARMONIC sum of client spans. A straggler hurts only in
        proportion to its rate share, not as a hard round floor.
      * Eq. 12's effective M is the number of updates averaged per
        aggregation. Asynchronously that is the buffer size K — the
        expected concurrency replaces the synchronous cohort M.

    J(b, alpha) = H(b, alpha; M=K) * T_agg(b, alpha) has per-client
    feasibility steps baked into neither term, but H's M-dependence and
    T_agg's harmonic pooling make the objective non-smooth in K, so —
    like `deadline_plan` — this sweeps the exact quantized decision
    space (b in {2^n} up to b_max x alpha on a log grid, alpha >=
    1/nu so V >= 1) rather than solving KKT conditions. The staleness
    discount is a second-order effect on H (weights are normalized per
    fill) and is not modeled.

    Returns a DEFLPlan whose T_round/overall_pred are the async
    T_agg / H*T_agg; `problem.M` records K (method 'async_grid').
    """
    wireless = wireless or WirelessConfig()
    if fed.compress_updates:
        update_bits = update_bits / 4.0
    t_cm_m = delay.per_client_uplink_time(update_bits, wireless, pop.p, pop.h)
    slopes = np.asarray(pop.G, np.float64) / np.asarray(pop.f, np.float64)
    K = int(buffer_size)
    if not 1 <= K <= slopes.size:
        raise ValueError(
            f"buffer_size must be in [1, M={slopes.size}], got {K}")

    n_pow = max(int(np.floor(np.log2(b_max))), 0)
    bs = 2.0 ** np.arange(0, n_pow + 1)
    als = np.geomspace(1.0 / fed.nu, 20.0, 96)

    best, best_J = None, np.inf
    for b in bs:
        for alpha in als:
            V = max(int(round(fed.nu * alpha)), 1)
            spans = V * slopes * b + t_cm_m  # per-client service span s_m
            T_agg = K / float(np.sum(1.0 / spans))
            H = kkt.communication_rounds_alpha(
                b, alpha, K, fed.epsilon, fed.nu, fed.c)
            J = H * T_agg
            if J < best_J:
                best, best_J = (float(b), float(alpha), float(T_agg)), J
    b, alpha, T_agg = best
    T_cm = float(np.max(t_cm_m))
    g = float(max(pop.G / pop.f))
    prob = kkt.DelayProblem(
        T_cm=T_cm, g=g, M=K, eps=fed.epsilon, nu=fed.nu, c=fed.c)
    sol = kkt.evaluate(prob, b, alpha, method="async_grid")
    return DEFLPlan(
        b=int(sol.b), theta=sol.theta, V=sol.V, H_pred=sol.H, T_cm=T_cm,
        T_cp=sol.T_cp,
        T_round=T_agg,
        overall_pred=sol.H * T_agg,
        update_bits=update_bits, solution=sol, problem=prob)


def plan_to_fedconfig(plan: DEFLPlan, fed: FedConfig) -> FedConfig:
    """Apply the DEFL plan onto a FedConfig (Alg. 1: run with b*, theta*)."""
    return dataclasses.replace(
        fed, batch_size=plan.b, theta=plan.theta,
        update_bytes=int(plan.update_bits // 8))


def fixed_plan(
    fed: FedConfig,
    pop: delay.DevicePopulation,
    update_bits: float,
    b: int,
    V: int,
    wireless: Optional[WirelessConfig] = None,
    theta: Optional[float] = None,
) -> DEFLPlan:
    """A baseline plan with manually chosen (b, V) — FedAvg / 'Rand.' rows.

    H is NOT predicted by Eq. 12 for baselines in the paper; the simulator
    measures it. H_pred is still filled from Eq. 12 for reference — at the
    exact `theta` when given (a swept theta whose V quantization would
    otherwise shift H), otherwise at theta = exp(-V/nu).
    """
    prob, T_cm, update_bits = _plan_problem(fed, pop, update_bits, wireless)
    if theta is not None:
        alpha = max(float(-np.log(theta)), 1e-6)
    else:
        alpha = max(V / fed.nu, 1e-6)
    sol = kkt.evaluate(prob, float(b), alpha, method="fixed")
    return DEFLPlan(
        b=b, theta=float(np.exp(-alpha)), V=V, H_pred=sol.H, T_cm=T_cm,
        T_cp=sol.T_cp, T_round=sol.T_round, overall_pred=sol.overall,
        update_bits=update_bits, solution=sol, problem=prob)
