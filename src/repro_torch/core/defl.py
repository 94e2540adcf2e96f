"""Algorithm 1 (DEFL): plan construction.

Ties together the delay models (core/delay.py) and the KKT solution
(core/kkt.py) into an executable federated training plan: the optimized
(b*, theta*, V*) plus the predicted round/overall times. Copy of
`make_plan`, `plan_to_fedconfig` and `fixed_plan` of repro/core/defl.py
for the dense, fully participating population (participation, cohorts,
and the batched, deadline and asynchronous planners serve parts of the
reference the port has not taken up yet).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

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
) -> DEFLPlan:
    """Solve the paper's optimization for a device population: the KKT
    problem solved by `kkt.solve(method=)` ('closed_form' is Eq. 29),
    quantized to a power-of-two batch.

    update_bits: local model update size s in bits (actual parameter
    bytes; int8 compression divides it by 4 here)."""
    prob, T_cm, update_bits = _plan_problem(fed, pop, update_bits, wireless)
    sol = kkt.solve(prob, method=method).quantized(prob)
    return _assemble_plan(sol, prob, T_cm, update_bits)


def _plan_problem(fed, pop, update_bits, wireless):
    """The Alg. 1 problem setup: wire size -> Eq. 7 uplink straggler max,
    bottleneck compute slope."""
    wireless = wireless or WirelessConfig()
    if fed.compress_updates:
        update_bits = update_bits / 4.0  # fp32 -> int8 quantized updates
    T_cm = delay.round_comm_time(update_bits, wireless, pop.p, pop.h)
    g = float(max(pop.G / pop.f))  # bottleneck compute slope (s per batch unit)
    prob = kkt.DelayProblem(
        T_cm=T_cm, g=g, M=fed.n_devices, eps=fed.epsilon, nu=fed.nu,
        c=fed.c)
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
