"""Algorithm 1 (DEFL): plan construction.

Ties together the delay models (core/delay.py) and the KKT solution
(core/kkt.py) into an executable federated training plan: the optimized
(b*, theta*, V*) plus the predicted round/overall times. Copy of
`make_plan` and `plan_to_fedconfig` of repro/core/defl.py for the dense,
fully participating population (the deadline and asynchronous planners
serve parts of the reference the port has not taken up yet).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

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
) -> DEFLPlan:
    """Solve the paper's optimization for a device population (the Eq. 29
    closed form, quantized to a power-of-two batch).

    update_bits: local model update size s in bits (actual parameter
    bytes; int8 compression divides it by 4 here)."""
    wireless = wireless or WirelessConfig()
    if fed.compress_updates:
        update_bits = update_bits / 4.0  # fp32 -> int8 quantized updates
    T_cm = delay.round_comm_time(update_bits, wireless, pop.p, pop.h)
    g = float(max(pop.G / pop.f))  # bottleneck compute slope (s per batch unit)
    prob = kkt.DelayProblem(
        T_cm=T_cm, g=g, M=fed.n_devices, eps=fed.epsilon, nu=fed.nu,
        c=fed.c)
    sol = kkt.closed_form(prob).quantized(prob)
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
