"""Talk-vs-work trade-off analysis (§II-E) — curves for Fig. 1.

Decomposes predicted overall time into 'talking' (H * T_cm) and 'working'
(H * V * T_cp) for sweeps over theta, b and eps. Copy of
repro/core/tradeoff.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.core import kkt
from repro_torch.core.convergence import communication_rounds, local_rounds


@dataclass(frozen=True)
class TradeoffPoint:
    theta: float
    b: float
    V: int
    H: float
    talk_time: float  # H * T_cm
    work_time: float  # H * V * T_cp
    overall: float


def sweep_theta(
    prob: kkt.DelayProblem, b: float, thetas: Sequence[float],
) -> list[TradeoffPoint]:
    out = []
    for th in thetas:
        V = local_rounds(th, prob.nu)
        H = communication_rounds(b, th, prob.M, prob.eps, prob.nu, prob.c)
        T_cp = prob.g * b
        out.append(TradeoffPoint(
            theta=float(th), b=b, V=V, H=H,
            talk_time=H * prob.T_cm, work_time=H * V * T_cp,
            overall=H * (prob.T_cm + V * T_cp)))
    return out


def sweep_batch(
    prob: kkt.DelayProblem, theta: float, batches: Sequence[int],
) -> list[TradeoffPoint]:
    out = []
    V = local_rounds(theta, prob.nu)
    for b in batches:
        H = communication_rounds(b, theta, prob.M, prob.eps, prob.nu, prob.c)
        T_cp = prob.g * b
        out.append(TradeoffPoint(
            theta=theta, b=float(b), V=V, H=H,
            talk_time=H * prob.T_cm, work_time=H * V * T_cp,
            overall=H * (prob.T_cm + V * T_cp)))
    return out


def sweep_epsilon(
    base: kkt.DelayProblem, epsilons: Sequence[float],
) -> list[tuple[float, kkt.DelaySolution]]:
    """Fig. 1(a): optimized solution per preset epsilon."""
    out = []
    for eps in epsilons:
        prob = kkt.DelayProblem(
            T_cm=base.T_cm, g=base.g, M=base.M, eps=float(eps),
            nu=base.nu, c=base.c)
        out.append((float(eps), kkt.closed_form(prob).quantized(prob)))
    return out
