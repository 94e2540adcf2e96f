"""§IV-V: the delay-minimization problem and its KKT solution (Eq. 29).

Problem (18):  minimize over (b, alpha, T_cp)
    J = ( c/(b^2 eps^2 M nu alpha) + c M /(b eps) ) * ( T_cm + nu alpha T_cp )
    s.t. b >= 1, alpha >= 0, T_cp >= G_m b / f_m  for all m.

At the optimum the compute constraint is active at the bottleneck device:
T_cp = g * b with g = max_m G_m / f_m. The paper's closed form (Eq. 29):

    alpha* = sqrt( T_cm f_m / (M^2 eps nu^2 G_m) )   [f/G at the bottleneck]
    b*     = 2 c M sqrt( T_cm f_m eps / G_m )
    T_cp*  = g * b*

Copy of the closed-form solver of repro/core/kkt.py, which the DEFL plan
runs (the reference's numerical, corrected and batched solvers serve its
benchmarks, Study and planner service, which the port has not taken up
yet). The arithmetic is the reference's, expression for expression, so a
plan is bit-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.convergence import communication_rounds_alpha


@dataclass(frozen=True)
class DelayProblem:
    """Inputs of problem (18)."""

    T_cm: float  # round communication time (Eq. 7), seconds
    g: float  # bottleneck compute slope max_m G_m/f_m, seconds per unit batch
    M: int  # number of devices
    eps: float  # preset global convergence error
    nu: float  # Remark-3 constant
    c: float  # big-O constant


@dataclass(frozen=True)
class DelaySolution:
    b: float
    alpha: float
    theta: float
    T_cp: float
    V: int
    H: float
    T_round: float
    overall: float
    method: str

    def quantized(self, prob: DelayProblem) -> "DelaySolution":
        """Apply constraint (15): b in {2^n}, plus V >= 1 integrality."""
        b = quantize_batch(self.b)
        return evaluate(prob, b, self.alpha, method=self.method + "+quant")


def quantize_batch(b: float) -> int:
    """Round to the nearest power of two, >= 1 (constraint 15)."""
    b = max(b, 1.0)
    lo = 2 ** int(np.floor(np.log2(b)))
    hi = lo * 2
    return int(lo if b / lo <= hi / b else hi)


def evaluate(prob: DelayProblem, b: float, alpha: float, method: str) -> DelaySolution:
    H = communication_rounds_alpha(b, alpha, prob.M, prob.eps, prob.nu, prob.c)
    T_cp = prob.g * b
    V = max(int(round(prob.nu * alpha)), 1)
    T = prob.T_cm + prob.nu * alpha * T_cp
    return DelaySolution(
        b=b, alpha=alpha, theta=float(np.exp(-alpha)), T_cp=T_cp, V=V,
        H=H, T_round=T, overall=H * T, method=method)


def closed_form(prob: DelayProblem) -> DelaySolution:
    """Eq. 29 verbatim (f_m/G_m at the bottleneck device = 1/g)."""
    inv_g = 1.0 / prob.g
    alpha = np.sqrt(prob.T_cm * inv_g / (prob.M ** 2 * prob.eps * prob.nu ** 2))
    b = 2.0 * prob.c * prob.M * np.sqrt(prob.T_cm * inv_g * prob.eps)
    b = max(b, 1.0)
    alpha = max(alpha, 1e-6)
    return evaluate(prob, b, alpha, method="closed_form")
