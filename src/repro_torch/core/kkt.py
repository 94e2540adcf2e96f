"""§IV-V: the delay-minimization problem and its KKT solution (Eq. 29).

Problem (18):  minimize over (b, alpha, T_cp)
    J = ( c/(b^2 eps^2 M nu alpha) + c M /(b eps) ) * ( T_cm + nu alpha T_cp )
    s.t. b >= 1, alpha >= 0, T_cp >= G_m b / f_m  for all m.

At the optimum the compute constraint is active at the bottleneck device:
T_cp = g * b with g = max_m G_m / f_m. The paper's closed form (Eq. 29):

    alpha* = sqrt( T_cm f_m / (M^2 eps nu^2 G_m) )   [f/G at the bottleneck]
    b*     = 2 c M sqrt( T_cm f_m eps / G_m )
    T_cp*  = g * b*

Copy of the scalar solvers of repro/core/kkt.py: the closed form
verbatim, the corrected point and a numerical optimizer (log-space grid +
golden-section coordinate descent), selected by `solve(method=)`. The
arithmetic is the reference's, expression for expression, so a plan is
bit-identical to the reference's. (The reference's batched `_batch` /
`_vec` twins serve its Study and planner service, which the port has not
taken up yet.)
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


def objective(prob: DelayProblem, b: float, alpha: float) -> float:
    """J(b, alpha) with the compute constraint active (T_cp = g b)."""
    H = communication_rounds_alpha(b, alpha, prob.M, prob.eps, prob.nu, prob.c)
    T = prob.T_cm + prob.nu * alpha * prob.g * b
    return H * T


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


def stationary_alpha(prob: DelayProblem, b: float) -> float:
    """Exact interior argmin over alpha at fixed b.

    Expanding (18): J(alpha) = A/alpha + B*alpha + C with
      A = c*T_cm/(b^2 eps^2 M nu),  B = c*M*nu*g/eps
    so argmin alpha = sqrt(A/B) = sqrt(T_cm/(eps M^2 nu^2 g)) / b.

    The paper's Eq. 29 alpha* equals b * stationary_alpha(b): Eq. 29 is
    the b=1 stationary point (a factor of b was dropped in the paper's KKT
    algebra). closed_form() stays faithful; this is the corrected point.
    """
    return float(np.sqrt(prob.T_cm / (prob.eps * prob.M ** 2
                                      * prob.nu ** 2 * prob.g)) / b)


def corrected_solution(prob: DelayProblem, b_max: float = 64.0) -> DelaySolution:
    """Beyond-paper 'DEFL+' point: J is strictly decreasing in b
    (J = P/b^2 + Q/b + R, all positive), so b* sits at the practical upper
    bound (dataset/memory/generalization budget — constraint 15's
    'commonly used effective batch sizes'), with the exact stationary alpha.
    """
    b = float(b_max)
    # alpha floored at 1/nu so V = nu*alpha >= 1 (Eq. 12's regime).
    return evaluate(prob, b, max(stationary_alpha(prob, b), 1.0 / prob.nu),
                    method="corrected")


def grid_search(
    prob: DelayProblem,
    b_range=(1.0, 4096.0),
    alpha_range=(1e-3, 20.0),
    n: int = 160,
) -> DelaySolution:
    """Log-space grid over (b, alpha).

    Scalars are hoisted to np.float64 so `eps ** 2` runs numpy's power
    kernel (not Python's libm pow), as the reference does."""
    bs = np.geomspace(*b_range, n)
    als = np.geomspace(*alpha_range, n)
    Bm, Am = np.meshgrid(bs, als, indexing="ij")
    T_cm, g = np.float64(prob.T_cm), np.float64(prob.g)
    M, eps = np.float64(prob.M), np.float64(prob.eps)
    nu, c = np.float64(prob.nu), np.float64(prob.c)
    H = (c / (Bm ** 2 * eps ** 2 * M * nu * Am)
         + c * M / (Bm * eps))
    T = T_cm + nu * Am * g * Bm
    J = H * T
    i, j = np.unravel_index(np.argmin(J), J.shape)
    return evaluate(prob, float(bs[i]), float(als[j]), method="grid")


def _golden_min(f, lo: float, hi: float, iters: int = 80) -> float:
    """Golden-section minimize a unimodal f on [lo, hi] (log-space).

    Arithmetic is numpy float64 scalar ops (not math.*), as in the
    reference: math.exp and np.exp can disagree by an ulp."""
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = np.log(lo), np.log(hi)
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = f(np.exp(c)), f(np.exp(d))
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = f(np.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = f(np.exp(d))
    return float(np.exp((a + b) / 2.0))


def coordinate_descent(
    prob: DelayProblem, b0: float = 32.0, alpha0: float = 1.0,
    sweeps: int = 8, b_max: float = 64.0, alpha_min: float = None,
) -> DelaySolution:
    """Numerical optimum of the BOUNDED problem: b in [1, b_max],
    alpha >= alpha_min (default 1/nu so that V >= 1).

    The unbounded relaxation of (18) is degenerate (inf J = 0 along
    b->inf, alpha->0 paths), so bounds are required for the numerical
    cross-check to be meaningful; see stationary_alpha's docstring.
    J is unimodal per coordinate (A/x + Bx + C or P/x^2 + Q/x + R), so
    golden-section coordinate descent converges.
    """
    alpha_min = alpha_min if alpha_min is not None else 1.0 / prob.nu
    b, alpha = min(max(b0, 1.0), b_max), max(alpha0, alpha_min)
    for _ in range(sweeps):
        alpha = _golden_min(lambda a: objective(prob, b, a), alpha_min, 100.0)
        b = _golden_min(lambda bb: objective(prob, bb, alpha), 1.0, b_max)
    return evaluate(prob, b, alpha, method="numerical")


def solve(prob: DelayProblem, method: str = "closed_form",
          b_max: float = 64.0) -> DelaySolution:
    if method == "closed_form":
        return closed_form(prob)
    if method == "corrected":
        return corrected_solution(prob, b_max=b_max)
    if method == "numerical":
        grid = grid_search(prob, b_range=(1.0, b_max))
        return coordinate_descent(prob, grid.b, grid.alpha, b_max=b_max)
    raise ValueError(method)
