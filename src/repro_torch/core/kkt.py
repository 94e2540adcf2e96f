"""§IV-V: the delay-minimization problem and its KKT solution (Eq. 29).

Problem (18):  minimize over (b, alpha, T_cp)
    J = ( c/(b^2 eps^2 M nu alpha) + c M /(b eps) ) * ( T_cm + nu alpha T_cp )
    s.t. b >= 1, alpha >= 0, T_cp >= G_m b / f_m  for all m.

At the optimum the compute constraint is active at the bottleneck device:
T_cp = g * b with g = max_m G_m / f_m. The paper's closed form (Eq. 29):

    alpha* = sqrt( T_cm f_m / (M^2 eps nu^2 G_m) )   [f/G at the bottleneck]
    b*     = 2 c M sqrt( T_cm f_m eps / G_m )
    T_cp*  = g * b*

Copy of the solvers of repro/core/kkt.py: the closed form verbatim, the
corrected point and a numerical optimizer (log-space grid +
golden-section coordinate descent), selected by `solve(method=)`, and
their batched twins over N problems (`solve_batch`, which the Study's
`plans()` runs through `defl.make_plan_batch`). The arithmetic is the
reference's, expression for expression, so a plan is bit-identical to
the reference's.
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


def _grid_search_batch(T_cm, g, M, eps, nu, c,
                       b_range=(1.0, 4096.0), alpha_range=(1e-3, 20.0),
                       n: int = 160):
    """`grid_search` over N lanes: one (N, n, n) objective evaluation.

    The grid axes are shared across lanes (they depend only on the
    ranges), the lane parameters broadcast as (N, 1, 1), and the
    per-cell expression is the exact scalar association — so lane i's
    argmin cell is the cell scalar `grid_search(probs[i])` picks."""
    bs = np.geomspace(*b_range, n)
    als = np.geomspace(*alpha_range, n)
    Bm, Am = np.meshgrid(bs, als, indexing="ij")

    def lane(x):
        return np.asarray(x, np.float64)[:, None, None]

    T_cm, g, M = lane(T_cm), lane(g), lane(M)
    eps, nu, c = lane(eps), lane(nu), lane(c)
    H = (c / (Bm ** 2 * eps ** 2 * M * nu * Am)
         + c * M / (Bm * eps))
    T = T_cm + nu * Am * g * Bm
    J = H * T
    flat = np.argmin(J.reshape(J.shape[0], -1), axis=1)
    i, j = np.divmod(flat, n)
    return bs[i], als[j]


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


def _golden_min_vec(f, lo, hi, iters: int = 80) -> np.ndarray:
    """`_golden_min` over N independent lanes at once.

    lo/hi are (N,) float64 arrays and f maps (N,) probe points to (N,)
    objective values elementwise. Each lane runs the exact scalar
    control flow — its bracket updates depend only on its own fc < fd
    comparison, selected with np.where — and every probe/bracket value
    is produced by the same elementwise expressions as the scalar code,
    so lane i is bit-identical to `_golden_min(f_i, lo[i], hi[i])`
    (tests/test_torch_plan_batch.py holds it via solve_batch). One lane
    evaluates exactly one new probe per iteration, same as the scalar
    loop; the N lanes' probes are batched into one f call."""
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = np.log(np.asarray(lo, np.float64)), np.log(np.asarray(hi, np.float64))
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = f(np.exp(c)), f(np.exp(d))
    for _ in range(iters):
        left = fc < fd  # per-lane branch: shrink from the right
        na = np.where(left, a, c)
        nb = np.where(left, d, b)
        # left lanes probe a new c; right lanes probe a new d — both are
        # the same expression the scalar branch computes on its updated
        # bracket, evaluated lane-wise and gathered into ONE f call.
        probe_c = nb - gr * (nb - na)
        probe_d = na + gr * (nb - na)
        probe = np.where(left, probe_c, probe_d)
        fp = f(np.exp(probe))
        nc = np.where(left, probe_c, d)
        nd = np.where(left, c, probe_d)
        nfc = np.where(left, fp, fd)
        nfd = np.where(left, fc, fp)
        a, b, c, d, fc, fd = na, nb, nc, nd, nfc, nfd
    return np.exp((a + b) / 2.0)


def _objective_batch(T_cm, g, M, eps, nu, c, b, alpha):
    """Elementwise J(b, alpha) over lanes — same association as
    `objective` / `communication_rounds_alpha` (bit-identical per lane:
    +, *, / are exact IEEE ops, max -> np.maximum)."""
    alpha = np.maximum(alpha, 1e-12)
    H = c / (b * b * eps * eps * M * nu * alpha) + c * M / (b * eps)
    T = T_cm + nu * alpha * g * b
    return H * T


def _coordinate_descent_batch(T_cm, g, M, eps, nu, c, b0, alpha0,
                              sweeps: int = 8, b_max: float = 64.0):
    """`coordinate_descent` over N lanes: the same 8 alternating
    golden-section sweeps, each running all lanes through ONE
    `_golden_min_vec` call (alpha_min = 1/nu per lane)."""
    alpha_min = 1.0 / np.asarray(nu, np.float64)
    b = np.minimum(np.maximum(np.asarray(b0, np.float64), 1.0), b_max)
    alpha = np.maximum(np.asarray(alpha0, np.float64), alpha_min)
    hi_a = np.full_like(b, 100.0)
    lo_b, hi_b = np.ones_like(b), np.full_like(b, b_max)
    for _ in range(sweeps):
        alpha = _golden_min_vec(
            lambda a: _objective_batch(T_cm, g, M, eps, nu, c, b, a),
            alpha_min, hi_a)
        b = _golden_min_vec(
            lambda bb: _objective_batch(T_cm, g, M, eps, nu, c, bb, alpha),
            lo_b, hi_b)
    return b, alpha


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


def solve_batch(probs, method: str = "closed_form",
                b_max: float = 64.0):
    """`solve` over N problems at once, bit-identical to the scalar path.

    method='closed_form' (the default, and what every plan=True study
    arm runs) evaluates the Eq. 29 algebra as ONE (N,)-vectorized numpy
    dispatch; method='numerical' runs the grid seed as one (N, n, n)
    evaluation and the golden-section coordinate descent as lockstep
    `_golden_min_vec` sweeps (one batched objective probe per iteration
    for all lanes). Every lane reproduces the scalar expression
    association exactly, so each is bit-identical to `solve(probs[i])`
    — held by tests/test_torch_plan_batch.py. method='corrected' is a
    two-expression closed form; it stays a scalar loop, which is
    trivially identical.

    Returns a list of DelaySolution, one per problem, in order.
    """
    probs = list(probs)
    if not probs:
        return []
    if method == "corrected":
        return [solve(p, method=method, b_max=b_max) for p in probs]
    T_cm = np.asarray([p.T_cm for p in probs], np.float64)
    g = np.asarray([p.g for p in probs], np.float64)
    M = np.asarray([p.M for p in probs], np.float64)
    eps = np.asarray([p.eps for p in probs], np.float64)
    nu = np.asarray([p.nu for p in probs], np.float64)
    c = np.asarray([p.c for p in probs], np.float64)
    if method == "closed_form":
        inv_g = 1.0 / g
        alpha = np.sqrt(T_cm * inv_g / (M ** 2 * eps * nu ** 2))
        b = 2.0 * c * M * np.sqrt(T_cm * inv_g * eps)
        b = np.maximum(b, 1.0)
        alpha = np.maximum(alpha, 1e-6)
    elif method == "numerical":
        b0, a0 = _grid_search_batch(T_cm, g, M, eps, nu, c,
                                    b_range=(1.0, b_max))
        b, alpha = _coordinate_descent_batch(T_cm, g, M, eps, nu, c,
                                             b0, a0, b_max=b_max)
    else:
        raise ValueError(method)
    return [evaluate(p, float(bi), float(ai), method=method)
            for p, bi, ai in zip(probs, b, alpha)]
