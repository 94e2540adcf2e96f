"""Convergence theory (§III): Theorem 1, Corollaries 1-2, Remark 3.

These give the round-count model H(b, theta; M, eps, nu, c) that the delay
optimization (core/kkt.py) multiplies against the per-round time model.
Copy of repro/core/convergence.py, expression for expression.
"""
from __future__ import annotations

import numpy as np


def theorem1_bound(
    w0_dist_sq: float, sigma_sq: float, L: float,
    M: int, K: int, V: int, b: int = 1,
) -> float:
    """Corollary 1 (Eq. 10) upper bound on E[F(w̄_K) - F(w*)].

    b=1 recovers Theorem 1 (Eq. 9).
    """
    t1 = 8.0 * w0_dist_sq / np.sqrt(M * K)
    t2 = sigma_sq / (2.0 * b * L * np.sqrt(M * K))
    t3 = sigma_sq * M * (V - 1) / (b * L * K)
    return t1 + t2 + t3


def local_rounds(theta: float, nu: float) -> int:
    """Remark 3: V = nu * log(1/theta), >= 1."""
    return max(int(round(nu * np.log(1.0 / max(theta, 1e-12)))), 1)


def communication_rounds(
    b: float, theta: float, M: int, eps: float, nu: float, c: float,
) -> float:
    """Eq. 12: H = c/(b^2 eps^2 M nu log(1/theta)) + c M/(b eps).

    The first term is the variance-driven requirement (shrinks with more
    local work nu*log(1/theta) and bigger batches); the second is the
    drift/communication floor.
    """
    alpha = np.log(1.0 / max(theta, 1e-12))
    alpha = max(alpha, 1e-12)
    return c / (b * b * eps * eps * M * nu * alpha) + c * M / (b * eps)


def communication_rounds_alpha(
    b: float, alpha: float, M: int, eps: float, nu: float, c: float,
) -> float:
    """Eq. 12 in the alpha = log(1/theta) parameterization (Section V)."""
    alpha = max(alpha, 1e-12)
    return c / (b * b * eps * eps * M * nu * alpha) + c * M / (b * eps)


def gradient_steps_for_eps(
    eps: float, w0_dist_sq: float, sigma_sq: float, L: float,
    M: int, V: int, b: int,
) -> int:
    """Invert Corollary 1 numerically: smallest K with bound(K) <= eps."""
    lo, hi = 1, 1
    while theorem1_bound(w0_dist_sq, sigma_sq, L, M, hi, V, b) > eps:
        hi *= 2
        if hi > 1 << 40:
            raise ValueError("eps unreachable under this bound")
    while lo < hi:
        mid = (lo + hi) // 2
        if theorem1_bound(w0_dist_sq, sigma_sq, L, M, mid, V, b) <= eps:
            hi = mid
        else:
            lo = mid + 1
    return lo
