"""Convergence theory (§III): the Eq. 12 round-count model.

Copy of the part of repro/core/convergence.py that the DEFL plan
(core/kkt.py, core/defl.py) needs.
"""
from __future__ import annotations


def communication_rounds_alpha(
    b: float, alpha: float, M: int, eps: float, nu: float, c: float,
) -> float:
    """Eq. 12 in the alpha = log(1/theta) parameterization (Section V):
    H = c/(b^2 eps^2 M nu alpha) + c M/(b eps)."""
    alpha = max(alpha, 1e-12)
    return c / (b * b * eps * eps * M * nu * alpha) + c * M / (b * eps)
