"""What a plain reference round of any model family takes and gives: one
member's run (its plan, clients and FedAvg weights), the trace of its
followed rounds, and the change norms the comparison reads. The CNN's
round is fl.py; another family's reference round returns the same Trace.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class Member:
    """One run of a study, fleet or sampled cell. `client_rows(m)` gives
    client m's dataset rows and `sizes` its FedAvg weight; `cohort` (M, K)
    draws K of M clients a round, else every client runs."""

    b: int
    V: int
    seed: int
    compress: bool
    client_rows: Callable[[int], np.ndarray]
    sizes: np.ndarray
    cohort: Optional[tuple] = None


@dataclass
class Trace:
    """A member's first rounds: each round's loss, and each leaf's change
    norm from the initial model, {round: {leaf: norm}}, after the rounds
    it was read at (the reference: every round)."""

    losses: List[float]
    changes: Dict[int, dict]


def norms(delta: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            delta.items()}
