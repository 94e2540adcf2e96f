"""Federated data partitioning: the label-Dirichlet non-IID split.

Copy of repro/federated/partition.py's `partition_dirichlet` and
`partition_sizes`: the same RNG calls in the same order, so the same seed
gives the same partition."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import ClassificationData


def partition_dirichlet(
    data: ClassificationData, m_devices: int, alpha: float = 0.5, seed: int = 0,
) -> List[np.ndarray]:
    """Label-Dirichlet non-IID split (standard FL benchmark protocol).

    Every device is guaranteed at least one sample (re-draw on empties).
    """
    rng = np.random.default_rng(seed)
    for _ in range(100):
        shares = [[] for _ in range(m_devices)]
        for cls in range(data.n_classes):
            idx = np.flatnonzero(data.y == cls)
            rng.shuffle(idx)
            p = rng.dirichlet([alpha] * m_devices)
            cuts = (np.cumsum(p)[:-1] * len(idx)).astype(int)
            for dev, part in enumerate(np.split(idx, cuts)):
                shares[dev].append(part)
        parts = [np.sort(np.concatenate(s)) for s in shares]
        if all(len(p) > 0 for p in parts):
            return parts
    raise RuntimeError("could not produce non-empty Dirichlet partition")


def partition_sizes(parts: List[np.ndarray]) -> np.ndarray:
    """D_m (Eq. 1-2 weights)."""
    return np.array([len(p) for p in parts], dtype=np.int64)
