"""Federated data partitioning: the label-Dirichlet non-IID split and the
population-scale virtual shards.

Copy of repro/federated/partition.py's `partition_dirichlet`,
`partition_sizes`, `shard_indices` and `partition_virtual`: the same RNG
calls in the same order, so the same seed gives the same partition."""
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


def shard_indices(n: int, m: int, shard_size: int, seed: int = 0) -> np.ndarray:
    """Client m's virtual data shard: `shard_size` sorted rows of the
    n-row dataset, drawn from a per-client seed sequence — O(1) state per
    client, no M-long partition list. Clients share rows (the dataset is
    a sample library at M >> n, not a disjoint split); draws are without
    replacement unless shard_size > n."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5AAD, m]))
    return np.sort(rng.choice(n, size=shard_size, replace=shard_size > n))


def partition_virtual(n: int, m_devices: int, shard_size: int = None,
                      seed: int = 0):
    """Population-scale partition: a lazy `indices_fn(m)` + (M,) sizes
    instead of M materialized index arrays. Disjoint Dirichlet splits are
    infeasible (and meaningless) at M >> n_train; each client instead owns
    a deterministic virtual shard (`shard_indices`). Feed the pair to
    `repro_torch.data.pipeline.ClientDataPool`."""
    shard_size = min(64, n) if shard_size is None else int(shard_size)
    sizes = np.full(m_devices, shard_size, dtype=np.int64)
    return (lambda m: shard_indices(n, m, shard_size, seed)), sizes
