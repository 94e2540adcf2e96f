"""Frozen numpy copies of the inputs' arithmetic: the synthetic datasets,
the client partitions, the batch-index streams and the cohort draws.

Copied from repro_torch as it stood when the benchmark was written (the
same RNG calls in the same order), so the same seeds give the same arrays:
  make_mnist_like, make_cifar_like, _teacher_features  data/synthetic.py
  partition_dirichlet, shard_indices, partition_virtual federated/partition.py
  BatchIterator (its index stream only)                data/pipeline.py
  CohortStream (ScenarioStream's uniform cohort draw)  federated/scenarios.py
Later changes to the program do not reach these copies: they are the
yardstick's.
"""
from __future__ import annotations

import numpy as np

SHAPES = {"mnist": ((28, 28), 1), "cifar": ((32, 32), 3)}


def _teacher_features(rng, n, hw, c, n_classes, y):
    h, w = hw
    seeds = rng.normal(0.0, 1.0, (n_classes, 7, 7, c)).astype(np.float32)
    reps = (int(np.ceil(h / 7)), int(np.ceil(w / 7)))
    templates = np.kron(seeds, np.ones((1, *reps, 1), np.float32))[:, :h, :w, :]
    x = templates[y]
    x = x + rng.normal(0.0, 0.8, x.shape).astype(np.float32)
    return np.tanh(x).astype(np.float32)


def make_dataset(name: str, n: int, seed: int):
    """(x (n, H, W, C) float32, y (n,) int32) of the synthetic MNIST-like
    or CIFAR-like task."""
    hw, c = SHAPES[name]
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    return _teacher_features(rng, n, hw, c, 10, y), y


def partition_dirichlet(y: np.ndarray, m_devices: int, alpha: float,
                        seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        shares = [[] for _ in range(m_devices)]
        for cls in range(10):
            idx = np.flatnonzero(y == cls)
            rng.shuffle(idx)
            p = rng.dirichlet([alpha] * m_devices)
            cuts = (np.cumsum(p)[:-1] * len(idx)).astype(int)
            for dev, part in enumerate(np.split(idx, cuts)):
                shares[dev].append(part)
        parts = [np.sort(np.concatenate(s)) for s in shares]
        if all(len(p) > 0 for p in parts):
            return parts
    raise RuntimeError("could not produce non-empty Dirichlet partition")


def shard_indices(n: int, m: int, shard_size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5AAD, m]))
    return np.sort(rng.choice(n, size=shard_size, replace=shard_size > n))


def virtual_shard_size(n: int) -> int:
    return min(64, n)


class BatchIterator:
    """A client's stream of batch indices: an epoch-shuffled permutation of
    its rows, consumed batch_size at a time (with replacement when the
    client holds fewer rows than a batch)."""

    def __init__(self, indices, batch_size: int, seed: int):
        self.indices = np.asarray(indices)
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        self._reshuffle()

    def _reshuffle(self) -> None:
        self._order = self.rng.permutation(self.indices)
        self._ptr = 0

    def next_indices(self) -> np.ndarray:
        n, bs = len(self._order), self.batch_size
        if n < bs:
            return self.rng.choice(self.indices, size=bs, replace=True)
        if self._ptr + bs > n:
            self._reshuffle()
        idx = self._order[self._ptr:self._ptr + bs]
        self._ptr += bs
        return idx


class CohortStream:
    """The uniform K-of-M cohort draw of a sampled run: each round the K
    smallest of M uniform keys, sorted ascending."""

    def __init__(self, M: int, K: int, seed: int):
        self.M, self.K = int(M), int(K)
        self._rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xC047]))

    def draw(self) -> np.ndarray:
        if self.K == self.M:
            return np.arange(self.M, dtype=np.int32)
        key = self._rng.random(self.M)
        return np.sort(np.argpartition(key, self.K)[:self.K]).astype(np.int32)
