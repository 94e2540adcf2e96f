"""Synthetic image-classification sets (no dataset download is possible).

The set mimics MNIST in shape and cardinality:
inputs are per-class low-frequency templates plus noise through a tanh.
Copy of the MNIST-like part of repro/data/synthetic.py: the same RNG
calls in the same order, so the same seed gives the same arrays. Images
are NHWC float32, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ClassificationData:
    x: np.ndarray  # (N, H, W, C) float32
    y: np.ndarray  # (N,) int32
    n_classes: int

    @property
    def n(self) -> int:
        return len(self.y)


def _teacher_features(rng, n, hw, c, n_classes, y):
    """Class-conditional images: smooth class template + structured noise."""
    h, w = hw
    # Low-frequency class templates upsampled from 7x7 seeds.
    seeds = rng.normal(0.0, 1.0, (n_classes, 7, 7, c)).astype(np.float32)
    reps = (int(np.ceil(h / 7)), int(np.ceil(w / 7)))
    templates = np.kron(seeds, np.ones((1, *reps, 1), np.float32))[:, :h, :w, :]
    x = templates[y]
    x = x + rng.normal(0.0, 0.8, x.shape).astype(np.float32)
    # Mild nonlinearity so linear probes don't trivially solve it.
    return np.tanh(x).astype(np.float32)


def make_mnist_like(n: int = 10_000, seed: int = 0) -> ClassificationData:
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = _teacher_features(rng, n, (28, 28), 1, 10, y)
    return ClassificationData(x=x, y=y, n_classes=10)
