"""Synthetic datasets (no dataset download is possible).

The image-classification sets mimic MNIST / CIFAR-10 in shape and
cardinality: inputs are per-class low-frequency templates plus noise
through a tanh. Images are NHWC float32, as in the reference. Token
streams (`make_token_stream`, a learnable bigram stream) serve the LM
architectures. Copy of repro/data/synthetic.py: the same RNG calls in the
same order, so the same seed gives the same arrays.
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


def make_cifar_like(n: int = 10_000, seed: int = 0) -> ClassificationData:
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = _teacher_features(rng, n, (32, 32), 3, 10, y)
    return ClassificationData(x=x, y=y, n_classes=10)


def make_token_stream(n_tokens: int, vocab_size: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
    """Markov-ish synthetic token stream (learnable bigram structure):
    (n_tokens,) int32. `order` is the reference's unused argument."""
    rng = np.random.default_rng(seed)
    # Sparse bigram transition: each token strongly prefers a few successors.
    fanout = 8
    succ = rng.integers(0, vocab_size, (vocab_size, fanout))
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.integers(0, vocab_size)
    noise = rng.random(n_tokens)
    choice = rng.integers(0, fanout, n_tokens)
    rand_tok = rng.integers(0, vocab_size, n_tokens)
    for i in range(1, n_tokens):
        toks[i] = succ[toks[i - 1], choice[i]] if noise[i] < 0.8 else rand_tok[i]
    return toks
