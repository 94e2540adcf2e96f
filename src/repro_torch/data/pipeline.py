"""Batching pipeline: deterministic, seeded, epoch-shuffled mini-batches.

Copy of repro/data/pipeline.py's `BatchIterator` (the same RNG calls, so
the same seed draws the same batch indices), with `batch_from` gathering
from tensors: the simulator uploads the dataset to the device once and
gathers every batch there from the drawn int32 indices.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.data.synthetic import ClassificationData


class BatchIterator:
    """Infinite shuffled mini-batch iterator over index-selected data.

    `next_indices` returns the drawn *global* row indices of the next
    mini-batch; the samples themselves are gathered on the device by
    `batch_from` from the arrays `device_arrays` names."""

    def __init__(
        self, data: ClassificationData, indices: np.ndarray, batch_size: int,
        seed: int = 0,
    ):
        self.data = data
        self.indices = np.asarray(indices)
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        self._reshuffle()

    def _reshuffle(self) -> None:
        """Start a new epoch: snapshot the RNG position the permutation is
        drawn from (what `state` stores instead of the permutation itself),
        then draw it."""
        self._epoch_rng = self.rng.bit_generator.state
        self._order = self.rng.permutation(self.indices)
        self._ptr = 0

    def state(self) -> Dict:
        """Value snapshot of the draw position: the current RNG state, the
        RNG state the current epoch's permutation was drawn from, and the
        cursor. `set_state` on this iterator, or on a fresh one over the
        same data and partition, continues the batch stream exactly."""
        return {"rng": self.rng.bit_generator.state,
                "epoch_rng": self._epoch_rng, "ptr": self._ptr}

    def set_state(self, state: Dict) -> None:
        # Replay the epoch's permutation draw from its recorded RNG
        # position, then restore the current position.
        self.rng.bit_generator.state = state["epoch_rng"]
        self._epoch_rng = state["epoch_rng"]
        self._order = self.rng.permutation(self.indices)
        self.rng.bit_generator.state = state["rng"]
        self._ptr = int(state["ptr"])

    def next_indices(self) -> np.ndarray:
        """Global row indices of the next mini-batch, always exactly
        batch_size of them; small partitions sample with replacement."""
        n = len(self._order)
        bs = self.batch_size
        if n < bs:
            return self.rng.choice(self.indices, size=bs, replace=True)
        if self._ptr + bs > n:
            self._reshuffle()
        idx = self._order[self._ptr : self._ptr + bs]
        self._ptr += bs
        return idx

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The full backing arrays, uploaded once per simulator."""
        return {"x": self.data.x, "y": self.data.y}

    @staticmethod
    def batch_from(arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                   ) -> Dict[str, torch.Tensor]:
        """Gather a batch by global indices from device-resident arrays:
        with idx shaped (..., B) the leaves come out (..., B, sample...)."""
        return {"x": arrays["x"][idx], "y": arrays["y"][idx]}
