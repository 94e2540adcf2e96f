"""Batching pipeline: deterministic, seeded, epoch-shuffled mini-batches.

Copy of repro/data/pipeline.py's `BatchIterator` (the same RNG calls, so
the same seed draws the same batch indices), with `batch_from` gathering
from tensors: the chunked path uploads the dataset to the device once
and gathers every batch there from the drawn int32 indices, while the
per-round backends take `next_batch`, gathered on the host. With it,
`ClientDataPool`, the lazy per-client pool of sampled participation, and
`token_batches`, the LM training windows of a token stream.
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

    def next_batch(self) -> Dict[str, np.ndarray]:
        """The next mini-batch gathered on the host (the per-round backends'
        path): exactly `batch_from(device_arrays(), next_indices())`, so
        both styles draw from one RNG stream."""
        return self.batch_from(self.device_arrays(), self.next_indices())

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The full backing arrays, uploaded once per simulator."""
        return {"x": self.data.x, "y": self.data.y}

    @staticmethod
    def batch_from(arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                   ) -> Dict[str, torch.Tensor]:
        """Gather a batch by global indices from device-resident arrays (or
        host numpy arrays): with idx shaped (..., B) the leaves come out
        (..., B, sample...)."""
        return {"x": arrays["x"][idx], "y": arrays["y"][idx]}


class ClientDataPool:
    """Lazy per-client batch-iterator pool for population-scale M.

    The dense data path materializes one `BatchIterator` per client up
    front (an M-long Python list — fine at M <= a few hundred, absurd at
    M = 10^5-10^6 when only K clients participate per round). The pool
    holds an `indices_fn(m)` instead and materializes a client's iterator
    on first touch, seeded `seed + m` — exactly the dense factory's
    per-client seed, so a pool over the same partition produces
    bit-identical batch streams to the dense list.

    Checkpoint state is O(touched clients): untouched clients carry no
    state (a fresh `BatchIterator(seed + m)` IS their snapshot), so
    `state()` snapshots only the touched ones. `set_state` is lazy where
    the reference's rebuilds every touched client's iterator: a client's
    snapshot is applied when it is next drawn, and until then it is its
    own state, so restoring a state costs nothing per client (a run that
    resumes every chunk would otherwise rebuild all the clients it has
    touched each time). The batches and the snapshots are the
    reference's, key for key and in its order.
    """

    def __init__(self, data: ClassificationData, indices_fn, sizes,
                 batch_size: int, seed: int = 0):
        self.data = data
        self._indices_fn = indices_fn
        self.sizes = np.asarray(sizes, np.int64)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self._iters: Dict[int, BatchIterator] = {}
        # Restored snapshots not yet applied, and every touched client in
        # the order the reference's snapshot lists them.
        self._pending: Dict[int, Dict] = {}
        self._order: Dict[int, None] = {}

    @classmethod
    def from_parts(cls, data: ClassificationData, parts, batch_size: int,
                   seed: int = 0) -> "ClientDataPool":
        """Pool over an explicit partition list (small-M sampled runs):
        same indices, same per-client seeds as the dense factory."""
        sizes = np.array([len(p) for p in parts], np.int64)
        return cls(data, lambda m: parts[m], sizes, batch_size, seed)

    def __len__(self) -> int:
        return len(self.sizes)

    def client(self, m: int) -> BatchIterator:
        it = self._iters.get(m)
        if it is None:
            it = BatchIterator(self.data, self._indices_fn(m),
                               self.batch_size, seed=self.seed + m)
            snap = self._pending.pop(m, None)
            if snap is not None:
                it.set_state(snap)
            self._iters[m] = it
            self._order.setdefault(m, None)
        return it

    # -- snapshot / restore (SimState checkpointing) ------------------------
    def state(self) -> Dict:
        return {"clients": {
            m: (self._iters[m].state() if m in self._iters
                else self._pending[m]) for m in self._order}}

    def set_state(self, state: Dict) -> None:
        self._iters = {}
        self._pending = {int(m): s
                         for m, s in state.get("clients", {}).items()}
        self._order = dict.fromkeys(self._pending)

    # -- device-resident gathering (scan backend) ---------------------------
    def device_arrays(self) -> Dict[str, np.ndarray]:
        return {"x": self.data.x, "y": self.data.y}

    batch_from = staticmethod(BatchIterator.batch_from)


def token_batches(stream: np.ndarray, batch: int, seq: int, step: int,
                  seed: int = 0) -> np.ndarray:
    """Slice a token stream into (batch, seq+1) int32 training windows,
    their starts drawn from seed + step (the reference's draw)."""
    rng = np.random.default_rng(seed + step)
    starts = rng.integers(0, len(stream) - seq - 1, batch)
    return np.stack([stream[s:s + seq + 1] for s in starts]).astype(np.int32)
