"""Client-side batch scheduling for the chunked round driver.

Port of `stack_chunk_indices` of repro/federated/client.py."""
from __future__ import annotations

from typing import List

import numpy as np


def stack_chunk_indices(iterators: List, rounds: int, V: int) -> np.ndarray:
    """A whole chunk of batch *indices* -> (R, M, V, B) int32. Only the
    indices cross the host->device boundary; the samples are gathered on
    the device (BatchIterator.batch_from). Iterators are consumed round
    by round, client by client, step by step — the reference's order, so
    the drawn batches are the reference's."""
    out = np.empty(
        (rounds, len(iterators), V, iterators[0].batch_size), np.int32)
    for r in range(rounds):
        for c, it in enumerate(iterators):
            for v in range(V):
                out[r, c, v] = it.next_indices()
    return out
