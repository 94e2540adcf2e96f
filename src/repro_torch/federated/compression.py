"""Update compression for the uplink ('talk' reduction — beyond-paper).

int8 stochastic-rounding quantization with one float32 scale per
1024-value row shrinks T_cm ~4x at an unbiased gradient cost. Port of
repro/federated/compression.py.

Layout: each leaf of an update tree is flattened and padded to whole
1024-rows (so a row's scale never mixes leaves), and the padded leaves,
in `utils.tree.leaves` order (JAX's dict order), concatenate into one
(rows, 1024) matrix — the reference's layout, row for row. Updates may
carry leading client dimensions: all clients' rows go through ONE quantize
launch on the flat (clients * rows, 1024) matrix.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import ops
from repro_torch.utils.tree import leaves, tree_map, unflatten

# Values per scale: one fp32 scale per ROW-sized chunk.
ROW = 1024


def n_rows(params: Any) -> int:
    """Rows of one update of `params` (each leaf padded to whole rows)."""
    return sum(-(-int(np.prod(x.shape)) // ROW) for x in leaves(params))


def compress_update(update: Any, u: torch.Tensor) -> dict:
    """Quantize a tree of float32 deltas into int8 codes + row scales.

    u is the rounding noise, shaped (*lead, rows, ROW): `lead` are the
    leading (client) dimensions every leaf of `update` carries, and rows
    is `n_rows` of one update. Returns {'q' (*lead, rows, ROW) int8,
    'scale' (*lead, rows, 1), 'tree', 'meta'}."""
    lead = tuple(u.shape[:-2])
    segs, meta = [], []
    for leaf in leaves(update):
        flat = leaf.reshape(*lead, -1)
        size = flat.shape[-1]
        pad = (-size) % ROW
        segs.append(F.pad(flat, (0, pad)))
        meta.append((tuple(leaf.shape[len(lead):]), size, (size + pad) // ROW))
    rows = torch.cat(segs, dim=-1).reshape(-1, ROW)
    q, scale = ops.quantize(rows, u.reshape(-1, ROW))
    return {"q": q.reshape(*lead, -1, ROW),
            "scale": scale.reshape(*lead, -1, 1),
            "tree": tree_map(lambda _: None, update), "meta": tuple(meta)}


def decompress_update(comp: dict) -> Any:
    lead = tuple(comp["q"].shape[:-2])
    flat = ops.dequantize(comp["q"], comp["scale"]).reshape(*lead, -1)
    out, at = [], 0
    for shape, size, rows in comp["meta"]:
        out.append(flat[..., at : at + size].reshape(*lead, *shape))
        at += rows * ROW
    return unflatten(comp["tree"], out)


def compressed_bits(update: Any) -> int:
    """Uplink bits for an int8-compressed update (payload + scales)."""
    total = 0
    for x in leaves(update):
        n = int(np.prod(x.shape))
        total += n * 8 + int(np.ceil(n / 1024)) * 32
    return total


def raw_bits(update: Any) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize * 8
               for x in leaves(update))
