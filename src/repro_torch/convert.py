"""Parameters between the reference (JAX) package and the port.

The port keeps the reference's parameter layout (nested dicts with HWIO
conv filters and (in, out) dense weights), so carrying a model across is
a plain copy of each leaf: `to_torch` takes the reference's arrays as
numpy (`np.asarray` of a JAX array) and `to_numpy` gives them back.
`async_carry_to_torch` carries the asynchronous backend's event carry
(SimState.async_c) the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_map


def to_torch(params: Any, device=None) -> Any:
    """A tree of numpy arrays -> the same tree of tensors on `device`: the
    CUDA card unless the caller asks for the CPU (device.resolve_device;
    raises without a card)."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=dev), params)


def to_numpy(params: Any) -> Any:
    """A tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)


# The event carry of the asynchronous backend (SimState.async_c): its keys
# and, for the scheduling leaves, their dtypes; params_g and buf are float32
# parameter trees.
ASYNC_CARRY_DTYPES = {
    "buf_w": torch.float32, "cnt": torch.int32, "loss_sum": torch.float32,
    "t_finish": torch.float32, "t_next": torch.float32,
    "now": torch.float32, "version": torch.int32,
    "version_C": torch.int32, "drop_C": torch.float32,
}


def async_carry_to_torch(async_c: Any, device=None) -> dict:
    """The reference's asynchronous carry (`SimState.async_c` after
    `jax.device_get`: numpy leaves) as the port's, on `device` (the card
    unless the CPU is asked for): the same keys, each leaf copied with its
    dtype (float32 trees params_g and buf, 0-dim and (C,) scheduling
    leaves). With it a run of the port can start from the reference's
    mid-run state. Raises ValueError on a carry of other keys or dtypes."""
    want = set(ASYNC_CARRY_DTYPES) | {"params_g", "buf"}
    if set(async_c) != want:
        raise ValueError(f"an async carry has the keys {sorted(want)}, "
                         f"got {sorted(async_c)}")
    out = to_torch(async_c, device)
    for k, dt in ASYNC_CARRY_DTYPES.items():
        if out[k].dtype != dt:
            raise ValueError(f"async carry leaf {k!r} is {out[k].dtype}, "
                             f"expected {dt}")
    return out
