"""Parameters between the reference (JAX) package and the port.

The port keeps the reference's parameter layout (nested dicts with HWIO
conv filters and (in, out) dense weights), so carrying a model across is
a plain copy of each leaf: `to_torch` takes the reference's arrays as
numpy (`np.asarray` of a JAX array) and `to_numpy` gives them back.
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
