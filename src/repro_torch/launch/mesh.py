"""Named-axes meshes for the dry run (launch/dryrun.py), with no devices.

The reference builds `jax.make_mesh` over 256 or 512 placeholder CPU
devices; its sharding rules read only the mesh's `.shape`, an ordered
{axis: size}. A `Mesh` here is that shape and nothing else: building
one touches no device, starts no process group and initialises no
CUDA. Runs that do cross devices, the sharded FL client axis, are one
process a card in a torch.distributed group (sharding/collectives.py).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import MeshConfig


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """{axis: size} in axis order (jax.sharding.Mesh.shape)."""
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The device count."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ('data', 'model'), 256 devices; (2, 16, 16) ('pod',
    'data', 'model'), 512 devices."""
    mc = MeshConfig(multi_pod=multi_pod)
    return Mesh(mc.axes, mc.shape)


def make_mesh_from_config(mc: MeshConfig) -> Mesh:
    return make_production_mesh(multi_pod=mc.multi_pod)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    return Mesh(tuple(axes), tuple(shape))
