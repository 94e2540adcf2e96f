"""The collective term of the dry run's roofline: collective ops, their
wire bytes and their summary.

`CollectiveOp`, `_DTYPE_BYTES`, `_wire_bytes` and `collective_summary`
are copies of repro/utils/hlo.py's. The reference parses its ops out of
the compiled HLO text of the post-SPMD per-device program. Eager PyTorch
emits no HLO, so the port has no parser: `fedavg_collectives` lists,
from the spec tree, the FedAvg sync of each of the port's aggregations
across ranks (federated/mesh_rounds.py: the collectives its sharded
modes call, and the gather its one-process sum would need). Shapes are
per-device shapes; wire bytes are per-device bytes moved:

  all-reduce        2 * bytes * (g-1)/g      (ring reduce-scatter+all-gather)
  all-gather        bytes_out * (g-1)/g      (bytes received)
  reduce-scatter    bytes_in * (g-1)/g
  all-to-all        bytes * (g-1)/g
  collective-permute bytes
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

from repro_torch.sharding.specs import at_path, shard_shape
from repro_torch.utils.tree import leaves_with_path

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}


@dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: tuple
    bytes: int
    group_size: int
    wire_bytes: float


def _wire_bytes(kind: str, nbytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind == "all-gather":
        return nbytes * frac  # nbytes = output (gathered) size
    if kind == "reduce-scatter":
        return nbytes * g * frac  # nbytes = output (scattered) shard
    if kind == "all-to-all":
        return nbytes * frac
    return float(nbytes)  # collective-permute


# The FedAvg syncs `fedavg_collectives` plans (launch/dryrun.py's
# --aggregation); the first is the default.
CROSS_RANK_AGGREGATIONS = ("allreduce_shardmap", "int8_shardmap",
                           "allreduce")


def fedavg_collectives(abstract_params: Any, specs: Any, mesh,
                       client_axes: Sequence[str],
                       aggregation: str = "allreduce_shardmap",
                       ) -> List[CollectiveOp]:
    """The FedAvg sync of one round step over client-stacked params
    (every leaf (C, ...), client axis first), over a group of the product
    g of the client axes' sizes, for each client-sharded leaf whose
    per-device shard is (C/g, *m):
      'allreduce_shardmap'  one float32 all-reduce of the shard with one
                            client row, (1, *m): each device first sums its
                            own rows (the reference's `_psum_shardmap_sync`,
                            mesh_rounds' partial sums and one all_reduce);
      'int8_shardmap'       one s8 all-gather of every client's codes, (C,
                            prod(m)), and one float32 all-gather of their
                            scales, (C, 1) (`_int8_shardmap_sync`);
      'allreduce'           one float32 all-gather of every client's rows,
                            (C, *m): the one-process sum over C needs them
                            all (the reference's GSPMD contraction, which
                            it measured gathering the whole leaf).
    Shapes are the gathered outputs' for an all-gather."""
    if aggregation not in CROSS_RANK_AGGREGATIONS:
        raise ValueError(f"unknown aggregation {aggregation!r}; expected one "
                         f"of {CROSS_RANK_AGGREGATIONS}")
    g = math.prod(mesh.shape[a] for a in client_axes)

    def op(kind, dtype, shape):
        nbytes = math.prod(shape) * _DTYPE_BYTES[dtype]
        return CollectiveOp(kind=kind, dtype=dtype, shape=shape,
                            bytes=nbytes, group_size=g,
                            wire_bytes=_wire_bytes(kind, nbytes, g))

    ops = []
    for path, leaf in leaves_with_path(abstract_params):
        spec = at_path(specs, path)
        if not spec or spec[0] is None:
            continue  # not sharded over the clients: nothing to sync
        C, m = leaf.shape[0], shard_shape(leaf.shape, spec, mesh)[1:]
        if aggregation == "allreduce_shardmap":
            ops.append(op("all-reduce", "f32", (1,) + m))
        elif aggregation == "int8_shardmap":
            ops.append(op("all-gather", "s8", (C, math.prod(m))))
            ops.append(op("all-gather", "f32", (C, 1)))
        else:
            ops.append(op("all-gather", "f32", (C,) + m))
    return ops


def collective_summary(ops: List[CollectiveOp]) -> Dict:
    by_kind: Dict[str, Dict] = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "bytes": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["bytes"] += op.bytes
        d["wire_bytes"] += op.wire_bytes
    return {
        "total_wire_bytes": sum(o.wire_bytes for o in ops),
        "total_bytes": sum(o.bytes for o in ops),
        "count": len(ops),
        "by_kind": by_kind,
    }
