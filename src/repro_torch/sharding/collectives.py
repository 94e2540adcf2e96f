"""The client axis across processes: the port's counterparts of the
reference's `axis_index`, `psum` and `all_gather` over its ("clients",)
mesh (repro/federated/mesh_rounds.py, `_psum_shardmap_sync` and
`_int8_shardmap_sync`).

The reference runs one controller over a mesh of devices and shards the
stacked client axis with `shard_map`. The port runs one process a device,
as `torchrun --nproc-per-node N` launches them, and the ranks of the
caller's default `torch.distributed` group are the client axis: rank r
holds lanes [r C/n, (r+1) C/n) of the C lanes (`lane_slice`). The
backend is the caller's: NCCL for CUDA tensors across cards, gloo on the
CPU (gloo also takes CUDA tensors, as two ranks sharing one card need). A
collective that fails raises: nothing is staged through the host or
retried unsharded.

A sharded round makes two collectives (mesh_rounds.build_round_step): one
all_gather of each lane's loss (and, under a scenario, its post-guard
participation flag) and one all_reduce of every leaf's weighted partial
sum, flattened into one float32 buffer. The reference's shard_map makes
one psum a leaf (8 for the MNIST CNN).

Without a process group the world is one process and every function
below is the identity on its input.
"""
from __future__ import annotations

import os
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


def initialized() -> bool:
    """Whether the caller has initialised the default process group."""
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> int:
    """The number of ranks on the client axis (1 without a group)."""
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    """This process's place on the client axis (0 without a group)."""
    return dist.get_rank(group) if initialized() else 0


def lane_slice(C: int, group=None) -> slice:
    """The lanes [r C/n, (r+1) C/n) of C that rank r holds. Raises the
    reference's ValueError when C does not divide over the n ranks."""
    n = world(group)
    if C % n:
        raise ValueError(f"client axis ({C} lanes) must divide evenly over "
                         f"the {n} available devices")
    per = C // n
    r = rank(group)
    return slice(r * per, (r + 1) * per)


def sum_partials(tensors: Sequence[torch.Tensor], group=None,
                 ) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, as float32, by ONE
    all_reduce(SUM) of a buffer that holds all of them flattened (the
    inputs are not written). Every rank gets the same bits."""
    if not initialized():
        return [t.to(torch.float32) for t in tensors]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def gather_rows(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order (the lane
    axis): one all_gather, in x's own dtype."""
    if not initialized():
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def device_for_rank(device) -> torch.device:
    """The device this rank runs on: a CUDA run without a device index goes
    on cuda:{LOCAL_RANK} (set by torchrun), else on cuda:{rank %
    device_count()}, which becomes the current device (NCCL's barrier and
    the caller's "cuda" tensors land there). A CPU device, or a CUDA one
    with an index, is kept."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else rank() % torch.cuda.device_count())
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def on_rank0(write: Callable[[], None]) -> None:
    """write() on rank 0 alone, then every rank waits at a barrier, so a
    file a sharded run writes is written once and is there for every rank
    after the call."""
    try:
        if rank() == 0:
            write()
    finally:
        if initialized():
            dist.barrier()
