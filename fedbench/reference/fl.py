"""Plain federated rounds of the CNN (cnn.py) on images: each member's
clients take V SGD steps of batch b from the global model, their updates
are averaged by data size (FedAvg), through the int8 stochastic-rounding
round trip when compressed.

No code of the program: the batch indices come from the frozen copies of
data.py, the quantizer noise from a torch generator seeded with the
member's run seed (the generator's uint8 draws on the device, one draw of
every lane's rows a round), the quantizer from the frozen copy below.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from . import cnn
from .data import BatchIterator, CohortStream
from .rounds import Member, Trace, norms

ROW = 1024


def quantize(x: torch.Tensor, u: torch.Tensor):
    """Frozen copy of the rowwise int8 quantizer with stochastic rounding
    (repro_torch/kernels/quantize/ref.py quantize_ref)."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        1.0)
    q = torch.clamp(torch.floor(x / scale + u), -127, 127)
    q = torch.where(torch.isnan(q), 0.0, q)
    return q, scale


def noise(gen: torch.Generator, shape) -> torch.Tensor:
    b = torch.randint(0, 256, tuple(shape), dtype=torch.uint8, generator=gen,
                      device=gen.device)
    return (b.to(torch.float32) + 0.5) * (1.0 / 256.0)


def _int8_roundtrip(deltas: dict, u: torch.Tensor) -> dict:
    """Each lane's update, leaf by leaf in sorted order, each leaf padded to
    whole 1024-rows, quantized with its rows of u and dequantized."""
    keys = sorted(deltas)
    L = deltas[keys[0]].shape[0]
    segs = []
    for k in keys:
        flat = deltas[k].reshape(L, -1)
        segs.append(torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % ROW)))
    rows = torch.cat(segs, dim=1).reshape(-1, ROW)
    q, scale = quantize(rows, u.reshape(-1, ROW))
    flat = (q * scale).reshape(L, -1)
    out, at = {}, 0
    for k in keys:
        n = deltas[k][0].numel()
        out[k] = flat[:, at:at + n].reshape(deltas[k].shape)
        at += -(-n // ROW) * ROW
    return out


def run(member: Member, init: dict, x: torch.Tensor, y: torch.Tensor,
        lr: float, rounds: int, mode: str = "float32",
        half_batch: bool = False, mean_over: Optional[int] = None) -> Trace:
    """`rounds` rounds of one member from the global model `init` on the
    dataset (x, y) on its device. mode "tf32" is the control; half_batch
    plants the fault of a step that averages half of each batch;
    `mean_over` the fault of a padded step whose loss is the sum over the
    member's b samples divided by `mean_over` (a Study's B_env) instead
    of by b."""
    dev = x.device
    g0 = {k: v.clone() for k, v in init.items()}
    glob = {k: v.clone() for k, v in init.items()}
    gen = torch.Generator(device=dev).manual_seed(member.seed)
    iters = {}
    stream = None
    if member.cohort is not None:
        stream = CohortStream(*member.cohort, member.seed)
    n_clients = len(member.sizes)
    rows = sum(-(-v.numel() // ROW) for v in init.values())
    losses, changes = [], {}
    with cnn.precision(mode, dev) as emulate:
        def client_loss(p, xb, yb):
            if half_batch:
                keep = max(1, xb.shape[0] // 2)
                xb, yb = xb[:keep], yb[:keep]
            scale = xb.shape[0] / mean_over if mean_over else 1.0
            return cnn.loss(p, xb, yb, emulate) * scale

        step = vmap(grad_and_value(client_loss))
        for r in range(rounds):
            lanes = (stream.draw() if stream is not None
                     else np.arange(n_clients))
            u = (noise(gen, (len(lanes), rows, ROW)) if member.compress
                 else None)
            idx = np.empty((len(lanes), member.V, member.b), np.int64)
            for i, m in enumerate(lanes):
                it = iters.get(int(m))
                if it is None:
                    it = iters[int(m)] = BatchIterator(
                        member.client_rows(int(m)), member.b,
                        member.seed + int(m))
                for v in range(member.V):
                    idx[i, v] = it.next_indices()
            idx_t = torch.as_tensor(idx, device=dev)
            p = {k: v.expand(len(lanes), *v.shape).clone()
                 for k, v in glob.items()}
            total = torch.zeros(len(lanes), device=dev)
            for v in range(member.V):
                grads, lv = step(p, x[idx_t[:, v]], y[idx_t[:, v]])
                p = {k: p[k] - lr * grads[k] for k in p}
                total = total + lv
            w = torch.as_tensor(np.asarray(member.sizes)[lanes],
                                dtype=torch.float32, device=dev)
            w = w / w.sum()
            if member.compress:
                deltas = {k: p[k] - glob[k] for k in p}
                rec = _int8_roundtrip(deltas, u)
                glob = {k: glob[k] + torch.tensordot(w, rec[k], dims=1)
                        for k in glob}
            else:
                glob = {k: torch.tensordot(w, p[k], dims=1) for k in glob}
            losses.append(float((total / member.V).mean()))
            changes[r + 1] = norms({k: glob[k] - g0[k] for k in glob})
    return Trace(losses=losses, changes=changes)
