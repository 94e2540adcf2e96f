"""Mixture-of-Experts channel mixer: a top-k router and a capacity-based
dispatch into a dense per-expert buffer. Port of repro/models/moe.py.

As in the reference, the tokens are scattered into an (E, C, d) capacity
buffer in token-major assignment order, the experts run as one batched
GLU over it, and an assignment past its expert's capacity C is dropped
(its gate weight is 0). The router runs in float32 and returns the
reference's aux loss (Switch load balance plus 1e-3 x the router
z-loss) and the dropped share.

Nothing here reads a value back to the host, and no shape depends on the
data: the dispatch writes dropped assignments to one spare row past the
buffer (the reference adds zeros at slot 0; every kept slot gets exactly
one token either way, so the buffers are equal), and the token copies of
the reference's `repeat` are never made (each of the k assignment
columns adds the tokens themselves).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.mlp import _act, init_mlp, mlp_forward


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig) -> Dict:
    """Normal weights drawn from `gen` on its device, in the reference's
    order and scales: the router (d, E) and the experts' wg, wi (E, d, f)
    at 1/sqrt(d), wo (E, f, d) at 1/sqrt(f), then the shared expert's MLP
    when `shared_expert_d_ff` is set."""
    E, f = cfg.n_experts, cfg.d_ff_expert
    si = 1.0 / (d_model ** 0.5)
    so = 1.0 / (f ** 0.5)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device) * scale

    p = {
        "router": normal((d_model, E), si),
        "wg": normal((E, d_model, f), si),
        "wi": normal((E, d_model, f), si),
        "wo": normal((E, f, d_model), so),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = init_mlp(gen, d_model, cfg.shared_expert_d_ff)
    return p


def moe_capacity(n_tokens: int, cfg: MoEConfig, capacity_factor: float,
                 ) -> int:
    """Slots an expert: n_tokens * k * factor / E, rounded up to a
    multiple of 8, at least 8 (the reference's float arithmetic)."""
    c = int(n_tokens * cfg.top_k * capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


class Routing(NamedTuple):
    """The router's decision for T tokens (k assignments each, token
    major): float32 logits and probs (T, E), the renormalised gates and
    the experts (T, k), each assignment's position in its expert's buffer
    (T * k,) and whether it fits in the C slots."""
    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first, the lower index first
    among equal values (jax.lax.top_k's order; torch.topk promises none):
    a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Dict, xt: torch.Tensor, cfg: MoEConfig,
          capacity_factor: Optional[float] = None) -> Routing:
    """Float32 routing of xt (T, d) and the capacity positions:
    softmax(x @ router), top k, gates renormalised over k; an
    assignment's position is the count of earlier assignments (token
    major) to its expert, kept below C."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    C = moe_capacity(T, cfg, capacity_factor or cfg.capacity_factor)
    # The reference's (T * k, E) one-hot, held expert-major so that the
    # running count runs along the contiguous axis (PyTorch's scan down
    # the 65,536 rows of 128 columns at qwen3-moe-30b-a3b's prefill took
    # 21 ms a layer on an H100); the counts are the same integers.
    flat = experts.reshape(T * k)
    onehot = torch.zeros((E, T * k), dtype=torch.int32, device=xt.device)
    onehot.scatter_(0, flat[None], 1)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, 0, flat[None])[0]
    return Routing(logits, probs, gates, experts, pos, pos < C, C)


def moe_forward(p: Dict, x: torch.Tensor, cfg: MoEConfig, act: str = "silu",
                capacity_factor: Optional[float] = None,
                ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (out (B, S, d), metrics {"aux_loss", "drop_frac"},
    0-dim float32). dispatch="global" routes all B * S tokens through one
    capacity buffer; "batched" routes each row through its own (the
    reference's vmap) and averages the metrics over rows.
    `capacity_factor` None (or 0) means cfg.capacity_factor."""
    B, S, d = x.shape
    if cfg.dispatch == "batched":
        rows = [_moe_tokens(p, row, cfg, act, capacity_factor) for row in x]
        out = torch.stack([o for o, _ in rows])
        metrics = {name: torch.mean(torch.stack([m[name] for _, m in rows]))
                   for name in rows[0][1]}
        return out, metrics
    out, metrics = _moe_tokens(p, x.reshape(B * S, d), cfg, act,
                               capacity_factor)
    return out.reshape(B, S, d), metrics


def _moe_tokens(p: Dict, xt: torch.Tensor, cfg: MoEConfig, act: str,
                capacity_factor: Optional[float]) -> Tuple[torch.Tensor, Dict]:
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    r = route(p, xt, cfg, capacity_factor)
    C = r.capacity

    # Load-balance aux loss (Switch) + router z-loss.
    me = torch.mean(r.probs, dim=0)
    top1 = torch.zeros((T, E), dtype=torch.float32, device=xt.device)
    top1.scatter_(1, r.experts[:, :1], 1.0)
    ce = torch.mean(top1, dim=0)
    aux = E * torch.sum(me * ce)
    zloss = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)))

    # Dispatch: assignment (t, j) to row expert * C + pos of the flattened
    # (E * C, d) buffer, a dropped one to the spare row E * C.
    slot = r.experts.reshape(T * k) * C + torch.where(r.keep, r.pos, 0)
    dest = torch.where(r.keep, slot, E * C).reshape(T, k)
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        buf.index_add_(0, dest[:, j], xt)
    buf = buf[:E * C].view(E, C, d)

    # Batched expert GLU: (E, C, d) x (E, d, f) -> (E, C, f).
    g = _act(torch.bmm(buf, p["wg"].to(xt.dtype)), act)
    h = g * torch.bmm(buf, p["wi"].to(xt.dtype))
    out_buf = torch.bmm(h, p["wo"].to(xt.dtype)).reshape(E * C, d)

    # Combine: each assignment's output weighted by its gate, summed over k.
    gathered = out_buf[slot]  # (T * k, d)
    w = (r.gates.reshape(T * k) * r.keep.to(torch.float32)).to(xt.dtype)
    out = torch.sum((gathered * w[:, None]).reshape(T, k, d), dim=1)

    if "shared" in p:
        out = out + mlp_forward(p["shared"], xt, act)

    metrics = {
        "aux_loss": cfg.router_aux_weight * aux + 1e-3 * zloss,
        "drop_frac": 1.0 - torch.mean(r.keep.to(torch.float32)),
    }
    return out, metrics
