"""Plain PyTorch version of flash attention (the contract of
csrc/flash_attention.cu).

`attention_ref` is line for line the reference's oracle,
repro/kernels/flash_attention/ref.py: scores, softmax and the PV product
in float32, the output in q's dtype, and a row with no valid key gives
zeros. `flash_attention_ref` adds the GQA contract of the reference's
wrapper (repro/kernels/flash_attention/ops.py: flash_attention): q
(B, Sq, H, hd) against k, v (B, Sk, KV, hd), where query head h reads kv
head h // (H // KV) — `jnp.repeat` order, which is torch's
`repeat_interleave`, not `repeat`.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,  # (BH, Sk, hd)
    v: torch.Tensor,  # (BH, Sk, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    Sq, Sk = q.shape[1], k.shape[1]
    hd = q.shape[-1]
    s = torch.einsum("bqh,bkh->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * (hd ** -0.5)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask[None], s, NEG_INF)
    # Fully-masked rows -> zeros (matches kernel semantics).
    row_valid = mask.any(dim=1)
    p = torch.softmax(s, dim=-1)
    p = torch.where(row_valid[None, :, None], p, 0.0)
    return torch.einsum("bqk,bkh->bqh", p, v.to(torch.float32)).to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention. Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    rep = H // k.shape[2]
    qt = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kt = k.transpose(1, 2).repeat_interleave(rep, dim=1).reshape(B * H, -1, hd)
    vt = v.transpose(1, 2).repeat_interleave(rep, dim=1).reshape(B * H, -1, hd)
    out = attention_ref(qt, kt, vt, causal, window, q_offset)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)
