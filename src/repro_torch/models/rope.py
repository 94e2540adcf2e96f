"""Rotary position embeddings. Port of repro/models/rope.py: the head is
split into halves (not interleaved pairs), angles in fp32."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               ) -> torch.Tensor:
    """Apply RoPE.

    x: (..., S, n_heads, head_dim); positions: (..., S) integer,
    broadcastable.
    """
    head_dim = x.shape[-1]
    inv = rope_freqs(head_dim, theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
