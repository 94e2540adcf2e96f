"""Normalization layers (functional, param dicts). Port of
repro/models/norms.py."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             ) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to input dtype.

    Uses the (1 + scale) parameterization (gemma-style) with zero-init scale
    so initialization is exactly unit-gain for every arch.
    """
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * (1.0 / torch.sqrt(var + eps))
    return (xf * (1.0 + scale.to(torch.float32))).to(dtype)


def init_rms_norm(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)
