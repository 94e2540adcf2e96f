"""Gated-linear-unit MLPs (SwiGLU / GeGLU). Port of repro/models/mlp.py."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> Dict:
    """Normal weights scaled by 1/sqrt(fan_in), drawn from `gen` on its
    device (the values differ from the reference's: torch's generator is
    not JAX's threefry)."""
    si = 1.0 / (d_model ** 0.5)
    so = 1.0 / (d_ff ** 0.5)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device) * scale

    return {
        "wg": normal((d_model, d_ff), si),
        "wi": normal((d_model, d_ff), si),
        "wo": normal((d_ff, d_model), so),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def mlp_forward(p: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = _act(x @ p["wg"].to(x.dtype), act)
    h = g * (x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
