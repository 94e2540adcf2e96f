"""Mamba-1 block (falcon-mamba): selective SSM. Port of
repro/models/mamba.py.

The full-sequence scan is chosen by `impl`, with the names of
models/attention.py (the reference's in brackets):

  "plain", "blocked" (every impl but "pallas")  the chunked plain scan,
                        kernels/selective_scan/ref.py:selective_scan_ref;
  "kernel"  ("pallas")  the hand-written CUDA selective-scan kernel
                        (kernels/selective_scan), which runs its plain
                        version on CPU tensors.

Decode stays plain torch, as in the reference, and updates the layer's
cache in place (the reference returns a new one), as the attention decode
does.

bf16 rounding points follow the reference: the projections run in the
activations' dtype; `dt_in @ dt_w` is cast to float32 before `+ dt_b` and
the softplus; B and C are rounded by the projection before their float32
cast; the scan's float32 y is rounded to the activations' dtype before the
gate; the conv cache holds the pre-activation `xz` tail in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

IMPLS = ("plain", "blocked", "kernel")


def mamba1_dims(d_model: int, cfg: SSMConfig):
    d_in = cfg.expand * d_model
    dt_rank = max(d_model // 16, 1)
    return d_in, dt_rank


def init_mamba1(gen: torch.Generator, d_model: int, cfg: SSMConfig) -> Dict:
    """The reference's initialisation, drawn from `gen` on its device (the
    values differ from the reference's: torch's generator is not JAX's
    threefry). The normal draws go in the reference's key order."""
    d_in, dt_rank = mamba1_dims(d_model, cfg)
    dev = gen.device
    si = 1.0 / (d_model ** 0.5)
    sx = 1.0 / (d_in ** 0.5)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    in_x = normal((d_model, d_in), si)
    in_z = normal((d_model, d_in), si)
    conv_w = normal((cfg.d_conv, d_in), 0.1)
    x_proj = normal((d_in, dt_rank + 2 * cfg.d_state), sx)
    dt_w = normal((dt_rank, d_in), 1.0 / (dt_rank ** 0.5))
    out_proj = normal((d_in, d_model), sx)
    # S4D-real initialization for A.
    A = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                     device=dev).repeat(d_in, 1)
    return {
        "in_x": in_x,
        "in_z": in_z,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_in,), device=dev),
        "x_proj": x_proj,
        "dt_w": dt_w,
        "dt_b": torch.log(torch.expm1(torch.full((d_in,), 0.01, device=dev))),
        "A_log": torch.log(A),
        "D": torch.ones((d_in,), device=dev),
        "out_proj": out_proj,
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, D); w: (K, D); b: (D,)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(
        xp[:, i : i + x.shape[1], :] * w[i].to(x.dtype) for i in range(K)
    )
    return out + b.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    without torch's linear threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(p: Dict, x_c: torch.Tensor, cfg: SSMConfig):
    dt_rank = p["dt_w"].shape[0]
    proj = x_c @ p["x_proj"].to(x_c.dtype)
    dt_in, B_t, C_t = proj.split([dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = softplus(
        (dt_in @ p["dt_w"].to(x_c.dtype)).to(torch.float32) + p["dt_b"])
    A = -torch.exp(p["A_log"])  # (D, N)
    return dt, A, B_t.to(torch.float32), C_t.to(torch.float32)


def _scan(impl: str):
    if impl == "kernel":
        return ss_ops.selective_scan
    if impl in ("plain", "blocked"):
        return selective_scan_ref
    raise ValueError(f"unknown scan impl {impl!r}; expected one of {IMPLS}")


def mamba1_forward(
    p: Dict, x: torch.Tensor, cfg: SSMConfig, impl: str = "plain",
    h0: Optional[torch.Tensor] = None, return_state: bool = False,
):
    """x: (B, S, d_model) -> (B, S, d_model) [+ final (conv_tail, h) state]."""
    scan = _scan(impl)
    xz = x @ p["in_x"].to(x.dtype)
    z = x @ p["in_z"].to(x.dtype)
    conv_out = causal_conv1d(xz, p["conv_w"], p["conv_b"])
    x_c = F.silu(conv_out)
    dt, A, B_t, C_t = _ssm_inputs(p, x_c, cfg)
    y, h = scan(x_c.to(torch.float32), dt, A, B_t, C_t, p["D"],
                chunk=cfg.chunk, h0=h0)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        K = p["conv_w"].shape[0]
        conv_tail = xz[:, -(K - 1) :, :]  # last K-1 pre-activation inputs
        return out, (conv_tail, h)
    return out


def init_mamba1_cache(batch: int, d_model: int, cfg: SSMConfig,
                      dtype=torch.float32, device=None) -> Dict:
    d_in, _ = mamba1_dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_in, cfg.d_state), dtype=torch.float32,
                         device=device),
    }


def mamba1_decode_step(
    p: Dict, x: torch.Tensor, cfg: SSMConfig, cache: Dict
) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step. x: (B, 1, d_model). The cache's tensors
    are updated in place and the same dict returned."""
    xz = x @ p["in_x"].to(x.dtype)  # (B, 1, D)
    z = x @ p["in_z"].to(x.dtype)
    window = torch.cat([cache["conv"].to(x.dtype), xz], dim=1)
    conv_out = (
        torch.einsum("bkd,kd->bd", window, p["conv_w"].to(x.dtype))
        + p["conv_b"].to(x.dtype)
    )[:, None, :]
    x_c = F.silu(conv_out)
    dt, A, B_t, C_t = _ssm_inputs(p, x_c, cfg)
    xf = x_c.to(torch.float32)[:, 0]  # (B, D)
    dt0, B0, C0 = dt[:, 0], B_t[:, 0], C_t[:, 0]
    dA = torch.exp(dt0[:, :, None] * A[None])  # (B, D, N)
    dBx = dt0[:, :, None] * B0[:, None, :] * xf[:, :, None]
    h = dA * cache["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, C0) + p["D"] * xf
    y = y.to(x.dtype)[:, None, :] * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return out, cache
