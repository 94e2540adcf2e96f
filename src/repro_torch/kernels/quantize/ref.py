"""Plain PyTorch version of the int8 stochastic-rounding quantizer.

Contract (shared with the CUDA kernel, csrc/quantize.cu):

  q, scale = quantize(x, u)     x, u: (R, D) float32 -> q int8, scale (R, 1)
  x_hat    = dequantize(q, scale)

Line for line the reference's repro/kernels/quantize/ref.py, except that
the rounding noise u is an argument: torch cannot reproduce JAX's
threefry stream, so the noise is drawn by `stochastic_noise` from a torch
generator on the same 8-bit grid, and tests hand both packages the same
u. Stochastic rounding makes the quantizer unbiased: E[x_hat] = x.
"""
from __future__ import annotations

from typing import Tuple

import torch


def noise_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """Rounding noise on the grid (k + 0.5)/256, k in 0..255, from uint8
    bytes: the mean is exactly 1/2 (unbiased rounding) and no value is 0,
    which would put floor(y + u) on an integer boundary whenever y is."""
    return (b.to(torch.float32) + 0.5) * (1.0 / 256.0)


def stochastic_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Rounding noise of `shape` drawn as uint8 bytes from `generator`, on
    the generator's device."""
    b = torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                      generator=generator, device=generator.device)
    return noise_from_bytes(b)


def quantize_ref(x: torch.Tensor, u: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rowwise symmetric int8 quantization with stochastic rounding.

    x, u: (R, D) float32. Returns (q int8 (R, D), scale float32 (R, 1))."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # Divide by a tensor, not a Python number: on CUDA, torch turns
    # division by a scalar into multiplication by its reciprocal, which
    # is not IEEE division and misses the reference's scale by an ulp.
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        1.0)
    y = x / scale
    q = torch.floor(y + u)
    q = torch.clamp(q, -127, 127)
    # A NaN code (non-finite input) becomes 0, as XLA converts NaN to
    # int8 in the reference; torch leaves that conversion undefined.
    q = torch.where(torch.isnan(q), 0.0, q)
    return q.to(torch.int8), scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
