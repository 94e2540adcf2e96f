"""Plain PyTorch version of the fold matmul (csrc/fold_matmul.cu).

Contract: C = A @ B for A (batch, M, K) and B (batch, K, N) float32 at any
strides, C (batch, M, N) contiguous. The kernel sums each output over k in
order with fma; the plain version leaves the order to torch.matmul, so the
two agree to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch


def fold_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b).contiguous()
