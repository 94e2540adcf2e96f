"""Plain PyTorch version of the Mamba-1 selective scan (the contract of
csrc/selective_scan.cu). Port of repro/kernels/selective_scan/ref.py.

  y, h_final = selective_scan(x, dt, A, B, C, D, chunk, h0)

  x  : (B, S, D)  fp32   post-conv activations
  dt : (B, S, D)  fp32   softplus'd step sizes
  A  : (D, N)     fp32   negative-real state matrix (diag)
  B  : (B, S, N)  fp32   input projection
  C  : (B, S, N)  fp32   output projection
  D  : (D,)       fp32   skip
  h0 : (B, D, N)  fp32   initial state (None = zeros)

Recurrence: h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
            y_t = (h_t · C_t) + D * x_t

`selective_scan_sequential` is the reference's step-by-step oracle, line
for line. `selective_scan_ref` is its chunked form: a loop over chunks of
`chunk` steps carrying h, with an associative scan inside each chunk.
Torch has no public associative scan, so a doubling (Hillis–Steele) scan
over the chunk axis stands in for `lax.associative_scan`: log2(L)
whole-tensor steps of the reference's `_assoc_op`. It combines the same
pairs in another tree order, so it agrees with the reference to float32
tolerance, not to the bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _assoc_op(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, b1 * a2 + b2


def _doubling_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of `_assoc_op` over `dim`: after it, element i holds
    the composition of elements 0..i (earliest on the left)."""
    L = a.shape[dim]
    k = 1
    while k < L:
        left = (a.narrow(dim, 0, L - k), b.narrow(dim, 0, L - k))
        right = (a.narrow(dim, k, L - k), b.narrow(dim, k, L - k))
        ca, cb = _assoc_op(left, right)
        a = torch.cat([a.narrow(dim, 0, k), ca], dim=dim)
        b = torch.cat([b.narrow(dim, 0, k), cb], dim=dim)
        k *= 2
    return a, b


def selective_scan_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # Zero-pad the tail: dt=0 => decay=1 and input=0, so the state is
        # carried through padding unchanged and padded outputs are dropped.
        x, dt, B, C = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                       for t in (x, dt, B, C))
        y, h = selective_scan_ref(x, dt, A, B, C, D, chunk=chunk, h0=h0)
        return y[:, :S], h
    nc = S // L
    h = (torch.zeros((Bsz, Dm, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        dA = torch.exp(dtc[..., None] * A[None, None])  # (B, L, D, N)
        dBx = (dtc * xc)[..., None] * Bc[:, :, None, :]  # (B, L, D, N)
        a_cum, b_cum = _doubling_scan(dA, dBx, dim=1)
        hs = a_cum * h[:, None] + b_cum  # (B, L, D, N)
        ys.append(torch.einsum("bldn,bln->bld", hs, Cc))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    return y + D[None, None] * x, h


def selective_scan_sequential(
    x, dt, A, B, C, D, h0=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step scan — the ground-truth oracle for the chunked forms."""
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    if h0 is None:
        h0 = torch.zeros((Bsz, Dm, N), dtype=torch.float32, device=x.device)

    h = h0
    ys = []
    for t in range(S):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        dA = torch.exp(dtt[..., None] * A[None])
        h = dA * h + (dtt * xt)[..., None] * Bt[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Ct))
    return torch.stack(ys, dim=1) + D[None, None] * x, h
