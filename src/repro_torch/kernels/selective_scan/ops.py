"""Wrapper of the CUDA selective-scan kernel (csrc/selective_scan.cu).

`selective_scan` launches the kernel for CUDA tensors and counts the
launch in `launches`; for CPU tensors it runs the plain version
(ref.selective_scan_ref) and counts nothing. Any other device raises, and
a failed build or launch raises: nothing gives way to the plain version.
The kernel is built with nvcc at its first launch in the process
(kernels/build.py).

Unlike the reference's wrapper (repro/kernels/selective_scan/ops.py),
nothing is padded and a nonzero `h0` goes to the kernel itself (the
reference sends it to its oracle). B and C may be views with strided rows
(the split of the x projection); only their last dim must be contiguous.

On the card the kernel runs under autograd (`_SelectiveScan`): its
forward is one launch, and its backward is the VJP of the plain version
recomputed from the saved inputs (h0 included), as the flash wrapper's.
Neither package has a backward kernel (the reference's Pallas scan has no
VJP; its training runs the plain scan). On CPU tensors the plain version
is differentiable.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"

STATE_SIZES = (8, 16)

# Kernel launches since the count was last set to 0.
launches = 0

_kernel = None  # (launcher, nvcc log, occupancy query) once built


def load_kernel() -> Tuple[Callable, str]:
    """(launcher, nvcc log): builds the kernel on first use; later calls
    touch no file."""
    global _kernel
    if _kernel is None:
        lib, log = build.load(SOURCE)
        fn = lib.selective_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.selective_scan_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        _kernel = (fn, log, occ)
    return _kernel[:2]


def occupancy(Bsz: int, Dm: int, N: int) -> Tuple[int, int, int]:
    """(blocks an SM can hold, blocks in the grid, warps a block) of the
    kernel launched on Bsz x Dm channels with N states, on the current
    card (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    load_kernel()
    out = (ctypes.c_int * 3)()
    rc = _kernel[2](Bsz, Dm, N, out)
    if rc != 0:
        raise RuntimeError(f"selective scan occupancy query failed: "
                           f"cudaError {rc}")
    return out[0], out[1], out[2]


def _check(x, dt, A, B, C, D, h0) -> None:
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan needs x (B, S, D) and A (D, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    want = {"dt": (dt, (Bsz, S, Dm)), "A": (A, (Dm, N)),
            "B": (B, (Bsz, S, N)), "C": (C, (Bsz, S, N)), "D": (D, (Dm,))}
    if h0 is not None:
        want["h0"] = (h0, (Bsz, Dm, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape} for x "
                             f"{tuple(x.shape)} and A {tuple(A.shape)}")
    tensors = [x] + [t for t, _ in want.values()]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("selective_scan takes float32 inputs, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("selective_scan inputs lie on "
                         f"{sorted({str(t.device) for t in tensors})}")


def selective_scan(
    x: torch.Tensor,  # (B, S, D) fp32
    dt: torch.Tensor,  # (B, S, D) fp32
    A: torch.Tensor,  # (D, N) fp32
    B: torch.Tensor,  # (B, S, N) fp32
    C: torch.Tensor,  # (B, S, N) fp32
    D: torch.Tensor,  # (D,) fp32
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # (B, D, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ref.selective_scan_ref: (y (B, S, D) in x's dtype,
    h_final (B, D, N) float32), differentiable on both devices. `chunk`
    orders the plain version's sums (on the card, those of the backward);
    the kernel takes it and ignores it."""
    _check(x, dt, A, B, C, D, h0)
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu, not {x.device}")
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"the CUDA scan kernel takes d_state in "
                         f"{STATE_SIZES}, got {N}")
    if min(Bsz, S, Dm) == 0:
        raise ValueError(f"selective_scan needs nonempty inputs, got x "
                         f"{tuple(x.shape)}")
    if Bsz > 65535:
        raise ValueError(f"the CUDA scan kernel takes B <= 65535, got {Bsz}")
    dense = [x, dt, A, D] + ([h0] if h0 is not None else [])
    if not all(t.is_contiguous() for t in dense):
        raise ValueError("the CUDA scan kernel needs contiguous x, dt, A, D "
                         "and h0")
    if B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("the CUDA scan kernel needs B and C contiguous in "
                         "their last dim")
    return _SelectiveScan.apply(x, dt, A, B, C, D, h0, chunk)


class _SelectiveScan(torch.autograd.Function):
    """The kernel's forward with the plain version's VJP as its backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk):
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _launch(x, dt, A, B, C, D, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        inputs = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(saved, need)]
        with torch.enable_grad():
            outs = selective_scan_ref(*inputs[:6], chunk=ctx.chunk,
                                      h0=inputs[6])
        pairs = [(o, g) for o, g in zip(outs, (gy, gh)) if g is not None]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], [t for t, n in zip(inputs, need) if n],
            [g for _, g in pairs], allow_unused=True))
        return (*(next(grads) if n else None for n in need), None)


def _launch(x, dt, A, B, C, D, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on checked CUDA tensors."""
    global launches
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    launch, _ = load_kernel()
    y = torch.empty_like(x)
    h = torch.empty((Bsz, Dm, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), D.data_ptr(),
                    None if h0 is None else h0.data_ptr(), y.data_ptr(),
                    h.data_ptr(), Bsz, S, Dm, N, B.stride(0), B.stride(1),
                    C.stride(0), C.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"selective scan kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return y, h
