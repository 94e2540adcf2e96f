"""Wrapper of the CUDA quantize kernel (csrc/quantize.cu).

`quantize` launches the kernel for CUDA tensors and counts the launch in
`launches`; for CPU tensors it runs the plain version (ref.py) and counts
nothing. Any other device raises. The kernel is built with nvcc at its
first launch in the process (kernels/build.py).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize.cu"

# Kernel launches since the count was last set to 0.
launches = 0

_kernel = None  # (launcher, nvcc log) once built


def load_kernel() -> Tuple[Callable, str]:
    """(launcher, nvcc log): builds the kernel on first use; later calls
    touch no file."""
    global _kernel
    if _kernel is None:
        lib, log = build.load(SOURCE)
        fn = lib.quantize_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel = (fn, log)
    return _kernel


def _check(x: torch.Tensor, u: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape != u.shape:
        raise ValueError(
            f"quantize needs x and u of one (R, D) shape, got "
            f"{tuple(x.shape)} and {tuple(u.shape)}")
    if x.numel() == 0:
        raise ValueError(f"quantize needs a nonempty x, got {tuple(x.shape)}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"quantize needs float32, got {x.dtype} and {u.dtype}")
    if x.device != u.device:
        raise ValueError(f"x on {x.device} but u on {u.device}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("quantize needs contiguous x and u")


def quantize(x: torch.Tensor, u: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, u: (R, D) float32 -> (q int8 (R, D), scale float32 (R, 1))."""
    global launches
    _check(x, u)
    if x.device.type == "cpu":
        return quantize_ref(x, u)
    if x.device.type != "cuda":
        raise ValueError(f"quantize runs on cuda or cpu, not {x.device}")
    R, D = x.shape
    if D % 4 or x.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError(
            "the CUDA quantize kernel loads float4: D must be a multiple of "
            "4 and x, u 16-byte aligned")
    if R * D >= 2 ** 31:
        raise ValueError(f"quantize takes fewer than 2**31 elements, got {R * D}")
    launch, _ = load_kernel()
    q = torch.empty((R, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), u.data_ptr(), q.data_ptr(),
                    scale.data_ptr(), R, D, stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {rc}")
    launches += 1
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return dequantize_ref(q, scale)
