"""Wrapper of the CUDA fold matmul kernel (csrc/fold_matmul.cu).

`fold_matmul(a, b)` is a batched float32 product whose every output is a
left fold over k: its rows do not depend on how many rows, batch entries
or zero-padded k the call has (the kernel's header says why a library
GEMM does not give that). It launches the kernel for CUDA tensors and
counts the launch in `launches`; for CPU tensors it runs the plain version
(ref.py) and counts nothing. Any other device raises. The kernel is built
with nvcc at its first launch in the process (kernels/build.py).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fold_matmul.ref import fold_matmul_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fold_matmul.cu"

# Kernel launches since the count was last set to 0.
launches = 0

_kernel = None  # ({route: launcher}, nvcc log) once built

# The row route takes products of at most this many rows, or whose 64 x 64
# tiles would number fewer than this many (about one a streaming
# multiprocessor of the H100): both routes give the same bits.
ROW_ROUTE_MAX_M = 8
ROW_ROUTE_MIN_TILES = 132


def load_kernel() -> Tuple[Dict[str, Callable], str]:
    """({route: launcher}, nvcc log): builds the kernel on first use; later
    calls touch no file."""
    global _kernel
    if _kernel is None:
        lib, log = build.load(SOURCE)
        launchers = {"tiles": lib.fold_matmul_launch,
                     "rows": lib.fold_matmul_rows_launch}
        for fn in launchers.values():
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _kernel = (launchers, log)
    return _kernel


def route_for(batch: int, M: int, N: int) -> str:
    """The route the wrapper takes for a (batch, M, N) output."""
    tiles = batch * -(-M // 64) * -(-N // 64)
    return ("rows" if M <= ROW_ROUTE_MAX_M or tiles < ROW_ROUTE_MIN_TILES
            else "tiles")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"fold_matmul needs (batch, M, K) and (batch, K, N), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"fold_matmul shapes do not chain: {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"fold_matmul needs float32, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")


def fold_matmul(a: torch.Tensor, b: torch.Tensor,
                route: Optional[str] = None) -> torch.Tensor:
    """a (batch, M, K) @ b (batch, K, N) -> (batch, M, N) float32, for any
    strides of a and b (expanded views included). `route` ("tiles" or
    "rows") overrides `route_for`, for tests: the two give the same
    bits."""
    global launches
    _check(a, b)
    if a.device.type == "cpu":
        return fold_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fold_matmul runs on cuda or cpu, not {a.device}")
    batch, M, K = a.shape
    N = b.shape[2]
    route = route_for(batch, M, N) if route is None else route
    # Grid limits: batch entries on z, rows (tiles of 64, or single rows on
    # the row route) on y.
    if batch > 65535 or (M if route == "rows" else -(-M // 64)) > 65535:
        raise ValueError(f"fold_matmul's {route} route takes at most 65535 "
                         f"batch entries and grid rows, got {batch} and M={M}")
    c = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    launch = load_kernel()[0][route]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, M, N, K,
                    *a.stride(), *b.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"fold_matmul kernel launch failed: cudaError {rc}")
    launches += 1
    return c
