"""Wrapper of the CUDA fold matmul kernel (csrc/fold_matmul.cu).

`fold_matmul(a, b)` is a batched float32 product whose every output is a
left fold over k. The contract, the same on every route, tile and shape:

  * every output is fmaf folded from +0 over k = 0..K-1 in ascending order;
  * it then takes exactly one fmaf(0, 0, acc) if K % 16 != 0 (it turns a
    -0 sum into +0 and changes nothing else);
  * it does not depend on M, on the batch, on the route or on the tile.

So a call's rows do not move when it has more rows, more batch entries or
zeros appended to K (the kernel's header says why a library GEMM does not
give that). Each call is one launch, counted in `launches`, on one of
three routes that `route_for(batch, M, N, K)` picks from the shape:

  rows   one thread an output; short K (FedAvg's sum over clients, a sum
         over one batch). The bitwise oracle of the other two.
  tiles  a register-tiled SGEMM: 128 x 64 or 64 x 64 tiles (by their
         waves) for the convs' products, 16 x 64 for the dense layers at a
         batch of 16 or 32 rows.
  panel  long K with few outputs: bias gradients, conv1's weight gradient,
         conv2's at 10 clients, fc2's forward; the same kernel with slabs
         sized to spread over the card.

For CPU tensors it runs the plain version (ref.py) and counts nothing; any
other device raises, and a failed launch raises. The kernel is built with
nvcc at its first launch in the process (kernels/build.py).
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

_kernel = None  # ({"tiles": launcher, "rows": launcher}, nvcc log) once built

ROUTES = ("tiles", "panel", "rows")

# The tile kernel's instances, in the order of the .cu's FOLD_INSTANCES (the
# index is the instance id): name -> (BM, BN, TM, TN, BK, STAGES), a BM x BN
# output tile a block, TM x TN outputs a thread, K through a ring of STAGES
# shared-memory stages of BK k.
INSTANCES = {
    "128x64": (128, 64, 8, 4, 32, 3),
    "16x64": (16, 64, 2, 4, 32, 4),
    "64x64": (64, 64, 4, 4, 64, 3),
    "32x8": (32, 8, 2, 2, 128, 4),
    "1x8": (1, 8, 1, 1, 256, 3),
}
# The thresholds of route_for and instance_for, chosen at mnist_paper's
# shapes (10 clients, b* = 16) and the Fig. 2 Study groups' (60 clients,
# B_env 32 and 64), on an NVIDIA H100 80GB HBM3 (700 W).
# rows: K <= 64 with at most 32 rows (the sums over a batch of at most 32
# samples, dh at K = 10, FedAvg's sum over C = 10 clients), at most 16
# columns (fc2's weight gradient, N = 10) or at most 65,536 outputs, where
# a tile would be mostly padding or the launch is all there is (3 x 70 x
# 65 at K = 33: 0.0028 ms on rows, 0.0042 ms in 64 x 64 slabs);
ROWS_MAX_K = 64
ROWS_MAX_N = 16
ROWS_MAX_OUTPUTS = 1 << 16
# 16x64 tiles: at most 32 rows and 128 columns or more (fc1's forward and
# dflat at M = b = 16 or 32);
SKINNY_MAX_M = 32
SKINNY_MIN_N = 128
# tiles where 128 x 64 tiles would fill the card's 132 SMs (conv2's weight
# gradient at 60 clients: 420 tiles), else panel (at 10 clients: 70;
# conv1's weight gradient, 25 rows: 10 to 60);
CARD_SMS = 132
# On the tiles route, 64x64 in place of 128x64 where its waves cost less:
# each instance holds 2 blocks an SM, so a launch of t tiles takes
# ceil(t / 264) waves, and a 64-row wave does the work of 0.88 of a 128-row
# wave's half (scripts/fold_matmul_bench.py --route, device times: conv2's
# forward at 60 clients 1.1385 ms on 128x64, 1.2809 ms on 64x64; its weight
# gradient, M = 800 filling 7 tiles of 128 rows in under 2 waves, 1.3523
# and 1.1241 ms).
BLOCKS_PER_SM = 2
HALF_TILE_EFFICIENCY = 0.88
# panel: 1x8 for one row (bias gradients), 32x8 for at most 32 columns
# (conv1's weight gradient, fc2's forward), 64x64 above (conv2's weight
# gradient at 10 clients: 130 slabs).
PANEL_NARROW_N = 32


def load_kernel() -> Tuple[Dict[str, Callable], str]:
    """({"tiles": launcher, "rows": launcher}, nvcc log): builds the kernel
    on first use; later calls touch no file. The tiles launcher runs every
    tile and panel instance, by id."""
    global _kernel
    if _kernel is None:
        lib, log = build.load(SOURCE)
        strides = [ctypes.c_int] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        tiles = lib.fold_matmul_tile_launch
        tiles.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + strides
        rows = lib.fold_matmul_rows_launch
        rows.argtypes = [ctypes.c_void_p] * 3 + strides
        for fn in (tiles, rows):
            fn.restype = ctypes.c_int
        _kernel = ({"tiles": tiles, "rows": rows}, log)
    return _kernel


def route_for(batch: int, M: int, N: int, K: int) -> str:
    """The route ("tiles", "panel" or "rows") the wrapper takes for a
    (batch, M, K) @ (batch, K, N) product."""
    if K <= ROWS_MAX_K and (M <= SKINNY_MAX_M or N <= ROWS_MAX_N
                            or batch * M * N <= ROWS_MAX_OUTPUTS):
        return "rows"
    if M <= SKINNY_MAX_M:
        return "tiles" if N >= SKINNY_MIN_N else "panel"
    tiles = batch * -(-M // 128) * -(-N // 64)
    return "tiles" if tiles >= CARD_SMS else "panel"


def _waves(batch: int, M: int, N: int, instance: str) -> int:
    BM, BN = INSTANCES[instance][:2]
    tiles = batch * -(-M // BM) * -(-N // BN)
    return -(-tiles // (CARD_SMS * BLOCKS_PER_SM))


def instance_for(route: str, batch: int, M: int, N: int) -> str:
    """The kernel instance a route runs for a (batch, M, N) output ("rows"
    for the row route)."""
    if route == "rows":
        return "rows"
    if route == "tiles":
        if M <= SKINNY_MAX_M:
            return "16x64"
        half = _waves(batch, M, N, "64x64") / (2 * HALF_TILE_EFFICIENCY)
        return "64x64" if half < _waves(batch, M, N, "128x64") else "128x64"
    if route == "panel":
        return ("1x8" if M == 1 else
                "32x8" if N <= PANEL_NARROW_N else "64x64")
    raise ValueError(f"fold_matmul has no route {route!r}: {ROUTES}")


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
    strides of a and b (expanded views included). `route` overrides
    `route_for`, for tests: a route of ROUTES, or an instance of INSTANCES
    (or "rows").
    Every route and instance gives the same bits."""
    global launches
    _check(a, b)
    if a.device.type == "cpu":
        return fold_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fold_matmul runs on cuda or cpu, not {a.device}")
    batch, M, K = a.shape
    N = b.shape[2]
    if route is None:
        route = route_for(batch, M, N, K)
    instance = (route if route in INSTANCES else
                instance_for(route, batch, M, N))
    # Grid limits: the batch on y (rows: z), single rows on y for rows.
    if batch > 65535 or (instance == "rows" and M > 65535):
        raise ValueError(f"fold_matmul's {instance} takes at most 65535 "
                         f"batch entries (and rows on the row route), got "
                         f"{batch} and M={M}")
    c = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    launchers = load_kernel()[0]
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, M, N, K,
            *a.stride(), *b.stride())
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if instance == "rows":
            rc = launchers["rows"](*args, stream)
        else:
            rc = launchers["tiles"](list(INSTANCES).index(instance), *args,
                                    stream)
    if rc != 0:
        raise RuntimeError(f"fold_matmul kernel launch failed ({instance}): "
                           f"cudaError {rc}")
    launches += 1
    return c
