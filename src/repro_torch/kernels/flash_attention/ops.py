"""Wrapper of the CUDA flash-attention kernel (csrc/flash_attention.cu).

`flash_attention` launches the kernel for CUDA tensors and counts the
launch in `launches`; for CPU tensors it runs the plain version
(ref.flash_attention_ref) and counts nothing. Any other device raises, and
a failed build or launch raises: nothing gives way to the plain version.
The kernel is built with nvcc at its first launch in the process
(kernels/build.py).

On the card the kernel runs under autograd (`_FlashAttention`): its
forward is one launch, and its backward is the VJP of the plain version
recomputed from the saved q, k and v, as the reference's `custom_vjp`
(`_flash_bh_bwd`) takes the VJP of its oracle. Neither package has a
backward kernel.

Unlike the reference's wrapper (repro/kernels/flash_attention/ops.py),
nothing is padded, transposed or repeated here: the kernel reads the
(B, S, H, hd) layout, masks the ragged last tile, and indexes the kv head
of each query head itself.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# The head dims the kernel is instantiated at, in both dtypes: those of the
# zoo's attention paths (qwen2-0.5b 64, zamba2-2.7b's shared block 80,
# gemma-7b 256) and the smoke configs' 32, and 128. Any other raises.
HEAD_DIMS = (32, 64, 80, 128, 256)
# float32 goes to the CUDA-core kernel, bfloat16 to the wgmma + TMA kernel.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The launcher returns this plus a CUresult when it cannot encode a tensor
# map (kTensorMapError in the source).
TENSOR_MAP_ERROR = 30000

# Kernel launches since the count was last set to 0.
launches = 0

_kernel = None  # (launcher, nvcc log) once built


def load_kernel() -> Tuple[Callable, str]:
    """(launcher, nvcc log): builds the kernel on first use; later calls
    touch no file."""
    global _kernel
    if _kernel is None:
        lib, log = build.load(SOURCE)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel = (fn, log)
    return _kernel


def _check(q, k, v, window, q_offset) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention needs q (B, Sq, H, hd) and k, v (B, Sk, KV, "
            f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or "
            f"head_dim, or H is not a multiple of KV")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA flash attention. Returns (B, Sq, H, hd) in q's dtype,
    differentiable on both devices."""
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"the CUDA flash kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if min(B, Sq, Sk) == 0:
        raise ValueError(f"flash_attention needs nonempty inputs, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA flash kernel needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the CUDA flash kernel needs 16-byte aligned q, k, v")
    if B > 65535:
        raise ValueError(f"the CUDA flash kernel takes B <= 65535, got {B}")
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with the plain version's VJP as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, q_offset)
        return _launch(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_ref(*inputs, *ctx.args)
        return (*torch.autograd.grad(out, inputs, g), None, None, None)


def _launch(q, k, v, causal, window, q_offset) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors."""
    global launches
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    launch, _ = load_kernel()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    _DTYPES[q.dtype], B, Sq, Sk, H, KV, hd, q_offset,
                    int(causal), window or 0, hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: "
            + (f"CUresult {rc - TENSOR_MAP_ERROR} encoding a TMA tensor map"
               if rc >= TENSOR_MAP_ERROR else f"cudaError {rc}"))
    launches += 1
    return o
