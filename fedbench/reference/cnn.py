"""The FedAvg CNN (McMahan et al., arXiv:1602.05629 §3) in plain PyTorch:
two 5x5 'SAME' convolutions (32, 64 channels), each followed by ReLU and
a 2x2 max pool, a 512-unit dense layer with ReLU and a softmax head, the
mean cross-entropy as the loss. Gradients by autograd.

Parameters are a flat dict in the program's layout (the family's
param_shapes, fedbench/families/cnn.py): NHWC images, HWIO filters, fc1
over the NHWC flatten of the last pool.
`precision="tf32"` computes every convolution and matrix product in
TF32, the control of the comparison: on the card by PyTorch's TF32 flags,
on the CPU by rounding each product's operands to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class _TF32(torch.autograd.Function):
    """An operand of a product rounded to TF32, and so is the gradient
    that flows back to it (the integer view carries none)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _round_tf32(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    return _TF32.apply(x)


def forward(params: dict, images: torch.Tensor, emulate_tf32: bool = False,
            ) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, n_classes)."""
    r = _tf32_round if emulate_tf32 else (lambda t: t)
    x = images.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        w = params[f"{name}.w"].permute(3, 2, 0, 1)
        x = F.conv2d(r(x), r(w), params[f"{name}.b"],
                     padding=w.shape[-1] // 2)
        x = F.max_pool2d(torch.relu(x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(r(x) @ r(params["fc1.w"]) + params["fc1.b"])
    return r(x) @ r(params["fc2.w"]) + params["fc2.b"]


def loss(params: dict, x: torch.Tensor, y: torch.Tensor,
         emulate_tf32: bool = False) -> torch.Tensor:
    return F.cross_entropy(forward(params, x, emulate_tf32), y.long())


@contextlib.contextmanager
def precision(mode: str, device: torch.device):
    """float32 with TF32 off ("float32"), or TF32 ("tf32"): on the card
    PyTorch's flags, restored on exit; on the CPU `forward`'s emulation."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = mode == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield mode == "tf32" and device.type != "cuda"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
