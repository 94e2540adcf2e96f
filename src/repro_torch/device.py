"""Device resolution for the port's entry points.

Every entry point (ExperimentSpec.build, Simulator, the quantize kernel's
wrapper) runs on the CUDA card unless the caller asks for the CPU. There
is no silent fallback: asking for CUDA on a machine without a card
raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   ) -> torch.device:
    """The device an entry point runs on: `device` when given, else
    "cuda". Raises RuntimeError for a CUDA device when no card is present.

    Also turns TF32 off for float32 matmuls and cuDNN convolutions: cuDNN
    runs float32 convolutions in TF32 by default, which keeps about three
    decimal digits and would put the port out of reach of the reference's
    float32 tolerances. And it turns off cuBLAS's reduced-precision
    reductions in bf16 GEMMs (on by default), so a bf16 product sums in
    float32 and rounds once, at the reference's rounding point."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
