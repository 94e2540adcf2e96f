"""The card's peaks and the least time of a list of products.

Peaks: NVIDIA's H100 SXM5 data sheet at the full 700 W power limit (frozen
copy of repro_torch/utils/flops.py's and chip_smoke.py's constants), dense
rates: float32 outside the tensor cores, and bf16 on them. A model family
(fedbench/families/) counts its own useful work and names the peak its
dtype runs at.

A product is (flops, bytes): its useful operations, and its inputs read
once and its output written once.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0
F32 = 4


def least_s(products, peak_flops: float) -> float:
    """The least time the card could take for `products`: each bound by
    its operations at `peak_flops` or its bytes, whichever is slower
    (chip_smoke.py's `bound`, summed over the products)."""
    return sum(max(f / peak_flops, b / HBM_BYTES_PER_S)
               for f, b in products)


def quantize_bytes(rows: int) -> int:
    """A quantize call's bytes over `rows` rows of 1024: float32 values
    and noise read, int8 codes and a float32 scale a row written."""
    return rows * 1024 * (F32 + F32 + 1) + rows * F32
