"""Roofline constants and analytic MODEL_FLOPS (6*N_active*D).

`tokens_per_call` and `model_flops` are copies of
repro/utils/flops.py's. The constants are one card's: NVIDIA H100 80GB
HBM3 (SXM5), 700.00 W power limit, from NVIDIA's data sheet (dense
rates, no sparsity). A card set below 700 W runs slower under load.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelConfig

# bf16 dense tensor-core FLOP/s: every zoo config computes in bf16.
PEAK_FLOPS = 989.4e12
# float32 FLOP/s outside the tensor cores (device.py turns TF32 off).
PEAK_FLOPS_F32 = 67e12
# HBM3 bytes/s.
HBM_BW = 3.35e12
# NVLink 4 bytes/s per direction between two cards of one 8-card node. A
# mesh larger than one node (every production mesh here: 256 or 512
# devices) crosses InfiniBand between nodes, at a lower rate this
# constant does not model.
LINK_BW = 450e9


def tokens_per_call(cfg: ModelConfig, shape: InputShape, V: int = 1) -> int:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len * V
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one token per sequence


def model_flops(cfg: ModelConfig, shape: InputShape, V: int = 1) -> float:
    """6*N_active*D for training (fwd+bwd), 2*N_active*D for inference."""
    _, n_active = cfg.param_count()
    D = tokens_per_call(cfg, shape, V)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * D
