"""Input specs: (shape, dtype) stand-ins for every model input, per
(architecture x input shape x mesh), with the reference's shapes and
dtypes (repro/launch/specs_inputs.py). No tensor is made here; the dry
run (launch/dryrun.py) makes fake tensors of them.

Shapes follow the assignment:
  train_4k    : train round step — tokens (C, V, b_local, S) per client axis
  prefill_32k : serve prefill     — tokens (B, S)
  decode_32k  : serve decode      — 1 new token against a seq_len cache
  long_500k   : serve decode      — sub-quadratic only (SWA/SSM/hybrid)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, MeshConfig, ModelConfig

SWA_WINDOW = 8192  # sliding window qualifying dense archs for long_500k


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype (jax.ShapeDtypeStruct): a leaf of the
    port's trees, which descend into tuples."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def adapt_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply shape-driven config adaptations (SWA for long-context decode)."""
    if shape.name == "long_500k" and cfg.attention is not None:
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, sliding_window=SWA_WINDOW))
    return cfg


def _token_struct(shape: Tuple[int, ...]) -> TensorSpec:
    return TensorSpec(tuple(shape), torch.int32)


def train_input_specs(
    cfg: ModelConfig, shape: InputShape, mesh_cfg: MeshConfig, V: int,
) -> Dict:
    """Round-step inputs: batches (C, V, b_local, ...) + weights (C,)."""
    C = mesh_cfg.n_clients
    if shape.global_batch % C:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {C} clients")
    b = shape.global_batch // C
    S = shape.seq_len
    batch: Dict = {}
    if cfg.modality and cfg.modality.kind == "audio":
        K = cfg.modality.n_codebooks
        batch["tokens"] = _token_struct((C, V, b, S, K))
    elif cfg.modality:  # vlm: patch prefix + text tokens, total length S
        P = cfg.modality.prefix_len
        batch["tokens"] = _token_struct((C, V, b, S - P))
        batch["prefix_embeds"] = TensorSpec(
            (C, V, b, P, cfg.modality.embed_dim), torch.bfloat16)
    else:
        batch["tokens"] = _token_struct((C, V, b, S))
    weights = TensorSpec((C,), torch.float32)
    return {"batches": batch, "weights": weights}


def prefill_input_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.modality and cfg.modality.kind == "audio":
        return {"tokens": _token_struct((B, S, cfg.modality.n_codebooks))}
    if cfg.modality:
        P = cfg.modality.prefix_len
        return {
            "tokens": _token_struct((B, S - P)),
            "prefix_embeds": TensorSpec(
                (B, P, cfg.modality.embed_dim), torch.bfloat16),
        }
    return {"tokens": _token_struct((B, S))}


def decode_input_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """One-token decode inputs (the cache is built separately, by
    init_cache on fake tensors)."""
    B = shape.global_batch
    if cfg.modality and cfg.modality.kind == "audio":
        return {"tokens": _token_struct((B, 1, cfg.modality.n_codebooks))}
    return {"tokens": _token_struct((B, 1))}
