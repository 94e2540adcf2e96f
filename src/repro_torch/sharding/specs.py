"""Sharding specs for every parameter and cache leaf, and the per-device
shard shapes and bytes they give on a mesh.

The rule tables and the policies of `_leaf_trailing_spec`,
`param_specs` and `cache_specs` are copies of
repro/sharding/specs.py's. Rules address the TRAILING dims of each leaf
by parameter name; leading stacking dims (the layer-stack group axes,
and the federated client axis) are padded with None / the client axes.
A 'model' assignment is only applied when the dim is divisible by the
model-axis size; otherwise the dim stays replicated.

A spec is a plain tuple holding, for each dim, None, an axis name or a
tuple of names: the contents of a jax PartitionSpec, and `()` for a
fully replicated leaf. `shard_shape` and `sharded_bytes` stand for the
reference's `named_shardings`: what the specs mean on a mesh, computed
from shapes alone (the port's dry run never places a tensor).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

from repro_torch.utils.tree import leaves_with_path, tree_map_with_path

Spec = Tuple

# name -> trailing-dim logical roles; 'M' marks model-shardable dims.
# 'H'/'Hd' mark attention head / head_dim axes resolved by the head policy.
# Attention rules are keyed separately: 'wo' exists in BOTH attention
# (H, hd, d) and the dense MLP (ff, d).
_ATTN_RULES = {
    "wq": (None, "H", "Hd"), "wk": (None, "H", "Hd"), "wv": (None, "H", "Hd"),
    "bq": ("H", "Hd"), "bk": ("H", "Hd"), "bv": ("H", "Hd"),
    "wo": ("H", "Hd", None),
}

_TRAILING_RULES = {
    # dense mlp
    "wg": (None, "M"), "wi": (None, "M"), "wo": ("M", None),
    # moe (3D leaves override by rank below)
    "router": (None, "M"),
    # mamba
    "in_x": (None, "M"), "in_z": (None, "M"), "in_B": (None, "M"),
    "in_C": (None, "M"), "in_dt": (None, "M"),
    "conv_w": (None, "M"), "conv_b": ("M",),
    "x_proj": ("M", None), "dt_w": (None, "M"), "dt_b": ("M",),
    "A_log": ("M", None), "D": ("M",),
    "dt_bias": ("M",), "norm": ("M",),
    "out_proj": ("M", None),
}

_MOE_3D = {"wg": ("M", None, None), "wi": ("M", None, None),
           "wo": ("M", None, None)}


def _leaf_trailing_spec(path_keys, shape) -> Tuple:
    name = path_keys[-1]
    parents = set(path_keys[:-1])
    if name == "embed":
        if len(shape) == 3:  # audio (K, V, d)
            return (None, "M", None)
        return ("M", None)
    if name == "lm_head":
        if len(shape) == 3:  # (K, d, V)
            return (None, None, "M")
        return (None, "M")
    if "moe" in parents and name in _MOE_3D:
        return _MOE_3D[name]
    if "attn" in parents and name in _ATTN_RULES:
        return _ATTN_RULES[name]
    if "mlp" in parents and name == "wo":
        # The reference replicates small dense down-projections (under 1 GB
        # in float32), which kept its partitioner from sharding the score
        # intermediate's contraction.
        total_bytes = 1
        for d in shape:
            total_bytes *= d
        if total_bytes * 4 < 1e9:
            return ()
        return ("M", None)
    rule = _TRAILING_RULES.get(name)
    if rule is None:
        return ()  # replicate (norm scales, projector, CNN leaves, biases)
    return rule


def _keys(path) -> list:
    return [str(k) for k in path]


def param_specs(
    abstract_params: Any,
    mesh,
    model_axis: str = "model",
    client_axes: Optional[Tuple[str, ...]] = None,
) -> Any:
    """Spec tree matching abstract_params (leaves with a `.shape`).
    Trailing rules self-align by rank, past the leading layer-stack dims.
    client_axes: if set, every leaf has a leading client axis sharded over
    these mesh axes.
    """
    msize = math.prod(mesh.shape[a] for a in (model_axis,)) \
        if model_axis in mesh.shape else 1

    def spec_for(path, leaf):
        keys = _keys(path)
        shape = tuple(leaf.shape)
        offset = 1 if client_axes else 0
        trailing = _leaf_trailing_spec(keys, shape[offset:])
        n_trailing = len(trailing)
        ndim = len(shape)
        spec = [None] * ndim
        if client_axes:
            spec[0] = client_axes if len(client_axes) > 1 else client_axes[0]
        # Align trailing rule to the end; disambiguate mamba A_log rank:
        if keys and keys[-1] == "A_log" and (ndim - offset) % 2 == 1:
            trailing = ("M",)  # stacked mamba2 (G, sg, H) has odd base rank
            n_trailing = 1
        # Attention head/head_dim policy (the reference's):
        #   H % msize == 0       -> shard heads
        #   indivisible heads    -> shard head_dim where hd % msize == 0,
        #                           for the out-projection, or for q/k/v
        #                           stacks of 1 GB and more
        #   else                 -> replicate
        if any(r in ("H", "Hd") for r in trailing):
            h_pos = ndim - n_trailing + trailing.index("H")
            hd_pos = ndim - n_trailing + trailing.index("Hd")
            H = shape[h_pos]
            hd = shape[hd_pos]
            total_bytes = math.prod(shape) * 4
            is_wo = keys[-1] == "wo"
            if msize > 1:
                if H % msize == 0:
                    spec[h_pos] = model_axis
                elif hd % msize == 0 and (is_wo or total_bytes >= 1e9):
                    spec[hd_pos] = model_axis
            return tuple(spec)
        for i, role in enumerate(trailing):
            dim = ndim - n_trailing + i
            if dim < offset:
                continue
            if role == "M" and shape[dim] % msize == 0 and msize > 1:
                spec[dim] = model_axis
        return tuple(spec)

    return tree_map_with_path(spec_for, abstract_params)


def cache_specs(
    abstract_cache: Any,
    mesh,
    batch_axes: Optional[Tuple[str, ...]],
    model_axis: str = "model",
) -> Any:
    """Specs for serve caches.

    KV leaves (G, sg, B, L, KV, hd): batch over batch_axes (replicated when
    indivisible, e.g. long_500k B=1); KV heads over model when divisible,
    else head_dim over model. SSM conv/h leaves shard their channel dim.
    The host-int `pos` gets `()`.
    """
    msize = mesh.shape.get(model_axis, 1)
    bsize = math.prod(mesh.shape[a] for a in (batch_axes or ())) or 1

    def spec_for(path, leaf):
        name = _keys(path)[-1]
        if name == "pos":
            return ()
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec = [None] * ndim
        # Identify batch dim: first dim whose size matches a multiple of bsize
        # after the (G, sg) stack prefix. Caches are (G, sg, B, ...) except
        # shared-attn caches (G, B, ...).
        bdim = None
        for i in range(min(3, ndim)):
            if shape[i] % bsize == 0 and i >= 1:
                bdim = i
                break
        if batch_axes and bdim is not None and shape[bdim] % bsize == 0:
            spec[bdim] = (tuple(batch_axes) if len(batch_axes) > 1
                          else batch_axes[0])
        if name in ("k", "v") and ndim >= 2:
            kv_dim, hd_dim = ndim - 2, ndim - 1
            if shape[kv_dim] % msize == 0:
                spec[kv_dim] = model_axis
            elif shape[hd_dim] % msize == 0:
                spec[hd_dim] = model_axis
        elif name in ("conv", "h"):
            # channel dim: conv (..., B, K-1, C) -> last; h (..., B, D, N) or
            # (..., B, H, P, N) -> first after batch.
            tgt = ndim - 1 if name == "conv" else (
                bdim + 1 if bdim is not None else ndim - 2)
            if tgt < ndim and shape[tgt] % msize == 0:
                spec[tgt] = model_axis
        return tuple(spec)

    return tree_map_with_path(spec_for, abstract_cache)


def batch_spec(ndim: int, batch_axes: Sequence[str]) -> Spec:
    """A leading batch (or client) dim over `batch_axes`, the rest
    replicated; `()` entries for no axes."""
    ax = (tuple(batch_axes) if len(batch_axes) > 1
          else batch_axes[0]) if batch_axes else None
    return (ax,) + (None,) * (ndim - 1)


def _axis_count(entry, mesh) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of a leaf of `shape` under `spec`: each dim
    divided by the product of its axes' sizes (GSPMD's ceiling for an
    indivisible dim; the rules above shard only divisible ones)."""
    shape = tuple(int(n) for n in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // _axis_count(e, mesh)) for n, e in zip(shape, spec))


def sharded_bytes(abstract: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of a tree of leaves with `.shape` and
    `.dtype`, under the matching spec tree; leaves without a shape (the
    cache's host-int `pos`) hold none."""
    total = 0
    for path, leaf in leaves_with_path(abstract):
        if not hasattr(leaf, "shape"):
            continue
        spec = at_path(specs, path)
        total += (math.prod(shard_shape(leaf.shape, spec, mesh))
                  * leaf.dtype.itemsize)
    return total


def at_path(tree: Any, path) -> Any:
    """The subtree of `tree` at `path` (tree_map_with_path's keys)."""
    for k in path:
        tree = tree[k]
    return tree
