"""What the harness takes from the program: the registered experiment spec
a configuration names, rebuilt from the configuration's file, and the
global model of a run as a flat dict. The traffic kinds
(fedbench/kinds/) drive the program through these."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The spec fields a configuration's file states, beside its model and fed.
SPEC_FIELDS = ("dataset", "n_train", "n_test", "alpha", "heterogeneity",
               "plan", "plan_method", "batch_cap")


def _cnn_config(model: dict):
    from repro_torch.models.cnn import CNNConfig
    return CNNConfig(name=model["name"], input_hw=tuple(model["input_hw"]),
                     in_channels=model["in_channels"],
                     n_classes=model["n_classes"],
                     conv_channels=tuple(model["conv_channels"]),
                     kernel=model["kernel"], fc_dim=model["fc_dim"])


def registry_differences(cfg: dict) -> list:
    """Where the program's registered spec `cfg["spec"]` no longer runs the
    configuration's file: [(field, file's value, program's value)]."""
    from repro_torch.federated import experiment
    spec = experiment.get(cfg["spec"])
    ours = {f: cfg[f] for f in SPEC_FIELDS}
    theirs = {f: getattr(spec, f) for f in SPEC_FIELDS}
    ours["model"] = _cnn_config(cfg["model"])
    theirs["model"] = spec.model_config()
    for k, v in cfg["fed"].items():
        ours[f"fed.{k}"], theirs[f"fed.{k}"] = v, getattr(spec.fed, k)
    for group in ("compute", "wireless"):
        for k, v in cfg[group].items():
            ours[f"{group}.{k}"] = v
            theirs[f"{group}.{k}"] = getattr(getattr(spec, group), k)
    for k, v in (("scenario", None), ("faults", None), ("backend", "scan"),
                 ("with_eval", True), ("population", None)):
        ours[k], theirs[k] = v, getattr(spec, k)
    return [(k, ours[k], theirs[k]) for k in ours if ours[k] != theirs[k]]


def spec_for(cfg: dict, seed: int, compress: bool, **kw):
    """The configuration's ExperimentSpec at `seed` (data, partition,
    population and model draw), compressed or not, with `kw` replaced."""
    from repro_torch.configs.base import ComputeConfig, WirelessConfig
    from repro_torch.federated import experiment
    spec = experiment.get(cfg["spec"])
    fed = dataclasses.replace(spec.fed, seed=seed, compress_updates=compress,
                              **cfg["fed"])
    fields = {f: cfg[f] for f in SPEC_FIELDS}
    return spec.replace(model=_cnn_config(cfg["model"]), seed=seed, fed=fed,
                        compute=ComputeConfig(**cfg["compute"]),
                        wireless=WirelessConfig(**cfg["wireless"]),
                        **fields, **kw)


def nested(flat: dict) -> dict:
    """{"conv1.w": tensor} -> {"conv1": {"w": numpy}}: the program's
    layout of an initial model."""
    out: dict = {}
    for k, v in flat.items():
        layer, leaf = k.split(".")
        out.setdefault(layer, {})[leaf] = v.detach().cpu().numpy()
    return out


def flat(params: dict) -> dict:
    return {f"{layer}.{leaf}": v for layer, d in params.items()
            for leaf, v in d.items()}


def init_params(shapes: dict, seed: int, device: torch.device) -> dict:
    """He-normal weights and zero biases, drawn from `seed` on `device` in
    one call."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = [k for k in sorted(shapes) if k.endswith(".w")]
    sizes = [int(np.prod(shapes[k])) for k in weights]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for k, n in zip(weights, sizes):
        s = shapes[k]
        fan_in = s[0] if len(s) == 2 else s[0] * s[1] * s[2]
        out[k] = draw[at:at + n].reshape(s) * (2.0 / fan_in) ** 0.5
        out[k.replace(".w", ".b")] = torch.zeros(
            shapes[k.replace(".w", ".b")], device=device)
        at += n
    return out
