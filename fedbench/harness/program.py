"""What the harness takes from the program: the registered experiment spec
a configuration names, rebuilt from the configuration's file with the
model its family gives, and the global model of a run as a flat dict.
The traffic kinds (fedbench/kinds/) drive the program through these."""
from __future__ import annotations

import dataclasses

from fedbench.harness import manifest

# The spec fields a configuration's file states, beside its model and fed.
SPEC_FIELDS = ("dataset", "n_train", "n_test", "alpha", "heterogeneity",
               "plan", "plan_method", "batch_cap")


def spec_differences(cfg: dict, model) -> list:
    """Where the program's registered spec `cfg["spec"]` no longer runs the
    configuration's file, whose model its family rebuilds as `model`:
    [(field, file's value, program's value)]."""
    from repro_torch.federated import experiment
    spec = experiment.get(cfg["spec"])
    ours = {f: cfg[f] for f in SPEC_FIELDS}
    theirs = {f: getattr(spec, f) for f in SPEC_FIELDS}
    ours["model"] = model
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
    model = manifest.family(cfg["family"]).spec_model(cfg)
    return spec.replace(model=model, seed=seed, fed=fed,
                        compute=ComputeConfig(**cfg["compute"]),
                        wireless=WirelessConfig(**cfg["wireless"]),
                        **fields, **kw)


def nested(flat: dict) -> dict:
    """{"a.b.w": tensor} -> {"a": {"b": {"w": numpy}}}, dotted keys of any
    depth: the program's layout of an initial model."""
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.detach().cpu().numpy()
    return out


def flat(params: dict, prefix: str = "") -> dict:
    """The inverse: a nested dict of leaves -> {"a.b.w": leaf}."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
