"""Post-process dry-run JSONs: add the analytic roofline terms
(utils/analytic.py) and recompute the dominant bottleneck from the
combined estimate. A copy of repro/launch/postprocess.py on the H100's
constants (utils/flops.py): LINK_BW in place of the reference's ICI_BW,
and no `impl` (the port has none), so the attention context factor is
1.0.

  PYTHONPATH=src python -m repro_torch.launch.postprocess [dir]
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys

from repro_torch.configs.base import INPUT_SHAPES, MeshConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.specs_inputs import adapt_config
from repro_torch.utils import flops as fl
from repro_torch.utils.analytic import analytic_costs


def process_file(fn: str) -> None:
    with open(fn) as f:
        rec = json.load(f)
    if not rec.get("ok"):
        return
    cfg = adapt_config(get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]])
    shape = INPUT_SHAPES[rec["shape"]]
    mesh_cfg = MeshConfig(multi_pod=(rec["mesh"] == "multi"))
    V = rec.get("V", 4) if shape.kind == "train" else 1
    # Perf-variant knobs recorded by dryrun (defaults for baseline records).
    if not rec.get("remat", True):
        cfg = cfg.replace(remat=False)
    if rec.get("capacity") and cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=rec["capacity"]))
    ana = analytic_costs(cfg, shape, mesh_cfg, V=V, attn_ctx_factor=1.0)
    t_compute = ana["flops_per_device"] / fl.PEAK_FLOPS
    t_memory = ana["hbm_bytes_per_device"] / fl.HBM_BW
    # Collective: the planned FedAvg sync (counted from the specs) +
    # analytic in-loop tensor-parallel traffic.
    planned = rec["collectives"]["total_wire_bytes"]
    t_coll = (planned
              + ana["collective_inloop_wire_bytes_per_device"]) / fl.LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    rec["analytic"] = ana
    rec["terms_analytic_seconds"] = terms
    rec["dominant_analytic"] = max(terms, key=terms.get)
    rec["useful_flops_ratio_analytic"] = (
        rec["model_flops"] / ana["flops_global"] if ana["flops_global"] else None)
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(dirs):
    for d in dirs:
        for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
            process_file(fn)
        print(f"postprocessed {d}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["experiments/dryrun_torch"])
