"""Small forms of the benchmark's cells for CPU tests: the same kinds and
harness at mnist_cnn_small width (8 and 16 channels, 64 units), a few
clients and short rounds."""
from __future__ import annotations

import time

import torch

from fedbench.harness import cell, manifest

TRAFFIC = {
    "study": {"arms": [{"label": "DEFL", "plan": True},
                       {"label": "FedAvg", "b": 4, "V": 3},
                       {"label": "Rand", "b": 8, "V": 2},
                       {"label": "OneStep", "b": 2, "V": 1}], "seeds": 1},
    "fleet": {"members": 2, "rounds_per_call": 2, "eval_every": 2,
              "check_rounds": 2},
    "sampled": {"population_M": 400, "cohort_K": 5, "rounds_per_call": 2,
                "eval_every": 2, "check_rounds": 2},
}


def small(cell_name: str, bench=None):
    """(bench, cfg, traffic, limits) of a cell, cut to a CPU test's size."""
    bench = bench or manifest.benchmark()
    w = manifest.workload(bench, cell_name)
    cfg = manifest.config(bench, w["config"])
    cfg["model"].update(name=cfg["model"]["name"] + "-small",
                        conv_channels=[8, 16], fc_dim=64)
    cfg.update(n_train=240, n_test=80)
    # Eq. 29's constant raised so that the small model's plans keep a
    # batch of several samples, as the full-size ones do.
    cfg["fed"].update(n_devices=3, c=64.0)
    traffic = manifest.traffic(w["traffic"])
    traffic.update(TRAFFIC[traffic["kind"]])
    return bench, cfg, traffic, manifest.limits(cell_name)


def run_small(cell_name: str, seed: int = 2 ** 31 + 11, seconds=0.2):
    bench, cfg, traffic, limits = small(cell_name)
    return cell.run_cell(cell_name, seed, seconds, False,
                         torch.device("cpu"), time.perf_counter(),
                         bench=bench, cfg=cfg, traffic=traffic,
                         limits=limits)
