"""DEFL vs FedAvg vs Rand on the PyTorch/CUDA port, the twin of
examples/defl_vs_fedavg.py (same arguments, prints and JSON): the paper's
CNN task with real training and simulated delay accounting, Fig. 2 per
edge scenario.

  PYTHONPATH=src python examples/defl_vs_fedavg_torch.py [--quick] \
      [--scenario stragglers] [--seeds 8] [--json PATH] \
      [--checkpoint-dir DIR] [--no-resume] [--device cpu]

Each (scenario, dataset) comparison is one declarative `Study`
(`study_for`): the DEFL/FedAvg/Rand arms run as one folded fleet over
the (arm x seed) members, padded into one (V, b) envelope, with
in-fleet 90%-accuracy early stopping. Without --scenario the registered
table (uniform, stragglers, cell_edge, dropout, drifting) is swept;
--seeds N widens every arm to N realization seeds (mean +- std bands);
--json dumps the StudyResult payloads. Runs on the card unless
--device cpu is given.

`arm_specs`, `study_for` and `run` are copies of
benchmarks/fig2_defl_vs_fedavg.py's, and `make_cnn_spec` of
benchmarks/common.py's, without the fields the port has not taken up
(backend, impl, population, async_spec).
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.federated import scenarios  # noqa: E402
from repro_torch.federated.experiment import (CALIBRATED_C,  # noqa: E402
                                              ExperimentSpec)
from repro_torch.federated.study import Study  # noqa: E402

# The scenario table of the headline comparison.
SCENARIO_NAMES = ("uniform", "stragglers", "cell_edge", "dropout", "drifting")
TARGET_ACC = 0.90


def make_cnn_spec(dataset: str, fed: FedConfig, label: str,
                  n_train: int = 1500, n_test: int = 400, seed: int = 0,
                  with_eval: bool = True, cnn_cfg=None,
                  scenario=None) -> ExperimentSpec:
    """The CNN-FL harness (Figs. 1-2) as an ExperimentSpec. One seed
    governs everything: the dataset/partition/population draw and, by
    syncing fed.seed to `seed`, the default `init()` run state."""
    if fed.seed != seed:
        fed = dataclasses.replace(fed, seed=seed)
    model = cnn_cfg if cnn_cfg is not None else (
        "mnist_cnn" if dataset == "mnist" else "cifar_cnn")
    return ExperimentSpec(
        fed=fed, model=model, dataset=dataset, n_train=n_train,
        n_test=n_test, seed=seed, scenario=scenario, with_eval=with_eval,
        label=label)


def arm_specs(dataset: str, scenario: str, seed: int = 0,
              n_train: int = 1500):
    """The three method arms. DEFL is plan=True (solved against the
    scenario's population at build time, batch capped at 32, paper
    §VI-B); FedAvg (b=10, V=20) and Rand ((16, 15) on MNIST, (64, 30) on
    CIFAR) run the paper's fixed settings."""
    defl_fed = FedConfig(n_devices=10, epsilon=0.01, nu=2.0,
                         c=CALIBRATED_C, lr=0.05)
    fedavg = FedConfig(n_devices=10, batch_size=10,
                       theta=float(np.exp(-20 / 2.0)), nu=2.0, lr=0.05)
    rand_b, rand_v = (16, 15) if dataset == "mnist" else (64, 30)
    rand = FedConfig(n_devices=10, batch_size=rand_b,
                     theta=float(np.exp(-rand_v / 2.0)), nu=2.0, lr=0.05)

    def spec(label, fed):
        return make_cnn_spec(dataset, fed, f"{label}@{scenario}",
                             n_train=n_train, seed=seed, scenario=scenario)

    return [("DEFL", spec("DEFL", defl_fed).replace(plan=True)),
            ("FedAvg", spec("FedAvg", fedavg)),
            ("Rand", spec("Rand", rand))]


def study_for(dataset: str, scenario: str, seed: int = 0, seeds: int = 1,
              quick: bool = False) -> Study:
    """The (scenario, dataset) comparison as one declarative Study."""
    return Study(
        arms=arm_specs(dataset, scenario, seed,
                       n_train=600 if quick else 1500),
        seeds=range(seed, seed + seeds),
        max_rounds=4 if quick else 12, eval_every=1,
        target_acc=TARGET_ACC)


def rows_for(res, scen: str, ds: str, multi: bool):
    """One row per method of a comparison's StudyResult, plus the
    DEFL-vs-FedAvg reduction row."""
    rows = []
    for label in res.labels:
        s = res.summary(label)
        fed = res[label][0].fed
        # NaN-for-miss: nanmean over the seeds that hit the target.
        tta = res.time_to_target(label)
        hit = bool(np.isfinite(tta).any())
        band = lambda m, sd, nd: (  # noqa: E731
            f"{m:.{nd}f}+-{sd:.{nd}f}" if multi else round(m, nd))
        rows.append((
            "fig2", scen, ds, label, fed.batch_size,
            fed.local_rounds, round(s["rounds_mean"], 1),
            (round(s["mean_participants"], 1)
             if np.isfinite(s["mean_participants"]) else ""),
            band(s["total_time_mean"], s["total_time_std"], 2),
            band(s["final_acc_mean"], s["final_acc_std"], 4),
            (band(float(np.nanmean(tta)), float(np.nanstd(tta)), 2)
             if hit else "")))
    # Mean time-to-target (early-stop time when reached, total time
    # otherwise) per arm.
    rows.append(("fig2", scen, ds, "reduction_vs_fedavg", "", "",
                 "", "", round(res.reduction("DEFL", "FedAvg"), 1),
                 "", ""))
    return rows


HEADER = ("name,scenario,dataset,method,b,V,rounds,mean_participants,"
          "overall_time_s,acc,time_to_90")


def run(quick: bool = False, scenario: str = "", seed: int = 0,
        seeds: int = 1, checkpoint_dir: str = "", resume: bool = True,
        device: str = "cuda"):
    """One row per (scenario, dataset, method) from the grouped study,
    plus the DEFL-vs-FedAvg reduction row per comparison; with seeds > 1
    every column is a mean +- std band over the seeds. `checkpoint_dir`
    turns on per-(arm, seed) autosave/resume (Study.run) under one
    subdirectory per (scenario, dataset) comparison."""
    rows = []
    payload = {}
    scens = (scenario,) if scenario else SCENARIO_NAMES
    datasets = ["mnist"] if quick else ["mnist", "cifar"]
    for scen in scens:
        for ds in datasets:
            res = study_for(ds, scen, seed=seed, seeds=seeds,
                            quick=quick).run(
                checkpoint_dir=(os.path.join(checkpoint_dir,
                                             f"{scen}_{ds}")
                                if checkpoint_dir else None),
                resume=resume, device=device)
            payload[f"{scen}/{ds}"] = res.to_json()
            rows.extend(rows_for(res, scen, ds, seeds > 1))
    return HEADER, rows, payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--scenario", default="",
                    choices=("",) + scenarios.names())
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--json", default="",
                    help="write the StudyResult JSON payloads here")
    ap.add_argument("--checkpoint-dir", default="",
                    help="per-(arm, seed) autosave: a killed sweep "
                         "resumes from the saved members")
    ap.add_argument("--no-resume", action="store_true",
                    help="with --checkpoint-dir: ignore existing member "
                         "checkpoints and re-run everything")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the study runs (default: the card)")
    args = ap.parse_args(argv)
    header, rows, payload = run(quick=args.quick, scenario=args.scenario,
                                seeds=args.seeds,
                                checkpoint_dir=args.checkpoint_dir,
                                resume=not args.no_resume,
                                device=args.device)
    print(header)
    for r in rows:
        print(",".join(map(str, r)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, default=float)
            f.write("\n")
    return header, rows, payload


if __name__ == "__main__":
    main()
