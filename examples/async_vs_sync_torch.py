"""Asynchronous vs synchronous FL on the PyTorch/CUDA port, the twin of
examples/async_vs_sync.py (same arguments, prints and JSON, plus
--device): DEFL's synchronized rounds against FedBuff-style buffered
aggregation (backend='async') on the paper's MNIST CNN task, time to 90%
accuracy per edge scenario.

  PYTHONPATH=src python examples/async_vs_sync_torch.py [--quick] \
      [--scenario stragglers] [--seeds 8] [--json PATH] \
      [--checkpoint-dir DIR] [--no-resume] [--device cpu]

Each scenario comparison is one declarative Study (`study_for`): the
sync DEFL arm runs the grouped fleet path, the async arms run solo on the
event queue (one RoundRecord a buffer fill, sim_time on the event clock),
so the time-to-target columns compare like with like. Full runs add a
FedBuff+ arm re-planned under the async re-derivation of Eq. 12
(defl.async_plan: the buffer K replaces M, K over the harmonic sum of
the clients' service spans replaces the straggler max). Without
--scenario the registered trio (uniform, stragglers, dropout) is swept.
Runs on the card unless --device cpu is given.

`arm_specs`, `study_for` and `run` are copies of
benchmarks/async_vs_sync.py's, and `make_cnn_spec` of benchmarks/
common.py's, without the fields the port does not take (impl,
population).
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import defl  # noqa: E402
from repro_torch.federated.events import AsyncSpec  # noqa: E402
from repro_torch.federated.experiment import (CALIBRATED_C,  # noqa: E402
                                              ExperimentSpec)
from repro_torch.federated.study import Study  # noqa: E402

# The homogeneous baseline (async should tie: it has nothing to hide
# from), the compute-skewed population (where async wins) and Bernoulli
# dropout (faults compose with the event queue).
SCENARIO_NAMES = ("uniform", "stragglers", "dropout")
TARGET_ACC = 0.90
ASYNC_BUFFER = 5  # K: half the population an aggregate
M = 10


def make_cnn_spec(dataset: str, fed: FedConfig, label: str,
                  n_train: int = 1500, n_test: int = 400, seed: int = 0,
                  backend: str = "scan", with_eval: bool = True,
                  cnn_cfg=None, scenario=None,
                  async_spec=None) -> ExperimentSpec:
    """The CNN-FL harness as an ExperimentSpec. One seed governs
    everything: the dataset/partition/population draw and, by syncing
    fed.seed to `seed`, the default `init()` run state."""
    if fed.seed != seed:
        fed = dataclasses.replace(fed, seed=seed)
    model = cnn_cfg if cnn_cfg is not None else (
        "mnist_cnn" if dataset == "mnist" else "cifar_cnn")
    return ExperimentSpec(
        fed=fed, model=model, dataset=dataset, n_train=n_train,
        n_test=n_test, seed=seed, scenario=scenario, backend=backend,
        with_eval=with_eval, label=label, async_spec=async_spec)


def arm_specs(scenario: str, seed: int = 0, n_train: int = 1500,
              quick: bool = False):
    """The comparison arms as ExperimentSpecs (mnist task, M=10)."""
    defl_fed = FedConfig(n_devices=M, epsilon=0.01, nu=2.0,
                         c=CALIBRATED_C, lr=0.05)

    def spec(label, fed, **kw):
        return make_cnn_spec("mnist", fed, f"{label}@{scenario}",
                             n_train=n_train, seed=seed, scenario=scenario,
                             **kw)

    sync = spec("DEFL", defl_fed).replace(plan=True)
    # FedBuff at the sync arm's solved operating point: the execution
    # model (round clock vs event clock) alone differs from the plan.
    planned = sync.resolve_fed()
    buff = spec("FedBuff", planned, backend="async",
                async_spec=AsyncSpec(buffer_size=ASYNC_BUFFER,
                                     staleness="poly"))
    arms = [("DEFL", sync), ("FedBuff", buff)]
    if not quick:
        # FedBuff+ re-plans (b, V) under the async delay model itself.
        aplan = defl.async_plan(
            sync.base_fed(), sync.device_population(), sync.update_bits(),
            buffer_size=ASYNC_BUFFER, wireless=sync.wireless)
        b = min(aplan.b, 32)  # the same dataset-bounded cap as batch_cap
        afed = FedConfig(n_devices=M, batch_size=b, theta=aplan.theta,
                         nu=2.0, lr=0.05)
        arms.append(("FedBuff+", spec("FedBuff+", afed, backend="async",
                                      async_spec=AsyncSpec(
                                          buffer_size=ASYNC_BUFFER,
                                          staleness="poly"))))
    return arms


def study_for(scenario: str, seed: int = 0, seeds: int = 1,
              quick: bool = False) -> Study:
    return Study(
        arms=arm_specs(scenario, seed, n_train=600 if quick else 1500,
                       quick=quick),
        seeds=range(seed, seed + seeds),
        max_rounds=4 if quick else 12, eval_every=1,
        target_acc=TARGET_ACC)


def predicted_overall_s(spec: ExperimentSpec) -> float:
    """An arm's model-predicted overall time: Eq. 13 for a sync arm, the
    async re-derivation (defl.async_plan at the arm's buffer) for an
    async one."""
    if spec.backend == "async":
        return defl.async_plan(
            spec.base_fed(), spec.device_population(), spec.update_bits(),
            buffer_size=spec.async_spec.buffer_size,
            wireless=spec.wireless).overall_pred
    return spec.analytic_plan().overall_pred


HEADER = ("name,scenario,method,b,V,agg,rounds,overall_time_s,acc,"
          "time_to_90,predicted_overall_s")


def run(quick: bool = False, scenario: str = "", seed: int = 0,
        seeds: int = 1, checkpoint_dir: str = "", resume: bool = True,
        device: str = "cuda"):
    """One row per (scenario, method): measured rounds/time/acc/
    time-to-target plus each arm's model-predicted overall time, and a
    reduction row (FedBuff vs DEFL on mean time-to-target-or-total)."""
    rows = []
    payload = {}
    scens = (scenario,) if scenario else SCENARIO_NAMES
    for scen in scens:
        study = study_for(scen, seed=seed, seeds=seeds, quick=quick)
        res = study.run(
            checkpoint_dir=(os.path.join(checkpoint_dir, scen)
                            if checkpoint_dir else None),
            resume=resume, device=device)
        payload[scen] = res.to_json()
        multi = seeds > 1
        for label, spec in study.arms:
            s = res.summary(label)
            fed = res[label][0].fed
            pred = predicted_overall_s(spec)
            tta = res.time_to_target(label)
            hit = bool(np.isfinite(tta).any())
            band = lambda m, sd, nd: (  # noqa: E731
                f"{m:.{nd}f}+-{sd:.{nd}f}" if multi else round(m, nd))
            rows.append((
                "async_vs_sync", scen, label, fed.batch_size,
                fed.local_rounds,
                res.async_modes.get(label) or "sync",
                round(s["rounds_mean"], 1),
                band(s["total_time_mean"], s["total_time_std"], 2),
                band(s["final_acc_mean"], s["final_acc_std"], 4),
                (band(float(np.nanmean(tta)), float(np.nanstd(tta)), 2)
                 if hit else ""),
                round(pred, 2)))
        rows.append(("async_vs_sync", scen, "reduction_vs_defl", "", "",
                     "", "", round(res.reduction("FedBuff", "DEFL"), 1),
                     "", "", ""))
    return HEADER, rows, payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--scenario", default="", choices=("",) + SCENARIO_NAMES)
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
