"""Planner service demo on the PyTorch/CUDA port, the twin of
examples/planner_service_demo.py (same arguments, prints, JSON and exit
codes): replanning (b, V) over a production trace.

Walks the `diurnal_edge` trace scenario (the population behind the
`mnist_diurnal` registry spec: phone/tablet/IoT classes, battery/thermal
gates, time-of-day availability) with the online planner service
(federated/planner.py): each epoch the service re-solves the talk/work
operating point from the previous epoch's telemetry — all epochs batched
into ONE vectorized KKT dispatch — and the report scores the replanned
sequence against every fixed plan on simulated time-to-target over the
SAME realized rounds, quoting the regret vs the hindsight oracle.

  PYTHONPATH=src python examples/planner_service_demo_torch.py \
      [--quick] [--check] [--json PATH] [--seed N]

The planner is numpy on the host (federated/planner.py): the script
touches no device and imports only the port.

--check exits 1 unless the replanned sequence beats the worst fixed plan
(the acceptance bar: adapting must dominate the worst static choice).
--json writes the full regret report (the CI planner-smoke artifact).
"""
from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.federated import experiment, planner  # noqa: E402


def run(quick: bool = False, seed: int = 0) -> planner.ReplanReport:
    # The trace fed: mnist_diurnal's population/constants, but a looser
    # epsilon so the Eq. 12 budget is reachable inside a short demo trace
    # (epsilon=0.01 needs thousands of rounds; the *relative* ordering of
    # plans is what the demo exercises).
    spec = experiment.get("mnist_diurnal")
    fed = FedConfig(n_devices=spec.n_devices(), epsilon=0.1, nu=2.0,
                    c=1.0, lr=0.05)
    epochs, rounds = (4, 8) if quick else (6, 16)
    return planner.replan_trace(
        "diurnal_edge", fed, update_bits=spec.update_bits(),
        epochs=epochs, rounds_per_epoch=rounds, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="shorter trace (4 epochs x 8 rounds)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless replanning beats the worst fixed "
                         "plan on simulated time-to-target")
    ap.add_argument("--json", default="",
                    help="write the regret report JSON here (CI artifact)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    report = run(quick=args.quick, seed=args.seed)
    print(f"scenario: {report.scenario}  "
          f"({report.epochs} epochs x {report.rounds_per_epoch} rounds)")
    print("per-epoch operating points:")
    for p in report.plans:
        print(f"  epoch {p.epoch}: b={p.b:<3d} V={p.V:<2d} "
              f"participation={p.participation:.2f} "
              f"T_round_pred={p.T_round_pred:.3f}s")
    print(report.table())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2, default=float)
            f.write("\n")
    if args.check:
        if not report.beats_worst():
            print(f"FAIL: replanned {report.replanned_time:.2f}s does not "
                  f"beat worst fixed plan {report.worst} "
                  f"({report.worst_time:.2f}s)")
            raise SystemExit(1)
        print(f"check: replanned {report.replanned_time:.2f}s beats worst "
              f"fixed {report.worst} ({report.worst_time:.2f}s); regret vs "
              f"oracle {report.oracle} = {report.regret:+.2f}s")


if __name__ == "__main__":
    main()
