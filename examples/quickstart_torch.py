"""Quickstart on the PyTorch/CUDA port: DEFL through the declarative
experiment API, the twin of examples/quickstart.py (same spec, same
prints).

1. Describe the experiment as a frozen `ExperimentSpec` (model, data,
   population, wireless — and `plan=True` to solve the paper's (b*,
   theta*) against the realized population, Alg. 1 line 0).
2. `SPEC.build(device=...)` -> a `Simulator`; `sim.init(seed)` -> an
   immutable `SimState`; `sim.run(state, ...)` threads it through real
   training while tracking the simulated wall clock (Eq. 8).
3. `sim.run_fleet(seeds=...)` runs a multi-seed fleet with one device
   call per round-chunk — the confidence-band workload.

  PYTHONPATH=src python examples/quickstart_torch.py               # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.federated.experiment import ExperimentSpec  # noqa: E402

SPEC = ExperimentSpec(
    fed=FedConfig(n_devices=10, epsilon=0.01, nu=2.0, c=0.4, lr=0.05),
    model="mnist_cnn", dataset="mnist", n_train=1000,
    heterogeneity=0.2, plan=True, with_eval=False, label="defl")


def main(device: str = "cuda"):
    # --- the experiment, declaratively ------------------------------------
    plan = SPEC.resolve_plan()
    print(f"DEFL plan: b*={plan.b} theta*={plan.theta:.3f} V={plan.V} "
          f"H_pred={plan.H_pred:.1f} T_round={plan.T_round:.3f}s "
          f"overall_pred={plan.overall_pred:.1f}s")

    # --- one run: state-in / state-out ------------------------------------
    sim = SPEC.build(device=device)
    state, res = sim.run(sim.init(), max_rounds=5)
    for r in res.history:
        print(f"round {r.round}: sim_time={r.sim_time:7.2f}s "
              f"loss={r.train_loss:.4f}")

    # --- a 4-seed fleet: one device call per chunk ------------------------
    fleet = sim.run_fleet(seeds=range(4), max_rounds=5, eval_every=5)
    s = fleet.summary()
    print(f"fleet over 4 seeds: final loss "
          f"{s['final_loss_mean']:.4f} +- {s['final_loss_std']:.4f}, "
          f"overall time {s['total_time_mean']:.1f}s "
          f"+- {s['total_time_std']:.1f}s")
    return res, fleet


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the simulator runs (default: the card)")
    main(ap.parse_args().device)
