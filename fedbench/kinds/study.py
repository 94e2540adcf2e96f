"""Traffic kind `study`: the arms of a `Study` over run seeds, folded into
one shape group and driven through the Study's group runner
(repro_torch.federated.study._run_group), chunk by chunk with each
member's state carried forward.

Traffic parameters: arms (DEFL planned, or fixed b and V, either given
per dataset), seeds (run seeds a member of each arm), scenario, compress,
rounds_per_call and eval_every (the window's call), check_rounds (the
rounds the reference follows). DEFL, FedAvg and Rand are a frozen copy of
examples/defl_vs_fedavg_torch.py's `arm_specs`: FedAvg and Rand run their
fixed (b, V) with theta = exp(-V / nu), DEFL its plan. A traffic file may
add fixed arms of its own, such as one of a single local step, whose
first round the reference follows without the rounding that long chains
of steps carry.
"""
from __future__ import annotations

import numpy as np

from fedbench.harness import program
from fedbench.harness.common import Run, dense_members, param_shapes, pick


def arms(cfg: dict, traffic: dict):
    """[(label, None for the planned arm or its fixed (b, V))]."""
    out = []
    for arm in traffic["arms"]:
        if arm.get("plan"):
            out.append((arm["label"], None))
        else:
            out.append((arm["label"], (pick(arm["b"], cfg["dataset"]),
                                       pick(arm["V"], cfg["dataset"]))))
    return out


def run_seeds(traffic: dict, seed: int):
    return [seed + 1 + j for j in range(traffic["seeds"])]


class Program(Run):
    def __init__(self, cfg, traffic, seed, device, init):
        from repro_torch.configs.base import FedConfig
        from repro_torch.federated import study
        self._study = study
        compress = traffic["compress"]
        base = program.spec_for(cfg, seed, compress,
                                scenario=traffic.get("scenario"))
        specs = []
        for label, fixed in arms(cfg, traffic):
            if fixed is None:
                specs.append((label, base.replace(label=label)))
                continue
            b, V = fixed
            fed = FedConfig(
                n_devices=base.fed.n_devices, batch_size=b,
                theta=float(np.exp(-V / base.fed.nu)), nu=base.fed.nu,
                lr=base.fed.lr, seed=seed, compress_updates=compress)
            specs.append((label, base.replace(fed=fed, plan=False,
                                              label=label)))
        sims = {label: spec.build(device=device,
                                  params=program.nested(init))
                for label, spec in specs}
        self.group = [study._Member(arm=a, label=label, sim=sims[label],
                                    seed=s)
                      for a, (label, _) in enumerate(specs)
                      for s in run_seeds(traffic, seed)]
        for m in self.group:
            m.state = m.sim.init(m.seed)
        super().__init__(cfg, traffic, [m.sim for m in self.group],
                         cfg["fed"]["n_devices"])

    def _advance(self, rounds, eval_every):
        out = self._study._run_group(self.group, rounds, eval_every, None,
                                     None)
        for m, (state, _) in zip(self.group, out):
            m.state = state
        return [res.history for _, res in out]

    def params(self, i):
        m = self.group[i]
        return program.flat(m.sim.params(m.state))

    def extras(self):
        """The group's padding share: padded sample-steps over envelope
        sample-steps (chip_smoke.py phase 17 (d)'s `_padding_share`)."""
        bs, Vs = zip(*self.plans())
        real = sum(V * b for V, b in zip(Vs, bs))
        return {"padding_share": 1.0 - real / (len(Vs) * max(Vs) * max(bs))}


def reference_members(cfg: dict, traffic: dict, seed: int):
    from fedbench.reference import clock
    compress = traffic["compress"]
    M = cfg["fed"]["n_devices"]
    shapes = param_shapes(cfg)
    out = []
    for label, fixed in arms(cfg, traffic):
        b, V = (clock.plan(cfg, shapes, M, compress) if fixed is None
                else (fixed[0], clock.fixed_V(fixed[1], cfg["fed"]["nu"])))
        out += [(label, b, V, s) for s in run_seeds(traffic, seed)]
    return dense_members(cfg, seed, out, compress,
                         scenario=traffic.get("scenario") is not None)
