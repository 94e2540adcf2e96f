"""Traffic kind `fleet`: one configuration's run over many run seeds as
one fleet (`Simulator.run_fleet`), chunk by chunk with the members'
states carried forward (`states=`).

Traffic parameters: members (run seeds), compress, rounds_per_call and
eval_every (the window's call), check_rounds (the rounds the reference
follows).
"""
from __future__ import annotations

from fedbench.harness import program
from fedbench.harness.common import Run, dense_members, param_shapes


def run_seeds(traffic: dict, seed: int):
    return [seed + 1 + j for j in range(traffic["members"])]


class Program(Run):
    def __init__(self, cfg, traffic, seed, device, init):
        spec = program.spec_for(cfg, seed, traffic["compress"])
        self.sim = spec.build(device=device, params=program.nested(init))
        self.states = [self.sim.init(s) for s in run_seeds(traffic, seed)]
        super().__init__(cfg, traffic, [self.sim] * len(self.states),
                         cfg["fed"]["n_devices"])

    def _advance(self, rounds, eval_every):
        res = self.sim.run_fleet(states=self.states, max_rounds=rounds,
                                 eval_every=eval_every)
        self.states = res.states
        return [r.history for r in res.results]

    def params(self, i):
        return program.flat(self.sim.params(self.states[i]))


def reference_members(cfg: dict, traffic: dict, seed: int):
    from fedbench.reference import clock
    compress = traffic["compress"]
    b, V = clock.plan(cfg, param_shapes(cfg), cfg["fed"]["n_devices"],
                      compress)
    return dense_members(cfg, seed, [("run", b, V, s) for s in
                                     run_seeds(traffic, seed)],
                         compress, scenario=False)
