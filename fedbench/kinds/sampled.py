"""Traffic kind `sampled`: one run over a population of M clients, a
cohort of K drawn each round (`PopulationSpec(M, cohort=CohortSpec(K))`),
driven by `Simulator.run` chunk by chunk.

Traffic parameters: population_M, cohort_K, compress, rounds_per_call and
eval_every (the window's call), check_rounds (the rounds the reference
follows).
"""
from __future__ import annotations

import statistics
import time

import numpy as np

from fedbench.harness import program
from fedbench.harness.common import RefMember, Run, param_shapes


class Program(Run):
    def __init__(self, cfg, traffic, seed, device, init):
        from repro_torch.federated.experiment import CohortSpec, PopulationSpec
        pop = PopulationSpec(M=traffic["population_M"],
                             cohort=CohortSpec(K=traffic["cohort_K"]))
        spec = program.spec_for(cfg, seed, traffic["compress"],
                                population=pop)
        self.sim = spec.build(device=device, params=program.nested(init))
        self.state = self.sim.init(seed + 1)
        super().__init__(cfg, traffic, [self.sim], traffic["cohort_K"])

    def _advance(self, rounds, eval_every):
        self.state, res = self.sim.run(self.state, max_rounds=rounds,
                                       eval_every=eval_every)
        return [res.history]

    def params(self, i):
        return program.flat(self.sim.params(self.state))

    def extras(self):
        return {"host_draw_s": host_draws(self.sim, self.state)}


def host_draws(sim, state, n=3, reps=5):
    """Median host seconds a round of a sampled chunk's draws: the cohorts,
    the M-wide realization and its uplink times, the index stack, each on
    fresh host streams at `state`. Frozen copy of chip_smoke.py's
    `_host_draws` (phase 19 (f)), summed over its three parts."""
    from repro_torch.federated.client import stack_cohort_indices
    per_round = []
    for _ in range(reps):
        iters, stream = sim._materialize(state)
        t0 = time.perf_counter()
        cohorts = stream.draw_cohorts(n)
        sim._chunk_uplink(stream.draw_chunk(n))
        stack_cohort_indices(iters, cohorts, sim.fed.local_rounds)
        per_round.append((time.perf_counter() - t0) / n)
    return statistics.median(per_round)


def reference_members(cfg: dict, traffic: dict, seed: int):
    from fedbench.reference import clock, data
    from fedbench.reference.rounds import Member
    compress = traffic["compress"]
    M, K = traffic["population_M"], traffic["cohort_K"]
    shapes = param_shapes(cfg)
    b, V = clock.plan(cfg, shapes, M, compress, K=K)
    x, y = data.make_dataset(cfg["dataset"], cfg["n_train"], seed)
    n = cfg["n_train"]
    size = data.virtual_shard_size(n)
    member = Member(b=b, V=V, seed=seed + 1, compress=compress,
                    client_rows=lambda m: data.shard_indices(n, m, size, seed),
                    sizes=np.full(M, size, np.int64), cohort=(M, K))

    def records(rounds):
        stream = data.CohortStream(M, K, seed + 1)
        cohorts = [stream.draw() for _ in range(rounds)]
        return clock.records(cfg, shapes, M, b, V, compress, rounds,
                             cohorts=cohorts)

    return [RefMember("run", b, V, member, records)], (x, y)
