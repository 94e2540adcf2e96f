"""Online DEFL planner service: streaming device state in, (b, V) plans out.

The repo's studies solve Alg. 1 once, offline, at Study build time. A
serving deployment faces the inverse shape: device state (compute slope,
channel quality, availability) arrives as a telemetry stream, conditions
drift hour to hour (traces.TraceScenario), and *many* plan queries — one
per tenant / cohort / what-if — must be answered concurrently. This module
provides that layer:

  * `PlannerService` — ingests `DeviceStateUpdate`s into a rolling
    per-client state table, materializes population snapshots on demand,
    and answers plan queries through the exact Alg. 1 pipeline
    (`defl.make_plan` / `defl.make_plan_batch`). `plan_batch(queries)`
    routes every query into ONE vectorized `kkt.solve_batch` dispatch per
    method (closed-form and the golden-section numerical path are both
    batched), each lane bit-identical to the scalar `plan()` at Q=256.

  * `replan_trace` — the replanning driver: walk a trace scenario epoch
    by epoch, feed the planner the previous epoch's observations, emit a
    re-planned operating point per epoch (all epochs solved in one
    batched dispatch — the trace realization is open-loop, so plan e
    depends only on telemetry before e), then score every plan sequence
    on the *realized* rounds: simulated time until the Eq. 12 convergence
    budget is met, where each round contributes 1/H(b, V; arrived
    updates) progress and costs its realized straggler round time. The
    report compares the replanned sequence against every fixed plan
    (including deliberately bad corners), names the oracle (best fixed in
    hindsight) and the worst, and quotes the regret vs the oracle.

Copy of repro/federated/planner.py (numpy on the host, over the port's
core/defl.py, core/kkt.py and core/delay.py): its plans and reports are
the reference's exactly (tests/test_torch_planner.py). It touches no
device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ComputeConfig, FedConfig, WirelessConfig
from repro_torch.core import defl, delay
from repro_torch.federated import scenarios
from repro_torch.federated import traces  # noqa: F401  (registers trace scenarios)


# ---------------------------------------------------------------------------
# Telemetry and queries
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceStateUpdate:
    """One device's latest observed state.

    g  compute slope G_m/f_m (seconds per unit batch) — what Eq. 3/5
       actually consume; a device reports its measured per-iteration time
       divided by its batch size.
    p  uplink transmit power (W).
    h  observed channel gain (drives the Eq. 6 rate).
    t  observation timestamp (seconds); used for staleness eviction.
    """

    client_id: int
    g: float
    p: float
    h: float
    t: float = 0.0

    def __post_init__(self):
        if self.client_id < 0:
            raise ValueError(f"client_id must be >= 0, got {self.client_id}")
        if not (self.g > 0 and self.p > 0 and self.h > 0):
            raise ValueError(
                f"device {self.client_id}: g, p, h must be > 0 "
                f"(got g={self.g}, p={self.p}, h={self.h})")


@dataclass(frozen=True)
class PlanQuery:
    """One plan request against the service's rolling population estimate.

    Every field is optional: an empty query plans for the service's
    current snapshot with its default fed/method. Overrides let one
    batched dispatch serve heterogeneous tenants (different participation
    estimates, cohort sizes, epsilon targets, even explicit population
    snapshots, as the replanning driver uses for causality)."""

    participation: float = 1.0
    cohort_size: Optional[int] = None
    method: Optional[str] = None
    update_bits: Optional[float] = None
    fed: Optional[FedConfig] = None
    pop: Optional[delay.DevicePopulation] = None
    tag: str = ""


class PlannerService:
    """Rolling device-state table + batched Alg. 1 solves.

    The service is deliberately thin on the solve side: `plan` IS
    `defl.make_plan` and `plan_batch` IS `defl.make_plan_batch` on the
    service's snapshots, so the scalar/batched bit-identity contract
    those carry (tests/test_torch_plan_batch.py) transfers to the service
    verbatim — a batched answer never differs from the one-off answer.
    """

    def __init__(self, fed: FedConfig, update_bits: float,
                 wireless: Optional[WirelessConfig] = None,
                 method: str = "closed_form",
                 stale_after: Optional[float] = None):
        self.fed = fed
        self.update_bits = float(update_bits)
        self.wireless = wireless or WirelessConfig()
        self.method = method
        self.stale_after = stale_after
        self._state: Dict[int, DeviceStateUpdate] = {}
        self._participation: Optional[float] = None

    # -- ingest -------------------------------------------------------------
    def observe(self, updates: Union[DeviceStateUpdate,
                                     Iterable[DeviceStateUpdate]]) -> None:
        """Ingest one update or a batch; latest write per client wins."""
        if isinstance(updates, DeviceStateUpdate):
            updates = (updates,)
        for u in updates:
            self._state[u.client_id] = u

    def observe_population(self, pop: delay.DevicePopulation,
                           t: float = 0.0) -> None:
        """Seed/refresh the table from a DevicePopulation (ids 0..M-1) —
        the cold-start prior before any live telemetry arrives."""
        g = np.asarray(pop.G, float) / np.asarray(pop.f, float)
        self.observe([DeviceStateUpdate(i, float(g[i]), float(pop.p[i]),
                                        float(pop.h[i]), t=t)
                      for i in range(pop.n)])

    def observe_round(self, real, t: float = 0.0) -> None:
        """Ingest one realized round (scenarios.RoundRealization): present
        clients report their realized channel; the participation fraction
        feeds the rolling estimate (EWMA, beta=0.5)."""
        ids = np.flatnonzero(np.asarray(real.clock_mask, bool))
        h = np.asarray(real.h, float)
        self.observe([dataclasses.replace(self._state[i], h=float(h[i]), t=t)
                      for i in ids if int(i) in self._state])
        self.observe_participation(float(np.mean(real.clock_mask)))

    def observe_participation(self, fraction: float) -> None:
        f = float(np.clip(fraction, 0.0, 1.0))
        self._participation = (f if self._participation is None
                               else 0.5 * self._participation + 0.5 * f)

    def participation_estimate(self, default: float = 1.0) -> float:
        return default if self._participation is None else self._participation

    # -- snapshots ----------------------------------------------------------
    @property
    def n_devices(self) -> int:
        return len(self._state)

    def population(self, now: Optional[float] = None) -> delay.DevicePopulation:
        """Current population snapshot: non-stale clients sorted by id,
        encoded so the delay model sees exactly the observed slopes
        (G = g, f = 1 — only G/f is observable in Eqs. 3-8)."""
        rows = sorted(self._state.values(), key=lambda u: u.client_id)
        if self.stale_after is not None and now is not None:
            rows = [u for u in rows if u.t >= now - self.stale_after]
        if not rows:
            raise ValueError(
                "PlannerService has no (fresh) device state to plan on — "
                "observe() telemetry first")
        return delay.DevicePopulation(
            G=np.asarray([u.g for u in rows], float),
            f=np.ones(len(rows), float),
            p=np.asarray([u.p for u in rows], float),
            h=np.asarray([u.h for u in rows], float))

    # -- solves -------------------------------------------------------------
    def _resolve(self, q: PlanQuery,
                 pop: Optional[delay.DevicePopulation]) -> defl.PlanRequest:
        return defl.PlanRequest(
            fed=q.fed or self.fed,
            pop=q.pop if q.pop is not None else pop,
            update_bits=(self.update_bits if q.update_bits is None
                         else q.update_bits),
            wireless=self.wireless,
            method=q.method or self.method,
            participation=q.participation,
            cohort_size=q.cohort_size)

    def _shared_pop(self, queries) -> Optional[delay.DevicePopulation]:
        if all(q.pop is not None for q in queries):
            return None
        return self.population()

    def plan(self, query: PlanQuery = PlanQuery()) -> defl.DEFLPlan:
        """Scalar reference path: one query, one `defl.make_plan`."""
        r = self._resolve(query, self._shared_pop([query]))
        return defl.make_plan(
            r.fed, r.pop, r.update_bits, wireless=r.wireless,
            method=r.method, participation=r.participation,
            cohort_size=r.cohort_size)

    def plan_batch(self, queries: Sequence[PlanQuery]) -> List[defl.DEFLPlan]:
        """Answer Q concurrent queries with the KKT stage batched: ONE
        `kkt.solve_batch` dispatch per distinct method, each lane
        bit-identical to `plan(queries[i])`."""
        queries = list(queries)
        if not queries:
            return []
        pop = self._shared_pop(queries)
        return defl.make_plan_batch([self._resolve(q, pop) for q in queries])


# ---------------------------------------------------------------------------
# Replanning driver
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EpochPlan:
    """The operating point the service chose for one trace epoch."""

    epoch: int
    b: int
    V: int
    participation: float  # the estimate the solve used
    T_round_pred: float


@dataclass(frozen=True)
class ReplanReport:
    """Outcome of `replan_trace`: the per-epoch plans, the simulated
    time-to-target of the replanned sequence vs every fixed plan, and the
    regret vs the oracle (best fixed plan in hindsight). Times are np.inf
    when a plan never reaches the convergence budget inside the trace."""

    scenario: str
    epochs: int
    rounds_per_epoch: int
    target: float
    plans: Tuple[EpochPlan, ...]
    replanned_time: float
    fixed_times: Dict[str, float]
    oracle: str
    worst: str

    @property
    def oracle_time(self) -> float:
        return self.fixed_times[self.oracle]

    @property
    def worst_time(self) -> float:
        return self.fixed_times[self.worst]

    @property
    def regret(self) -> float:
        return self.replanned_time - self.oracle_time

    def beats_worst(self) -> bool:
        return self.replanned_time < self.worst_time

    def table(self) -> str:
        rows = [f"{'plan':>14} {'time-to-target (s)':>20}",
                f"{'replanned':>14} {self.replanned_time:>20.2f}"]
        for label, t in sorted(self.fixed_times.items(), key=lambda kv: kv[1]):
            mark = {self.oracle: "  <- oracle",
                    self.worst: "  <- worst"}.get(label, "")
            rows.append(f"{label:>14} {t:>20.2f}{mark}")
        rows.append(f"regret vs oracle: {self.regret:+.2f}s")
        return "\n".join(rows)

    def to_json(self) -> dict:
        return {
            "scenario": self.scenario,
            "epochs": self.epochs,
            "rounds_per_epoch": self.rounds_per_epoch,
            "target": self.target,
            "plans": [dataclasses.asdict(p) for p in self.plans],
            "replanned_time": self.replanned_time,
            "fixed_times": dict(self.fixed_times),
            "oracle": self.oracle,
            "worst": self.worst,
            "oracle_time": self.oracle_time,
            "worst_time": self.worst_time,
            "regret": self.regret,
            "beats_worst": self.beats_worst(),
        }


def _epoch_round_model(fed, wc, pop, bits_eff, chunk, b, V):
    """Realized per-round (cost, progress) for operating point (b, V) on
    one trace chunk: cost is the Eq. 8 straggler round time over the
    clients the server waits for; progress is 1/H with Eq. 12's M set to
    the updates that actually arrived that round (0 arrivals = 0
    progress — the round is spent but buys nothing)."""
    t_cp = delay.per_client_compute_time(b, pop.G, pop.f)
    t_cm = delay.per_client_uplink_time(bits_eff, wc, pop.p, chunk.h)
    T_cm, T_cp = delay.chunk_round_times(t_cp, t_cm, chunk.clock_mask)
    T = T_cm + V * T_cp
    n_upd = chunk.mask.sum(axis=1)
    alpha = max(V / fed.nu, 1e-12)
    M_eff = np.maximum(n_upd, 1).astype(float)
    H = (fed.c / (b * b * fed.epsilon * fed.epsilon * M_eff * fed.nu * alpha)
         + fed.c * M_eff / (b * fed.epsilon))
    dp = np.where(n_upd > 0, 1.0 / H, 0.0)
    return T, dp


def _walk(fed, wc, pop, bits_eff, chunks, plan_seq, target=None):
    """Walk the realized trace under a per-epoch plan sequence.

    target=None: return (total_time, total_progress) over the whole
    trace. Otherwise: simulated time until cumulative progress reaches
    `target` (linear credit inside the crossing round), or np.inf if the
    trace ends short of it."""
    t, prog = 0.0, 0.0
    for chunk, (b, V) in zip(chunks, plan_seq):
        T, dp = _epoch_round_model(fed, wc, pop, bits_eff, chunk, b, V)
        if target is not None:
            cum = prog + np.cumsum(dp)
            hit = np.nonzero(cum >= target)[0]
            if hit.size:
                k = int(hit[0])
                before = cum[k] - dp[k]
                t += float(T[:k].sum()) + float(T[k]) * \
                    ((target - before) / dp[k])
                return t
        t += float(T.sum())
        prog = prog + float(dp.sum())
    return (t, prog) if target is None else float("inf")


def replan_trace(
    scenario: Union[str, scenarios.Scenario],
    fed: FedConfig,
    update_bits: float,
    epochs: int = 6,
    rounds_per_epoch: int = 16,
    wireless: Optional[WirelessConfig] = None,
    cc: Optional[ComputeConfig] = None,
    seed: int = 0,
    method: str = "closed_form",
    target: Optional[float] = None,
    target_frac: float = 0.5,
    extra_candidates: Tuple[Tuple[int, int], ...] = ((1, 1), (64, 16)),
    service: Optional[PlannerService] = None,
) -> ReplanReport:
    """Walk `scenario` for epochs x rounds_per_epoch rounds, re-planning
    (b, V) each epoch from the telemetry of the rounds before it.

    Causality: epoch e's query carries the population snapshot and
    participation estimate as of the END of epoch e-1 (epoch 0 plans on
    the analytic prior). Because the trace realization is open-loop — the
    masks/channels do not depend on the plan — every epoch's query is
    known upfront and all E solves run as ONE `plan_batch` dispatch.

    Scoring: the replanned sequence and every fixed candidate (each
    distinct replanned operating point held for the whole trace, plus
    `extra_candidates` — deliberately including bad corners like (1, 1))
    are walked over the SAME realized rounds. `target` is the Eq. 12
    progress budget; by default it is `target_frac` of the replanned
    sequence's total realized progress — the budget the service commits
    to and comfortably meets — applied identically to every sequence (a
    fixed plan that cannot deliver it inside the trace scores np.inf).
    The oracle is the fixed plan with the smallest time-to-target in
    hindsight; regret = replanned - oracle.
    """
    scen = scenarios.get(scenario)
    wc = wireless or WirelessConfig()
    pop = scen.population(fed.n_devices, cc, wc, seed)
    stream = scen.stream(pop, seed)
    chunks = [stream.draw_chunk(rounds_per_epoch) for _ in range(epochs)]
    bits_eff = update_bits / 4.0 if fed.compress_updates else update_bits

    svc = service or PlannerService(fed, update_bits, wireless=wc,
                                    method=method)
    svc.observe_population(pop)
    prior = scen.expected_participation
    queries = []
    for e in range(epochs):
        part = svc.participation_estimate(default=prior)
        queries.append(PlanQuery(pop=svc.population(), participation=part,
                                 tag=f"epoch{e}"))
        # ingest epoch e's telemetry (feeds epoch e+1's query): each
        # device's mean realized channel over the epoch + the realized
        # participation rate
        ch = chunks[e]
        h_mean = ch.h.mean(axis=0)
        svc.observe([DeviceStateUpdate(i, float(pop.G[i] / pop.f[i]),
                                       float(pop.p[i]), float(h_mean[i]),
                                       t=float(e))
                     for i in range(pop.n)])
        svc.observe_participation(float(ch.clock_mask.mean()))
    plans = svc.plan_batch(queries)  # ONE batched dispatch for all epochs

    epoch_plans = tuple(
        EpochPlan(epoch=e, b=p.b, V=p.V, participation=q.participation,
                  T_round_pred=p.T_round)
        for e, (p, q) in enumerate(zip(plans, queries)))
    replanned_seq = [(p.b, p.V) for p in epoch_plans]

    candidates: Dict[str, Tuple[int, int]] = {}
    for b, V in replanned_seq + list(extra_candidates):
        candidates.setdefault(f"b{int(b)}.V{int(V)}", (int(b), int(V)))

    if target is None:
        _, replanned_prog = _walk(fed, wc, pop, bits_eff, chunks,
                                  replanned_seq)
        target = target_frac * replanned_prog
    replanned_time = _walk(fed, wc, pop, bits_eff, chunks, replanned_seq,
                           target=target)
    fixed_times = {
        label: _walk(fed, wc, pop, bits_eff, chunks, [bv] * epochs,
                     target=target)
        for label, bv in candidates.items()}
    oracle = min(fixed_times, key=lambda k: fixed_times[k])
    worst = max(fixed_times, key=lambda k: fixed_times[k])
    return ReplanReport(
        scenario=getattr(scen, "name", str(scenario)),
        epochs=epochs, rounds_per_epoch=rounds_per_epoch,
        target=float(target), plans=epoch_plans,
        replanned_time=float(replanned_time),
        fixed_times=fixed_times, oracle=oracle, worst=worst)
