"""Scenario engine: named edge-population scenarios for the FL simulator.

The paper's talk/work trade-off is governed by *heterogeneous* device
compute and *unreliable* wireless links (Eqs. 3-8, Fig. 2), but a single
`draw_population` knob can't express the populations that matter: compute-
skewed straggler cohorts, cell-edge devices with attenuated channels,
partial participation (per-round Bernoulli dropout and link failure), and
channels that drift over rounds. A `Scenario` bundles

  1. a *population draw* — per-device (G_m, f_m, p_m, h_m) with named
     skew knobs, feeding `core.delay` and `core.defl.make_plan`; and
  2. a *per-round realization stream* — participation masks and realized
     channel gains, consumed by the simulator (`simulation.Simulator`) on
     the host and uploaded to the chunked round step once a chunk
     (mesh_rounds.build_fleet_chunk). Stream position snapshots
     (`state`/`set_state`) ride in `SimState`.

Registry access is by name (`scenarios.get("stragglers")`). Copy of
repro/federated/scenarios.py (numpy only, the reference's RNG calls in
its order; tests/test_torch_scenarios.py holds every registered
scenario's draws equal to the reference's). The `TraceRound` overlay hook
is traces.py's: its device-class and replay streams override it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np

from repro_torch.configs.base import ComputeConfig, FedConfig, WirelessConfig
from repro_torch.core import defl, delay
from repro_torch.federated.faults import FaultModel


# ---------------------------------------------------------------------------
# Per-round realization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RoundRealization:
    """What one round of the scenario actually looked like.

    mask        (M,) bool — clients whose update reaches the aggregator
                (present AND upload succeeded, possibly after retries).
                Drives the FedAvg weights.
    clock_mask  (M,) bool — clients the synchronous server waits for
                (present, whether or not their upload then fails). Drives
                the Eq. 8 straggler max. mask is always a subset. Crashed
                clients are absent from BOTH masks (the server's
                heartbeat timeout knows not to wait for them).
    h           (M,) float — realized channel gains this round (drift
                applied), feeding the vectorized Eq. 6 uplink times.

    Fault-path extras (None unless the scenario has an active FaultModel):
    attempts    (M,) int — uplink transmissions made this round (first
                try + retries; 0 for absent clients). Every attempt's
                airtime and bits are accounted.
    h_att       (M, A) float — per-attempt realized channel gains
                (A = 1 + max_retries; column 0 equals h). Retries see
                freshly drawn AR(1) states.
    """

    mask: np.ndarray
    clock_mask: np.ndarray
    h: np.ndarray
    attempts: Optional[np.ndarray] = None
    h_att: Optional[np.ndarray] = None

    @property
    def n_participants(self) -> int:
        return int(self.mask.sum())


@dataclass(frozen=True)
class ChunkRealization:
    """A chunk of R consecutive round realizations, stacked on a leading
    round axis: mask/clock_mask (R, M) bool, h (R, M) float. This is the
    host-side source of the chunked driver's scenario inputs — one (R, M)
    transfer per chunk instead of R per-round ones.
    Fault-path extras stack the same way: attempts (R, M) int and h_att
    (R, M, A) float, or None when the scenario has no active FaultModel.
    """

    mask: np.ndarray
    clock_mask: np.ndarray
    h: np.ndarray
    attempts: Optional[np.ndarray] = None
    h_att: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.mask.shape[0]

    @property
    def n_participants(self) -> np.ndarray:
        """(R,) int — updates that reached the aggregator each round."""
        return self.mask.sum(axis=1).astype(int)

    def round(self, i: int) -> RoundRealization:
        return RoundRealization(
            mask=self.mask[i], clock_mask=self.clock_mask[i], h=self.h[i],
            attempts=None if self.attempts is None else self.attempts[i],
            h_att=None if self.h_att is None else self.h_att[i])


class TraceRound(NamedTuple):
    """Per-round overlay a trace-driven stream feeds into `_draw_round`.

    present  (M,) bool or None — availability gate ANDed into presence
             (battery/thermal/diurnal state machines, or a replayed log's
             present set). None = everyone eligible.
    lost     (M,) bool or None — deterministic upload losses (a replayed
             log's lost set). ORed into the link-failure outcome and
             final: retransmission retries never resurrect a recorded
             loss. None = no recorded losses.
    h_scale  (M,) float or None — multiplier on this round's realized
             channel gains (device-class channel quality, recorded
             fading), applied after the AR(1) drift to h and to every
             retry attempt's gain. None = unscaled.
    """

    present: Optional[np.ndarray] = None
    lost: Optional[np.ndarray] = None
    h_scale: Optional[np.ndarray] = None


class ScenarioStream:
    """Stateful per-round realization generator (host-side, numpy only).

    Owns the dropout/link-failure draws and the AR(1) log-drift state of
    the channel. One stream per simulation run; seeded so all backends
    (and reruns) see identical realizations.

    Trace-driven subclasses (federated/traces.py) override `_trace_round`
    to overlay availability/loss/channel-quality signals per round; the
    base implementation returns None and consumes no randomness, so plain
    scenario streams keep the pre-trace wire format bit for bit.
    """

    def __init__(self, scenario: "Scenario", pop: delay.DevicePopulation,
                 seed: int = 0, cohort_size: Optional[int] = None,
                 cohort_weights=None):
        self.scenario = scenario
        self.pop = pop
        self._seed = seed
        self._rng = np.random.default_rng(np.random.SeedSequence([seed, 0xED6E]))
        self._log_drift = np.zeros(pop.n)
        # crash/rejoin lifecycle: rounds each client stays down (0 = alive)
        self._down = np.zeros(pop.n, dtype=np.int64)
        # Sampled participation: K-client cohorts drawn per round from a
        # dedicated RNG so the mask/drift wire format above stays
        # bit-identical to a dense (no-cohort) stream at the same seed.
        if cohort_size is not None and not 1 <= int(cohort_size) <= pop.n:
            raise ValueError(
                f"cohort_size must be in [1, {pop.n}], got {cohort_size}")
        self.cohort_size = None if cohort_size is None else int(cohort_size)
        self._cohort_weights = None
        if cohort_weights is not None:
            w = np.asarray(cohort_weights, np.float64)
            if w.shape != (pop.n,) or not np.all(w > 0):
                raise ValueError(
                    f"cohort_weights must be ({pop.n},) positive floats")
            self._cohort_weights = w
        self._cohort_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xC047]))

    @property
    def _faults(self) -> Optional[FaultModel]:
        fm = self.scenario.faults
        return fm if (fm is not None and fm.active) else None

    # -- snapshot / restore (SimState checkpointing) ------------------------
    def state(self) -> dict:
        """Value snapshot of the stream position: the RNG bit-generator
        state, the AR(1) drift carry, and the crash/rejoin down-counters.
        A stream restored from this via `set_state` continues the
        realization sequence bit-identically — the simulator's SimState
        carries these snapshots so a saved run resumes on the exact
        mask/channel stream it left, mid-crash-epoch included."""
        return {"rng": self._rng.bit_generator.state,
                "log_drift": self._log_drift.copy(),
                "down": self._down.copy(),
                "cohort_rng": self._cohort_rng.bit_generator.state}

    def set_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]
        self._log_drift = np.asarray(state["log_drift"], float).copy()
        # pre-fault snapshots have no "down" key: tolerate them (all-up)
        down = state.get("down")
        self._down = (np.zeros(self.pop.n, dtype=np.int64) if down is None
                      else np.asarray(down, np.int64).copy())
        # pre-cohort snapshots have no "cohort_rng" key: re-seed fresh
        # (dense streams never consume this generator, so it's a no-op)
        crng = state.get("cohort_rng")
        if crng is None:
            self._cohort_rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, 0xC047]))
        else:
            self._cohort_rng.bit_generator.state = crng

    # -- cohort sampling ----------------------------------------------------
    def draw_cohort(self) -> np.ndarray:
        """Draw this round's participant cohort: (K,) sorted int32 client
        ids. K = M (or no cohort configured) returns arange(M) WITHOUT
        consuming the cohort RNG — a K=M sampled stream is state-identical
        to a dense one, which is what the K=M bit-parity contract rests
        on. "uniform" takes the K smallest of M uniform keys; "weighted"
        is Gumbel top-K over the configured positive weights (exact
        weighted sampling without replacement). Sorting makes cohort
        lanes ascend in client id, so at K=M the lane order is exactly
        the dense client order.

        Over-provisioned cohorts (CohortSpec.spare) reuse this draw
        unchanged with cohort_size = K + spare: one random(M) vector is
        consumed regardless of K, so drawing K + spare candidates
        advances the cohort RNG exactly as drawing K would — spare=0 is
        structurally bit-identical to today. The feasible-fastest
        down-select to K happens in the Simulator, after fault
        realizations resolve M-wide."""
        M = self.pop.n
        K = M if self.cohort_size is None else self.cohort_size
        if K == M:
            return np.arange(M, dtype=np.int32)
        if self._cohort_weights is None:
            key = self._cohort_rng.random(M)
        else:
            u = self._cohort_rng.random(M)
            key = -(np.log(self._cohort_weights) - np.log(-np.log(u)))
        idx = np.argpartition(key, K)[:K]
        return np.sort(idx).astype(np.int32)

    def draw_cohorts(self, rounds: int) -> np.ndarray:
        """Next `rounds` cohorts stacked to (R, K) int32 — R sequential
        `draw_cohort()` calls, bit for bit (the cohort twin of the
        draw_chunk == R x next_round contract)."""
        if rounds == 0:
            K = (self.pop.n if self.cohort_size is None
                 else self.cohort_size)
            return np.empty((0, K), np.int32)
        return np.stack([self.draw_cohort() for _ in range(rounds)])

    # -- trace overlay hook -------------------------------------------------
    def _trace_round(self) -> Optional[TraceRound]:
        """Called exactly once at the top of `_draw_round`. Trace-driven
        subclasses return a TraceRound overlay (and may advance their own
        dedicated RNG/state machines); the base returns None, consuming
        nothing — the legacy wire format is untouched."""
        return None

    def _draw_round(self):
        """One round's raw draws: (uploaded, present, h, attempts, h_att).

        The draw order (trace overlay, crash, dropout, link failure,
        drift, then the retry attempts — each an M-vector from the shared
        RNG) is the stream's wire format: draw_chunk must consume the
        generator in exactly this per-round interleaving so a chunked run
        is bit-identical to a per-round run and the two call styles can
        be mixed on one stream. Every fault draw is gated on its knob, so
        a scenario without an active FaultModel consumes the RNG exactly
        as before faults existed (bit-identical legacy streams); the
        trace overlay draws from its own generator, never the shared one,
        so trace scenarios keep the same guarantee."""
        s, M = self.scenario, self.pop.n
        fm = self._faults
        tr = self._trace_round()
        present = np.ones(M, bool)
        if tr is not None and tr.present is not None:
            present &= tr.present
        if fm is not None and fm.crash_rate > 0:
            # alive -> crashed (down for rejoin_rounds) -> alive again
            crashed = (self._down == 0) & (self._rng.random(M) < fm.crash_rate)
            self._down[crashed] = fm.rejoin_rounds
            present &= self._down == 0
            self._down = np.maximum(self._down - 1, 0)
        if s.dropout > 0:
            present &= self._rng.random(M) >= s.dropout
        uploaded = present.copy()
        failed = np.zeros(M, bool)
        if tr is not None and tr.lost is not None:
            failed |= tr.lost
        if s.link_failure > 0:
            failed |= self._rng.random(M) < s.link_failure
        uploaded &= ~failed
        h = self.pop.h
        if s.drift_sigma > 0:
            self._log_drift = (s.drift_rho * self._log_drift
                               + self._rng.normal(0.0, s.drift_sigma, M))
            h = h * np.exp(self._log_drift)
        if tr is not None and tr.h_scale is not None:
            h = h * tr.h_scale
        if fm is None:
            return uploaded, present, h, None, None
        # Retransmission: up to max_retries re-attempts, each against a
        # freshly drawn AR(1) channel state. The retry drift rides a
        # transient copy — the next round's channel continues from the
        # attempt-0 state, so retries don't perturb the round-scale AR(1).
        A = fm.n_attempts
        h_att = np.empty((M, A), np.float64)
        h_att[:, 0] = h
        attempts = present.astype(np.int64)
        pending = present & failed
        if tr is not None and tr.lost is not None:
            # Recorded losses are final: the log says that upload never
            # arrived, so retries must not resurrect it.
            pending &= ~tr.lost
        log_d = self._log_drift.copy()
        for k in range(1, A):
            fail_k = np.zeros(M, bool)
            if s.link_failure > 0:
                fail_k = self._rng.random(M) < s.link_failure
            if s.drift_sigma > 0:
                log_d = (s.drift_rho * log_d
                         + self._rng.normal(0.0, s.drift_sigma, M))
                h_att[:, k] = self.pop.h * np.exp(log_d)
            else:
                h_att[:, k] = self.pop.h
            if tr is not None and tr.h_scale is not None:
                h_att[:, k] *= tr.h_scale
            attempts += pending
            uploaded |= pending & ~fail_k
            pending &= fail_k
        return uploaded, present, h, attempts, h_att

    def next_round(self) -> RoundRealization:
        uploaded, present, h, attempts, h_att = self._draw_round()
        return RoundRealization(mask=uploaded, clock_mask=present, h=h,
                                attempts=attempts, h_att=h_att)

    def draw_chunk(self, rounds: int) -> ChunkRealization:
        """Materialize the next `rounds` realizations as stacked (R, M)
        arrays (the chunked driver's per-chunk scenario input).

        Per round the draws are vectorized across clients; across rounds
        the RNG is consumed in the same interleaved order as `next_round`
        (the AR(1) drift recursion is inherently sequential), so
        `draw_chunk(R)` equals R sequential `next_round()` calls bit for
        bit, and advances
        the stream state identically."""
        draws = [self._draw_round() for _ in range(rounds)]
        fault = self._faults is not None
        return ChunkRealization(
            mask=np.stack([d[0] for d in draws]),
            clock_mask=np.stack([d[1] for d in draws]),
            h=np.stack([d[2] for d in draws]),
            attempts=np.stack([d[3] for d in draws]) if fault else None,
            h_att=np.stack([d[4] for d in draws]) if fault else None)


# ---------------------------------------------------------------------------
# Scenario definition
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """A named edge-population scenario (all knobs default to 'off').

    Population knobs (one draw per simulation):
      compute_sigma        lognormal jitter on per-device G_m and f_m
      channel_sigma        lognormal jitter on per-device channel gain h_m
      straggler_frac       fraction of devices in the slow cohort
      straggler_slowdown   f_m divisor for the slow cohort (>1 = slower)
      cell_edge_frac       fraction of devices at the cell edge
      cell_edge_attenuation  h_m multiplier for the cell-edge cohort (<1)

    Per-round knobs (one realization per round):
      dropout        P(client absent this round)         — Bernoulli
      link_failure   P(upload lost | client present)     — Bernoulli
      drift_sigma    AR(1) innovation std of log channel drift
      drift_rho      AR(1) coefficient of the drift (persistence)

    Fault/recovery semantics (deadlines, retransmission with backoff,
    crash/rejoin lifecycle, divergence guards) layer on via `faults`
    (faults.FaultModel); None or an inactive model is bit-identical to
    the plain scenario.
    """

    name: str
    description: str
    compute_sigma: float = 0.0
    channel_sigma: float = 0.0
    straggler_frac: float = 0.0
    straggler_slowdown: float = 1.0
    cell_edge_frac: float = 0.0
    cell_edge_attenuation: float = 1.0
    dropout: float = 0.0
    link_failure: float = 0.0
    drift_sigma: float = 0.0
    drift_rho: float = 0.9
    faults: Optional[FaultModel] = None

    # -- population -------------------------------------------------------
    def population(
        self,
        n_devices: int,
        cc: Optional[ComputeConfig] = None,
        wc: Optional[WirelessConfig] = None,
        seed: int = 0,
    ) -> delay.DevicePopulation:
        """Draw the scenario's device population (Eqs. 3-4 parameters).

        Cohorts (stragglers, cell-edge) are the leading ceil(frac*M)
        devices of the draw — deterministic given the seed, so plans and
        realizations line up across reruns."""
        cc = cc or ComputeConfig()
        wc = wc or WirelessConfig()
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5CE9]))
        G0 = delay.cycles_per_iteration(cc)
        f0 = delay.gpu_frequency(cc)
        jit = lambda sig: np.exp(rng.normal(0.0, sig, n_devices))  # noqa: E731
        G = G0 * (jit(self.compute_sigma) if self.compute_sigma else 1.0)
        f = f0 / (jit(self.compute_sigma) if self.compute_sigma else 1.0)
        h = wc.mean_channel_gain * (
            jit(self.channel_sigma) if self.channel_sigma else 1.0)
        G = np.broadcast_to(np.asarray(G, float), (n_devices,)).copy()
        f = np.broadcast_to(np.asarray(f, float), (n_devices,)).copy()
        h = np.broadcast_to(np.asarray(h, float), (n_devices,)).copy()
        if self.straggler_frac > 0 and self.straggler_slowdown != 1.0:
            k = int(np.ceil(self.straggler_frac * n_devices))
            f[:k] /= self.straggler_slowdown
        if self.cell_edge_frac > 0 and self.cell_edge_attenuation != 1.0:
            k = int(np.ceil(self.cell_edge_frac * n_devices))
            h[:k] *= self.cell_edge_attenuation
        return delay.DevicePopulation(
            G=G, f=f, p=np.full(n_devices, wc.tx_power_w), h=h)

    # -- per-round stream -------------------------------------------------
    def stream(self, pop: delay.DevicePopulation, seed: int = 0,
               cohort_size: Optional[int] = None,
               cohort_weights=None) -> ScenarioStream:
        return ScenarioStream(self, pop, seed, cohort_size=cohort_size,
                              cohort_weights=cohort_weights)

    @property
    def expected_participation(self) -> float:
        """E[fraction of clients whose update arrives] per round.

        With an active FaultModel, retransmission turns one link-failure
        draw into up-to-A independent ones (success 1 - q^A) and the
        crash/rejoin chain caps availability at 1/(1 + crash_rate *
        rejoin_rounds); without one this reduces exactly to the legacy
        (1 - dropout)(1 - link_failure)."""
        fm = self.faults if (self.faults is not None and self.faults.active) \
            else None
        if fm is None:
            return (1.0 - self.dropout) * (1.0 - self.link_failure)
        return (fm.availability() * (1.0 - self.dropout)
                * fm.link_success(self.link_failure))

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get(name: Union[str, Scenario]) -> Scenario:
    if isinstance(name, Scenario):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register(Scenario(
    "uniform",
    "Paper baseline: homogeneous devices, ideal links, full participation.",
))
register(Scenario(
    "stragglers",
    "Compute-skewed: 20% of devices run 4x slower (plus mild lognormal "
    "compute jitter) — the Eq. 5 straggler max binds on the slow cohort.",
    compute_sigma=0.2, straggler_frac=0.2, straggler_slowdown=4.0,
))
register(Scenario(
    "cell_edge",
    "Channel-skewed: 30% of devices sit at the cell edge with ~13 dB "
    "pathloss penalty — the Eq. 7 uplink max binds on the edge cohort.",
    channel_sigma=0.3, cell_edge_frac=0.3, cell_edge_attenuation=0.05,
))
register(Scenario(
    "dropout",
    "Partial participation: per-round Bernoulli absence (30%) and upload "
    "loss (5%) over a mildly heterogeneous population.",
    compute_sigma=0.2, channel_sigma=0.2, dropout=0.3, link_failure=0.05,
))
register(Scenario(
    "drifting",
    "Drifting channel: per-round AR(1) log-drift of every uplink gain "
    "(rho=0.9, sigma=0.2) — T_cm varies round to round.",
    channel_sigma=0.3, drift_sigma=0.2, drift_rho=0.9,
))
register(Scenario(
    "hetero_storm",
    "Everything at once: straggler cohort, cell-edge cohort, dropout, "
    "link failure and channel drift — the stress population.",
    compute_sigma=0.3, channel_sigma=0.3,
    straggler_frac=0.2, straggler_slowdown=3.0,
    cell_edge_frac=0.2, cell_edge_attenuation=0.1,
    dropout=0.2, link_failure=0.05, drift_sigma=0.15, drift_rho=0.9,
))
register(Scenario(
    "unreliable_edge",
    "Production failure semantics: lossy drifting links with up-to-2 "
    "retransmissions (exponential backoff), a 1.5x-nominal round "
    "deadline that cuts stragglers out of aggregation, and a crash/"
    "rejoin lifecycle (5% crash rate, 3-round heartbeat gap) over a "
    "heterogeneous straggler population.",
    compute_sigma=0.25, channel_sigma=0.25,
    straggler_frac=0.2, straggler_slowdown=3.0,
    dropout=0.1, link_failure=0.2, drift_sigma=0.15, drift_rho=0.9,
    faults=FaultModel(deadline_factor=1.5, max_retries=2,
                      backoff_base=0.05, crash_rate=0.05, rejoin_rounds=3),
))


# ---------------------------------------------------------------------------
# DEFL re-planning against the realized population
# ---------------------------------------------------------------------------


def plan_for_scenario(
    fed: FedConfig,
    scenario: Union[str, Scenario],
    update_bits: float,
    cc: Optional[ComputeConfig] = None,
    wc: Optional[WirelessConfig] = None,
    seed: int = 0,
    method: str = "closed_form",
    cohort_size: Optional[int] = None,
    spare: int = 0,
) -> defl.DEFLPlan:
    """Solve Alg. 1 against the scenario's realized population.

    The straggler maxes (Eqs. 5/7) are taken over the drawn population —
    a straggler or cell-edge cohort shifts (b*, theta*) — and expected
    partial participation shrinks the effective M in the Eq. 12 round-
    count model (fewer updates per round average into the global model).
    With `cohort_size=K` (sampled participation) the Eq. 12 effective M
    is based on the K-client cohort instead of the population, while the
    Eq. 5/7 straggler maxes stay population-wide (any client can be
    drawn) — see defl.make_plan.

    A scenario whose FaultModel sets a round deadline re-solves under the
    truncated delay model (defl.deadline_plan): the unconstrained plan is
    solved first, a `deadline_factor` is resolved against its nominal
    round time (one-step fixed point — the Simulator resolves against the
    final fed's own nominal, so a planned spec can differ slightly; pass
    an absolute `deadline` for exact agreement), and (b, V) are re-derived
    over the deadline-feasible region."""
    scenario = get(scenario)
    pop = scenario.population(fed.n_devices, cc, wc, seed)
    plan = defl.make_plan(fed, pop, update_bits, wireless=wc, method=method,
                          participation=scenario.expected_participation,
                          cohort_size=cohort_size)
    fm = scenario.faults
    if fm is not None and fm.active and (
            fm.deadline is not None or fm.deadline_factor is not None):
        D = fm.resolve_deadline(plan.T_round)
        plan = defl.deadline_plan(
            fed, pop, update_bits, D, wireless=wc,
            participation=scenario.expected_participation,
            cohort_size=cohort_size, spare=spare)
    return plan
