"""Trace-driven production scenarios: device classes, state machines,
and deterministic log replay.

The registry scenarios (scenarios.py) describe populations with a handful
of statistical knobs. Production edge fleets are messier: a fleet is a
*mix of device classes* (phones, tablets, battery-less IoT gateways) whose
availability follows time-of-day waves and whose participation is gated by
battery and thermal state machines. This module compiles that behavior
into the existing `ScenarioStream` wire format — per-round masks /
clock-masks / realized gains as stacked (R, M) arrays — via the
`ScenarioStream._trace_round` hook, so trace-driven traffic runs on the
unchanged backends, composes with `FaultModel` retransmission /
crash-rejoin and `CohortSpec` sampling, and checkpoint/resumes
bit-identically (the trace state machines ride the stream snapshot).

Two scenario sources:

  * `TraceScenario` — generative: a tuple of frozen `DeviceClassSpec`s
    (fleet fractions, compute/channel scaling, diurnal availability wave,
    battery and thermal state machines). `TraceStream` advances the
    machines one tick per round, drawing exactly two (M,) vectors per
    round from a dedicated RNG stream (SeedSequence tag 0x7ACE) — the
    shared scenario RNG is never touched, so the dropout/link-failure/
    drift draws stay bit-identical to a plain scenario at the same seed.

  * `ReplayScenario` + `TraceSpec` — replay: a recorded JSONL device-state
    log (one object per round: present ids, lost ids, optional per-device
    channel scale; optional leading meta line with fleet size and
    per-device compute/channel scales) replayed deterministically — no
    randomness at all beyond the base scenario knobs, which default off.

`record_trace` closes the loop: run any scenario's stream, serialize what
happened to JSONL, and replay it later (recorded == replayed masks bit for
bit).

Copy of repro/federated/traces.py (numpy only, the reference's RNG calls
in its order and its error messages word for word;
tests/test_torch_traces.py holds the draws, snapshots and recorded files
equal to the reference's). The parse cache of `_load_trace` is this
module's own: only this module's `write_trace` clears it.
"""
from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import ComputeConfig, WirelessConfig
from repro_torch.core import delay
from repro_torch.federated.scenarios import (
    Scenario, ScenarioStream, TraceRound, register,
)

_TWO_PI = 2.0 * np.pi
_TRACE_TAG = 0x7ACE  # SeedSequence stream tag for trace state machines


# ---------------------------------------------------------------------------
# Device classes (generative traces)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceClassSpec:
    """One device class in a trace-driven fleet.

    Fleet composition / hardware:
      frac            fraction of the fleet in this class (normalized
                      across classes; devices are the leading blocks of
                      the population, mirroring scenario cohorts)
      compute_scale   slowdown on the compute slope G/f (>1 = slower);
                      applied as an f divisor so Eq. 3 sees it directly
      channel_scale   multiplier on the mean channel gain h (<1 = worse)
      compute_sigma   per-device lognormal jitter on the compute slope
      channel_sigma   per-device lognormal jitter on the channel gain

    Diurnal availability wave (time-of-day t in [0, 1), 0 = midnight):
      avail_base      mean P(device wants to participate)
      avail_amp       wave amplitude: avail = base + amp*sin(2pi(t-phase))
      avail_phase     phase offset in fractions of a day

    Battery state machine (charge in [0, 1], per-round deltas):
      battery_drain       charge burned by a round of training
      battery_idle_drain  charge burned idling
      battery_charge      charge gained per round while plugged in
      battery_min         participation cutoff (device sits out below it)
      plug_day/plug_night P(plugged in) at solar noon / midnight
                          (interpolated through the day)

    Thermal state machine (heat in [0, 1]):
      heat_per_round   heat added by a round of training
      cool_per_round   passive cooling per round
      thermal_limit    participation cutoff (device throttles above it)

    Battery-less mains devices: battery_min=0, heat_per_round=0.
    """

    name: str
    frac: float
    compute_scale: float = 1.0
    channel_scale: float = 1.0
    compute_sigma: float = 0.0
    channel_sigma: float = 0.0
    avail_base: float = 0.9
    avail_amp: float = 0.0
    avail_phase: float = 0.0
    battery_drain: float = 0.01
    battery_idle_drain: float = 0.001
    battery_charge: float = 0.05
    battery_min: float = 0.2
    plug_day: float = 0.05
    plug_night: float = 0.6
    heat_per_round: float = 0.0
    cool_per_round: float = 0.05
    thermal_limit: float = 0.8

    def __post_init__(self):
        if not self.frac > 0:
            raise ValueError(f"class {self.name!r}: frac must be > 0, "
                             f"got {self.frac}")
        if not (self.compute_scale > 0 and self.channel_scale > 0):
            raise ValueError(f"class {self.name!r}: compute_scale and "
                             "channel_scale must be > 0")
        for knob in ("avail_base", "battery_min", "plug_day", "plug_night",
                     "thermal_limit"):
            v = getattr(self, knob)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"class {self.name!r}: {knob} must be in [0, 1], got {v}")


PHONE = DeviceClassSpec(
    "phone", frac=0.6,
    compute_sigma=0.15, channel_sigma=0.2,
    avail_base=0.75, avail_amp=0.2, avail_phase=0.3,
    battery_drain=0.02, battery_idle_drain=0.002, battery_charge=0.06,
    battery_min=0.2, plug_day=0.1, plug_night=0.8,
    heat_per_round=0.08, cool_per_round=0.05, thermal_limit=0.85)
TABLET = DeviceClassSpec(
    "tablet", frac=0.25,
    compute_scale=1.6, compute_sigma=0.15, channel_sigma=0.2,
    avail_base=0.6, avail_amp=0.3, avail_phase=0.45,
    battery_drain=0.015, battery_idle_drain=0.001, battery_charge=0.08,
    battery_min=0.15, plug_day=0.2, plug_night=0.7,
    heat_per_round=0.05, cool_per_round=0.06, thermal_limit=0.9)
IOT = DeviceClassSpec(
    "iot", frac=0.15,
    compute_scale=4.0, channel_scale=0.3, channel_sigma=0.3,
    avail_base=0.95,  # mains-powered gateway: always on, no battery/heat
    battery_min=0.0, battery_drain=0.0, battery_idle_drain=0.0,
    heat_per_round=0.0)


@dataclass(frozen=True)
class TraceScenario(Scenario):
    """Generative trace scenario: a device-class fleet with per-round
    battery/thermal/diurnal state machines layered over the base
    Scenario's per-round knobs (dropout/link_failure/drift/faults all
    still apply — the trace overlay gates *presence* and scales the
    channel; the base knobs keep drawing from the shared RNG exactly as
    a plain scenario would).

      classes        fleet composition (fracs normalized)
      round_seconds  wall-clock seconds one FL round represents — with
                     day_seconds this sets how fast the diurnal wave
                     sweeps (86400/round_seconds rounds per day)
      start_frac     time of day at round 0 (0 = midnight, 0.5 = noon)
      battery_init   uniform initial-charge range at stream start
    """

    classes: Tuple[DeviceClassSpec, ...] = (PHONE, TABLET, IOT)
    round_seconds: float = 1800.0
    day_seconds: float = 86400.0
    start_frac: float = 0.0
    battery_init: Tuple[float, float] = (0.5, 1.0)

    def __post_init__(self):
        if not self.classes:
            raise ValueError("TraceScenario needs at least one DeviceClassSpec")
        if not (self.round_seconds > 0 and self.day_seconds > 0):
            raise ValueError("round_seconds and day_seconds must be > 0")
        lo, hi = self.battery_init
        if not 0.0 <= lo <= hi <= 1.0:
            raise ValueError(f"battery_init must be 0 <= lo <= hi <= 1, "
                             f"got {self.battery_init}")

    # -- fleet layout -------------------------------------------------------
    def class_fracs(self) -> np.ndarray:
        f = np.asarray([c.frac for c in self.classes], float)
        return f / f.sum()

    def class_index(self, n_devices: int) -> np.ndarray:
        """(M,) int class assignment: leading contiguous blocks sized by
        largest-remainder apportionment of the normalized fracs —
        deterministic, and every class with frac > 0 gets at least the
        rounding it earns (ties go to the earlier class)."""
        fr = self.class_fracs() * n_devices
        counts = np.floor(fr).astype(int)
        rem = n_devices - counts.sum()
        if rem > 0:
            order = np.argsort(-(fr - counts), kind="stable")
            counts[order[:rem]] += 1
        return np.repeat(np.arange(len(self.classes)), counts)

    # -- population ---------------------------------------------------------
    def population(self, n_devices, cc=None, wc=None, seed: int = 0):
        """Per-class scaled draw of (G, f, p, h): class compute_scale
        divides f (so the Eq. 3 slope G/f scales up), channel_scale
        multiplies h, and per-class lognormal jitter rides a dedicated
        RNG stream (tag 0x7C1A) — the base Scenario population draw is
        not consulted, so the base statistical knobs stay zero here."""
        cc = cc or ComputeConfig()
        wc = wc or WirelessConfig()
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7C1A]))
        G0 = delay.cycles_per_iteration(cc)
        f0 = delay.gpu_frequency(cc)
        cls = self.class_index(n_devices)
        c_scale = np.asarray([c.compute_scale for c in self.classes])[cls]
        h_scale = np.asarray([c.channel_scale for c in self.classes])[cls]
        c_sig = np.asarray([c.compute_sigma for c in self.classes])[cls]
        h_sig = np.asarray([c.channel_sigma for c in self.classes])[cls]
        c_jit = np.exp(rng.normal(0.0, 1.0, n_devices) * c_sig)
        h_jit = np.exp(rng.normal(0.0, 1.0, n_devices) * h_sig)
        G = np.full(n_devices, G0, float)
        f = f0 / (c_scale * c_jit)
        h = wc.mean_channel_gain * h_scale * h_jit
        return delay.DevicePopulation(
            G=G, f=f, p=np.full(n_devices, wc.tx_power_w), h=h)

    # -- stream -------------------------------------------------------------
    def stream(self, pop, seed: int = 0, cohort_size=None,
               cohort_weights=None) -> "TraceStream":
        return TraceStream(self, pop, seed, cohort_size=cohort_size,
                           cohort_weights=cohort_weights)

    @property
    def expected_participation(self) -> float:
        """Mean-field estimate: the class-frac-weighted mean availability
        (the diurnal wave averages out over a day) times the base
        scenario's dropout/link/fault factor. The battery/thermal gates
        shave this further when drain outruns charging; the planner's
        rolling estimates (planner.PlannerService) observe the realized
        rate instead of trusting this prior."""
        avail = float(np.dot(self.class_fracs(),
                             [c.avail_base for c in self.classes]))
        return avail * super().expected_participation


class TraceStream(ScenarioStream):
    """ScenarioStream whose `_trace_round` overlay runs the device-class
    state machines.

    Wire-format contract: exactly two (M,) uniform vectors per round from
    the dedicated trace RNG (availability intent, plugged-in), in that
    order — so `draw_chunk(R)` == R `next_round()` calls bit for bit, and
    the shared scenario RNG sequence is untouched (a TraceScenario with
    trace machinery disabled would draw identically to a plain Scenario).
    The battery/thermal vectors, tick counter, and trace RNG state ride
    the `state()` snapshot for bit-identical checkpoint/resume.
    """

    def __init__(self, scenario: TraceScenario, pop, seed: int = 0,
                 cohort_size=None, cohort_weights=None):
        super().__init__(scenario, pop, seed, cohort_size=cohort_size,
                         cohort_weights=cohort_weights)
        cls = scenario.class_index(pop.n)

        def per_dev(attr):
            return np.asarray(
                [getattr(c, attr) for c in scenario.classes], float)[cls]

        self._avail_base = per_dev("avail_base")
        self._avail_amp = per_dev("avail_amp")
        self._avail_phase = per_dev("avail_phase")
        self._b_drain = per_dev("battery_drain")
        self._b_idle = per_dev("battery_idle_drain")
        self._b_charge = per_dev("battery_charge")
        self._b_min = per_dev("battery_min")
        self._plug_day = per_dev("plug_day")
        self._plug_night = per_dev("plug_night")
        self._heat = per_dev("heat_per_round")
        self._cool = per_dev("cool_per_round")
        self._t_limit = per_dev("thermal_limit")
        self._reset_trace()

    def _reset_trace(self) -> None:
        """(Re-)initialize the state machines as at stream construction:
        fresh trace RNG, uniform initial battery draw, cold devices."""
        self._trace_rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, _TRACE_TAG]))
        lo, hi = self.scenario.battery_init
        self._battery = lo + (hi - lo) * self._trace_rng.random(self.pop.n)
        self._thermal = np.zeros(self.pop.n)
        self._tick = 0

    # -- snapshot / restore -------------------------------------------------
    def state(self) -> dict:
        s = super().state()
        s["trace"] = {"rng": self._trace_rng.bit_generator.state,
                      "battery": self._battery.copy(),
                      "thermal": self._thermal.copy(),
                      "tick": self._tick}
        return s

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        tr = state.get("trace")
        if tr is None:  # snapshot from a non-trace stream: start fresh
            self._reset_trace()
            return
        self._trace_rng.bit_generator.state = tr["rng"]
        self._battery = np.asarray(tr["battery"], float).copy()
        self._thermal = np.asarray(tr["thermal"], float).copy()
        self._tick = int(tr["tick"])

    # -- the overlay --------------------------------------------------------
    def _trace_round(self) -> TraceRound:
        sc: TraceScenario = self.scenario
        M = self.pop.n
        t = (sc.start_frac
             + self._tick * sc.round_seconds / sc.day_seconds) % 1.0
        # daylight in [0, 1]: 0 at midnight, 1 at solar noon
        day = 0.5 * (1.0 - np.cos(_TWO_PI * t))
        avail = np.clip(
            self._avail_base
            + self._avail_amp * np.sin(_TWO_PI * (t - self._avail_phase)),
            0.0, 1.0)
        wants = self._trace_rng.random(M) < avail          # draw 1 of 2
        plug_p = self._plug_night + (self._plug_day - self._plug_night) * day
        plugged = self._trace_rng.random(M) < plug_p       # draw 2 of 2
        healthy = (self._battery >= self._b_min) & \
                  (self._thermal <= self._t_limit)
        present = wants & healthy
        # advance the machines: training drains and heats, idling sips,
        # plugged-in devices charge, everyone cools a little
        drain = np.where(present, self._b_drain, self._b_idle)
        self._battery = np.clip(
            self._battery + np.where(plugged, self._b_charge, 0.0) - drain,
            0.0, 1.0)
        self._thermal = np.clip(
            self._thermal + np.where(present, self._heat, 0.0) - self._cool,
            0.0, 1.0)
        self._tick += 1
        return TraceRound(present=present)


# ---------------------------------------------------------------------------
# JSONL trace replay
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceSpec:
    """A recorded device-state log to replay deterministically.

    path    JSONL file. Optional first line {"meta": {...}} with
            "devices" (fleet size, validated against the run) and
            optional per-device "compute_scale"/"channel_scale" lists
            (applied to the replay population). Every other line is one
            round: {"present": [ids], "lost": [ids], "h_scale": [M
            floats]} — "lost" and "h_scale" optional.
    on_end  what to do when the run outlives the log:
            'cycle' (wrap around), 'hold' (repeat the last round), or
            'error' (raise — the run must fit the log).
    """

    path: str
    on_end: str = "cycle"

    def __post_init__(self):
        if self.on_end not in ("cycle", "hold", "error"):
            raise ValueError(
                f"TraceSpec.on_end must be 'cycle', 'hold' or 'error', "
                f"got {self.on_end!r}")

    @property
    def name(self) -> str:
        base = os.path.basename(self.path)
        return f"trace:{base}"


def write_trace(path: str, rounds, meta: Optional[dict] = None) -> None:
    """Serialize per-round records (dicts in TraceSpec schema) to JSONL,
    with an optional leading meta line."""
    with open(path, "w") as fh:
        if meta is not None:
            fh.write(json.dumps({"meta": meta}) + "\n")
        for rec in rounds:
            fh.write(json.dumps(rec) + "\n")
    _load_trace.cache_clear()


@functools.lru_cache(maxsize=32)
def _load_trace(path: str):
    """Parse a JSONL trace once per path: (meta dict, tuple of records)."""
    meta, records = {}, []
    with open(path) as fh:
        for ln, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "meta" in obj:
                if records or meta:
                    raise ValueError(
                        f"{path}:{ln + 1}: meta must be the first line")
                meta = dict(obj["meta"])
                continue
            if "present" not in obj:
                raise ValueError(
                    f"{path}:{ln + 1}: round record needs a 'present' list")
            records.append(obj)
    if not records:
        raise ValueError(f"{path}: trace has no round records")
    return meta, tuple(records)


@dataclass(frozen=True)
class ReplayScenario(Scenario):
    """Scenario that replays a recorded JSONL trace through the stream
    overlay. The base per-round knobs default off, so the replay is fully
    deterministic (no RNG draws consumed); setting them (or faults)
    layers fresh stochastic behavior over the recorded masks — e.g.
    replaying production presence under a synthetic crash model."""

    trace: Optional[TraceSpec] = None

    def __post_init__(self):
        if self.trace is None:
            raise ValueError("ReplayScenario requires a TraceSpec")

    def _meta(self) -> dict:
        return _load_trace(self.trace.path)[0]

    def population(self, n_devices, cc=None, wc=None, seed: int = 0):
        """Base scenario draw, then the meta per-device compute/channel
        scales (if recorded). compute_scale divides f — only the Eq. 3
        slope G/f is observable in the delay model, so scaling f
        reproduces recorded slopes exactly."""
        meta = self._meta()
        rec_m = meta.get("devices")
        if rec_m is not None and int(rec_m) != int(n_devices):
            raise ValueError(
                f"trace {self.trace.path!r} records {rec_m} devices but the "
                f"run asks for {n_devices} (fields n_devices, trace)")
        pop = super().population(n_devices, cc, wc, seed)
        cs = meta.get("compute_scale")
        hs = meta.get("channel_scale")
        f, h = pop.f, pop.h
        if cs is not None:
            f = f / np.asarray(cs, float)
        if hs is not None:
            h = h * np.asarray(hs, float)
        return delay.DevicePopulation(G=pop.G, f=f, p=pop.p, h=h)

    def stream(self, pop, seed: int = 0, cohort_size=None,
               cohort_weights=None) -> "ReplayStream":
        return ReplayStream(self, pop, seed, cohort_size=cohort_size,
                            cohort_weights=cohort_weights)

    @property
    def expected_participation(self) -> float:
        """Empirical: mean fraction of devices whose update arrived per
        recorded round (falls back to the base estimate if the meta has
        no fleet size), times the base dropout/link/fault factor."""
        meta, records = _load_trace(self.trace.path)
        m = meta.get("devices")
        base = super().expected_participation
        if m is None:
            return base
        arrived = [len(set(r["present"]) - set(r.get("lost", ())))
                   for r in records]
        return float(np.mean(arrived) / float(m)) * base


class ReplayStream(ScenarioStream):
    """Replays the recorded per-round present/lost/h_scale overlay.

    Consumes no randomness: the cursor is the only state, carried in the
    `state()` snapshot, so checkpoint/resume lands on the exact recorded
    round it left."""

    def __init__(self, scenario: ReplayScenario, pop, seed: int = 0,
                 cohort_size=None, cohort_weights=None):
        super().__init__(scenario, pop, seed, cohort_size=cohort_size,
                         cohort_weights=cohort_weights)
        meta, self._records = _load_trace(scenario.trace.path)
        rec_m = meta.get("devices")
        if rec_m is not None and int(rec_m) != pop.n:
            raise ValueError(
                f"trace {scenario.trace.path!r} records {rec_m} devices but "
                f"the population has {pop.n}")
        self._cursor = 0

    def state(self) -> dict:
        s = super().state()
        s["replay_cursor"] = self._cursor
        return s

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        self._cursor = int(state.get("replay_cursor", 0))

    def _ids_to_mask(self, ids, what: str) -> np.ndarray:
        mask = np.zeros(self.pop.n, bool)
        idx = np.asarray(ids, int)
        if idx.size and (idx.min() < 0 or idx.max() >= self.pop.n):
            raise ValueError(
                f"trace round {self._cursor}: {what} id out of range "
                f"[0, {self.pop.n})")
        mask[idx] = True
        return mask

    def _trace_round(self) -> TraceRound:
        n = len(self._records)
        i = self._cursor
        if i >= n:
            mode = self.scenario.trace.on_end
            if mode == "error":
                raise RuntimeError(
                    f"trace {self.scenario.trace.path!r} exhausted after "
                    f"{n} rounds (on_end='error')")
            i = i % n if mode == "cycle" else n - 1
        rec = self._records[i]
        present = self._ids_to_mask(rec["present"], "present")
        lost = (self._ids_to_mask(rec["lost"], "lost")
                if rec.get("lost") else None)
        h_scale = None
        if rec.get("h_scale") is not None:
            h_scale = np.asarray(rec["h_scale"], float)
            if h_scale.shape != (self.pop.n,):
                raise ValueError(
                    f"trace round {self._cursor}: h_scale must have "
                    f"{self.pop.n} entries, got {h_scale.shape}")
        self._cursor += 1
        return TraceRound(present=present, lost=lost, h_scale=h_scale)


def replay_scenario(spec: TraceSpec, name: Optional[str] = None,
                    **scenario_kw) -> ReplayScenario:
    """Build a ReplayScenario for a TraceSpec (extra Scenario knobs — e.g.
    faults — pass through)."""
    return ReplayScenario(
        name=name or spec.name,
        description=f"deterministic replay of {spec.path}",
        trace=spec, **scenario_kw)


def record_trace(scenario, n_devices: int, rounds: int, path: str,
                 seed: int = 0, cc: Optional[ComputeConfig] = None,
                 wc: Optional[WirelessConfig] = None) -> TraceSpec:
    """Run `scenario`'s stream for `rounds` and serialize what happened as
    a replayable JSONL trace: per-round present/lost ids and the realized
    channel as a scale relative to the drawn population, plus a meta line
    with the fleet size and per-device compute/channel scales relative to
    the nominal homogeneous device — so a fresh `ReplayScenario` (whose
    base population is homogeneous) reproduces the recorded compute
    slopes exactly and the recorded masks bit for bit."""
    from repro_torch.federated import scenarios as _scenarios
    scenario = _scenarios.get(scenario)
    cc = cc or ComputeConfig()
    wc = wc or WirelessConfig()
    pop = scenario.population(n_devices, cc, wc, seed)
    stream = scenario.stream(pop, seed)
    G0 = delay.cycles_per_iteration(cc)
    f0 = delay.gpu_frequency(cc)
    slope0 = G0 / f0
    meta = {
        "devices": int(n_devices),
        "source": getattr(scenario, "name", "scenario"),
        "seed": int(seed),
        "compute_scale": ((pop.G / pop.f) / slope0).tolist(),
        "channel_scale": (pop.h / wc.mean_channel_gain).tolist(),
    }
    recs = []
    for _ in range(rounds):
        r = stream.next_round()
        present = np.flatnonzero(r.clock_mask)
        lost = np.flatnonzero(r.clock_mask & ~r.mask)
        rec = {"present": present.tolist()}
        if lost.size:
            rec["lost"] = lost.tolist()
        if not np.array_equal(r.h, pop.h):
            rec["h_scale"] = (r.h / pop.h).tolist()
        recs.append(rec)
    write_trace(path, recs, meta=meta)
    return TraceSpec(path=path)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

register(TraceScenario(
    "diurnal_edge",
    "Trace-driven production fleet: 60% phones / 25% tablets / 15% IoT "
    "gateways with per-class compute/channel scaling, diurnal "
    "availability waves, battery + thermal participation gates "
    "(30-minute rounds), over mildly lossy drifting links.",
    classes=(PHONE, TABLET, IOT),
    round_seconds=1800.0, start_frac=0.375,  # round 0 at 09:00
    link_failure=0.05, drift_sigma=0.1, drift_rho=0.9,
))
