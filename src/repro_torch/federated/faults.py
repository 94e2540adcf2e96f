"""Fault-injection & recovery layer: the production failure semantics the
paper's model stops short of. Copy of repro/federated/faults.py (numpy
only; tests/test_torch_faults.py holds it equal to the reference).

The paper motivates DEFL with "unreliable network connections", but the
scenario engine's failure model ends at per-round Bernoulli masks — a
failed uplink costs nothing and a straggler can stall the Eq. 8 clock
unboundedly. A `FaultModel` layers the missing production behaviors on a
`Scenario` (scenarios.Scenario.faults) without leaving the chunked driver:

  round deadlines    the server truncates every round at `deadline`
                     seconds (or `deadline_factor` x the nominal full-
                     population Eq. 8 round time, resolved at Simulator
                     build). Clients whose V*t_cp + effective-uplink time
                     exceeds it are excluded from aggregation exactly like
                     dropouts (participation-renormalized), and the Eq. 8
                     clock becomes min(deadline, masked straggler max).
  retransmission     a failed uplink re-attempts up to `max_retries`
                     times with exponential backoff (`backoff_base` *
                     `backoff_factor`**(k-1) wait before attempt k), each
                     attempt against a freshly drawn AR(1) channel state.
                     Every attempt's airtime and bits are accounted: a
                     client's effective uplink time is the SUM of its
                     attempt times plus backoff waits, and uplink_bits
                     counts attempts x bits-per-update. Exhausted retries
                     = dropped this round.
  crash/rejoin       a per-client lifecycle state machine: an alive
                     client crashes with `crash_rate` per round and stays
                     down (absent from mask AND clock_mask — the server's
                     heartbeat timeout knows not to wait) for
                     `rejoin_rounds` rounds before rejoining. Crash
                     epochs span rounds: the down-counters ride in
                     ScenarioStream.state() so checkpoint/resume
                     continues an epoch bit-identically.
  quorum gating      a round whose post-dropout/deadline/guard
                     participation falls below `min_quorum` (an absolute
                     count, or a fraction of the cohort) is resolved
                     on the device by `quorum_policy`: 'reject' makes the
                     params/opt writes a no-op (the round never happened
                     to the model) while the Eq. 8 clock still pays the
                     failed round's wall time plus `redispatch_cost`
                     seconds of re-dispatch overhead; 'accept' merely
                     counts the violation (`RoundRecord.rejected`).
  divergence guards  per-client update sanitation at aggregation, on the
                     device (mesh_rounds.build_round_step(guard=...)): non-finite
                     updates/losses are rejected (client dropped that
                     round) and update norms clipped at
                     `max_update_norm`; plus a run()-level guard that
                     snapshots the pre-chunk state and raises a
                     structured `DivergenceError` carrying the last-good
                     SimState instead of silently producing NaN history.

The host-side draws feed the chunked driver as per-round tensors (one
upload a chunk), and a disabled FaultModel (`active == False`) is
bit-identical to not having one: the fault draws are gated per knob, so
the scenario RNG stream, the round step and the clock accounting are
untouched.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class FaultModel:
    """Failure/recovery knobs layered on a Scenario (all default 'off').

    deadline          server-side round deadline, simulated seconds.
    deadline_factor   alternative to `deadline`: the deadline as a
                      multiple of the nominal full-population Eq. 8 round
                      time (T_cm + V*T_cp at the resolved FedConfig) —
                      portable across models/populations; the Simulator
                      resolves it to seconds at build.
    max_retries       uplink re-attempts after a failed transmission.
    backoff_base      wait before the first retry, seconds.
    backoff_factor    exponential backoff multiplier per further retry.
    crash_rate        P(alive client crashes) per round.
    rejoin_rounds     heartbeat-timeout gap: rounds a crashed client
                      stays down before rejoining.
    reject_nonfinite  guard: drop clients whose update or loss is
                      non-finite (on whenever the model is active).
    max_update_norm   guard: clip each client's update to this L2 norm
                      before aggregation (None = no clipping).
    divergence_guard  run()-level guard: snapshot state per chunk and
                      raise DivergenceError on a non-finite round loss
                      with participants, instead of a NaN history.
    min_quorum        quorum gate: the minimum participation a round
                      needs to count. An int is an absolute client
                      count; a float in (0, 1] is a fraction of the
                      cohort (resolved with ceil at Simulator build —
                      `resolve_quorum`). None = no gate.
    quorum_policy     what a below-quorum round does: 'reject' no-ops
                      the params/opt update (clock still pays
                      the round plus `redispatch_cost`); 'accept' keeps
                      the update and only counts the violation.
    redispatch_cost   extra simulated seconds a rejected round costs on
                      top of its wall time (server re-dispatch overhead;
                      'reject' policy only).
    """

    deadline: Optional[float] = None
    deadline_factor: Optional[float] = None
    max_retries: int = 0
    backoff_base: float = 0.0
    backoff_factor: float = 2.0
    crash_rate: float = 0.0
    rejoin_rounds: int = 1
    reject_nonfinite: bool = True
    max_update_norm: Optional[float] = None
    divergence_guard: bool = True
    min_quorum: Optional[float] = None  # int count | float fraction
    quorum_policy: str = "reject"
    redispatch_cost: float = 0.0

    @property
    def active(self) -> bool:
        """False == disabled == bit-identical to no FaultModel at all."""
        return bool(self.deadline is not None
                    or self.deadline_factor is not None
                    or self.max_retries > 0
                    or self.crash_rate > 0
                    or self.max_update_norm is not None
                    or self.min_quorum is not None)

    @property
    def n_attempts(self) -> int:
        """Attempt-axis length A of a realization (first try + retries)."""
        return 1 + int(self.max_retries)

    def validate(self) -> None:
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {self.deadline}")
        if self.deadline_factor is not None and self.deadline_factor <= 0:
            raise ValueError(
                f"deadline_factor must be > 0, got {self.deadline_factor}")
        if self.deadline is not None and self.deadline_factor is not None:
            raise ValueError(
                "set deadline (seconds) OR deadline_factor (x nominal "
                "round time), not both")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base < 0:
            raise ValueError(
                f"backoff_base must be >= 0, got {self.backoff_base}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")
        if not 0.0 <= self.crash_rate < 1.0:
            raise ValueError(
                f"crash_rate must be in [0, 1), got {self.crash_rate}")
        if self.rejoin_rounds < 1:
            raise ValueError(
                f"rejoin_rounds must be >= 1, got {self.rejoin_rounds}")
        if self.max_update_norm is not None and self.max_update_norm <= 0:
            raise ValueError(
                f"max_update_norm must be > 0, got {self.max_update_norm}")
        if self.min_quorum is not None:
            q = self.min_quorum
            if isinstance(q, bool) or not isinstance(
                    q, (int, float, np.integer, np.floating)):
                raise ValueError(
                    f"min_quorum must be an int count or a float fraction, "
                    f"got {q!r}")
            if isinstance(q, (int, np.integer)):
                if q < 1:
                    raise ValueError(
                        f"min_quorum as a count must be >= 1, got {q}")
            elif not 0.0 < q <= 1.0:
                raise ValueError(
                    f"min_quorum as a fraction must be in (0, 1], got {q}")
        if self.quorum_policy not in ("reject", "accept"):
            raise ValueError(
                f"unknown quorum_policy {self.quorum_policy!r}; "
                "expected 'reject' or 'accept'")
        if self.redispatch_cost < 0:
            raise ValueError(
                f"redispatch_cost must be >= 0, got {self.redispatch_cost}")

    def resolve_deadline(self, nominal_round_time: float) -> Optional[float]:
        """The deadline in seconds, resolving `deadline_factor` against
        the caller's nominal (full-population, fault-free) Eq. 8 round
        time. None when no deadline is configured."""
        if self.deadline is not None:
            return float(self.deadline)
        if self.deadline_factor is not None:
            return float(self.deadline_factor * nominal_round_time)
        return None

    def resolve_quorum(self, cohort_size: int) -> Optional[int]:
        """The quorum as an absolute client count for a `cohort_size`-
        client round (K when sampled, M dense). Fractions resolve with
        ceil, floored at 1; None when no quorum is configured."""
        if self.min_quorum is None:
            return None
        q = self.min_quorum
        if isinstance(q, (int, np.integer)):
            q_abs = int(q)
        else:
            q_abs = max(1, int(np.ceil(float(q) * cohort_size)))
        if q_abs > cohort_size:
            raise ValueError(
                f"min_quorum {q!r} resolves to {q_abs} clients but rounds "
                f"have only {cohort_size} — no round could ever pass")
        return q_abs

    def guard_spec(self) -> tuple:
        """Static (max_norm, reject_nonfinite) pair built into the
        round step's sanitation path (mesh_rounds.build_round_step's
        `guard` argument)."""
        max_norm = (float(self.max_update_norm)
                    if self.max_update_norm is not None else float("inf"))
        return (max_norm, bool(self.reject_nonfinite))

    def link_success(self, link_failure: float) -> float:
        """P(an upload eventually lands | client present): retries turn
        one Bernoulli failure draw into A independent ones."""
        return float(1.0 - link_failure ** self.n_attempts)

    def availability(self) -> float:
        """Stationary P(client not in a crash epoch): the alive/down
        Markov chain spends 1/crash_rate rounds up per `rejoin_rounds`
        down, so uptime = 1 / (1 + crash_rate * rejoin_rounds)."""
        return float(1.0 / (1.0 + self.crash_rate * self.rejoin_rounds))

    def backoff_waits(self, attempts) -> np.ndarray:
        """Total backoff wait (seconds) for clients that made `attempts`
        tries: sum_{k=1}^{a-1} backoff_base * backoff_factor**(k-1)."""
        attempts = np.asarray(attempts)
        if self.backoff_base == 0.0 or self.max_retries == 0:
            return np.zeros(attempts.shape, np.float64)
        k = np.arange(1, self.n_attempts)
        waits = self.backoff_base * self.backoff_factor ** (k - 1.0)
        used = k[..., :] < attempts[..., None]
        return np.where(used, waits, 0.0).sum(axis=-1)

    def replace(self, **kw) -> "FaultModel":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RecoveryPolicy:
    """Auto-recovery from divergence, consumed by
    `Simulator.run(recovery=...)`: on a `DivergenceError` the run rewinds
    to the carried last-good SimState, deterministically shrinks the
    learning rate by `lr_backoff` (cumulative across restarts), optionally
    tightens the norm guard by `tighten_guard` (multiplies the model's
    `max_update_norm`; a no-op when none is set), and re-runs — at most
    `max_restarts` times before the error propagates. Every restart is
    recorded in `SimResult.restarts` (attempt, round, lr scale, guard,
    message) so recovered runs stay auditable."""

    max_restarts: int = 3
    lr_backoff: float = 0.5
    tighten_guard: Optional[float] = None

    def validate(self) -> None:
        if self.max_restarts < 1:
            raise ValueError(
                f"max_restarts must be >= 1, got {self.max_restarts}")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError(
                f"lr_backoff must be in (0, 1], got {self.lr_backoff}")
        if self.tighten_guard is not None and not (
                0.0 < self.tighten_guard <= 1.0):
            raise ValueError(
                f"tighten_guard must be in (0, 1], got {self.tighten_guard}")


class DivergenceError(RuntimeError):
    """Raised by Simulator.run() (divergence_guard on) when a round's
    train loss goes non-finite with participants — e.g. the guard's
    non-finite rejection was disabled, or the aggregate itself diverged.

    Carries enough to recover instead of rerunning from scratch:
      state        the last-good SimState host snapshot (taken at the
                   chunk / eval boundary BEFORE the offending rounds) —
                   resumable via Simulator.run(state, ...)
      history      RoundRecords up to and including the offending round
      round        global round number where the loss went non-finite
      faults       the run's FaultModel (None on guard-less sims)
      guard        the (max_norm, reject_nonfinite) guard spec in
                   effect, or None
      finite_mask  (C,) bool per-client finite-loss mask of the offending
                   round (which clients' local losses were still finite) —
                   distinguishes "one client NaN'd" from "global blow-up"
                   without a re-run.
    """

    def __init__(self, message: str, state=None, history=None,
                 round: int = -1, faults=None, guard=None,
                 finite_mask=None):
        super().__init__(message)
        self.state = state
        self.history = list(history) if history is not None else []
        self.round = int(round)
        self.faults = faults
        self.guard = guard
        self.finite_mask = (None if finite_mask is None
                            else np.asarray(finite_mask, bool))
