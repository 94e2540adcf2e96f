"""Host-level FL simulator: Algorithm 1 with the paper's delay accounting.

Runs real training (PyTorch, on the card) while advancing a *simulated*
wall clock from the paper's delay models (Eqs. 5, 7, 8). Port of the
reference's `Simulator` (repro/federated/simulation.py) for a dense
population on its chunked ('scan') driver, with its edge scenarios
(federated/scenarios.py) and fault layer (federated/faults.py):

    sim   = Simulator(loss_fn, params, data_factory, sizes, fed, opt, pop,
                      scenario="unreliable_edge")
    state = sim.init(seed)
    state, result  = sim.run(state, max_rounds=100, eval_every=10,
                             recovery=RecoveryPolicy())
    state, records = sim.run_chunk(state, rounds=10)
    fleet = sim.run_fleet(seeds=range(8), max_rounds=100, eval_every=10)

A chunk of `eval_every` rounds runs on the device with no host
synchronisation inside: the batch indices of the whole chunk go up in one
transfer, batches are gathered on the device from the dataset uploaded
once, and the per-round train losses come back in one fetch per chunk.
The Eq. 8 clock and the uplink bits come from the float64 host model
(core/delay.py), exactly as the reference's records do. Under a scenario
each chunk also uploads the (R, S*C) participation masks its host stream
drew, and fetches the participant counts, quorum flags and per-client
finite flags of its rounds with the losses.

All run state lives in an immutable `SimState`; the methods are
state-in/state-out and never modify a state's tensors in place.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, WirelessConfig
from repro_torch.core import delay
from repro_torch.device import resolve_device
from repro_torch.federated import compression, mesh_rounds, scenarios
from repro_torch.federated.client import stack_chunk_indices
from repro_torch.federated.faults import (DivergenceError, FaultModel,
                                          RecoveryPolicy)
from repro_torch.kernels.quantize.ref import stochastic_noise
from repro_torch.optim.api import Optimizer
from repro_torch.utils.tree import leaves, tree_bytes, tree_map


@dataclass
class RoundRecord:
    round: int
    sim_time: float  # cumulative simulated seconds (Eq. 8 accumulated)
    T_cm: float
    T_cp: float
    train_loss: float
    # Total uplink bits the round carried (clients x bits per update,
    # exact compression.compressed_bits accounting when compressing).
    uplink_bits: float
    test_acc: Optional[float] = None
    # NaN when the eval hook reports no loss (ExperimentSpec's reports
    # accuracy only, as the reference's does).
    test_loss: Optional[float] = None
    # Scenario rounds: the client updates that reached the aggregator
    # (after the guard's rejections); None without a scenario (all M).
    n_participants: Optional[int] = None
    # Quorum gate (FaultModel.min_quorum): True when the round fell below
    # quorum (under 'reject' its update was a no-op and sim_time also paid
    # the re-dispatch cost); None without a quorum.
    rejected: Optional[bool] = None


@dataclass
class SimResult:
    history: List[RoundRecord]
    params: Any
    label: str
    fed: FedConfig
    # Auto-recovery audit trail (run(recovery=...)): one dict a restart —
    # attempt, offending and resume rounds, the cumulative lr scale and the
    # guard norm applied, and the error message.
    restarts: List[dict] = field(default_factory=list)

    @property
    def total_time(self) -> float:
        return self.history[-1].sim_time if self.history else 0.0

    @property
    def rounds(self) -> int:
        return len(self.history)

    @property
    def rounds_rejected(self) -> int:
        """Rounds the quorum gate rejected (0 on quorum-less runs)."""
        return sum(1 for r in self.history if r.rejected)

    def time_to_accuracy(self, acc: float) -> Optional[float]:
        for r in self.history:
            if r.test_acc is not None and r.test_acc >= acc:
                return r.sim_time
        return None


@dataclass(frozen=True)
class SimState:
    """Everything a run advances, as one immutable value.

      params_C  stacked (C, ...) client params; every row equals the
                global model between rounds
      opt_C     stacked per-client optimizer state
      rng       state of the run's quantizer-noise generator
                (torch.Generator.get_state() of a generator on the
                simulator's device)
      seed      the seed `Simulator.init` was called with; the data
                iterators are rebuilt from it
      round     global round cursor (continues across run() calls)
      sim_time  cumulative Eq. 8 simulated seconds
      stream    ScenarioStream.state() snapshot; None means "fresh at
                `seed`" (and any scenario-less simulator)
      data      per-client BatchIterator.state() snapshots; None means
                "fresh at `seed`"

    No method writes into a state's tensors, so a state stays valid after
    it is passed to run(): the divergence guard keeps the pre-chunk state
    itself as its last-good snapshot.
    """

    params_C: Any
    opt_C: Any
    rng: torch.Tensor
    seed: int = 0
    round: int = 0
    sim_time: float = 0.0
    stream: Optional[dict] = None
    data: Optional[tuple] = None


@dataclass
class FleetResult:
    """`run_fleet` output: per-member final states and SimResults, in
    input order (member s = seed/state s)."""

    states: List[SimState]
    results: List[SimResult]

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def loss_history(self) -> np.ndarray:
        """(S, R) train-loss matrix across the fleet."""
        return np.asarray(
            [[r.train_loss for r in res.history] for res in self.results])

    def total_times(self) -> np.ndarray:
        return np.asarray([res.total_time for res in self.results])

    def summary(self) -> Dict[str, float]:
        """Mean/std over the fleet of final train loss and overall time —
        the confidence-band numbers multi-seed FL papers report."""
        losses = self.loss_history()[:, -1]
        times = self.total_times()
        return {"final_loss_mean": float(np.nanmean(losses)),
                "final_loss_std": float(np.nanstd(losses)),
                "total_time_mean": float(times.mean()),
                "total_time_std": float(times.std())}


def _scaled_optimizer(opt: Optimizer, scale: float) -> Optimizer:
    """`opt` with every update scaled by `scale` (in float32): exact
    learning-rate backoff for SGD-family optimizers, whose updates are
    linear in lr; the recovery path's `RecoveryPolicy.lr_backoff`."""
    s = float(np.float32(scale))

    def update(grads, state, params=None):
        updates, state = opt.update(grads, state, params)
        return tree_map(lambda u: u * s, updates), state

    return Optimizer(init=opt.init, update=update)


def _validate_run_args(max_rounds: int, eval_every: int) -> None:
    if not isinstance(max_rounds, (int, np.integer)) or max_rounds < 1:
        raise ValueError(
            f"max_rounds must be an int >= 1, got {max_rounds!r}")
    if not isinstance(eval_every, (int, np.integer)) or eval_every < 1:
        raise ValueError(
            f"eval_every must be an int >= 1, got {eval_every!r}")


class Simulator:
    """One FL system: M clients with data and a delay model, as pure
    state-in/state-out methods over `SimState`.

    `data` is a factory `seed -> list of per-client BatchIterator`s over
    ONE shared dataset (uploaded to the device once). `noise(generator,
    shape)` draws the quantizer's rounding noise when
    fed.compress_updates is set (default: uint8 draws from the run's
    generator on the device, kernels/quantize/ref.stochastic_noise).
    `eval_fn(params) -> {'acc', ...}` evaluates a global model (run);
    `eval_batch_fn` does so for a stacked (S, ...) member axis in one
    call (values (S,)), for run_fleet. Both are given or neither. Runs
    on `device` ("cuda" unless the caller asks for "cpu").

    `scenario` (a scenarios.Scenario or a registered name) draws each
    round's participation mask and channel on the host; `faults` (a
    faults.FaultModel) overlays deadlines, retransmission, crash/rejoin,
    the update guard and the quorum gate on it (on 'uniform' when no
    scenario is given). An inactive FaultModel is ignored.

    `masked_loss_fn(params, batch, sample_mask, n)` is the (V, b)-envelope
    form of loss_fn (mesh_rounds.envelope_local_steps_fn); with it, a
    Study can run this simulator padded into a group of arms with other
    (b, V) plans (federated/study.py). `value_and_grad(params_N, batch_N,
    sample_mask=None, n=None) -> (grads_N, loss (N,))` computes both
    losses' gradients over the stacked client axis at once; by default it
    is torch.func.vmap of their autograd gradients
    (mesh_rounds.vmapped_value_and_grad). ExperimentSpec.build gives the
    CNN's own (cnn.cnn_value_and_grad), under which a member's round on
    the card does not depend on the members beside it or on its padding.
    """

    def __init__(
        self,
        loss_fn: Callable,  # (params, batch) -> scalar loss
        init_params: Any,
        data: Callable[[int], List[Any]],
        data_sizes: np.ndarray,  # D_m
        fed: FedConfig,
        opt: Optimizer,
        pop: delay.DevicePopulation,
        wireless: Optional[WirelessConfig] = None,
        eval_fn: Optional[Callable] = None,  # (params) -> {'acc'}
        label: str = "defl",
        device=None,
        noise: Callable = stochastic_noise,
        eval_batch_fn: Optional[Callable] = None,
        scenario: Any = None,  # scenarios.Scenario | name | None
        faults: Optional[FaultModel] = None,
        masked_loss_fn: Optional[Callable] = None,
        value_and_grad: Optional[Callable] = None,
    ):
        # The constructor's arguments, for the recovery path's rebuilt
        # simulator (_recovery_variant).
        self._ctor = dict(
            loss_fn=loss_fn, init_params=init_params, data=data,
            data_sizes=data_sizes, fed=fed, opt=opt, pop=pop,
            wireless=wireless, eval_fn=eval_fn, label=label, device=device,
            noise=noise, eval_batch_fn=eval_batch_fn, scenario=scenario,
            faults=faults, masked_loss_fn=masked_loss_fn,
            value_and_grad=value_and_grad)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self._data_src = data
        self.data_sizes = data_sizes
        self.fed = fed
        self.opt = opt
        self.pop = pop
        self.wireless = wireless or WirelessConfig()
        if (eval_fn is None) != (eval_batch_fn is None):
            raise ValueError("give eval_fn and eval_batch_fn together "
                             "(run evaluates with one, run_fleet the other)")
        self.eval_fn = eval_fn
        self.eval_batch_fn = eval_batch_fn
        self.label = label
        self.masked_loss_fn = masked_loss_fn
        self.value_and_grad = (
            value_and_grad if value_and_grad is not None
            else mesh_rounds.vmapped_value_and_grad(loss_fn, masked_loss_fn))
        self.noise = noise
        probe = data(fed.seed)
        if not len(probe) == fed.n_devices == pop.n:
            raise ValueError(
                f"{len(probe)} client iterators, fed.n_devices="
                f"{fed.n_devices} and a population of {pop.n}: all three "
                "must be the client count M")
        if len({id(it.data) for it in probe}) != 1:
            raise ValueError(
                "all client iterators must draw from one shared dataset "
                "(it is uploaded to the device once)")
        self._init_params = tree_map(
            lambda x: torch.as_tensor(x, dtype=torch.float32,
                                      device=self.device), init_params)
        arrays = probe[0].device_arrays()
        self._data_dev = {
            "x": torch.as_tensor(arrays["x"], dtype=torch.float32,
                                 device=self.device),
            "y": torch.as_tensor(arrays["y"], dtype=torch.int64,
                                 device=self.device)}
        w = torch.as_tensor(np.asarray(data_sizes), dtype=torch.float32,
                            device=self.device)
        # Dense rounds take normalised FedAvg weights; scenario rounds take
        # the raw sizes and renormalise over each round's participants
        # (mesh_rounds._participation_weights).
        self._weights = w / torch.sum(w)
        self._sizes = w
        self.scenario = (scenarios.get(scenario) if scenario is not None
                         else None)
        if faults is not None and faults.active:
            base = self.scenario or scenarios.get("uniform")
            self.scenario = base.replace(faults=faults)
        fm = self.scenario.faults if self.scenario is not None else None
        self._faults = fm if (fm is not None and fm.active) else None
        self._guard = self._quorum = self._quorum_policy = None
        self._deadline = None
        # Static per-client compute times (Eq. 4); the uplink times follow
        # each round's realized channel.
        self._t_cp_clients = delay.per_client_compute_time(
            fed.batch_size, pop.G, pop.f)
        if self._faults is not None:
            self._faults.validate()
            g = self._faults.guard_spec()
            # A guard that neither clips nor rejects does nothing.
            self._guard = None if (g[0] == float("inf") and not g[1]) else g
            self._quorum = self._faults.resolve_quorum(fed.n_devices)
            if self._quorum is not None:
                self._quorum_policy = self._faults.quorum_policy
            # A deadline_factor resolves against this simulator's nominal
            # full-population Eq. 8 round time.
            nominal = delay.round_time(*self.round_times(), fed.local_rounds)
            self._deadline = self._faults.resolve_deadline(nominal)
        self._batch_from = type(probe[0]).batch_from
        self._chunk_fn = self.build_chunk()

    def build_chunk(self, envelope: bool = False):
        """This simulator's chunk function (mesh_rounds.build_fleet_chunk);
        envelope=True builds the Study's group chunk over the masked
        loss."""
        return mesh_rounds.build_fleet_chunk(
            self.value_and_grad, self.opt, self.fed.n_devices, self.fed.compress_updates,
            self._batch_from, self.noise,
            compression.n_rows(self._init_params), guard=self._guard,
            quorum=(None if self._quorum is None
                    else (self._quorum, self._quorum_policy)),
            envelope=envelope)

    # -- state construction -------------------------------------------------
    def init(self, seed: Optional[int] = None) -> SimState:
        """A fresh run state at `seed` (default: fed.seed): replicated
        client params/opt, the noise generator seeded with `seed`, round
        0, clock 0, and fresh data iterators."""
        seed = int(self.fed.seed if seed is None else seed)
        params = mesh_rounds.replicate_clients(
            self._init_params, self.fed.n_devices)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return SimState(params_C=params, opt_C=self.opt.init(params),
                        rng=gen.get_state(), seed=seed)

    def _materialize(self, state: SimState):
        """Live host-side streams positioned at `state`: (data iterators,
        scenario stream or None)."""
        iters = list(self._data_src(state.seed))
        if state.data is not None:
            for it, snap in zip(iters, state.data):
                it.set_state(snap)
        stream = None
        if self.scenario is not None:
            stream = self.scenario.stream(self.pop, state.seed)
            if state.stream is not None:
                stream.set_state(state.stream)
        return iters, stream

    def _state_at(self, state: SimState, params_C, opt_C, gen, mat,
                  rnd: int, sim_time: float) -> SimState:
        """`state` advanced to these tensors, generator and host streams."""
        iters, stream = mat
        return dataclasses.replace(
            state, params_C=params_C, opt_C=opt_C, rng=gen.get_state(),
            round=int(rnd), sim_time=float(sim_time),
            stream=None if stream is None else stream.state(),
            data=tuple(it.state() for it in iters))

    def params(self, state: SimState) -> Any:
        """The global model in `state` (client row 0)."""
        return tree_map(lambda x: x[0], state.params_C)

    # -- delay accounting ---------------------------------------------------
    def _update_bits(self) -> float:
        """Wire size of one client update: fed.update_bytes when set, else
        the exact int8 accounting (8-bit payload + one float32 scale per
        1024-row) when compressing, else the float32 parameter bytes."""
        if self.fed.update_bytes is not None:
            return self.fed.update_bytes * 8.0
        if self.fed.compress_updates:
            return float(compression.compressed_bits(self._init_params))
        return float(tree_bytes(self._init_params) * 8.0)

    def round_times(self) -> tuple:
        T_cm = delay.round_comm_time(
            self._update_bits(), self.wireless, self.pop.p, self.pop.h)
        T_cp = delay.round_compute_time(
            self.fed.batch_size, self.pop.G, self.pop.f)
        return T_cm, T_cp

    # -- fault semantics (host float64 side) ---------------------------------
    def _chunk_uplink(self, chunk):
        """(mask, t_cm) of a chunk realization, (R, M) each: the effective
        per-client uplink times (retransmission sums on the fault path,
        single-shot Eq. 6 otherwise) and the aggregation mask after the
        deadline cut (clients whose V*t_cp + t_cm exceeds the deadline stay
        in the clock mask but send nothing). The reference's float64 host
        twin, row for row."""
        mask = np.asarray(chunk.mask, bool)
        if self._faults is not None:
            fm = self._faults
            t_cm = delay.effective_uplink_times(
                self._update_bits(), self.wireless, self.pop.p,
                chunk.h_att, chunk.attempts,
                fm.backoff_base, fm.backoff_factor)
            if self._deadline is not None:
                finish = delay.finish_times(
                    self._t_cp_clients, t_cm, self.fed.local_rounds)
                mask = mask & (finish <= self._deadline)
        else:
            t_cm = delay.per_client_uplink_time(
                self._update_bits(), self.wireless, self.pop.p, chunk.h)
        return mask, t_cm

    def _raise_if_diverged(self, history, start: int, snap,
                           finites) -> int:
        """run()'s divergence guard: a non-finite train loss on a round
        that had participants (a round without one is NaN by design)
        raises DivergenceError with the last-good state `snap`, the
        records up to the failure and the round's per-client finite flags
        (`finites`, aligned with `history`). Returns the index checked up
        to otherwise."""
        for i in range(start, len(history)):
            rec = history[i]
            n_p = rec.n_participants
            if not np.isfinite(rec.train_loss) and (n_p is None or n_p > 0):
                raise DivergenceError(
                    f"train loss became non-finite ({rec.train_loss}) at "
                    f"round {rec.round} with "
                    f"{'all' if n_p is None else n_p} participating "
                    "clients; .state holds the last-good SimState "
                    "snapshot, .history the records up to the failure",
                    state=snap, history=history[:i + 1], round=rec.round,
                    faults=self._faults, guard=self._guard,
                    finite_mask=finites[i] if i < len(finites) else None)
        return len(history)

    # -- the chunked driver -------------------------------------------------
    def _chunk_inputs(self, iters, stream, n: int,
                      envelope: Optional[tuple] = None):
        """Host-side draws of one member's next n rounds: (batch indices
        (n, C, V, B), participation mask (n, C) float32 or None, and the
        host dict of the float64 clock twin for the records, or None
        without a scenario). With `envelope=(V_env, B_env)` (a Study
        group) the indices are zero-padded to (n, C, V_env, B_env): no
        extra draw, so the iterators and the stream advance exactly as in
        a run of this simulator alone."""
        V, b = self.fed.local_rounds, self.fed.batch_size
        idx = stack_chunk_indices(iters, n, V)
        if envelope is not None and tuple(envelope) != (V, b):
            padded = np.zeros(idx.shape[:2] + tuple(envelope), idx.dtype)
            padded[:, :, :V, :b] = idx
            idx = padded
        if stream is None:
            return idx, None, None
        chunk = stream.draw_chunk(n)
        mask, t_cm = self._chunk_uplink(chunk)
        T_cm, T_cp = delay.chunk_round_times(self._t_cp_clients, t_cm,
                                             chunk.clock_mask)
        host = {"T_cm": T_cm, "T_cp": T_cp,
                "n_participants": mask.sum(axis=1)}
        if self._faults is not None:
            host["attempts"] = chunk.attempts.sum(axis=1)
        return idx, mask.astype(np.float32), host

    def _chunk_records(self, ys, host, n: int, r0: int, t0: float,
                       ) -> List[RoundRecord]:
        """The n RoundRecords of one member's chunk from its fetched
        outputs `ys` (numpy, one entry a round) and its host clock twin,
        from round r0 and clock t0 (the reference's accounting)."""
        update_bits = self._update_bits()
        V = self.fed.local_rounds
        if self.scenario is None:
            T_cm_c, T_cp_c = self.round_times()
        records, sim_time = [], t0
        for i in range(n):
            if self.scenario is None:
                T_cm, T_cp, n_part = T_cm_c, T_cp_c, None
                bits = float(self.fed.n_devices * update_bits)
            else:
                T_cm, T_cp = float(host["T_cm"][i]), float(host["T_cp"][i])
                if self._faults is not None:
                    # The post-guard count, and every retransmission
                    # attempt's bits.
                    n_part = int(ys["n_participants"][i])
                    bits = float(host["attempts"][i] * update_bits)
                else:
                    n_part = int(host["n_participants"][i])
                    bits = float(n_part * update_bits)
            rej = bool(ys["rejected"][i]) if "rejected" in ys else None
            sim_time += delay.round_time(T_cm, T_cp, V,
                                         deadline=self._deadline)
            if rej and self._quorum_policy == "reject":
                sim_time += self._faults.redispatch_cost
            records.append(RoundRecord(
                round=r0 + i + 1, sim_time=sim_time, T_cm=T_cm, T_cp=T_cp,
                train_loss=float(ys["loss"][i]), uplink_bits=bits,
                n_participants=n_part, rejected=rej))
        return records

    def _generator(self, state: SimState) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.set_state(state.rng)
        return gen

    def _rewind(self, mat, pre: tuple, t: int) -> None:
        """Reposition a member's host streams as if only the first t
        rounds of the chunk just drawn had been consumed: restore the
        pre-chunk snapshots and replay t rounds of draws."""
        iters, stream = mat
        data, stream_state = pre
        for it, st in zip(iters, data):
            it.set_state(st)
        stack_chunk_indices(iters, t, self.fed.local_rounds)
        if stream is not None:
            stream.set_state(stream_state)
            stream.draw_chunk(t)

    def _drive(self, states: Sequence[SimState], max_rounds: int,
               eval_every: int, target_acc: Optional[float],
               max_sim_time: Optional[float], evaluate: Optional[Callable],
               divergence: bool = False,
               sims: Optional[Sequence["Simulator"]] = None,
               chunk_fn: Optional[Callable] = None,
               env: Optional[Dict[str, torch.Tensor]] = None):
        """The chunked round loop, for S member states in lockstep (S = 1 for
        run/run_chunk): (states', histories), after up to max_rounds
        rounds in chunks of eval_every. This is the one driver: `run`,
        `run_fleet` and the Study's groups (federated/study.py) all run
        through it.

        The members are stacked on the client axis (S*C rows, members
        major) and each chunk is ONE device call for all of them: one
        index (and mask) upload in, one fetch of the round outputs out.
        `evaluate(globals)` maps the
        stacked (S', ...) global models of the members still running to
        their eval dicts; it runs at each eval boundary (a multiple of
        eval_every, or max_rounds), for the members whose history reaches
        it. A member stops at the first round whose clock reaches
        max_sim_time (its history truncated there, its host streams
        rewound to it, its device state and noise generator end-of-chunk:
        the reference's documented deviation) or at an eval reaching
        target_acc; it is then sliced out of the stack and keeps its state
        as its final state.

        A Study group passes its members' own simulators as `sims` (default:
        this one for every member): member s draws its batches and masks,
        and keeps its Eq. 8 clock and uplink bits, through sims[s], with its
        own plan, and its quantizer noise comes from its own generator.
        The device call is `chunk_fn` (default
        this simulator's chunk); a group's is the envelope chunk of its
        first simulator, and `env` holds the members' envelope masks one
        row a client (S*C rows; mesh_rounds.envelope_local_steps_fn): each
        member's draws are zero-padded to its (V_env, B_env), and a
        stopped member's rows leave the stack with its params.

        divergence (run() of one member, with the fault layer's
        divergence_guard) checks each chunk's losses and raises
        DivergenceError carrying the state before the chunk."""
        C = self.fed.n_devices
        S = len(states)
        sims = list(sims) if sims is not None else [self] * S
        chunk_fn = self._chunk_fn if chunk_fn is None else chunk_fn
        envelope = None if env is None else (env["v_mask"].shape[1],
                                             env["sample_mask"].shape[1])
        mats = [sim._materialize(st) for sim, st in zip(sims, states)]
        gens = [sim._generator(st) for sim, st in zip(sims, states)]
        params = tree_map(lambda *xs: _cat_members(xs),
                          *[st.params_C for st in states])
        opt_state = tree_map(lambda *xs: _cat_members(xs),
                             *[st.opt_C for st in states])
        weights = self._weights if self.scenario is None else self._sizes
        active = list(range(S))  # the members in the stack, in its order
        finals: List[Optional[tuple]] = [None] * S
        histories: List[List[RoundRecord]] = [[] for _ in range(S)]
        times = [st.sim_time for st in states]
        r0 = states[0].round
        guard_on = (divergence and self._faults is not None
                    and self._faults.divergence_guard)
        snap, checked, finites = states[0], 0, []
        R = min(eval_every, max_rounds)
        done = 0
        while done < max_rounds:
            n = min(R, max_rounds - done)
            pre = [(tuple(it.state() for it in mats[s][0]),
                    None if mats[s][1] is None else mats[s][1].state())
                   if max_sim_time else None for s in active]
            drawn = [sims[s]._chunk_inputs(*mats[s], n, envelope)
                     for s in active]
            idx = np.concatenate([d[0] for d in drawn], axis=1)
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            mask = None
            if self.scenario is not None:
                mask = torch.from_numpy(np.concatenate(
                    [d[1] for d in drawn], axis=1)).to(self.device)
            params, opt_state, ys = chunk_fn(
                params, opt_state, [gens[s] for s in active], weights,
                self._data_dev, idx, mask, env)
            ys = {k: v.cpu().numpy() for k, v in ys.items()}
            stopped = set()
            for i, s in enumerate(active):
                recs = sims[s]._chunk_records(
                    {k: v[i] for k, v in ys.items()}, drawn[i][2], n,
                    r0 + done, times[s])
                if max_sim_time:
                    for j, rec in enumerate(recs):
                        if rec.sim_time >= max_sim_time:
                            if j + 1 < n:
                                sims[s]._rewind(mats[s], pre[i], j + 1)
                            recs = recs[:j + 1]
                            stopped.add(s)
                            break
                histories[s].extend(recs)
                times[s] = histories[s][-1].sim_time
                if guard_on:
                    finites.extend(ys["finite"][i][:len(recs)])
            done += n
            if guard_on:
                checked = self._raise_if_diverged(histories[0], checked, snap,
                                                  finites)
                snap = self._state_at(states[0], params, opt_state, gens[0],
                                      mats[0], r0 + len(histories[0]),
                                      times[0])
            if evaluate is not None and (done % eval_every == 0
                                         or done == max_rounds):
                evs = evaluate(tree_map(
                    lambda x: x.reshape(-1, C, *x.shape[1:])[:, 0], params))
                for i, s in enumerate(active):
                    rec = histories[s][-1]
                    # A member truncated inside the chunk has no eval here
                    # (its run alone would not evaluate there either).
                    if rec.round != r0 + done:
                        continue
                    rec.test_acc = float(evs[i].get("acc", np.nan))
                    rec.test_loss = float(evs[i].get("loss", np.nan))
                    if target_acc and rec.test_acc >= target_acc:
                        stopped.add(s)
            if len(stopped) == len(active):
                break
            if stopped:
                keep = [i for i, s in enumerate(active) if s not in stopped]
                for i, s in enumerate(active):
                    if s in stopped:
                        finals[s] = tuple(
                            tree_map(lambda x: _member(x, C, i).clone(), t)
                            for t in (params, opt_state))
                params, opt_state = (
                    tree_map(lambda x: _members(x, C, keep), t)
                    for t in (params, opt_state))
                if env is not None:
                    env = {k: _members(x, C, keep) for k, x in env.items()}
                active = [active[i] for i in keep]
        for i, s in enumerate(active):
            finals[s] = tuple(tree_map(lambda x: _member(x, C, i), t)
                              for t in (params, opt_state))
        out = [sims[s]._state_at(st, *finals[s], gens[s], mats[s],
                                 r0 + len(histories[s]), times[s])
               for s, st in enumerate(states)]
        return out, histories

    def run_chunk(self, state: SimState, rounds: int):
        """Run `rounds` rounds as one chunk, without evaluation:
        (state', [RoundRecord])."""
        _validate_run_args(rounds, 1)
        states, histories = self._drive([state], rounds, rounds, None, None,
                                        None)
        return states[0], histories[0]

    def run(
        self,
        state: SimState,
        max_rounds: int = 200,
        target_acc: Optional[float] = None,
        eval_every: int = 1,
        max_sim_time: Optional[float] = None,
        recovery: Optional[RecoveryPolicy] = None,
    ):
        """Run up to `max_rounds` MORE rounds from `state` in chunks of
        `eval_every` rounds: (state', SimResult). Round numbers and the
        Eq. 8 clock continue from the state's cursors. With an eval_fn,
        test accuracy is taken at each chunk's end, and a run with
        target_acc stops at the first chunk that reaches it. With
        max_sim_time the history stops at the first round whose clock
        reaches it, and the returned state's data iterators are rewound
        to that round (so a resumed run draws the next round's batches)
        while its params and noise generator are those at the end of the
        chunk, as in the reference's scan backend.

        With the fault layer's divergence_guard (on by default in an
        active FaultModel), a non-finite train loss on a round with
        participants raises DivergenceError carrying the state before the
        chunk. `recovery=RecoveryPolicy(...)` catches it instead: the run
        resumes from that state with the learning rate backed off (and the
        guard norm optionally tightened), at most max_restarts times, each
        restart recorded in SimResult.restarts."""
        _validate_run_args(max_rounds, eval_every)
        if recovery is not None:
            return self._run_recovering(state, recovery, max_rounds,
                                        target_acc, eval_every, max_sim_time)
        evaluate = None
        if self.eval_fn is not None:
            evaluate = lambda g: [  # noqa: E731
                self.eval_fn(tree_map(lambda x: x[0], g))]
        states, histories = self._drive([state], max_rounds, eval_every,
                                        target_acc, max_sim_time, evaluate,
                                        divergence=True)
        return states[0], SimResult(
            history=histories[0], params=self.params(states[0]),
            label=self.label, fed=self.fed)

    # -- auto-recovery --------------------------------------------------------
    def _recovery_variant(self, lr_scale: float, fm) -> "Simulator":
        """This simulator rebuilt for a restart: the optimizer's updates
        scaled by `lr_scale` and the FaultModel replaced by `fm` (whose
        guard norm the policy may have tightened)."""
        kw = dict(self._ctor)
        kw["opt"] = _scaled_optimizer(kw["opt"], lr_scale)
        if fm is not None:
            if kw.get("faults") is not None and kw["faults"].active:
                kw["faults"] = fm
            elif kw.get("scenario") is not None:
                sc = scenarios.get(kw["scenario"])
                if sc.faults is not None and sc.faults.active:
                    kw["scenario"] = sc.replace(faults=fm)
        return Simulator(**kw)

    def _run_recovering(self, state, recovery, max_rounds, target_acc,
                        eval_every, max_sim_time):
        """run(recovery=...): run, catch DivergenceError, resume from its
        last-good state with the lr backed off by recovery.lr_backoff
        (cumulative) and the guard norm optionally tightened, at most
        recovery.max_restarts times; every restart is logged in the
        result's `restarts`. The records the snapshot covers are kept, the
        rounds past it run again."""
        recovery.validate()
        sim = self
        fm = self._faults
        lr_scale = 1.0
        restarts: List[dict] = []
        prefix: List[RoundRecord] = []
        r_start = int(state.round)
        attempt = 0
        while True:
            rounds_left = max_rounds - (int(state.round) - r_start)
            try:
                state, res = sim.run(
                    state, max_rounds=rounds_left, target_acc=target_acc,
                    eval_every=eval_every, max_sim_time=max_sim_time)
            except DivergenceError as e:
                attempt += 1
                if e.state is None or attempt > recovery.max_restarts:
                    raise
                good = int(e.state.round)
                prefix.extend(r for r in e.history if r.round <= good)
                lr_scale *= recovery.lr_backoff
                if (recovery.tighten_guard is not None and fm is not None
                        and fm.max_update_norm is not None
                        and np.isfinite(fm.max_update_norm)):
                    fm = dataclasses.replace(
                        fm, max_update_norm=(fm.max_update_norm
                                             * recovery.tighten_guard))
                restarts.append({
                    "attempt": attempt,
                    "round": int(e.round),
                    "resume_round": good,
                    "lr_scale": lr_scale,
                    "max_update_norm": (
                        None if fm is None else fm.max_update_norm),
                    "error": str(e)})
                sim = self._recovery_variant(lr_scale, fm)
                state = e.state
                continue
            res.history = prefix + res.history
            res.restarts = restarts
            return state, res

    def _eval_members(self, globals_S) -> List[Dict]:
        """Eval of stacked (S, ...) global models: ONE eval_batch_fn call
        for all members, one dict a member."""
        ev = self.eval_batch_fn(globals_S)
        return [{k: v[i] for k, v in ev.items()}
                for i in range(leaves(globals_S)[0].shape[0])]

    def run_fleet(
        self,
        seeds: Optional[Iterable[int]] = None,
        states: Optional[Sequence[SimState]] = None,
        max_rounds: int = 200,
        eval_every: int = 1,
        target_acc: Optional[float] = None,
        max_sim_time: Optional[float] = None,
    ) -> FleetResult:
        """Run S member runs in lockstep: `seeds` (each becomes
        `init(seed)`) or `states` (which must share a round cursor), with
        ONE device call per chunk for the whole fleet. The members are
        folded into the client axis (mesh_rounds.build_fleet_chunk): one
        value_and_grad call over S*C clients, a per-member FedAvg, and,
        with compression, one quantize launch a round for all S*C
        clients. Member s draws from its own data iterators and noise
        generator, in member order, exactly the batches and noise a run
        of it alone draws. Early stop (target_acc, max_sim_time) is per
        member, with `run`'s semantics; a stopped member leaves the stack
        and keeps its state. Eval goes through eval_batch_fn, one call
        for the stacked members.

        The member contract, against `run` of the member's state on the
        same device:
          * the plan, round numbers, sim_time, T_cm, T_cp and uplink_bits
            (and under a scenario n_participants and rejected: each member
            draws its own masks from its own stream on the host) are
            exact, over any number of rounds, and a max_sim_time stop
            falls on the same round (a target_acc stop follows test_acc,
            which follows the params);
          * one round from equal states gives train losses within 1e-5
            relative and params within 5e-4 absolute (chip_smoke.py's
            fleet phase holds 8 seeds to it on the card). Under the CNN's
            stacked gradient (ExperimentSpec.build) a member's numbers on
            the card do not depend on the members beside it, so there it
            repeats its run alone bit for bit; on the CPU torch.matmul's
            sums follow the shapes, and so does cuDNN under vmap of
            autograd (the default value_and_grad).
        Over whole histories the CPU tests hold members to the same bounds
        (tests/test_torch_fleet.py).
        test_acc is exact on equal params
        (eval_batch_fn agrees with eval_fn).
        """
        if target_acc and self.eval_batch_fn is None:
            raise ValueError(
                "run_fleet(target_acc=...) needs an eval_fn/eval_batch_fn "
                "(build the spec with with_eval=True)")
        _validate_run_args(max_rounds, eval_every)
        if states is None:
            if seeds is None:
                raise ValueError("run_fleet needs seeds=... or states=...")
            seeds = [int(s) for s in seeds]
            if not seeds:
                raise ValueError("run_fleet needs at least one member")
            states = [self.init(s) for s in seeds]
        else:
            states = list(states)
            if not states:
                raise ValueError("run_fleet needs at least one member")
            if len({st.round for st in states}) != 1:
                raise ValueError(
                    "fleet members must share a round cursor (got rounds "
                    f"{sorted({st.round for st in states})}) — lockstep "
                    "chunking has no per-member ragged tails")

        evaluate = (self._eval_members if self.eval_batch_fn is not None
                    else None)
        out, histories = self._drive(states, max_rounds, eval_every,
                                     target_acc, max_sim_time, evaluate)
        return FleetResult(states=out, results=[
            SimResult(history=h, params=self.params(st),
                      label=f"{self.label}[seed={st.seed}]", fed=self.fed)
            for st, h in zip(out, histories)])


def _atomic_pickle(path: str, payload: Any) -> None:
    """Crash-safe pickle write: serialize into a temp file in the
    target's directory (os.replace must not cross filesystems), fsync,
    then rename it into place. A kill at any instant leaves the previous
    file or none, never a torn pickle (at worst a stray `<name>.tmp*`
    file, which no reader opens)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _cat_members(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Member tensors (C, ...) stacked as (S*C, ...), members major (one
    member's tensor as it is)."""
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def _member(x: torch.Tensor, C: int, i: int) -> torch.Tensor:
    """Member i's (C, ...) rows of a (S*C, ...) stack (a view)."""
    return x.reshape(-1, C, *x.shape[1:])[i]


def _members(x: torch.Tensor, C: int, keep: List[int]) -> torch.Tensor:
    """The (len(keep)*C, ...) rows of the members `keep` of a stack."""
    return x.reshape(-1, C, *x.shape[1:])[keep].reshape(-1, *x.shape[1:])
