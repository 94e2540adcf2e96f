"""Host-level FL simulator: Algorithm 1 with the paper's delay accounting.

Runs real training (PyTorch, on the card) while advancing a *simulated*
wall clock from the paper's delay models (Eqs. 5, 7, 8). Port of the
reference's `Simulator` (repro/federated/simulation.py), for a dense
population or sampled K-client cohorts of an M-client one, with its edge
scenarios (federated/scenarios.py) and fault layer (federated/faults.py):

    sim   = Simulator(loss_fn, params, data_factory, sizes, fed, opt, pop,
                      scenario="unreliable_edge", backend="scan",
                      cohort=None)
    state = sim.init(seed)
    state, result  = sim.run(state, max_rounds=100, eval_every=10,
                             recovery=RecoveryPolicy())
    state, metrics = sim.run_round(state)
    state, records = sim.run_chunk(state, rounds=10)
    fleet = sim.run_fleet(seeds=range(8), max_rounds=100, eval_every=10)
    save_state(path, state); state = load_state(path, like=sim.init())
    asim = Simulator(..., backend="async", async_spec=AsyncSpec(5))
    state, records = asim.run_events(asim.init(seed), events=11)

Three synchronous backends share the same math:

  backend='scan' (default): a chunk of `eval_every` rounds runs on the
      device with no host synchronisation inside. When every client
      iterator draws from one shared dataset and speaks the index
      protocol (data.BatchIterator), the batch indices of the whole chunk
      go up in one transfer and batches are gathered on the device from
      the dataset uploaded once; any other data source goes up as
      host-stacked batches, one upload a chunk. The per-round train
      losses come back in one fetch per chunk. run_fleet and the Study
      run on this path.
  backend='batched': one round step a round (the step the chunked path
      calls, mesh_rounds.build_fleet_round), fed by one upload of the
      round's host-stacked batches (client.stack_client_batches). Losses
      stay on the device until the next `eval_every` boundary. Same
      batches and noise as 'scan', so the same numbers.
  backend='loop': the reference's per-client host loop, its oracle for
      the stacked round: each participating client runs its V steps alone
      (client.make_local_update, the stacked value-and-grad at N = 1), is
      compressed alone (one quantize launch a client) and FedAvg is
      server.aggregate_updates. The round's quantizer noise is the batched
      round's one (C, rows, 1024) draw, row m for client m, drawn for all
      M clients whatever the mask (the reference's sequential_client_keys
      rule), so the three backends stay on one generator stream.

The asynchronous backend, backend='async' with async_spec=
events.AsyncSpec(...), replaces the round barrier with an event queue
(mesh_rounds.build_async_chunk): one client a arrival event, popped on the
device from a (C,) float32 finish-time array, its update staleness-
weighted into a buffer that aggregates every buffer_size kept updates
(FedBuff) or mixes at once (FedAsync). A 'round' is an aggregation:
run(max_rounds=) counts fills and chunks end at them; run_events(state,
events) runs an exact event count and may stop mid-buffer. The host
replays the schedule in numpy float32 (events.twin_step) to pick each
event's client and batches ahead of the chunk, and checks the device's
pops against it at every chunk's one fetch. Each event draws one M-wide
dispatch realization (service time V t_cp + uplink, and the drop flag)
from the scenario stream ('uniform' when none is given) and, compressed,
one (1, rows, 1024) quantizer noise and one quantize launch.

Sampled participation (`cohort=K`, 'scan' and 'batched'): each round a
K-client cohort is drawn from the M clients on the host (uniform, or
D_m-weighted with cohort_sampler='weighted'; with cohort_spare the K
deadline-feasible-fastest of K + spare candidates), and only its members
compute and upload. The device state is O(K): the stacked params carry K
lanes, re-initialised from the global model every round (the local
optimizer must be stateless), while the population model (data
partitions, scenario masks, channel state) stays O(M) on the host. The
fault semantics resolve M-wide first and are then gathered to the
cohort's columns, so K = M is the dense run bit for bit.

The Eq. 8 clock and the uplink bits come from the float64 host model
(core/delay.py), exactly as the reference's records do. Under a scenario
each round (or chunk) also takes the participation masks its host stream
drew, and reports the participant counts, quorum flags and per-client
finite flags.

All run state lives in an immutable `SimState`; the methods are
state-in/state-out and never modify a state's tensors in place.

`FLSimulation` remains as the reference's deprecated shim (one
`DeprecationWarning` a process) holding a (Simulator, SimState) pair
behind the old mutable interface.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, WirelessConfig
from repro_torch.core import delay
from repro_torch.device import resolve_device
from repro_torch.federated import compression, events, mesh_rounds, scenarios
from repro_torch.federated.client import (
    client_round,
    make_local_update,
    stack_batches,
    stack_chunk_batches,
    stack_chunk_indices,
    stack_client_batches,
    stack_cohort_batches,
    stack_cohort_indices,
)
from repro_torch.federated.faults import (DivergenceError, FaultModel,
                                          RecoveryPolicy)
from repro_torch.federated.server import aggregate_updates
from repro_torch.kernels.quantize.ref import stochastic_noise
from repro_torch.optim.api import Optimizer
from repro_torch.sharding import collectives
from repro_torch.utils import spans
from repro_torch.utils.tree import leaves, structure, tree_bytes, tree_map

# The backends: three synchronous ones and the event queue.
BACKENDS = ("scan", "batched", "loop", "async")


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

      params_C  stacked (C, ...) client params (C = K cohort lanes when
                sampled); every row equals the global model between
                rounds ('loop': the global model itself, unstacked, as in
                the reference)
      opt_C     stacked per-client optimizer state ('loop': a tuple of
                the M clients' states)
      rng       state of the run's quantizer-noise generator
                (torch.Generator.get_state() of a generator on the
                simulator's device: a CPU generator's and a CUDA
                generator's states differ in kind, so a state resumes on
                the kind of device it was made on)
      seed      the seed `Simulator.init` was called with; the data
                iterators are rebuilt from it
      round     global round cursor (continues across run() calls)
      sim_time  cumulative Eq. 8 simulated seconds
      stream    ScenarioStream.state() snapshot; None means "fresh at
                `seed`" (and any scenario-less simulator)
      data      per-client iterator state() snapshots (a ClientDataPool's:
                its touched clients only); None means "fresh at `seed`"
                (or iterators without snapshots)

    The asynchronous backend's fields (None / 0 on the synchronous
    backends, so their states and checkpoints are unchanged):
      async_c     the event queue's device carry (global model, buffer,
                  finish times, dispatch versions, drop flags:
                  mesh_rounds.build_async_chunk). A mid-buffer state
                  resumes bit for bit: the pending updates live here.
      event       arrival-event cursor (`round` counts aggregations)
      async_host  float64 bookkeeping of the in-flight dispatches for the
                  records: {'t_cm_disp' (C,), 'attempts_disp' (C,),
                  'bits_acc'} (each dispatch's effective uplink seconds
                  and attempts, and the uplink bits since the last
                  aggregation)

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
    async_c: Optional[dict] = None
    event: int = 0
    async_host: Optional[dict] = None


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

    `data` is a factory `seed -> list of per-client iterators` (or a list
    of live iterators, the reference's legacy form: its streams then
    continue where they are, whatever the seed, and run_fleet refuses it).
    An iterator gives `next_batch()`, and optionally `state()` /
    `set_state()` for checkpoints; data.BatchIterator also speaks the
    index protocol, with which the 'scan' backend uploads the dataset
    once and gathers batches on the device. `noise(generator, shape)`
    draws the quantizer's rounding noise when fed.compress_updates is set
    (default: uint8 draws from the run's generator on the device,
    kernels/quantize/ref.stochastic_noise). `eval_fn(params) -> {'acc',
    ...}` evaluates a global model (run); `eval_batch_fn` does so for a
    stacked (S, ...) member axis in one call (values (S,)), for
    run_fleet. Both are given or neither. Runs on `device` ("cuda" unless
    the caller asks for "cpu"), with `backend` 'scan' (default),
    'batched', 'loop' or 'async' (the module docstring).

    `async_spec` (an events.AsyncSpec) is the event queue's aggregation
    policy, required with backend='async' and refused without it: its
    buffer_size at most M, no cohort, shard_clients, min_quorum or
    max_update_norm, and a stateless local optimizer (every client
    re-dispatches from the current global model); a simulator without a
    scenario runs on 'uniform' (the dispatch draws live on its stream).

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

    `cohort=K` turns on sampled participation (the module docstring): K in
    [1, M], K + cohort_spare <= M, 'scan' or 'batched', a stateless local
    optimizer; `data` may then give a data.ClientDataPool (one lazy object
    for all M clients) instead of a list. A sampled simulator without a
    scenario runs on 'uniform' (the cohort draws live on the scenario
    stream), and a quorum resolves against K.

    `shard_clients=True` is the reference's client-axis sharding: 'scan'
    only, no compression, the lanes dividing evenly over the devices. The
    port runs one process a device (`torchrun --nproc-per-node N`), and
    the ranks of the caller's default torch.distributed group are the
    client axis (sharding/collectives.py): rank r holds lanes [r C/n, (r+1)
    C/n) of each member, its local steps run on them alone, and FedAvg is
    each rank's partial sum plus one all_reduce
    (mesh_rounds.build_round_step's 'allreduce_shardmap'; a group of one
    rank takes that path too, as the reference's one-device mesh does).
    Every rank runs the same host loop (plan, cohorts, masks, the float64
    clock, the records), draws every lane's batches as the unsharded run
    does and uploads only its own lanes'; every rank returns the same
    records and bit-equal params. A SimState keeps all C lanes, as the
    reference's global arrays do (the params from the rank's first lane,
    every lane of a member holding the global model between rounds; the
    optimizer state gathered), so checkpoints and run_round work as
    unsharded. Without a group one device runs the unsharded step, and
    more than one visible card raises ValueError: a sharded run needs one
    process a card and never falls back to one card.
    """

    def __init__(
        self,
        loss_fn: Callable,  # (params, batch) -> scalar loss
        init_params: Any,
        data: Any,  # Callable[[int], List[iterator]] | List[iterator]
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
        backend: str = "scan",
        cohort: Optional[int] = None,  # K-client sampled participation
        cohort_sampler: str = "uniform",  # 'uniform' | 'weighted' (by D_m)
        cohort_spare: int = 0,  # over-provisioned candidates a round
        shard_clients: bool = False,
        async_spec: Optional[events.AsyncSpec] = None,
    ):
        # The constructor's arguments, for the recovery path's rebuilt
        # simulator (_recovery_variant).
        self._ctor = dict(
            loss_fn=loss_fn, init_params=init_params, data=data,
            data_sizes=data_sizes, fed=fed, opt=opt, pop=pop,
            wireless=wireless, eval_fn=eval_fn, label=label, device=device,
            noise=noise, eval_batch_fn=eval_batch_fn, scenario=scenario,
            faults=faults, masked_loss_fn=masked_loss_fn,
            value_and_grad=value_and_grad, backend=backend, cohort=cohort,
            cohort_sampler=cohort_sampler, cohort_spare=cohort_spare,
            shard_clients=shard_clients, async_spec=async_spec)
        self.device = resolve_device(device)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "async" and async_spec is None:
            raise ValueError(
                "backend='async' needs an aggregation policy — pass "
                "async_spec=events.AsyncSpec(buffer_size=K, ...)")
        if (async_spec is not None
                and async_spec.buffer_size > fed.n_devices):
            raise ValueError(
                f"AsyncSpec.buffer_size ({async_spec.buffer_size}) must "
                f"not exceed n_devices ({fed.n_devices}): accepted "
                "updates block their client until the consuming "
                "aggregation, so a buffer larger than the population "
                "could never fill")
        if async_spec is not None and backend != "async":
            raise ValueError(
                f"async_spec is only meaningful with backend='async' "
                f"(got backend={backend!r}) — drop it or switch backends")
        if backend == "async":
            if cohort is not None:
                raise ValueError(
                    "backend='async' and cohort=K (sampled participation) "
                    "are mutually exclusive: the event queue already "
                    "schedules per-client work continuously, so there is "
                    "no per-round cohort to draw. Drop cohort (every "
                    "client stays in flight) or use backend='scan'.")
            if shard_clients:
                raise ValueError(
                    "backend='async' and shard_clients are mutually "
                    "exclusive: the event scan runs ONE client per event "
                    "(nothing to shard over a client mesh). Drop "
                    "shard_clients or use backend='scan'.")
        self._async = async_spec if backend == "async" else None
        self.backend = backend
        if cohort_sampler not in ("uniform", "weighted"):
            raise ValueError(
                f"unknown cohort_sampler {cohort_sampler!r}; "
                "expected 'uniform' or 'weighted'")
        if cohort is not None:
            if backend == "loop":
                raise ValueError(
                    "cohort (sampled participation) requires backend "
                    "'scan' or 'batched' — the loop reference is dense-only")
            if not 1 <= int(cohort) <= pop.n:
                raise ValueError(
                    f"cohort must be in [1, {pop.n}], got {cohort}")
        self._cohort = None if cohort is None else int(cohort)
        self._sampled = self._cohort is not None
        if not isinstance(cohort_spare, (int, np.integer)) or cohort_spare < 0:
            raise ValueError(
                f"cohort_spare must be an int >= 0, got {cohort_spare!r}")
        if cohort_spare and not self._sampled:
            raise ValueError(
                "cohort_spare (over-provisioned cohorts) requires sampled "
                "participation — pass cohort=K as well")
        if self._sampled and self._cohort + int(cohort_spare) > pop.n:
            raise ValueError(
                f"cohort + cohort_spare ({cohort} + {cohort_spare}) must "
                f"not exceed the population size {pop.n}")
        self._spare = int(cohort_spare)
        # Each round draws K + spare candidates and keeps the K
        # deadline-feasible-fastest (_select_cohorts).
        self._cohort_draw = (
            None if self._cohort is None else self._cohort + self._spare)
        self._cohort_weights = (
            np.asarray(np.asarray(data_sizes), np.float64)
            if (self._sampled and cohort_sampler == "weighted") else None)
        # The stacked client axis: K cohort lanes when sampled, else M.
        self._lanes = self._cohort if self._sampled else fed.n_devices
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
        probe = self._make_iters(fed.seed)
        if not len(probe) == fed.n_devices == pop.n:
            raise ValueError(
                f"{len(probe)} client iterators, fed.n_devices="
                f"{fed.n_devices} and a population of {pop.n}: all three "
                "must be the client count M")
        if hasattr(probe, "client") and not self._sampled:
            raise ValueError(
                "a ClientDataPool data source requires cohort sampling "
                "(cohort=K) — the dense backends stack every client's "
                "batches, which is exactly what the pool exists to avoid")
        self.shard_clients = bool(shard_clients)
        self._shard = False
        if shard_clients:
            if backend != "scan":
                raise ValueError(
                    f"shard_clients requires backend='scan', not {backend!r}")
            if fed.compress_updates:
                raise ValueError(
                    "shard_clients with compress_updates is unsupported: "
                    "the int8 quantizer uses its own aggregation path")
            grouped = collectives.initialized()
            n_dev = (collectives.world() if grouped
                     else torch.cuda.device_count()
                     if self.device.type == "cuda" else 1)
            if self._lanes % n_dev:
                raise ValueError(
                    f"client axis ({self._lanes} lanes) must divide evenly "
                    f"over the {n_dev} available devices")
            if n_dev > 1 and not grouped:
                raise ValueError(
                    f"shard_clients sees {n_dev} CUDA devices and no "
                    "torch.distributed process group: launch one process a "
                    f"card (torchrun --nproc-per-node {n_dev} ...) and "
                    "initialise the default group in each; its ranks share "
                    "the client axis. A sharded run does not fall back to "
                    "one card.")
            self._shard = grouped
            if grouped:
                self.device = collectives.device_for_rank(self.device)
        # This rank's lanes of the client axis (all of them unsharded).
        self._lane_slice = (collectives.lane_slice(self._lanes)
                            if self._shard else slice(0, self._lanes))
        self._lanes_local = self._lane_slice.stop - self._lane_slice.start
        self._init_params = tree_map(
            lambda x: torch.as_tensor(x, dtype=torch.float32,
                                      device=self.device), init_params)
        if self._sampled and leaves(opt.init(self._init_params)):
            raise ValueError(
                "sampled participation carries no per-client optimizer "
                "state between rounds (cohort lanes change owners every "
                "round; clients re-initialize from the global model) — "
                "use a stateless local optimizer (plain SGD)")
        if self._async is not None and leaves(opt.init(self._init_params)):
            raise ValueError(
                "backend='async' re-dispatches every client from the "
                "current global model, so per-client optimizer state "
                "carried across stale dispatches is ill-defined — use a "
                "stateless local optimizer (plain SGD)")
        self._rows = compression.n_rows(self._init_params)
        # The device-resident data path is the chunked paths', as in the
        # reference; the per-round backends always take host batches.
        self._data_dev = self._batch_from = None
        if backend in ("scan", "async"):
            self._detect_device_data(probe)
        w = torch.as_tensor(np.asarray(data_sizes), dtype=torch.float32,
                            device=self.device)
        # Dense rounds take normalised FedAvg weights; scenario rounds take
        # the raw sizes and renormalise over each round's participants
        # (mesh_rounds._participation_weights).
        self._weights = w / torch.sum(w)
        self._sizes = w
        # The raw sizes' float32 host twin: a sampled round gathers its
        # cohort's row from it, the same float32 values as `_sizes`, so a
        # K = M row equals the dense constant.
        self._sizes_host = np.asarray(np.asarray(data_sizes), np.float32)
        self.scenario = (scenarios.get(scenario) if scenario is not None
                         else None)
        if faults is not None and faults.active:
            base = self.scenario or scenarios.get("uniform")
            self.scenario = base.replace(faults=faults)
        if self._sampled and self.scenario is None:
            # The cohort draws live on the scenario stream: promote to the
            # neutral 'uniform' scenario so the stream exists.
            self.scenario = scenarios.get("uniform")
        if self._async is not None and self.scenario is None:
            # The event queue draws each dispatch's service time from the
            # realization stream: promote as the sampled path does.
            self.scenario = scenarios.get("uniform")
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
            # Against the round's cohort size (K when sampled, M dense).
            self._quorum = self._faults.resolve_quorum(self._lanes)
            if self._quorum is not None:
                self._quorum_policy = self._faults.quorum_policy
            # A deadline_factor resolves against this simulator's nominal
            # full-population Eq. 8 round time.
            nominal = delay.round_time(*self.round_times(), fed.local_rounds)
            self._deadline = self._faults.resolve_deadline(nominal)
        if self._async is not None and self._quorum is not None:
            raise ValueError(
                "backend='async' and FaultModel.min_quorum are mutually "
                "exclusive: the buffered server aggregates whenever "
                "buffer_size updates arrive — there is no per-round "
                "participant count to gate. Drop min_quorum from the "
                "FaultModel (AsyncSpec.buffer_size IS the async quorum) "
                "or use backend='scan'.")
        if (self._async is not None and self._faults is not None
                and self._faults.max_update_norm is not None):
            raise ValueError(
                "backend='async' and FaultModel.max_update_norm are "
                "mutually exclusive: update sanitation runs at the sync "
                "round step's participant axis, which the event scan "
                "does not have. Drop max_update_norm or use "
                "backend='scan'. (The always-on defaults "
                "reject_nonfinite/divergence_guard are round-level "
                "guards and are inert on the async backend.)")
        if backend == "loop":
            self.local_update = make_local_update(self.value_and_grad, opt)
        elif backend == "async":
            # Each chunk ends at an aggregation boundary or after E events
            # (the reference's static event budget).
            self._async_E = int(
                self._async.event_budget
                if self._async.event_budget is not None
                else 8 * max(fed.n_devices, self._async.buffer_size))
            self._chunk_fn = mesh_rounds.build_async_chunk(
                self.value_and_grad, opt, fed.n_devices, self._async,
                self._batch_from, fed.compress_updates, noise, self._rows)
        else:
            # The batched round, also run_round's step on 'scan' (the
            # stacked state layout is the same).
            self._round_fn = mesh_rounds.build_fleet_round(
                self.value_and_grad, opt, self._lanes,
                fed.compress_updates, noise, self._rows, guard=self._guard,
                quorum=self._quorum_arg(), shard=self._shard)
        if backend == "scan":
            self._chunk_fn = self.build_chunk()

    def _quorum_arg(self):
        return (None if self._quorum is None
                else (self._quorum, self._quorum_policy))

    def _detect_device_data(self, its) -> None:
        """The device-resident data path, where the reference's
        `_detect_device_data` takes it: when every client iterator speaks
        the index protocol (next_indices, device_arrays) and draws from
        one shared dataset, the dataset is uploaded once and each chunk
        uploads only batch indices, gathered on the device (batch_from).
        Any other source goes up as host-stacked batches, one upload a
        chunk (client.stack_chunk_batches). A ClientDataPool is one shared
        dataset."""
        if hasattr(its, "client"):
            self._data_dev = {k: _upload(v, self.device)
                              for k, v in its.device_arrays().items()}
            self._batch_from = its.batch_from
        elif (its
                and all(hasattr(it, "next_indices")
                        and hasattr(it, "device_arrays") for it in its)
                and getattr(its[0], "data", None) is not None
                and len({id(getattr(it, "data", None)) for it in its}) == 1):
            self._data_dev = {k: _upload(v, self.device)
                              for k, v in its[0].device_arrays().items()}
            self._batch_from = type(its[0]).batch_from

    def build_chunk(self, envelope: bool = False):
        """This simulator's chunk function (mesh_rounds.build_fleet_chunk);
        envelope=True builds the Study's group chunk over the masked
        loss."""
        return mesh_rounds.build_fleet_chunk(
            self.value_and_grad, self.opt, self._lanes,
            self.fed.compress_updates, self._batch_from, self.noise,
            self._rows, guard=self._guard, quorum=self._quorum_arg(),
            envelope=envelope, shard=self._shard)

    # -- state construction -------------------------------------------------
    def init(self, seed: Optional[int] = None) -> SimState:
        """A fresh run state at `seed` (default: fed.seed): replicated
        client params/opt (K cohort lanes when sampled, else M; 'loop': the
        global model and M optimizer states), the noise generator seeded
        with `seed`, round 0, clock 0, and fresh data iterators (a
        simulator built on a list of live iterators continues them where
        they are).

        'async': the initial dispatch hands every client version-0 work at
        t=0, which takes one realization draw, so the state holds the
        stream's position after it, the event carry (finish times = the
        drawn service times) and the draw's float64 bookkeeping."""
        seed = int(self.fed.seed if seed is None else seed)
        if self.backend == "loop":
            params = self._init_params
            opt_C: Any = tuple(self.opt.init(params)
                               for _ in range(self.fed.n_devices))
        else:
            params = mesh_rounds.replicate_clients(self._init_params,
                                                   self._lanes)
            opt_C = self.opt.init(params)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = SimState(params_C=params, opt_C=opt_C, rng=gen.get_state(),
                         seed=seed)
        if self.backend != "async":
            return state
        stream = self.scenario.stream(self.pop, seed)
        t_svc0, drop0, t_cm0, att0 = self._async_dispatch_draw(stream)
        C, dev = self.fed.n_devices, self.device
        scalar = lambda dt: torch.zeros((), dtype=dt, device=dev)  # noqa: E731
        async_c = {
            "params_g": tree_map(lambda x: x.clone(), self._init_params),
            "buf": tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=dev), self._init_params),
            "buf_w": scalar(torch.float32),
            "cnt": scalar(torch.int32),
            "loss_sum": scalar(torch.float32),
            "t_finish": torch.from_numpy(t_svc0).to(dev),
            "t_next": torch.zeros(C, dtype=torch.float32, device=dev),
            "now": scalar(torch.float32),
            "version": scalar(torch.int32),
            "version_C": torch.zeros(C, dtype=torch.int32, device=dev),
            "drop_C": torch.from_numpy(drop0).to(dev),
        }
        return dataclasses.replace(
            state, stream=stream.state(), async_c=async_c,
            async_host={"t_cm_disp": np.asarray(t_cm0, np.float64),
                        "attempts_disp": np.asarray(att0, np.float64),
                        "bits_acc": 0.0})

    def _make_iters(self, seed: int):
        src = (self._data_src(seed) if callable(self._data_src)
               else self._data_src)
        # A ClientDataPool is one lazy object, not a per-client list.
        return src if hasattr(src, "client") else list(src)

    @staticmethod
    def _snapshot_iters(iters) -> Optional[Any]:
        """The iterators' state() snapshots (a ClientDataPool's: its
        touched clients only), or None when they have none (such an
        iterator is taken to be stateless)."""
        if hasattr(iters, "client"):
            return iters.state()
        if all(hasattr(it, "state") and hasattr(it, "set_state")
               for it in iters):
            return tuple(it.state() for it in iters)
        return None

    @staticmethod
    def _restore_iters(iters, snap) -> None:
        if hasattr(iters, "client"):
            iters.set_state(snap)
            return
        for it, st in zip(iters, snap):
            it.set_state(st)

    def _materialize(self, state: SimState):
        """Live host-side streams positioned at `state`: (data iterators,
        scenario stream or None; a sampled simulator's stream draws its
        cohorts too, and its snapshot carries the cohort generator)."""
        iters = self._make_iters(state.seed)
        if state.data is not None:
            self._restore_iters(iters, state.data)
        stream = None
        if self.scenario is not None:
            stream = self.scenario.stream(
                self.pop, state.seed, cohort_size=self._cohort_draw,
                cohort_weights=self._cohort_weights)
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
            data=self._snapshot_iters(iters))

    def _placed(self, state: SimState) -> SimState:
        """`state` with its params and optimizer state on this simulator's
        device (a checkpoint's come back on the CPU); tensors already
        there are kept as they are."""
        on = lambda t: tree_map(lambda x: x.to(self.device), t)  # noqa: E731
        return dataclasses.replace(
            state, params_C=on(state.params_C), opt_C=on(state.opt_C),
            async_c=None if state.async_c is None else on(state.async_c))

    def _to_lanes(self, tree):
        """This rank's lanes of a (C, ...) tree (views; all of them
        unsharded)."""
        return tree_map(lambda x: x[self._lane_slice], tree)

    def _from_lanes(self, params_l, opt_l) -> tuple:
        """A member's (C, ...) params and optimizer state from this rank's
        lanes: the params from its first lane (every lane of a member holds
        the global model between rounds, bit-equal across the ranks), the
        optimizer state gathered from every rank."""
        if not self._shard:
            return params_l, opt_l
        C = self._lanes
        return (tree_map(lambda x: x[:1].expand(C, *x.shape[1:]), params_l),
                tree_map(collectives.gather_rows, opt_l))

    def _generator(self, state: SimState) -> torch.Generator:
        """The run's noise generator on this simulator's device, at the
        state's position. A state made on the other kind of device raises
        ValueError: a CUDA generator's state cannot be set on a CPU
        generator, nor the reverse."""
        gen = torch.Generator(device=self.device)
        if state.rng.numel() != gen.get_state().numel():
            raise ValueError(
                f"the state's noise generator is a {_rng_kind(state.rng)} "
                f"generator's and this simulator runs on {self.device}: a "
                "generator's state does not move between the CPU and the "
                "card, so a state made (or saved) on the card resumes on "
                "the card, and one made on the CPU on the CPU")
        gen.set_state(state.rng)
        return gen

    def params(self, state: SimState) -> Any:
        """The global model in `state` (client row 0; 'loop' holds it
        unstacked; 'async' carries it in async_c, its client rows being
        dispatch snapshots that differ between aggregations)."""
        if self.backend == "async":
            return state.async_c["params_g"]
        return self._params_from(state.params_C)

    def _params_from(self, params_C) -> Any:
        if self.backend == "loop":
            return params_C
        return tree_map(lambda x: x[0], params_C)

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
        """(mask, t_cm) of a chunk realization, (R, M) each, or of one
        round's realization, (M,) each: the effective
        per-client uplink times (retransmission sums on the fault path,
        single-shot Eq. 6 otherwise) and the aggregation mask after the
        deadline cut (clients whose V*t_cp + t_cm exceeds the deadline stay
        in the clock mask but send nothing). The reference's float64 host
        twin, row for row. Under sampling too the realization is resolved
        population-wide, so a cohort's gathered columns are exactly the
        rows a dense run sees."""
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

    @staticmethod
    def _gather_real(real, cohort):
        """A round's M-wide realization restricted to the cohort's columns.
        The fault semantics (retransmission clocks, deadline cuts) resolve
        M-wide FIRST, then are gathered: sampling selects who
        participates, it never changes what would have happened to
        them."""
        return dataclasses.replace(
            real,
            mask=np.asarray(real.mask)[cohort],
            clock_mask=np.asarray(real.clock_mask)[cohort],
            h=np.asarray(real.h)[cohort],
            attempts=(None if real.attempts is None
                      else np.asarray(real.attempts)[cohort]),
            h_att=(None if real.h_att is None
                   else np.asarray(real.h_att)[cohort]))

    def _select_cohorts(self, cands: np.ndarray, t_cm: np.ndarray,
                        ) -> np.ndarray:
        """Over-provisioned cohort selection: the K deadline-feasible-
        fastest of each round's (K + spare) candidates, (R, K) from (R,
        K + spare) candidates and the (R, M) effective uplink times.
        Candidates rank by the float64 finish time V*t_cp + t_cm
        (delay.finish_times), deadline-infeasible ones last and ties by
        client index; the kept K come back sorted ascending (draw_cohort's
        convention)."""
        K = self._cohort
        finish_all = delay.finish_times(
            self._t_cp_clients, t_cm, self.fed.local_rounds)
        finish = np.take_along_axis(finish_all, cands, axis=1)
        infeas = (finish > self._deadline if self._deadline is not None
                  else np.zeros(finish.shape, bool))
        out = np.empty((cands.shape[0], K), np.int32)
        for r in range(cands.shape[0]):
            # lexsort: the LAST key is primary — feasible first, then
            # fastest, ties by client id.
            order = np.lexsort((cands[r], finish[r], infeas[r]))
            out[r] = np.sort(cands[r][order[:K]])
        return out

    def _resolve_round(self, real, cohort=None):
        """One round's realization after the M-wide fault resolution
        (`_chunk_uplink`) and, when sampled, restricted to its cohort (the
        K kept of K + spare candidates with cohort_spare): (real', its
        per-client uplink times, the cohort or None)."""
        mask, t_cm = self._chunk_uplink(real)
        real = dataclasses.replace(real, mask=mask)
        if cohort is not None:
            if self._spare:
                cohort = self._select_cohorts(
                    np.asarray(cohort)[None],
                    np.asarray(t_cm, np.float64)[None])[0]
            real = self._gather_real(real, cohort)
            t_cm = np.asarray(t_cm)[cohort]
        return real, t_cm, cohort

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
                fin = finites[i] if i < len(finites) else None
                if torch.is_tensor(fin):
                    fin = fin.cpu().numpy()
                raise DivergenceError(
                    f"train loss became non-finite ({rec.train_loss}) at "
                    f"round {rec.round} with "
                    f"{'all' if n_p is None else n_p} participating "
                    "clients; .state holds the last-good SimState "
                    "snapshot, .history the records up to the failure",
                    state=snap, history=history[:i + 1], round=rec.round,
                    faults=self._faults, guard=self._guard,
                    finite_mask=fin)
        return len(history)

    # -- the chunked driver -------------------------------------------------
    def _stack_data(self, iters, n: int, cohorts=None):
        """n rounds of data on this simulator's path: batch indices (n, C,
        V, B) on the device-resident path, else host batches, leaves (n, C,
        V, B, ...); C = K lanes when sampled (lane k of round r from client
        cohorts[r, k]), else all M clients."""
        V = self.fed.local_rounds
        if cohorts is None:
            return (stack_chunk_indices(iters, n, V)
                    if self._data_dev is not None
                    else stack_chunk_batches(iters, n, V))
        if self._data_dev is not None:
            return stack_cohort_indices(iters, cohorts, V)
        return stack_batches([stack_cohort_batches(iters, c, V)
                              for c in cohorts])

    def _draw_cohorts(self, stream, n: int):
        """A sampled chunk's host draws, in the reference's order: the
        candidate cohorts (their own generator), then the chunk's
        realization, resolved M-wide (`_chunk_uplink`), then with
        cohort_spare the K kept of each round's candidates: (cohorts (n,
        K), realization, mask (n, M), t_cm (n, M))."""
        cands = stream.draw_cohorts(n)
        chunk = stream.draw_chunk(n)
        mask, t_cm = self._chunk_uplink(chunk)
        cohorts = self._select_cohorts(cands, t_cm) if self._spare else cands
        return cohorts, chunk, mask, t_cm

    def _chunk_inputs(self, iters, stream, n: int,
                      envelope: Optional[tuple] = None):
        """Host-side draws of one member's next n rounds: (the data — batch
        indices (n, C, V, B) on the device-resident path, else the host
        batches, leaves (n, C, V, B, ...) —, participation mask (n, C)
        float32 or None, the host dict of the float64 clock twin for the
        records, or None without a scenario, and a sampled chunk's (n, K)
        float32 cohort sizes, one row a round, or None). With
        `envelope=(V_env, B_env)` (a Study group) the draws are zero-padded
        to (n, C, V_env, B_env, ...): no extra draw, so the iterators and
        the stream advance exactly as in a run of this simulator alone.

        A sampled chunk draws its cohorts and its realization before the
        data (only the cohort's iterators advance), and everything below
        the gather sees only the cohort's columns: mask, clock, bits and
        attempts. That order makes K = M (and K + spare = M with spare
        cohorts) the dense run."""
        V, b = self.fed.local_rounds, self.fed.batch_size
        cohorts = None
        if self._sampled:
            cohorts, chunk, mask_M, t_cm_M = self._draw_cohorts(stream, n)
        xs = self._stack_data(iters, n, cohorts)
        if envelope is not None and tuple(envelope) != (V, b):
            def pad(a):
                out = np.zeros(a.shape[:2] + tuple(envelope) + a.shape[4:],
                               a.dtype)
                out[:, :, :V, :b] = a
                return out

            xs = tree_map(pad, xs)
        if stream is None:
            return xs, None, None, None
        weights = None
        if self._sampled:
            g = lambda a: np.take_along_axis(  # noqa: E731
                np.asarray(a), cohorts, axis=1)
            mask, clock_mask, t_cm = (g(mask_M), g(chunk.clock_mask),
                                      g(t_cm_M))
            t_cp = np.take(self._t_cp_clients, cohorts)
            attempts = None if chunk.attempts is None else g(chunk.attempts)
            weights = np.take(self._sizes_host, cohorts)
        else:
            chunk = stream.draw_chunk(n)
            mask, t_cm = self._chunk_uplink(chunk)
            clock_mask, t_cp = chunk.clock_mask, self._t_cp_clients
            attempts = chunk.attempts
        T_cm, T_cp = delay.chunk_round_times(t_cp, t_cm, clock_mask)
        host = {"T_cm": T_cm, "T_cp": T_cp,
                "n_participants": mask.sum(axis=1)}
        if self._faults is not None:
            host["attempts"] = attempts.sum(axis=1)
        return xs, mask.astype(np.float32), host, weights

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

    def _rewind(self, mat, pre: tuple, t: int) -> None:
        """Reposition a member's host streams as if only the first t
        rounds of the chunk just drawn had been consumed: restore the
        pre-chunk snapshots and replay t rounds of draws (a sampled chunk's
        in `_chunk_inputs`' order: cohorts, realization, data)."""
        iters, stream = mat
        data, stream_state = pre
        if self._sampled:
            stream.set_state(stream_state)
            cohorts = self._draw_cohorts(stream, t)[0]
            if data is not None:
                self._restore_iters(iters, data)
                self._stack_data(iters, t, cohorts)
            return
        if data is not None:
            self._restore_iters(iters, data)
            self._stack_data(iters, t)
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
        major; C = K lanes when sampled, each member with its own cohorts)
        and each chunk is ONE device call for all of them: one index (and
        mask, and with cohorts weights) upload in, one fetch of the round
        outputs out.
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
        # This rank's lanes of each member (all C unsharded).
        C, lanes = self._lanes_local, self._lane_slice
        S = len(states)
        sims = list(sims) if sims is not None else [self] * S
        chunk_fn = self._chunk_fn if chunk_fn is None else chunk_fn
        envelope = None if env is None else (env["v_mask"].shape[1],
                                             env["sample_mask"].shape[1])
        spans.count("fl.drive.calls", 1)
        with spans.span("fl.drive.enter"):
            states = [sim._placed(st) for sim, st in zip(sims, states)]
            mats = [sim._materialize(st) for sim, st in zip(sims, states)]
            gens = [sim._generator(st) for sim, st in zip(sims, states)]
            params = tree_map(lambda *xs: _cat_members(xs),
                              *[self._to_lanes(st.params_C) for st in states])
            opt_state = tree_map(lambda *xs: _cat_members(xs),
                                 *[self._to_lanes(st.opt_C) for st in states])
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
            with spans.span("fl.drive.draws"):
                pre = [(sims[s]._snapshot_iters(mats[s][0]),
                        None if mats[s][1] is None else mats[s][1].state())
                       if max_sim_time else None for s in active]
                drawn = [sims[s]._chunk_inputs(*mats[s], n, envelope)
                         for s in active]
                xs = tree_map(lambda *a: np.concatenate(
                    [x[:, lanes] for x in a], axis=1), *[d[0] for d in drawn])
            with spans.span("fl.drive.upload"):
                if self._data_dev is not None:
                    data, idx = self._data_dev, _upload(xs, self.device)
                else:
                    data, idx = tree_map(lambda a: _upload(a, self.device),
                                         xs), None
                mask = None
                if self.scenario is not None:
                    mask = torch.from_numpy(np.concatenate(
                        [d[1][:, lanes] for d in drawn],
                        axis=1)).to(self.device)
                if self._sampled:
                    # (n, S, K): one row of each member's cohort sizes a
                    # round.
                    weights = torch.from_numpy(np.stack(
                        [d[3] for d in drawn], axis=1)).to(self.device)
                if spans.on():
                    sent = ([idx] if idx is not None else leaves(data)) + [
                        mask, weights if self._sampled else None]
                    spans.count("fl.drive.h2d_bytes", sum(
                        t.nbytes for t in sent if t is not None))
            with spans.span("fl.drive.call"):
                params, opt_state, ys = chunk_fn(
                    params, opt_state, [gens[s] for s in active], weights,
                    data, idx, mask, env)
            with spans.span("fl.drive.fetch"):
                ys = {k: v.cpu().numpy() for k, v in ys.items()}
                spans.resolve()
            spans.count("fl.drive.rounds", n)
            with spans.span("fl.drive.records"):
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
                    checked = self._raise_if_diverged(
                        histories[0], checked, snap, finites)
                    snap = self._state_at(
                        states[0], *self._from_lanes(params, opt_state),
                        gens[0], mats[0], r0 + len(histories[0]), times[0])
            if evaluate is not None and (done % eval_every == 0
                                         or done == max_rounds):
                with spans.span("fl.drive.eval"):
                    evs = evaluate(tree_map(
                        lambda x: x.reshape(-1, C, *x.shape[1:])[:, 0],
                        params))
                    for i, s in enumerate(active):
                        rec = histories[s][-1]
                        # A member truncated inside the chunk has no eval
                        # here (its run alone would not evaluate there
                        # either).
                        if rec.round != r0 + done:
                            continue
                        rec.test_acc = float(evs[i].get("acc", np.nan))
                        rec.test_loss = float(evs[i].get("loss", np.nan))
                        if target_acc and rec.test_acc >= target_acc:
                            stopped.add(s)
            if len(stopped) == len(active):
                break
            if stopped:
                with spans.span("fl.drive.records"):
                    keep = [i for i, s in enumerate(active)
                            if s not in stopped]
                    for i, s in enumerate(active):
                        if s in stopped:
                            finals[s] = tuple(
                                tree_map(lambda x: _member(x, C, i).clone(),
                                         t)
                                for t in (params, opt_state))
                    params, opt_state = (
                        tree_map(lambda x: _members(x, C, keep), t)
                        for t in (params, opt_state))
                    if env is not None:
                        env = {k: _members(x, C, keep)
                               for k, x in env.items()}
                    active = [active[i] for i in keep]
        with spans.span("fl.drive.exit"):
            for i, s in enumerate(active):
                finals[s] = tuple(tree_map(lambda x: _member(x, C, i), t)
                                  for t in (params, opt_state))
            out = [sims[s]._state_at(st, *self._from_lanes(*finals[s]),
                                     gens[s], mats[s],
                                     r0 + len(histories[s]), times[s])
                   for s, st in enumerate(states)]
        return out, histories

    # -- per-round execution ('batched', 'loop'; run_round on all three) ---
    def run_round(self, state: SimState, real=None, t_cm_clients=None):
        """One communication round: (state', metrics dict). `real` is the
        scenario's realization of the round (drawn from the state's
        stream when omitted); giving one to a scenario-less simulator
        raises, and so does giving one to a sampled simulator (an M-wide
        realization from outside has no cohort: the state's stream draws
        both). `t_cm_clients`, the reference's per-client uplink times
        for its in-graph clock, is checked and not used: the port's round
        has no in-graph clock (the records take it from the host model,
        core/delay.py). 'scan' shares the batched round here. As in the
        reference, the state's clock does not advance (run() keeps it).

        metrics: 'train_loss' (a device scalar on the stacked backends, a
        float on 'loop'), and under a scenario 'n_participants', on the
        fault path also 'finite' and, with a quorum, 'rejected'."""
        if self.backend == "async":
            raise ValueError(
                "run_round is round-synchronous; backend='async' advances "
                "by arrival events, not rounds — use run() (aggregation "
                "cadence) or run_events() (exact event counts).")
        if real is not None and self.scenario is None:
            raise ValueError(
                "run_round(real=...) was given a scenario realization but "
                "this simulation has no scenario — the mask/channel inputs "
                "would be silently ignored. Construct the Simulator with "
                "scenario=... or drop the argument.")
        if real is not None and self._sampled:
            raise ValueError(
                "run_round(real=...) is unsupported with sampled cohorts: "
                "an externally supplied M-wide realization has no cohort "
                "to condition on. Drop the argument (the state's stream "
                "draws both) or run dense.")
        if t_cm_clients is not None and self.scenario is None:
            raise ValueError(
                "run_round(t_cm_clients=...) was given uplink times but "
                "this simulation has no scenario — they would be silently "
                "ignored. Drop the argument.")
        M = self.fed.n_devices
        for what, arr in (("real.mask", None if real is None else real.mask),
                          ("t_cm_clients", t_cm_clients)):
            if arr is not None and np.shape(arr) != (M,):
                raise ValueError(
                    f"run_round: {what} has shape {np.shape(arr)}, and "
                    f"this simulation has M={M} clients")
        state = self._placed(state)
        mat = self._materialize(state)
        iters, stream = mat
        gen = self._generator(state)
        cohort = None
        if self.scenario is not None and real is None:
            if self._sampled:
                cohort = stream.draw_cohort()
            real = stream.next_round()
        if real is not None:
            real, _, cohort = self._resolve_round(real, cohort)
        params_C, opt_C, metrics = self._round(
            state.params_C, state.opt_C, gen, iters, real, cohort)
        return self._state_at(state, params_C, opt_C, gen, mat,
                              state.round + 1, state.sim_time), metrics

    def _round(self, params_C, opt_C, gen, iters, real, cohort=None):
        if self.backend == "loop":
            return self._round_loop(params_C, opt_C, gen, iters, real)
        return self._round_batched(params_C, opt_C, gen, iters, real, cohort)

    def _round_batched(self, params_C, opt_C, gen, iters, real, cohort=None):
        """The stacked round (mesh_rounds.build_fleet_round, the chunk
        path's step) on one upload of the round's host batches: every
        client's, or a sampled round's cohort's (lane k from client
        cohort[k], with that client's size)."""
        V, lanes = self.fed.local_rounds, self._lane_slice
        batches = tree_map(lambda x: _upload(x[lanes], self.device),
                           stack_client_batches(iters, V) if cohort is None
                           else stack_cohort_batches(iters, cohort, V))
        mask = (None if real is None else torch.from_numpy(
            np.asarray(real.mask, np.float32)[lanes]).to(self.device))
        if real is None:
            weights = self._weights
        elif cohort is None:
            weights = self._sizes
        else:
            weights = torch.from_numpy(
                self._sizes_host[cohort][None]).to(self.device)
        params_C, opt_C, ys = self._round_fn(
            self._to_lanes(params_C), self._to_lanes(opt_C), [gen], weights,
            batches, mask)
        params_C, opt_C = self._from_lanes(params_C, opt_C)
        out = {"train_loss": ys["loss"][0]}  # a device scalar
        if real is not None:
            if self._faults is None:
                out["n_participants"] = real.n_participants
            else:
                # The guard decides on the device: the post-guard count,
                # synced at the next eval boundary with the loss.
                out.update({k: ys[k][0] for k in
                            ("n_participants", "finite", "rejected")
                            if k in ys})
        return params_C, opt_C, out

    def _round_loop(self, params, opt_states, gen, iters, real):
        """The reference's per-client host loop (simulation.py:1408): each
        participating client's V steps alone, the guard's float32 norm
        and clip, its own quantize launch, then server.aggregate_updates.
        Every client's batches are drawn every round, participating or
        not, as stack_client_batches draws them; the round's noise is the
        batched round's one draw for all M clients, row m for client m."""
        V, M = self.fed.local_rounds, len(iters)
        u = None
        if self.fed.compress_updates:
            u = self.noise(gen, (M, self._rows, compression.ROW))
        mask = (np.ones(M, bool) if real is None
                else np.asarray(real.mask, bool))
        opt_states = list(opt_states)
        # The quorum gate's reference: a rejected round restores every
        # client's pre-round optimizer state.
        pre_opts = list(opt_states) if self._quorum is not None else None
        deltas, sizes, losses = [], [], []
        for m, it in enumerate(iters):
            raw = [it.next_batch() for _ in range(V)]
            if not mask[m]:
                continue
            batches = tree_map(lambda x: _upload(x, self.device),
                               stack_batches(raw))
            prev_opt = opt_states[m]
            delta, opt_states[m], loss_v = client_round(
                self.local_update, params, opt_states[m], batches)
            loss_m = float(mesh_rounds.fold_mean(list(loss_v)))
            if self._guard is not None:
                max_norm, reject = self._guard
                sq = torch.zeros((), dtype=torch.float32, device=self.device)
                for d in leaves(delta):
                    sq = sq + torch.sum(d.to(torch.float32) ** 2)
                norm = float(torch.sqrt(sq))
                finite = bool(np.isfinite(norm) and np.isfinite(loss_m))
                if reject and not finite:
                    # Rejected = dropped this round: its pre-round
                    # optimizer state back, no delta, not a participant.
                    opt_states[m] = prev_opt
                    continue
                if np.isfinite(max_norm) and finite:
                    scale = torch.tensor(min(1.0, max_norm / max(norm, 1e-12)),
                                         dtype=torch.float32,
                                         device=self.device)
                    # The batched clip exactly: the clipped params o + d*s,
                    # and the delta taken again from them.
                    delta = tree_map(
                        lambda o, d: (o.to(torch.float32)
                                      + d.to(torch.float32) * scale)
                        - o.to(torch.float32), params, delta)
            if u is not None:
                delta = compression.decompress_update(
                    compression.compress_update(delta, u[m]))
            deltas.append(delta)
            sizes.append(self.data_sizes[m])
            losses.append(loss_m)
        rejected = None
        if self._quorum is not None and real is not None:
            n_q = len(deltas) if self._guard is not None else int(mask.sum())
            rejected = n_q < self._quorum
        if rejected and self._quorum_policy == "reject":
            # Below quorum the round writes nothing (the clock still
            # advances; run() adds the re-dispatch cost).
            opt_states = pre_opts
        elif deltas:  # a round without participants keeps the params
            params = aggregate_updates(params, deltas, sizes)
        out = {"train_loss": float(np.mean(losses)) if losses
               else float("nan")}
        if real is not None:
            out["n_participants"] = (len(deltas) if self._guard is not None
                                     else int(mask.sum()))
            if rejected is not None:
                out["rejected"] = rejected
        return params, tuple(opt_states), out

    @staticmethod
    def _sync_history(history: List[RoundRecord]) -> None:
        """The host-sync boundary: losses (and, on the fault path,
        participant counts) still on the device become host numbers."""
        for rec in history:
            if not isinstance(rec.train_loss, float):
                rec.train_loss = float(rec.train_loss)
            if rec.n_participants is not None and not isinstance(
                    rec.n_participants, int):
                rec.n_participants = int(rec.n_participants)

    def _run_rounds(self, state, max_rounds, target_acc, eval_every,
                    max_sim_time):
        """run() on 'batched' and 'loop': the reference's per-round loop
        (simulation.py:2118-2225), one round step a round. The batched
        step's losses (and on the fault path its participant counts,
        finite flags and quorum flags: the quorum flag is read every round
        for the clock) stay on the device between eval_every boundaries."""
        state = self._placed(state)
        mat = self._materialize(state)
        iters, stream = mat
        gen = self._generator(state)
        guard_on = (self._faults is not None
                    and self._faults.divergence_guard)
        snap, checked, finites = state, 0, []
        params_C, opt_C = state.params_C, state.opt_C
        history: List[RoundRecord] = []
        sim_time, r0 = state.sim_time, state.round
        T_cm, T_cp = self.round_times()
        V = self.fed.local_rounds
        update_bits = self._update_bits()
        for k in range(1, max_rounds + 1):
            real = n_attempts = cohort = None
            if stream is not None:
                # The round's realization on the host (a sampled round's
                # cohort first, and the realization gathered to it), its
                # Eq. 8 clock as the straggler max over the clients the
                # server waits for, and the same realization to the step.
                if self._sampled:
                    cohort = stream.draw_cohort()
                real, t_cm_clients, cohort = self._resolve_round(
                    stream.next_round(), cohort)
                if self._faults is not None:
                    n_attempts = int(real.attempts.sum())
                t_cp = (self._t_cp_clients if cohort is None
                        else self._t_cp_clients[cohort])
                T_cm, T_cp = delay.masked_round_times(
                    t_cp, t_cm_clients, real.clock_mask)
            params_C, opt_C, metrics = self._round(params_C, opt_C, gen,
                                                   iters, real, cohort)
            sim_time += delay.round_time(T_cm, T_cp, V,
                                         deadline=self._deadline)
            rej = metrics.get("rejected")
            if rej is not None:
                rej = bool(rej)
                if rej and self._quorum_policy == "reject":
                    sim_time += self._faults.redispatch_cost
            n_part = metrics.get("n_participants")
            if n_attempts is not None:
                bits = float(n_attempts * update_bits)
            else:
                bits = float((self.fed.n_devices if n_part is None
                              else n_part) * update_bits)
            rec = RoundRecord(
                round=r0 + k, sim_time=sim_time, T_cm=T_cm, T_cp=T_cp,
                train_loss=metrics["train_loss"], uplink_bits=bits,
                n_participants=n_part, rejected=rej)
            history.append(rec)
            if guard_on:
                finites.append(metrics.get("finite"))
            at_boundary = k % eval_every == 0 or k == max_rounds
            if self.eval_fn is not None and at_boundary:
                ev = self.eval_fn(self._params_from(params_C))
                rec.test_acc = float(ev.get("acc", np.nan))
                rec.test_loss = float(ev.get("loss", np.nan))
            if at_boundary:
                self._sync_history(history)
                if guard_on:
                    checked = self._raise_if_diverged(history, checked, snap,
                                                      finites)
                    snap = self._state_at(state, params_C, opt_C, gen, mat,
                                          r0 + k, sim_time)
            if (target_acc and rec.test_acc is not None
                    and rec.test_acc >= target_acc):
                break
            if max_sim_time and sim_time >= max_sim_time:
                break
        self._sync_history(history)
        if guard_on:
            self._raise_if_diverged(history, checked, snap, finites)
        out = self._state_at(state, params_C, opt_C, gen, mat,
                             r0 + len(history), sim_time)
        return out, SimResult(history=history,
                              params=self._params_from(params_C),
                              label=self.label, fed=self.fed)

    # -- asynchronous (event-driven) execution ------------------------------
    def _async_dispatch_draw(self, stream):
        """One M-wide dispatch realization from the scenario stream:
        (t_svc float32, drop float32, t_cm float64, attempts float64), all
        (M,). t_svc is the service time V*t_cp + effective uplink, in
        float32 (it feeds the float32 schedule, twin and device alike);
        drop marks the dispatches whose update will be lost: the scenario's
        mask after the fault layer's deadline cut, resolved M-wide in
        float64 by `_resolve_round` exactly as a synchronous round's.
        Retransmission attempts and backoff are inside the effective uplink
        time, so a retrying client simply finishes later."""
        real = stream.next_round()
        if self._faults is not None:
            real, t_cm, _ = self._resolve_round(real)
            attempts = np.asarray(real.attempts, np.float64)
        else:
            t_cm = delay.per_client_uplink_time(
                self._update_bits(), self.wireless, self.pop.p, real.h)
            attempts = np.ones(self.fed.n_devices, np.float64)
        t_svc = (self.fed.local_rounds * self._t_cp_clients
                 + t_cm).astype(np.float32)
        drop = (~np.asarray(real.mask, bool)).astype(np.float32)
        return t_svc, drop, np.asarray(t_cm, np.float64), attempts

    def _async_twin(self, state: SimState) -> events.TwinState:
        """The host float32 schedule twin positioned at `state`: one fetch
        of the carry's scheduling leaves (params stay on the device)."""
        a = {k: state.async_c[k].cpu().numpy() for k in (
            "t_finish", "t_next", "drop_C", "version", "version_C", "cnt",
            "now")}
        h = state.async_host
        return events.TwinState(
            t_finish=np.asarray(a["t_finish"], np.float32).copy(),
            t_next=np.asarray(a["t_next"], np.float32).copy(),
            drop=np.asarray(a["drop_C"], np.float32).copy(),
            version=int(a["version"]),
            version_disp=np.asarray(a["version_C"], np.int32).copy(),
            cnt=int(a["cnt"]),
            now=np.float32(a["now"]),
            t_cm_disp=np.asarray(h["t_cm_disp"], np.float64).copy(),
            attempts_disp=np.asarray(h["attempts_disp"], np.float64).copy())

    def _async_chunk_inputs(self, iters, twin, stream, stop_aggs=None,
                            stop_events=None, max_sim_time=None):
        """The host side of one event chunk: advance the twin event by
        event — one M-wide dispatch draw and the arriving client's V
        batches an event — until `stop_aggs` aggregations have fired (a
        chunk ends at an aggregation boundary, the async form of
        eval_every chunks), an aggregation reaches `max_sim_time`,
        `stop_events` events have run (run_events), or the budget E is
        full. Returns (xs on the host, [TwinEvent], n_events); the twin
        is advanced in place. Only the chunk's events are stacked (the
        reference pads to E for its one compiled trace)."""
        V = self.fed.local_rounds
        limit = (self._async_E if stop_events is None
                 else min(self._async_E, int(stop_events)))
        t_svc_rows, drop_rows, data_rows, evs = [], [], [], []
        n_aggs = 0
        while len(evs) < limit:
            c = int(np.argmin(twin.t_finish))
            # The arriving client's batches: its iterator advances at
            # arrival (per-client streams are independent, so client c's
            # k-th dispatch takes its k-th block of V batches).
            it = iters[c]
            if self._data_dev is not None:
                data_rows.append(np.stack(
                    [it.next_indices() for _ in range(V)]).astype(np.int32))
            else:
                data_rows.append(stack_batches(
                    [it.next_batch() for _ in range(V)]))
            t_svc, drop, t_cm, att = self._async_dispatch_draw(stream)
            e = events.twin_step(self._async, twin, t_svc, drop, t_cm, att)
            assert e.client == c
            t_svc_rows.append(t_svc)
            drop_rows.append(drop)
            evs.append(e)
            if e.aggregated and stop_events is None:
                n_aggs += 1
                if stop_aggs is not None and n_aggs >= stop_aggs:
                    break
                if (max_sim_time is not None
                        and float(e.t_event) >= max_sim_time):
                    break
        xs = {"t_svc": np.stack(t_svc_rows), "drop_next": np.stack(drop_rows)}
        if self._data_dev is not None:
            xs["idx"] = np.stack(data_rows)
        else:
            xs["batches"] = stack_batches(data_rows)
        return xs, evs, len(evs)

    def _async_call(self, params_C, opt_C, gen, async_c, xs):
        """One event chunk on the device: xs uploaded first (one transfer a
        leaf), the chunk (no host synchronisation inside), then the
        chunk's ONE fetch: every output packed into one float64 (E, 8)
        tensor (exact for its float32, int32 and bool values) and copied
        to the host together. Returns (params_C', opt_C', async_c', ys as
        numpy columns)."""
        dev = self.device
        inputs = {"t_svc": torch.from_numpy(xs["t_svc"]).to(dev),
                  "drop_next": torch.from_numpy(xs["drop_next"]).to(dev)}
        if "idx" in xs:
            inputs["idx"] = _upload(xs["idx"], dev)
        else:
            inputs["batches"] = tree_map(lambda a: _upload(a, dev),
                                         xs["batches"])
        params_C, opt_C, async_c, ys = self._chunk_fn(
            params_C, opt_C, gen, async_c, self._sizes, self._data_dev,
            inputs)
        return params_C, opt_C, async_c, fetch_columns(ys)

    def _async_records(self, ys, evs, n_ev: int, r0: int, bits_acc: float):
        """One RoundRecord an aggregation of a fetched event chunk, and
        the uplink-bits accumulator carried on (the bits of the arrivals
        since the last aggregation: it spans chunks and checkpoints in
        SimState.async_host). First the device's pops are checked against
        the twin's, event by event: a mismatch raises RuntimeError, since
        every record would be misattributed.

        An async 'round' is one buffer fill: sim_time is the absolute
        float32 event clock at the filling arrival (the event clock is
        the schedule); T_cm and T_cp are the filling update's own float64
        uplink and compute times."""
        clients = np.asarray(ys["client"][:n_ev]).astype(np.int32)
        twin_clients = np.array([e.client for e in evs], np.int32)
        if not np.array_equal(clients, twin_clients):
            j = int(np.argmin(clients == twin_clients))
            raise RuntimeError(
                "async schedule twin diverged from the compiled event "
                f"queue at event {j}: twin predicted client "
                f"{int(twin_clients[j])}, the scan popped "
                f"{int(clients[j])}. The f32 replay contract "
                "(events.twin_step) is broken — records would be "
                "misattributed, refusing to continue.")
        update_bits = self._update_bits()
        records = []
        k = 0
        for j, e in enumerate(evs):
            # Every arrival's dispatch paid its uplink: on the fault path
            # every retransmission attempt, dropped or not (the
            # synchronous rounds' attempts rule); else one upload a kept
            # arrival.
            if self._faults is not None:
                bits_acc += float(e.attempts_done) * update_bits
            elif not e.dropped:
                bits_acc += update_bits
            if e.aggregated:
                k += 1
                records.append(RoundRecord(
                    round=r0 + k, sim_time=float(e.t_event),
                    T_cm=float(e.t_cm_done),
                    T_cp=float(self._t_cp_clients[e.client]),
                    train_loss=float(ys["loss_agg"][j]),
                    n_participants=int(self._async.buffer_size),
                    uplink_bits=bits_acc))
                bits_acc = 0.0
        return records, bits_acc

    def _async_state(self, state, params_C, opt_C, gen, async_c, twin, mat,
                     rnd: int, n_events: int, bits_acc: float) -> SimState:
        """`state` advanced over async chunks: the device carry, the
        twin's float64 dispatch bookkeeping and the event cursor; the
        clock is the twin's event clock."""
        return dataclasses.replace(
            self._state_at(state, params_C, opt_C, gen, mat, rnd,
                           float(twin.now)),
            async_c=async_c, event=int(state.event) + int(n_events),
            async_host={"t_cm_disp": twin.t_cm_disp.copy(),
                        "attempts_disp": twin.attempts_disp.copy(),
                        "bits_acc": float(bits_acc)})

    def _async_begin(self, state: SimState):
        """An async run's live parts at `state`: (state on this device,
        (iterators, stream), generator, twin, bits accumulator)."""
        state = self._placed(state)
        mat = self._materialize(state)
        return (state, mat, self._generator(state), self._async_twin(state),
                float(state.async_host.get("bits_acc", 0.0)))

    def _run_async(self, state, max_rounds, target_acc, eval_every,
                   max_sim_time):
        """run() on 'async': chunks of events ending at aggregation
        boundaries (so eval falls where a synchronous run's does),
        one upload and one fetch a chunk. A 'round' is a buffer fill;
        max_rounds counts fills. Eval takes the global model params_g."""
        state, mat, gen, twin, bits_acc = self._async_begin(state)
        iters, stream = mat
        params_C, opt_C, async_c = state.params_C, state.opt_C, state.async_c
        history: List[RoundRecord] = []
        r0 = state.round
        n_events = 0
        done, stop, idle_chunks = 0, False, 0
        while done < max_rounds and not stop:
            n_t = min(eval_every - done % eval_every, max_rounds - done)
            xs, evs, n_ev = self._async_chunk_inputs(
                iters, twin, stream, stop_aggs=n_t,
                max_sim_time=max_sim_time)
            params_C, opt_C, async_c, ys = self._async_call(
                params_C, opt_C, gen, async_c, xs)
            records, bits_acc = self._async_records(
                ys, evs, n_ev, r0 + done, bits_acc)
            n_events += n_ev
            history.extend(records)
            done += len(records)
            # Aggregation-progress watchdog: a scenario that drops every
            # update (or a buffer the surviving arrivals can never fill)
            # would otherwise run chunks forever.
            idle_chunks = 0 if records else idle_chunks + 1
            if idle_chunks >= 1000:
                raise RuntimeError(
                    f"async run made no aggregation progress over "
                    f"{idle_chunks * self._async_E} consecutive events "
                    f"(buffer_size={self._async.buffer_size}) — the "
                    "scenario drops too many updates to ever fill the "
                    "buffer. Shrink buffer_size or fix the scenario.")
            if max_sim_time and float(twin.now) >= max_sim_time:
                stop = True
            at_boundary = done > 0 and (done % eval_every == 0
                                        or done == max_rounds)
            if self.eval_fn and records and (at_boundary or stop):
                rec = history[-1]
                ev = self.eval_fn(async_c["params_g"])
                rec.test_acc = float(ev.get("acc", np.nan))
                rec.test_loss = float(ev.get("loss", np.nan))
                if (target_acc and rec.test_acc is not None
                        and rec.test_acc >= target_acc):
                    stop = True
        out = self._async_state(state, params_C, opt_C, gen, async_c, twin,
                                mat, r0 + done, n_events, bits_acc)
        return out, SimResult(history=history, params=async_c["params_g"],
                              label=self.label, fed=self.fed)

    def run_events(self, state: SimState, events: int):
        """Run EXACTLY `events` arrival events ('async' only): (state',
        [RoundRecord] of the aggregations among them). Unlike run(), this
        may stop mid-buffer: the pending updates, the partial buffer and
        the event cursor live in the returned state, and a save_state /
        load_state / resume from it is the uninterrupted run bit for
        bit."""
        if self.backend != "async":
            raise ValueError(
                f"run_events requires backend='async', not {self.backend!r}")
        if not isinstance(events, (int, np.integer)) or events < 1:
            raise ValueError(f"events must be an int >= 1, got {events!r}")
        state, mat, gen, twin, bits_acc = self._async_begin(state)
        iters, stream = mat
        params_C, opt_C, async_c = state.params_C, state.opt_C, state.async_c
        history: List[RoundRecord] = []
        done_ev = 0
        while done_ev < events:
            xs, evs, n_ev = self._async_chunk_inputs(
                iters, twin, stream, stop_events=events - done_ev)
            params_C, opt_C, async_c, ys = self._async_call(
                params_C, opt_C, gen, async_c, xs)
            records, bits_acc = self._async_records(
                ys, evs, n_ev, state.round + len(history), bits_acc)
            history.extend(records)
            done_ev += n_ev
        out = self._async_state(state, params_C, opt_C, gen, async_c, twin,
                                mat, state.round + len(history), done_ev,
                                bits_acc)
        return out, history

    def run_chunk(self, state: SimState, rounds: int):
        """Run `rounds` rounds as one chunk, without evaluation:
        (state', [RoundRecord]) ('scan' backend)."""
        if self.backend != "scan":
            raise ValueError(
                f"run_chunk requires backend='scan', not {self.backend!r}")
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
        """Run up to `max_rounds` MORE rounds from `state`: (state',
        SimResult). Round numbers and the Eq. 8 clock continue from the
        state's cursors, so a run resumed from a checkpoint (save_state /
        load_state) gives the history an uninterrupted run would; params
        and optimizer state held on the CPU (a loaded checkpoint's) move
        to this simulator's device first.

        'scan' runs chunks of `eval_every` rounds. With an eval_fn, test
        accuracy is taken at each chunk's end, and a run with target_acc
        stops at the first chunk that reaches it. With max_sim_time the
        history stops at the first round whose clock reaches it, and the
        returned state's data iterators are rewound to that round (so a
        resumed run draws the next round's batches) while its params and
        noise generator are those at the end of the chunk, as in the
        reference's scan backend. 'batched' and 'loop' run round by round
        (`_run_rounds`): eval at each multiple of eval_every, and both
        stops fall after the round that reaches them, with the state of
        that round.

        With the fault layer's divergence_guard (on by default in an
        active FaultModel), a non-finite train loss on a round with
        participants raises DivergenceError carrying the state before the
        chunk. `recovery=RecoveryPolicy(...)` catches it instead: the run
        resumes from that state with the learning rate backed off (and the
        guard norm optionally tightened), at most max_restarts times, each
        restart recorded in SimResult.restarts.

        'async' runs max_rounds aggregations (buffer fills) as chunks of
        events ending at aggregation boundaries, eval on the global model
        at each multiple of eval_every, and stops after the aggregation
        whose event clock reaches max_sim_time; it has no divergence
        guard, so recovery= raises ValueError."""
        _validate_run_args(max_rounds, eval_every)
        if self.backend == "async":
            if recovery is not None:
                raise ValueError(
                    "recovery=RecoveryPolicy requires the divergence-"
                    "guarded sync backends — backend='async' has no "
                    "in-graph guard to raise from. Use backend='scan'.")
            return self._run_async(state, max_rounds, target_acc,
                                   eval_every, max_sim_time)
        if recovery is not None:
            return self._run_recovering(state, recovery, max_rounds,
                                        target_acc, eval_every, max_sim_time)
        if self.backend != "scan":
            return self._run_rounds(state, max_rounds, target_acc,
                                    eval_every, max_sim_time)
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
        if self.backend != "scan":
            raise ValueError(
                f"run_fleet requires backend='scan', not {self.backend!r}")
        if target_acc and self.eval_batch_fn is None:
            raise ValueError(
                "run_fleet(target_acc=...) needs an eval_fn/eval_batch_fn "
                "(build the spec with with_eval=True)")
        if not callable(self._data_src):
            raise ValueError(
                "run_fleet needs a per-seed data factory: this Simulator "
                "was built on a list of live iterators, which every member "
                "would share (and advance past each other). Construct it "
                "with data=lambda seed: [...fresh iterators...] or through "
                "ExperimentSpec.build().")
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


def fetch_columns(ys: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A chunk's per-event outputs (equal-length 1-D tensors of float32,
    int32 or bool) copied to the host in ONE transfer: stacked as float64
    columns, which hold every such value exactly, and split again on the
    host (float64 numpy columns)."""
    keys = sorted(ys)
    if not keys:
        return {}
    host = torch.stack([ys[k].to(torch.float64) for k in keys],
                       dim=1).cpu().numpy()
    return {k: host[:, i] for i, k in enumerate(keys)}


def _upload(x, device) -> torch.Tensor:
    """A host array as a tensor on `device`: floating point as float32,
    integers (labels, batch indices) as int64."""
    t = torch.as_tensor(np.asarray(x))
    return t.to(device, torch.float32 if t.is_floating_point()
                else torch.int64)


def _rng_kind(rng: torch.Tensor) -> str:
    """'CPU' or 'CUDA': the kind of generator a SimState.rng came from (the
    two kinds' states differ in size)."""
    return ("CPU" if rng.numel() == torch.Generator().get_state().numel()
            else "CUDA")


# -- checkpoints ----------------------------------------------------------------

# Checkpoint schema version: bump when the on-disk payload layout changes.
_STATE_VERSION = 1


def _state_signature(state: SimState) -> tuple:
    """Shape signature of a state's (params, opt, rng) trio: the trio's
    structure and every leaf's shape and dtype. Metadata only, so it is
    cheap at save and at load, and it catches a checkpoint fed to the
    wrong spec (or a corrupt payload) before the first round does. An
    async state appends its event carry; a synchronous state's signature
    is the trio's, as before."""
    trio = (state.params_C, state.opt_C, state.rng)
    if getattr(state, "async_c", None) is not None:
        trio = trio + (state.async_c,)
    return (structure(trio), tuple((tuple(x.shape), str(x.dtype))
                                   for x in leaves(trio)))


def _host_copy(tree):
    """Every tensor of `tree` as its own contiguous copy on the CPU (never
    a view, which would pickle its whole base)."""
    return tree_map(lambda x: x.detach().to("cpu").clone(
        memory_format=torch.contiguous_format), tree)


def save_state(path: str, state: SimState) -> None:
    """Checkpoint a SimState: its tensors copied to the CPU, and the whole
    value (host stream and iterator snapshots included) pickled under a
    versioned envelope with the state's shape signature, written
    crash-safely (`_atomic_pickle`). `load_state` + `Simulator.run`
    continues the run bit for bit, on the kind of device the state was
    made on (its noise generator's state is that device's). Under a
    torch.distributed group (a sharded run, whose ranks hold the same
    state) rank 0 alone writes and every rank waits until the file is
    there (collectives.on_rank0); `load_state` then runs on every rank."""
    host = dataclasses.replace(
        state, params_C=_host_copy(state.params_C),
        opt_C=_host_copy(state.opt_C), rng=_host_copy(state.rng),
        async_c=(None if state.async_c is None
                 else _host_copy(state.async_c)))
    collectives.on_rank0(lambda: _atomic_pickle(
        path, {"__repro_simstate__": _STATE_VERSION,
               "signature": _state_signature(host), "state": host}))


def load_state(path: str, like: Optional[SimState] = None) -> SimState:
    """Restore a `save_state` checkpoint, its tensors on the CPU (`run`
    moves them to its device).

    The payload is checked first — schema version, the type it holds, and
    the stored shape signature against its leaves — so corruption or a
    version skew fails here with a ValueError. `like=` (any SimState of
    the target simulator, e.g. `sim.init()`) also checks that the
    checkpoint was saved from a simulator of the same shapes, and on the
    same kind of device. A bare pickled SimState (the reference's legacy
    form) loads too, and so does a checkpoint written before the async
    fields existed (they take their synchronous defaults)."""
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except (pickle.UnpicklingError, EOFError, AttributeError) as e:
        raise ValueError(
            f"{path!r} is not a readable checkpoint "
            f"(corrupt or truncated pickle): {e}") from e
    if isinstance(payload, SimState):  # legacy: a bare SimState pickle
        state = payload
    elif isinstance(payload, dict) and "__repro_simstate__" in payload:
        version = payload["__repro_simstate__"]
        if version != _STATE_VERSION:
            raise ValueError(
                f"{path!r} holds checkpoint schema v{version}, this build "
                f"reads v{_STATE_VERSION} — re-save the state with this "
                "version (or load it with the matching build)")
        state = payload.get("state")
        if not isinstance(state, SimState):
            raise ValueError(f"{path!r} does not hold a SimState")
        sig = payload.get("signature")
        if sig is not None and sig != _state_signature(state):
            raise ValueError(
                f"{path!r} is corrupt: its stored shape signature does not "
                "match the payload's leaves")
    else:
        raise ValueError(f"{path!r} does not hold a SimState")
    if "async_c" not in vars(state):
        # Pickled before the async fields existed: pickle restored the old
        # instance dict, so install the synchronous defaults.
        for name, value in (("async_c", None), ("event", 0),
                            ("async_host", None)):
            object.__setattr__(state, name, value)
    if like is not None:
        if _rng_kind(like.rng) != _rng_kind(state.rng):
            raise ValueError(
                f"checkpoint {path!r} holds a {_rng_kind(state.rng)} "
                f"generator's state and the target simulator runs a "
                f"{_rng_kind(like.rng)} generator: a state saved on the "
                "card resumes on the card, and one saved on the CPU on the "
                "CPU")
        if _state_signature(like) != _state_signature(state):
            raise ValueError(
                f"checkpoint {path!r} was saved from a different spec: its "
                "(params, opt, rng) shape signature does not match the "
                "target simulator's states")
    return state


# -- the deprecated stateful facade ----------------------------------------------

_FLSIM_WARNED = False


class FLSimulation:
    """Deprecated: the reference's old mutable simulator interface, a thin
    shim holding a (Simulator, SimState) pair. Build a `Simulator` (or an
    experiment.ExperimentSpec) and thread `SimState` through `run()`
    instead: that is what gives run_fleet, checkpoints and multi-seed
    sweeps. Emits one `DeprecationWarning` a process."""

    def __init__(
        self,
        loss_fn: Callable,
        init_params: Any,
        client_iterators: List,
        data_sizes: np.ndarray,
        fed: FedConfig,
        opt: Optimizer,
        pop: delay.DevicePopulation,
        wireless: Optional[WirelessConfig] = None,
        eval_fn: Optional[Callable] = None,
        label: str = "defl",
        backend: str = "scan",
        scenario: Any = None,
        device=None,
    ):
        global _FLSIM_WARNED
        if not _FLSIM_WARNED:
            warnings.warn(
                "FLSimulation is deprecated: build a "
                "repro_torch.federated.simulation.Simulator (or an "
                "repro_torch.federated.experiment.ExperimentSpec) and "
                "thread SimState through run()/run_fleet() instead.",
                DeprecationWarning, stacklevel=2)
            _FLSIM_WARNED = True
        self.sim = Simulator(
            loss_fn, init_params, client_iterators, data_sizes, fed, opt,
            pop, wireless=wireless, eval_fn=eval_fn, label=label,
            device=device, scenario=scenario, backend=backend,
            eval_batch_fn=None if eval_fn is None else _members_eval(eval_fn))
        self.state = self.sim.init(fed.seed)

    def __getattr__(self, name):
        # The simulator's views (fed, pop, round_times, _update_bits, ...);
        # __getattr__ fires only for names the shim itself lacks.
        if name in ("sim", "state"):
            raise AttributeError(name)
        return getattr(self.sim, name)

    @property
    def eval_fn(self):
        return self.sim.eval_fn

    @eval_fn.setter
    def eval_fn(self, fn):
        self.sim.eval_fn = fn
        self.sim.eval_batch_fn = None if fn is None else _members_eval(fn)

    @property
    def params(self):
        return self.sim.params(self.state)

    def run_round(self, real=None, t_cm_clients=None) -> Dict:
        self.state, metrics = self.sim.run_round(self.state, real,
                                                 t_cm_clients)
        return metrics

    def run(self, max_rounds: int = 200, target_acc: Optional[float] = None,
            eval_every: int = 1, max_sim_time: Optional[float] = None,
            ) -> SimResult:
        self.state, res = self.sim.run(
            self.state, max_rounds=max_rounds, target_acc=target_acc,
            eval_every=eval_every, max_sim_time=max_sim_time)
        return res


def _members_eval(eval_fn: Callable) -> Callable:
    """An eval_batch_fn from an eval_fn: one call a member of the stacked
    (S, ...) models, each value stacked to (S,)."""
    def eval_batch_fn(params_S):
        evs = [eval_fn(tree_map(lambda x, i=i: x[i], params_S))
               for i in range(leaves(params_S)[0].shape[0])]
        return {k: np.asarray([ev[k] for ev in evs]) for k in evs[0]}

    return eval_batch_fn


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
