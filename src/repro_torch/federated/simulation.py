"""Host-level FL simulator: Algorithm 1 with the paper's delay accounting.

Runs real training (PyTorch, on the card) while advancing a *simulated*
wall clock from the paper's delay models (Eqs. 5, 7, 8). Port of the
reference's `Simulator` (repro/federated/simulation.py) for a dense,
fully participating population on its chunked ('scan') driver:

    sim   = Simulator(loss_fn, params, data_factory, sizes, fed, opt, pop)
    state = sim.init(seed)
    state, result  = sim.run(state, max_rounds=100, eval_every=10)
    state, records = sim.run_chunk(state, rounds=10)
    fleet = sim.run_fleet(seeds=range(8), max_rounds=100, eval_every=10)

A chunk of `eval_every` rounds runs on the device with no host
synchronisation inside: the batch indices of the whole chunk go up in one
transfer, batches are gathered on the device from the dataset uploaded
once, and the per-round train losses come back in one fetch per chunk.
The Eq. 8 clock and the uplink bits come from the float64 host model
(core/delay.py), exactly as the reference's records do.

All run state lives in an immutable `SimState`; the methods are
state-in/state-out and never modify a state's tensors in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, WirelessConfig
from repro_torch.core import delay
from repro_torch.device import resolve_device
from repro_torch.federated import compression, mesh_rounds
from repro_torch.federated.client import stack_chunk_indices
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


@dataclass
class SimResult:
    history: List[RoundRecord]
    params: Any
    label: str
    fed: FedConfig

    @property
    def total_time(self) -> float:
        return self.history[-1].sim_time if self.history else 0.0

    @property
    def rounds(self) -> int:
        return len(self.history)

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
      data      per-client BatchIterator.state() snapshots; None means
                "fresh at `seed`"
    """

    params_C: Any
    opt_C: Any
    rng: torch.Tensor
    seed: int = 0
    round: int = 0
    sim_time: float = 0.0
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
    ):
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
        self._weights = w / torch.sum(w)
        self._chunk_fn = mesh_rounds.build_fleet_chunk(
            loss_fn, opt, fed.n_devices, fed.compress_updates,
            type(probe[0]).batch_from, noise,
            compression.n_rows(self._init_params))

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
        """Live host-side data iterators positioned at `state`."""
        iters = list(self._data_src(state.seed))
        if state.data is not None:
            for it, snap in zip(iters, state.data):
                it.set_state(snap)
        return iters

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

    # -- the chunked driver -------------------------------------------------
    def _chunk_records(self, losses, n: int, r0: int, t0: float,
                       ) -> List[RoundRecord]:
        bits = float(self.fed.n_devices * self._update_bits())
        T_cm, T_cp = self.round_times()
        V = self.fed.local_rounds
        records, sim_time = [], t0
        for i in range(n):
            sim_time += delay.round_time(T_cm, T_cp, V)
            records.append(RoundRecord(
                round=r0 + i + 1, sim_time=sim_time, T_cm=T_cm, T_cp=T_cp,
                train_loss=float(losses[i]), uplink_bits=bits))
        return records

    def _generator(self, state: SimState) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.set_state(state.rng)
        return gen

    def _rewind(self, iters, snap: tuple, t: int) -> None:
        """Reposition a member's iterators as if only the first t rounds
        of the chunk just drawn had been consumed: restore the pre-chunk
        snapshots and replay t rounds of draws."""
        for it, st in zip(iters, snap):
            it.set_state(st)
        stack_chunk_indices(iters, t, self.fed.local_rounds)

    def _drive(self, states: Sequence[SimState], max_rounds: int,
               eval_every: int, target_acc: Optional[float],
               max_sim_time: Optional[float], evaluate: Optional[Callable]):
        """The chunked round loop, for S member states in lockstep (S = 1 for
        run/run_chunk): (states', histories), after up to max_rounds
        rounds in chunks of eval_every.

        The members are stacked on the client axis (S*C rows, members
        major) and each chunk is ONE device call for all of them: one
        index upload in, one loss fetch out. `evaluate(globals)` maps the
        stacked (S', ...) global models of the members still running to
        their eval dicts; it runs at each eval boundary (a multiple of
        eval_every, or max_rounds), for the members whose history reaches
        it. A member stops at the first round whose clock reaches
        max_sim_time (its history truncated there, its iterators rewound
        to it, its device state and noise generator end-of-chunk: the
        reference's documented deviation) or at an eval reaching
        target_acc; it is then sliced out of the stack and keeps its state
        as its final state."""
        C, V = self.fed.n_devices, self.fed.local_rounds
        S = len(states)
        iters = [self._materialize(st) for st in states]
        gens = [self._generator(st) for st in states]
        params = tree_map(lambda *xs: _cat_members(xs),
                          *[st.params_C for st in states])
        opt_state = tree_map(lambda *xs: _cat_members(xs),
                             *[st.opt_C for st in states])
        active = list(range(S))  # the members in the stack, in its order
        finals: List[Optional[tuple]] = [None] * S
        histories: List[List[RoundRecord]] = [[] for _ in range(S)]
        times = [st.sim_time for st in states]
        r0 = states[0].round
        R = min(eval_every, max_rounds)
        done = 0
        while done < max_rounds:
            n = min(R, max_rounds - done)
            pre = [tuple(it.state() for it in iters[s]) if max_sim_time
                   else None for s in active]
            idx = np.concatenate([stack_chunk_indices(iters[s], n, V)
                                  for s in active], axis=1)
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            params, opt_state, losses = self._chunk_fn(
                params, opt_state, [gens[s] for s in active], self._weights,
                self._data_dev, idx)
            losses = losses.cpu().numpy()
            stopped = set()
            for i, s in enumerate(active):
                recs = self._chunk_records(losses[i], n, r0 + done, times[s])
                if max_sim_time:
                    for j, rec in enumerate(recs):
                        if rec.sim_time >= max_sim_time:
                            if j + 1 < n:
                                self._rewind(iters[s], pre[i], j + 1)
                            recs = recs[:j + 1]
                            stopped.add(s)
                            break
                histories[s].extend(recs)
                times[s] = histories[s][-1].sim_time
            done += n
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
                active = [active[i] for i in keep]
        for i, s in enumerate(active):
            finals[s] = tuple(tree_map(lambda x: _member(x, C, i), t)
                              for t in (params, opt_state))
        out = [dataclasses.replace(
            st, params_C=finals[s][0], opt_C=finals[s][1],
            rng=gens[s].get_state(), round=r0 + len(histories[s]),
            sim_time=times[s], data=tuple(it.state() for it in iters[s]))
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
        chunk, as in the reference's scan backend."""
        _validate_run_args(max_rounds, eval_every)
        evaluate = None
        if self.eval_fn is not None:
            evaluate = lambda g: [  # noqa: E731
                self.eval_fn(tree_map(lambda x: x[0], g))]
        states, histories = self._drive([state], max_rounds, eval_every,
                                        target_acc, max_sim_time, evaluate)
        return states[0], SimResult(
            history=histories[0], params=self.params(states[0]),
            label=self.label, fed=self.fed)

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
        vmap(grad_and_value) over S*C clients, a per-member FedAvg, and,
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
            are exact, over any number of rounds, and a max_sim_time stop
            falls on the same round (a target_acc stop follows test_acc,
            which follows the params);
          * one round from equal states gives train losses within 1e-5
            relative and params within 5e-4 absolute: the batched kernels
            see S*C clients instead of C and may sum in another order,
            which can flip a stochastic-rounding code or a ReLU's sign
            (chip_smoke.py's fleet phase holds 8 seeds to it on the card).
        Over whole histories the CPU tests hold members to the same bounds
        (tests/test_torch_fleet.py). The card holds them to no float bound:
        the FL dynamics amplify a float32 ulp within a few rounds, and
        with cuDNN's default algorithms the card does not repeat even a
        run alone bit for bit (the fleet phase prints both).
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

        evaluate = None
        if self.eval_batch_fn is not None:
            def evaluate(g):
                ev = self.eval_batch_fn(g)
                return [{k: v[i] for k, v in ev.items()}
                        for i in range(leaves(g)[0].shape[0])]

        out, histories = self._drive(states, max_rounds, eval_every,
                                     target_acc, max_sim_time, evaluate)
        return FleetResult(states=out, results=[
            SimResult(history=h, params=self.params(st),
                      label=f"{self.label}[seed={st.seed}]", fed=self.fed)
            for st, h in zip(out, histories)])


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
