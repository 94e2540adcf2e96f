"""Host-level FL simulator: Algorithm 1 with the paper's delay accounting.

Runs real training (PyTorch, on the card) while advancing a *simulated*
wall clock from the paper's delay models (Eqs. 5, 7, 8). Port of the
reference's `Simulator` (repro/federated/simulation.py) for a dense,
fully participating population on its chunked ('scan') driver:

    sim   = Simulator(loss_fn, params, data_factory, sizes, fed, opt, pop)
    state = sim.init(seed)
    state, result  = sim.run(state, max_rounds=100, eval_every=10)
    state, records = sim.run_chunk(state, rounds=10)

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
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, WirelessConfig
from repro_torch.core import delay
from repro_torch.device import resolve_device
from repro_torch.federated import compression, mesh_rounds
from repro_torch.federated.client import stack_chunk_indices
from repro_torch.kernels.quantize.ref import stochastic_noise
from repro_torch.optim.api import Optimizer
from repro_torch.utils.tree import tree_bytes, tree_map


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


@dataclass
class SimResult:
    history: List[RoundRecord]
    params: Any
    label: str
    fed: FedConfig


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
    Runs on `device` ("cuda" unless the caller asks for "cpu").
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
    ):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self._data_src = data
        self.data_sizes = data_sizes
        self.fed = fed
        self.opt = opt
        self.pop = pop
        self.wireless = wireless or WirelessConfig()
        self.eval_fn = eval_fn
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
        self._chunk_fn = mesh_rounds.build_round_chunk(
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
    def _chunk(self, params_C, opt_C, gen, iters, n: int):
        """n rounds on the device: one index upload in, one loss fetch out."""
        idx = stack_chunk_indices(iters, n, self.fed.local_rounds)
        idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        params_C, opt_C, losses = self._chunk_fn(
            params_C, opt_C, gen, self._weights, self._data_dev, idx)
        return params_C, opt_C, losses.cpu().numpy()

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

    def _drive(self, state: SimState, max_rounds: int, eval_every: int,
               target_acc: Optional[float], evaluate: bool):
        """The chunked driver: (state', history) after up to max_rounds
        rounds in chunks of eval_every, evaluating after each chunk."""
        iters = self._materialize(state)
        gen = self._generator(state)
        params_C, opt_C = state.params_C, state.opt_C
        history: List[RoundRecord] = []
        done = 0
        while done < max_rounds:
            n = min(eval_every, max_rounds - done)
            params_C, opt_C, losses = self._chunk(params_C, opt_C, gen,
                                                  iters, n)
            history.extend(self._chunk_records(
                losses, n, state.round + done,
                history[-1].sim_time if history else state.sim_time))
            done += n
            if evaluate:
                rec = history[-1]
                rec.test_acc = float(self.eval_fn(
                    tree_map(lambda x: x[0], params_C))["acc"])
                if target_acc and rec.test_acc >= target_acc:
                    break
        return dataclasses.replace(
            state, params_C=params_C, opt_C=opt_C, rng=gen.get_state(),
            round=state.round + done, sim_time=history[-1].sim_time,
            data=tuple(it.state() for it in iters)), history

    def run_chunk(self, state: SimState, rounds: int):
        """Run `rounds` rounds as one chunk, without evaluation:
        (state', [RoundRecord])."""
        _validate_run_args(rounds, 1)
        return self._drive(state, rounds, rounds, None, evaluate=False)

    def run(
        self,
        state: SimState,
        max_rounds: int = 200,
        target_acc: Optional[float] = None,
        eval_every: int = 1,
    ):
        """Run up to `max_rounds` MORE rounds from `state` in chunks of
        `eval_every` rounds: (state', SimResult). Round numbers and the
        Eq. 8 clock continue from the state's cursors. With an eval_fn,
        test accuracy is taken at each chunk's end, and a run with
        target_acc stops at the first chunk that reaches it."""
        _validate_run_args(max_rounds, eval_every)
        new_state, history = self._drive(state, max_rounds, eval_every,
                                         target_acc, self.eval_fn is not None)
        return new_state, SimResult(
            history=history, params=self.params(new_state),
            label=self.label, fed=self.fed)
