"""Declarative experiment API: `ExperimentSpec.build() -> Simulator`.

Port of repro/federated/experiment.py: an `ExperimentSpec` is the frozen
value form of a simulator's wiring — model, data + partition, population
(dense, or sampled K-client cohorts of M clients), edge scenario and
faults, wireless, plan-or-fed — with `build()` materializing the
`Simulator` and a small registry of named configurations:

    spec = experiment.get("mnist_storm")    # hetero_storm, planned
    sim = spec.build()                      # on the CUDA card
    state, res = sim.run(sim.init(), max_rounds=100, eval_every=10)
    fleet = sim.run_fleet(seeds=range(8), max_rounds=100, eval_every=10)
    loop = spec.replace(backend="loop").build()   # the per-client oracle
    big = experiment.get("mnist_paper").replace(
        population=PopulationSpec(M=10_000, cohort=CohortSpec(K=50)))
    asim = experiment.get("mnist_async").build()  # the event queue
    state, records = asim.run_events(asim.init(), events=11)
    dsim = experiment.get("mnist_diurnal").build()  # a trace-driven fleet
    replay = spec.replace(scenario=None, trace=TraceSpec("fleet.jsonl"))

The fields are the reference's but its kernel implementation switch
(`impl`): the port picks a kernel's form by the tensor's device.

The plan, the data, the partition and the device population are the
reference's, value for value (numpy copies of its numpy code).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ComputeConfig, FedConfig, WirelessConfig
from repro_torch.convert import to_torch
from repro_torch.core import defl, delay
from repro_torch.data.pipeline import BatchIterator, ClientDataPool
from repro_torch.data.synthetic import make_cifar_like, make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.federated import scenarios
from repro_torch.federated.events import AsyncSpec
from repro_torch.federated.faults import FaultModel
from repro_torch.federated.partition import (partition_dirichlet,
                                             partition_sizes,
                                             partition_virtual)
from repro_torch.federated.simulation import BACKENDS, Simulator
from repro_torch.federated.traces import TraceSpec, replay_scenario
from repro_torch.kernels.quantize.ref import stochastic_noise
from repro_torch.models import cnn
from repro_torch.optim.sgd import sgd
from repro_torch.sharding import collectives
from repro_torch.utils.tree import tree_map

# Calibration (the reference's): per-sample compute ~10 ms at b=1 on the
# 2 GHz edge GPU pins theta* ~= 0.13-0.15, and c ~= 4.0 then pins
# b* ~= 32 at eps = 0.01.
CALIBRATED_COMPUTE = ComputeConfig(bits_per_sample=6.8e5)
CALIBRATED_C = 4.0

MODELS = {
    "mnist_cnn": cnn.mnist_cnn,
    "mnist_cnn_small": cnn.mnist_cnn_small,
    "mnist_cnn_tiny": cnn.mnist_cnn_tiny,
    "cifar_cnn": cnn.cifar_cnn,
}

DATASETS = {"mnist": make_mnist_like, "cifar": make_cifar_like}

# Dense device state above this many clients is almost certainly a
# mistake (the stacked params carry one lane per client): build() warns
# DeprecationWarning, pointing at PopulationSpec(M, cohort=CohortSpec(K)).
DENSE_M_DEPRECATION_THRESHOLD = 4096


@dataclass(frozen=True)
class CohortSpec:
    """Per-round sampled participation: K clients drawn from the
    population each round.

    K        cohort size — the device-resident client state is O(K).
    sampler  'uniform' (each round's cohort uniform without replacement)
             | 'weighted' (D_m-weighted Gumbel top-K without
             replacement: data-rich clients are drawn more often).
    spare    over-provisioning: each round draws K + spare candidates
             from the same cohort generator and keeps the K deadline-
             feasible-fastest (ties by client index); spare=0 is the
             plain draw.
    """

    K: int
    sampler: str = "uniform"
    spare: int = 0

    def __post_init__(self):
        self.validate()

    def validate(self) -> "CohortSpec":
        if self.K < 1:
            raise ValueError(f"CohortSpec.K must be >= 1, got {self.K}")
        if self.sampler not in ("uniform", "weighted"):
            raise ValueError(
                f"unknown CohortSpec.sampler {self.sampler!r}; expected "
                "'uniform' or 'weighted'")
        if not isinstance(self.spare, int) or self.spare < 0:
            raise ValueError(
                f"CohortSpec.spare must be an int >= 0, got {self.spare!r}")
        return self


@dataclass(frozen=True)
class PopulationSpec:
    """The client population: its size and, optionally, the per-round
    participation regime.

    M       population size. Plain `fed.n_devices` (no PopulationSpec)
            stays sugar for a dense M-client population — the same
            simulator, bit for bit.
    cohort  None runs dense (every client computes every round, device
            state O(M)); CohortSpec(K) runs sampled participation
            (device state O(K), the population model O(M) on the host).
    """

    M: int
    cohort: Optional[CohortSpec] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> "PopulationSpec":
        if self.M < 1:
            raise ValueError(f"PopulationSpec.M must be >= 1, got {self.M}")
        if self.cohort is not None:
            self.cohort.validate()
            if self.cohort.K > self.M:
                raise ValueError(
                    f"cohort K={self.cohort.K} exceeds population M={self.M}")
            if self.cohort.K + self.cohort.spare > self.M:
                raise ValueError(
                    f"cohort K+spare={self.cohort.K + self.cohort.spare} "
                    f"exceeds population M={self.M}")
        return self


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, declaratively; `replace()` derives variants. The
    fields and defaults are the reference's.

    fed            the federated/DEFL configuration (M, b, theta, lr,
                   compression, ...). With `plan=True`, b/theta/V are
                   solved against the drawn population and `fed` provides
                   the problem constants (epsilon, nu, c, M).
    population     optional PopulationSpec: its M overrides fed.n_devices
                   (`base_fed()`), and its CohortSpec turns on K-client
                   sampled participation (device state O(K), cohorts
                   drawn on the host from the M-client population).
                   `PopulationSpec(M)` with no cohort is `fed.n_devices=M`
                   (dense; build() warns DeprecationWarning from
                   DENSE_M_DEPRECATION_THRESHOLD clients up).
    shard_clients  the reference's client-axis sharding ('scan', no
                   compression) over the ranks of the caller's default
                   torch.distributed group, one process a device
                   (`torchrun --nproc-per-node N`); without a group one
                   device runs the unsharded step (Simulator's
                   docstring). build() places a sharded run on its
                   rank's card (collectives.device_for_rank).
    model          registry name (MODELS) or a literal cnn.CNNConfig.
    dataset        'mnist' | 'cifar' (synthetic *-like tasks, DATASETS).
    n_train/n_test dataset sizes; alpha the Dirichlet non-IID knob.
    seed           draw seed for dataset, partition, population and the
                   initial model; run seeds are chosen at `Simulator.init`
                   / `run_fleet`, which is what multi-seed bands vary.
    scenario       registered edge-scenario name (scenarios.py) or a
                   scenarios.Scenario, or None; draws the population and
                   the per-round participation/channel stream.
    trace          optional traces.TraceSpec: replay a recorded JSONL
                   device-state log as the scenario source (deterministic
                   presence/loss/channel overlay on the unchanged
                   backends). Mutually exclusive with `scenario`; the
                   error names both fields. `scenario_ref()` resolves
                   whichever is set.
    faults         optional faults.FaultModel overriding (or adding to)
                   the scenario's failure semantics — deadlines, uplink
                   retransmission, crash/rejoin, guards, quorum. None
                   keeps the scenario's own `faults` (if any).
    heterogeneity  the population's lognormal spread when no scenario is
                   given (0: the paper's homogeneous devices).
    compute        the devices' compute model; wireless the uplink.
    plan           solve Alg. 1 for (b*, theta*) before building; under a
                   CohortSpec the Eq. 12 effective M is the cohort's K.
    plan_method    the KKT solver: 'closed_form' (Eq. 29) | 'corrected'
                   | 'numerical' (kkt.solve).
    batch_cap      cap applied to a planned b* (paper §VI-B); None
                   disables it.
    backend        'scan' (default) | 'batched' | 'loop' | 'async'
                   (simulation.py's module docstring).
    with_eval      wire the test-set accuracy eval into the Simulator.
    async_spec     events.AsyncSpec for backend='async': buffered
                   staleness-weighted aggregation over the device-side
                   event queue. Requires backend='async' (and vice versa).
                   Mutually exclusive with sampled participation
                   (population.cohort), shard_clients and the quorum and
                   update-norm fault guards; the errors name the fields.
    """

    fed: FedConfig = FedConfig()
    population: Optional[PopulationSpec] = None
    shard_clients: bool = False
    model: Union[str, cnn.CNNConfig] = "mnist_cnn"
    dataset: str = "mnist"
    n_train: int = 1500
    n_test: int = 400
    alpha: float = 1.0
    seed: int = 0
    scenario: Optional[Union[str, scenarios.Scenario]] = None
    trace: Optional[TraceSpec] = None
    faults: Optional[FaultModel] = None
    heterogeneity: float = 0.0
    compute: ComputeConfig = CALIBRATED_COMPUTE
    wireless: WirelessConfig = WirelessConfig()
    plan: bool = False
    plan_method: str = "closed_form"
    batch_cap: Optional[int] = 32
    backend: str = "scan"
    with_eval: bool = True
    label: str = ""
    async_spec: Optional[AsyncSpec] = None

    def __post_init__(self):
        # The knobs that exclude each other fail here, naming the fields,
        # before any build() cost is paid (the reference's checks, the
        # trace's first).
        if self.trace is not None and self.scenario is not None:
            raise ValueError(
                f"ExperimentSpec: trace={self.trace.name!r} and scenario="
                f"{self.scenario!r} are mutually exclusive (fields "
                "scenario, trace) — a TraceSpec replays its own recorded "
                "device-state stream, so a registry scenario cannot also "
                "drive the population; drop one of them")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"ExperimentSpec: unknown backend {self.backend!r}; "
                f"expected one of {BACKENDS}")
        if self.backend == "async" and self.async_spec is None:
            raise ValueError(
                "ExperimentSpec: backend='async' requires async_spec="
                "AsyncSpec(...) (fields backend, async_spec)")
        if self.async_spec is not None and self.backend != "async":
            raise ValueError(
                f"ExperimentSpec: async_spec is set but backend="
                f"{self.backend!r}; asynchronous aggregation requires "
                "backend='async' (fields backend, async_spec)")
        if self.backend != "async":
            return
        if self.population is not None and self.population.cohort is not None:
            raise ValueError(
                "ExperimentSpec: backend='async' is incompatible with "
                "sampled participation (fields backend, population.cohort) "
                "— the event queue tracks every client; use a dense "
                "PopulationSpec(M) or drop the CohortSpec")
        if self.shard_clients:
            raise ValueError(
                "ExperimentSpec: backend='async' is incompatible with "
                "client sharding (fields backend, shard_clients) — the "
                "event queue pops one client per step, which does not "
                "shard across devices")
        fm = self.effective_faults()
        if fm is not None and fm.min_quorum is not None:
            raise ValueError(
                "ExperimentSpec: backend='async' is incompatible with "
                "quorum gating (fields backend, faults.min_quorum) — "
                "rounds are buffer fills, not synchronized cohorts; use "
                "AsyncSpec.buffer_size to set the fill threshold")
        if fm is not None and fm.max_update_norm is not None:
            raise ValueError(
                "ExperimentSpec: backend='async' is incompatible with "
                "update-norm clipping (fields backend, "
                "faults.max_update_norm); deadline/retransmission/crash "
                "fault channels do compose with async")

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    # -- resolution ---------------------------------------------------------
    def model_config(self) -> cnn.CNNConfig:
        if isinstance(self.model, str):
            try:
                return MODELS[self.model]()
            except KeyError:
                raise KeyError(
                    f"unknown model {self.model!r}; registered: "
                    f"{tuple(MODELS)}") from None
        return self.model

    def scenario_ref(self) -> Union[str, scenarios.Scenario, None]:
        """The scenario source this spec runs: the ReplayScenario of
        `trace` when set, else `scenario`, else None. Every scenario
        consumer (faults, population, plan, build) resolves through this,
        so a trace-driven spec rides the same paths as a registry one."""
        if self.trace is not None:
            return replay_scenario(self.trace)
        return self.scenario

    def effective_faults(self) -> Optional[FaultModel]:
        """The FaultModel this spec runs under: its own `faults` when set,
        else the scenario's, else None; an inactive model is None."""
        fm = self.faults
        ref = self.scenario_ref()
        if fm is None and ref is not None:
            fm = scenarios.get(ref).faults
        return fm if fm is not None and fm.active else None

    def n_devices(self) -> int:
        """Population size M: PopulationSpec.M when given (it overrides
        fed.n_devices), else fed.n_devices."""
        return (self.fed.n_devices if self.population is None
                else self.population.M)

    def cohort_spec(self) -> Optional[CohortSpec]:
        """The sampled-participation regime, or None for dense."""
        return None if self.population is None else self.population.cohort

    def base_fed(self) -> FedConfig:
        """`fed` with the PopulationSpec's M applied: what the plan, the
        build and the Study's grouping read n_devices from."""
        M = self.n_devices()
        if M == self.fed.n_devices:
            return self.fed
        return dataclasses.replace(self.fed, n_devices=M)

    def device_population(self) -> delay.DevicePopulation:
        """Draw the (M,) device population (compute + channel): the
        scenario's when there is one."""
        M = self.n_devices()
        ref = self.scenario_ref()
        if ref is not None:
            return scenarios.get(ref).population(
                M, self.compute, self.wireless, self.seed)
        return delay.draw_population(
            M, self.compute, self.wireless, self.seed, self.heterogeneity)

    def update_bits(self) -> float:
        """Raw float32 wire size of one model update (the plan's input;
        the simulator applies the compression accounting itself)."""
        shapes = cnn.param_shapes(self.model_config())
        return float(sum(int(np.prod(s)) for layer in shapes.values()
                         for s in layer.values()) * 4 * 8)

    def _solve_plan(self, pop: delay.DevicePopulation,
                    ) -> Optional[defl.DEFLPlan]:
        if not self.plan:
            return None
        fed = self.base_fed()
        cohort = self.cohort_spec()
        K = None if cohort is None else cohort.K
        ref = self.scenario_ref()
        if ref is not None:
            return scenarios.plan_for_scenario(
                fed, ref, self.update_bits(), cc=self.compute,
                wc=self.wireless, seed=self.seed, method=self.plan_method,
                cohort_size=K, spare=0 if cohort is None else cohort.spare)
        return defl.make_plan(fed, pop, self.update_bits(),
                              wireless=self.wireless,
                              method=self.plan_method, cohort_size=K)

    def _fed_with_plan(self, plan: Optional[defl.DEFLPlan]) -> FedConfig:
        base = self.base_fed()
        if plan is None:
            return base
        fed = defl.plan_to_fedconfig(plan, base)
        b = fed.batch_size if self.batch_cap is None else min(
            fed.batch_size, self.batch_cap)
        return dataclasses.replace(fed, batch_size=b, update_bytes=None)

    def resolve_plan(self) -> Optional[defl.DEFLPlan]:
        """The DEFL plan this spec runs under (None when plan=False)."""
        return self._solve_plan(self.device_population())

    def resolve_fed(self) -> FedConfig:
        """`fed` with the solved (b*, theta*) applied when plan=True
        (batch capped at `batch_cap`, wire size left to the simulator's
        exact accounting), `fed` unchanged otherwise."""
        return self._fed_with_plan(self.resolve_plan())

    def plan_request(self) -> Optional[defl.PlanRequest]:
        """The arm's Alg. 1 solve in batchable value form: a
        `defl.PlanRequest` when `resolve_plan()` reduces to a plain
        `defl.make_plan` (plan=True and no deadline re-derivation), else
        None: fixed-(b, V) baselines solve nothing and deadline-fault
        scenarios re-derive over the truncated delay model, so both keep
        their scalar paths. `Study.plans()` solves all batchable arms in
        one `defl.make_plan_batch` call, bit-identical to per-arm
        `analytic_plan()`; a sampled arm's request carries its cohort's
        K."""
        if not self.plan:
            return None
        participation = 1.0
        ref = self.scenario_ref()
        if ref is not None:
            sc = scenarios.get(ref)
            fm = sc.faults
            if fm is not None and fm.active and (
                    fm.deadline is not None
                    or fm.deadline_factor is not None):
                return None
            participation = sc.expected_participation
        cohort = self.cohort_spec()
        return defl.PlanRequest(
            fed=self.base_fed(), pop=self.device_population(),
            update_bits=self.update_bits(), wireless=self.wireless,
            method=self.plan_method, participation=participation,
            cohort_size=None if cohort is None else cohort.K)

    def analytic_plan(self) -> defl.DEFLPlan:
        """The delay-model operating point, always available: the solved
        DEFL plan when plan=True, otherwise Eq. 12/8 evaluated at the
        spec's fixed (b, theta) (`defl.fixed_plan` at the exact theta:
        the FedAvg/Rand baseline rows of the paper's tables)."""
        if self.plan:
            return self.resolve_plan()
        fed = self.base_fed()
        return defl.fixed_plan(
            fed, self.device_population(), self.update_bits(),
            b=fed.batch_size, V=fed.local_rounds,
            wireless=self.wireless, theta=fed.theta)

    # -- materialization ----------------------------------------------------
    def build(self, device=None, params: Any = None,
              noise: Callable = stochastic_noise) -> Simulator:
        """Materialize the Simulator on `device` ("cuda" unless "cpu" is
        asked for): draw data/partition/population at `self.seed`, solve
        the plan once, and wire model, loss and (with_eval) the eval hooks.

        params: the initial global model as a tree of arrays in the
        reference's layout, e.g. a model from the JAX package carried over
        by convert.py (default: cnn.init_cnn at `self.seed`). noise: the
        simulator's quantizer-noise draw (see Simulator).

        The Simulator also gets the (V, b)-envelope form of the loss
        (cnn.cnn_loss_masked) and the CNN's stacked gradient
        (cnn.cnn_value_and_grad): on the card a client's numbers then do
        not depend on the clients or the padding beside it, so a Study
        member or a fleet member repeats its run alone. Evaluation goes
        through the same products (cnn.cnn_logits_stacked).

        Sampled participation (PopulationSpec.cohort) swaps the dense
        per-client iterator list for a lazy ClientDataPool: at M <=
        n_train over the same Dirichlet partition with the same per-client
        seeds (so a K = M sampled build is the dense one, bit for bit),
        above that — where a disjoint split is impossible — over one
        deterministic virtual shard a client (partition.partition_virtual,
        O(1) host state a client)."""
        dev = resolve_device(device)
        if self.shard_clients and collectives.initialized():
            dev = collectives.device_for_rank(dev)
        make = DATASETS[self.dataset]
        pop = self.device_population()
        fed = self._fed_with_plan(self._solve_plan(pop))
        cohort = self.cohort_spec()
        if (cohort is None and self.backend != "loop"
                and fed.n_devices >= DENSE_M_DEPRECATION_THRESHOLD):
            warnings.warn(
                f"dense device state with M={fed.n_devices} clients is "
                "deprecated: the stacked params carry one lane per client. "
                "Use population=PopulationSpec(M=..., cohort=CohortSpec("
                "K=...)) for O(K) device state.",
                DeprecationWarning, stacklevel=2)
        cfg = self.model_config()
        data = make(self.n_train, seed=self.seed)
        init = (cnn.init_cnn(cfg, self.seed, dev) if params is None
                else to_torch(params, dev))
        if cohort is not None and fed.n_devices > self.n_train:
            # Population scale: no M-long partition list exists anywhere.
            indices_fn, data_sizes = partition_virtual(
                self.n_train, fed.n_devices, seed=self.seed)

            def data_factory(seed: int):
                return ClientDataPool(data, indices_fn, data_sizes,
                                      fed.batch_size, seed=seed)
        else:
            parts = partition_dirichlet(data, fed.n_devices,
                                        alpha=self.alpha, seed=self.seed)
            data_sizes = partition_sizes(parts)
            if cohort is not None:
                def data_factory(seed: int):
                    return ClientDataPool.from_parts(
                        data, parts, fed.batch_size, seed=seed)
            else:
                def data_factory(seed: int):
                    return [BatchIterator(data, p, fed.batch_size,
                                          seed=seed + i)
                            for i, p in enumerate(parts)]

        eval_fn = eval_batch_fn = None
        if self.with_eval:
            test = make(self.n_test, seed=self.seed + 1)
            xb = torch.as_tensor(test.x, device=dev)
            yb = torch.as_tensor(test.y, dtype=torch.int64, device=dev)

            # One member's logits through the products of its training
            # step (cnn.cnn_logits_stacked): eval_batch_fn's value for a
            # member equals eval_fn's on its params, however many members
            # share the call.
            @torch.no_grad()
            def eval_batch_fn(ps):
                logits = cnn.cnn_logits_stacked(cfg, ps, xb)
                hits = (logits.argmax(-1) == yb[None]).to(torch.float32)
                return {"acc": hits.mean(dim=-1).cpu().numpy()}

            def eval_fn(p):
                return {"acc": float(eval_batch_fn(
                    tree_map(lambda x: x[None], p))["acc"][0])}

        ref = self.scenario_ref()
        label = self.label or (
            f"{self.dataset}@{scenarios.get(ref).name}" if ref is not None
            else self.dataset)
        return Simulator(
            lambda p, batch: cnn.cnn_loss(cfg, p, batch), init,
            data_factory, data_sizes, fed, sgd(fed.lr), pop,
            wireless=self.wireless, eval_fn=eval_fn, label=label,
            device=dev, noise=noise, eval_batch_fn=eval_batch_fn,
            scenario=ref, faults=self.faults, backend=self.backend,
            masked_loss_fn=lambda p, batch, m, n: cnn.cnn_loss_masked(
                cfg, p, batch, m, n),
            value_and_grad=lambda p, batch, m=None, n=None: (
                cnn.cnn_value_and_grad(cfg, p, batch, m, n)),
            cohort=None if cohort is None else cohort.K,
            cohort_sampler="uniform" if cohort is None else cohort.sampler,
            cohort_spare=0 if cohort is None else cohort.spare,
            shard_clients=self.shard_clients, async_spec=self.async_spec)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ExperimentSpec] = {}


def register(name: str, spec: ExperimentSpec) -> ExperimentSpec:
    if name in _REGISTRY:
        raise ValueError(f"experiment {name!r} already registered")
    _REGISTRY[name] = spec
    return spec


def get(name: Union[str, ExperimentSpec]) -> ExperimentSpec:
    if isinstance(name, ExperimentSpec):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown experiment {name!r}; registered: {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register("mnist_paper", ExperimentSpec(
    fed=FedConfig(n_devices=10, epsilon=0.01, nu=2.0, c=CALIBRATED_C,
                  lr=0.05),
    model="mnist_cnn", dataset="mnist", plan=True,
    label="mnist_paper"))
register("cifar_paper", ExperimentSpec(
    fed=FedConfig(n_devices=10, epsilon=0.01, nu=2.0, c=CALIBRATED_C,
                  lr=0.05),
    model="cifar_cnn", dataset="cifar", plan=True,
    label="cifar_paper"))
register("mnist_smoke", ExperimentSpec(
    fed=FedConfig(n_devices=3, batch_size=8, theta=0.62, lr=0.05),
    model="mnist_cnn_small", dataset="mnist", n_train=240, n_test=80,
    label="mnist_smoke"))
register("mnist_sampled", ExperimentSpec(
    fed=FedConfig(batch_size=8, theta=0.62, lr=0.05),
    population=PopulationSpec(M=40, cohort=CohortSpec(K=8)),
    model="mnist_cnn_small", dataset="mnist", n_train=240, n_test=80,
    scenario="dropout",
    label="mnist_sampled"))
register("mnist_async", ExperimentSpec(
    fed=FedConfig(n_devices=10, batch_size=8, theta=0.62, lr=0.05),
    model="mnist_cnn_small", dataset="mnist", n_train=240, n_test=80,
    scenario="stragglers", backend="async",
    async_spec=AsyncSpec(buffer_size=4, staleness="poly"),
    label="mnist_async"))
register("mnist_diurnal", ExperimentSpec(
    fed=FedConfig(n_devices=12, epsilon=0.01, nu=2.0, c=CALIBRATED_C,
                  lr=0.05),
    model="mnist_cnn_small", dataset="mnist", n_train=240, n_test=80,
    scenario="diurnal_edge", plan=True,
    label="mnist_diurnal"))
register("mnist_storm", ExperimentSpec(
    fed=FedConfig(n_devices=10, epsilon=0.01, nu=2.0, c=CALIBRATED_C,
                  lr=0.05),
    model="mnist_cnn", dataset="mnist", scenario="hetero_storm", plan=True,
    label="mnist_storm"))
