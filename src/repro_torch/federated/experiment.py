"""Declarative experiment API: `ExperimentSpec.build() -> Simulator`.

Port of repro/federated/experiment.py for dense populations: an
`ExperimentSpec` is the frozen value form of a simulator's wiring —
model, data + partition, population, edge scenario and faults, wireless,
plan-or-fed — with `build()` materializing the `Simulator` and a small
registry of named configurations:

    spec = experiment.get("mnist_storm")    # hetero_storm, planned
    sim = spec.build()                      # on the CUDA card
    state, res = sim.run(sim.init(), max_rounds=100, eval_every=10)
    fleet = sim.run_fleet(seeds=range(8), max_rounds=100, eval_every=10)
    loop = spec.replace(backend="loop").build()   # the per-client oracle

The reference's fields for traces, populations with cohorts, client
sharding, asynchronous aggregation (backend='async' and async_spec) and
the kernel implementation switch are not here: the port runs none of them
yet (ROADMAP.md, queue 1).

The plan, the data, the partition and the device population are the
reference's, value for value (numpy copies of its numpy code).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ComputeConfig, FedConfig, WirelessConfig
from repro_torch.convert import to_torch
from repro_torch.core import defl, delay
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_cifar_like, make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.federated import scenarios
from repro_torch.federated.faults import FaultModel
from repro_torch.federated.partition import (partition_dirichlet,
                                             partition_sizes)
from repro_torch.federated.simulation import BACKENDS, Simulator
from repro_torch.kernels.quantize.ref import stochastic_noise
from repro_torch.models import cnn
from repro_torch.optim.sgd import sgd
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


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, declaratively; `replace()` derives variants. The
    fields and defaults are the reference's.

    fed            the federated/DEFL configuration (M, b, theta, lr,
                   compression, ...). With `plan=True`, b/theta/V are
                   solved against the drawn population and `fed` provides
                   the problem constants (epsilon, nu, c, M).
    model          registry name (MODELS) or a literal cnn.CNNConfig.
    dataset        'mnist' | 'cifar' (synthetic *-like tasks, DATASETS).
    n_train/n_test dataset sizes; alpha the Dirichlet non-IID knob.
    seed           draw seed for dataset, partition, population and the
                   initial model; run seeds are chosen at `Simulator.init`
                   / `run_fleet`, which is what multi-seed bands vary.
    scenario       registered edge-scenario name (scenarios.py) or a
                   scenarios.Scenario, or None; draws the population and
                   the per-round participation/channel stream.
    faults         optional faults.FaultModel overriding (or adding to)
                   the scenario's failure semantics — deadlines, uplink
                   retransmission, crash/rejoin, guards, quorum. None
                   keeps the scenario's own `faults` (if any).
    heterogeneity  the population's lognormal spread when no scenario is
                   given (0: the paper's homogeneous devices).
    compute        the devices' compute model; wireless the uplink.
    plan           solve Alg. 1 for (b*, theta*) before building.
    plan_method    the KKT solver: 'closed_form' (Eq. 29) | 'corrected'
                   | 'numerical' (kkt.solve).
    batch_cap      cap applied to a planned b* (paper §VI-B); None
                   disables it.
    backend        'scan' (default) | 'batched' | 'loop' (simulation.py's
                   module docstring); 'async' is not ported yet.
    with_eval      wire the test-set accuracy eval into the Simulator.
    """

    fed: FedConfig = FedConfig()
    model: Union[str, cnn.CNNConfig] = "mnist_cnn"
    dataset: str = "mnist"
    n_train: int = 1500
    n_test: int = 400
    alpha: float = 1.0
    seed: int = 0
    scenario: Optional[Union[str, scenarios.Scenario]] = None
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

    def __post_init__(self):
        if self.backend == "async":
            raise ValueError(
                "ExperimentSpec: backend='async' (the event queue) is not "
                "ported yet: ROADMAP.md, queue 1, item 12")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"ExperimentSpec: unknown backend {self.backend!r}; "
                f"expected one of {BACKENDS}")

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
        """The scenario this spec runs (the reference also resolves a
        trace here, which the port does not take yet)."""
        return self.scenario

    def effective_faults(self) -> Optional[FaultModel]:
        """The FaultModel this spec runs under: its own `faults` when set,
        else the scenario's, else None; an inactive model is None."""
        fm = self.faults
        ref = self.scenario_ref()
        if fm is None and ref is not None:
            fm = scenarios.get(ref).faults
        return fm if fm is not None and fm.active else None

    def device_population(self) -> delay.DevicePopulation:
        """Draw the (M,) device population (compute + channel): the
        scenario's when there is one."""
        ref = self.scenario_ref()
        if ref is not None:
            return scenarios.get(ref).population(
                self.fed.n_devices, self.compute, self.wireless, self.seed)
        return delay.draw_population(
            self.fed.n_devices, self.compute, self.wireless, self.seed,
            self.heterogeneity)

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
        ref = self.scenario_ref()
        if ref is not None:
            return scenarios.plan_for_scenario(
                self.fed, ref, self.update_bits(), cc=self.compute,
                wc=self.wireless, seed=self.seed, method=self.plan_method)
        return defl.make_plan(self.fed, pop, self.update_bits(),
                              wireless=self.wireless,
                              method=self.plan_method)

    def _fed_with_plan(self, plan: Optional[defl.DEFLPlan]) -> FedConfig:
        if plan is None:
            return self.fed
        fed = defl.plan_to_fedconfig(plan, self.fed)
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
        `analytic_plan()`. The port has no sampled cohorts yet, so
        `cohort_size` is None."""
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
        return defl.PlanRequest(
            fed=self.fed, pop=self.device_population(),
            update_bits=self.update_bits(), wireless=self.wireless,
            method=self.plan_method, participation=participation,
            cohort_size=None)

    def analytic_plan(self) -> defl.DEFLPlan:
        """The delay-model operating point, always available: the solved
        DEFL plan when plan=True, otherwise Eq. 12/8 evaluated at the
        spec's fixed (b, theta) (`defl.fixed_plan` at the exact theta:
        the FedAvg/Rand baseline rows of the paper's tables)."""
        if self.plan:
            return self.resolve_plan()
        fed = self.fed
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
        through the same products (cnn.cnn_logits_stacked)."""
        dev = resolve_device(device)
        make = DATASETS[self.dataset]
        pop = self.device_population()
        fed = self._fed_with_plan(self._solve_plan(pop))
        cfg = self.model_config()
        data = make(self.n_train, seed=self.seed)
        init = (cnn.init_cnn(cfg, self.seed, dev) if params is None
                else to_torch(params, dev))
        parts = partition_dirichlet(data, fed.n_devices, alpha=self.alpha,
                                    seed=self.seed)

        def data_factory(seed: int):
            return [BatchIterator(data, p, fed.batch_size, seed=seed + i)
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
            data_factory, partition_sizes(parts), fed, sgd(fed.lr), pop,
            wireless=self.wireless, eval_fn=eval_fn, label=label,
            device=dev, noise=noise, eval_batch_fn=eval_batch_fn,
            scenario=ref, faults=self.faults, backend=self.backend,
            masked_loss_fn=lambda p, batch, m, n: cnn.cnn_loss_masked(
                cfg, p, batch, m, n),
            value_and_grad=lambda p, batch, m=None, n=None: (
                cnn.cnn_value_and_grad(cfg, p, batch, m, n)))


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
register("mnist_storm", ExperimentSpec(
    fed=FedConfig(n_devices=10, epsilon=0.01, nu=2.0, c=CALIBRATED_C,
                  lr=0.05),
    model="mnist_cnn", dataset="mnist", scenario="hetero_storm", plan=True,
    label="mnist_storm"))
