"""Declarative experiment API: `ExperimentSpec.build() -> Simulator`.

Port of repro/federated/experiment.py for dense, fully participating
populations: an `ExperimentSpec` is the frozen value form of a simulator's
wiring — model, data + partition, population, wireless, plan-or-fed —
with `build()` materializing the `Simulator` and a small registry of
named configurations:

    spec = experiment.get("mnist_paper")    # plan=True: solve (b*, theta*)
    sim = spec.build()                      # on the CUDA card
    state, res = sim.run(sim.init(), max_rounds=100, eval_every=10)

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
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.federated.partition import (partition_dirichlet,
                                             partition_sizes)
from repro_torch.federated.simulation import Simulator
from repro_torch.kernels.quantize.ref import stochastic_noise
from repro_torch.models import cnn
from repro_torch.optim.sgd import sgd

# Calibration (the reference's): per-sample compute ~10 ms at b=1 on the
# 2 GHz edge GPU pins theta* ~= 0.13-0.15, and c ~= 4.0 then pins
# b* ~= 32 at eps = 0.01.
CALIBRATED_COMPUTE = ComputeConfig(bits_per_sample=6.8e5)
CALIBRATED_C = 4.0

# The reference spec's defaults, fixed here until a registered spec needs
# another value: the wireless link, the Dirichlet non-IID knob, the
# population's lognormal spread (0: the paper's homogeneous devices) and
# the cap on a planned b*.
WIRELESS = WirelessConfig()
ALPHA = 1.0
HETEROGENEITY = 0.0
BATCH_CAP = 32

MODELS = {
    "mnist_cnn": cnn.mnist_cnn,
    "mnist_cnn_small": cnn.mnist_cnn_small,
    "mnist_cnn_tiny": cnn.mnist_cnn_tiny,
    "cifar_cnn": cnn.cifar_cnn,
}


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, declaratively; `replace()` derives variants.

    fed            the federated/DEFL configuration (M, b, theta, lr,
                   compression, ...). With `plan=True`, b/theta/V are
                   solved against the drawn population and `fed` provides
                   the problem constants (epsilon, nu, c, M).
    model          registry name (MODELS) or a literal cnn.CNNConfig.
    n_train/n_test sizes of the synthetic MNIST-like train and test sets.
    seed           draw seed for dataset, partition, population and the
                   initial model; run seeds are chosen at `Simulator.init`.
    plan           solve Alg. 1 (the Eq. 29 closed form) for
                   (b*, theta*) before building.
    """

    fed: FedConfig = FedConfig()
    model: Union[str, cnn.CNNConfig] = "mnist_cnn"
    n_train: int = 1500
    n_test: int = 400
    seed: int = 0
    plan: bool = False
    label: str = ""

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

    def device_population(self) -> delay.DevicePopulation:
        """Draw the (M,) device population (compute + channel)."""
        return delay.draw_population(
            self.fed.n_devices, CALIBRATED_COMPUTE, WIRELESS, self.seed,
            HETEROGENEITY)

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
        return defl.make_plan(self.fed, pop, self.update_bits(),
                              wireless=WIRELESS)

    def _fed_with_plan(self, plan: Optional[defl.DEFLPlan]) -> FedConfig:
        if plan is None:
            return self.fed
        fed = defl.plan_to_fedconfig(plan, self.fed)
        return dataclasses.replace(fed, batch_size=min(fed.batch_size,
                                                       BATCH_CAP),
                                   update_bytes=None)

    def resolve_plan(self) -> Optional[defl.DEFLPlan]:
        """The DEFL plan this spec runs under (None when plan=False)."""
        return self._solve_plan(self.device_population())

    def resolve_fed(self) -> FedConfig:
        """`fed` with the solved (b*, theta*) applied when plan=True
        (batch capped at BATCH_CAP, wire size left to the simulator's
        exact accounting), `fed` unchanged otherwise."""
        return self._fed_with_plan(self.resolve_plan())

    # -- materialization ----------------------------------------------------
    def build(self, device=None, params: Any = None,
              noise: Callable = stochastic_noise) -> Simulator:
        """Materialize the Simulator on `device` ("cuda" unless "cpu" is
        asked for): draw data/partition/population at `self.seed`, solve
        the plan once, and wire model, loss and eval.

        params: the initial global model as a tree of arrays in the
        reference's layout, e.g. a model from the JAX package carried over
        by convert.py (default: cnn.init_cnn at `self.seed`). noise: the
        simulator's quantizer-noise draw (see Simulator)."""
        dev = resolve_device(device)
        pop = self.device_population()
        fed = self._fed_with_plan(self._solve_plan(pop))
        cfg = self.model_config()
        data = make_mnist_like(self.n_train, seed=self.seed)
        init = (cnn.init_cnn(cfg, self.seed, dev) if params is None
                else to_torch(params, dev))
        parts = partition_dirichlet(data, fed.n_devices, alpha=ALPHA,
                                    seed=self.seed)

        def data_factory(seed: int):
            return [BatchIterator(data, p, fed.batch_size, seed=seed + i)
                    for i, p in enumerate(parts)]

        test = make_mnist_like(self.n_test, seed=self.seed + 1)
        xb = torch.as_tensor(test.x, device=dev)
        yb = torch.as_tensor(test.y, dtype=torch.int64, device=dev)

        @torch.no_grad()
        def eval_fn(p):
            logits = cnn.cnn_forward(cfg, p, xb)
            return {"acc": float(
                (logits.argmax(-1) == yb).to(torch.float32).mean())}

        return Simulator(
            lambda p, batch: cnn.cnn_loss(cfg, p, batch), init,
            data_factory, partition_sizes(parts), fed, sgd(fed.lr), pop,
            wireless=WIRELESS, eval_fn=eval_fn,
            label=self.label or "mnist", device=dev, noise=noise)


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
    model="mnist_cnn", plan=True,
    label="mnist_paper"))
register("mnist_smoke", ExperimentSpec(
    fed=FedConfig(n_devices=3, batch_size=8, theta=0.62, lr=0.05),
    model="mnist_cnn_small", n_train=240, n_test=80,
    label="mnist_smoke"))
