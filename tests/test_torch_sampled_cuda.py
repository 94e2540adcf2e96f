"""Sampled participation on the card, at `mnist_cnn_small` width: K = M
sampled is the dense run bit for bit, and sampled `batched` repeats
sampled `scan` bit for bit at K < M (the same step on the same cohorts,
batches and noise), each round one quantize launch over the K lanes.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_sampled_cuda.py

Without a card the tests skip (the kernels have no CPU form; the CPU
parity of sampled participation is held in tests/test_torch_sampled.py).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.federated import compression
from repro_torch.federated.experiment import (CohortSpec, ExperimentSpec,
                                              PopulationSpec)
from repro_torch.kernels.fold_matmul import ops as fm_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.utils.tree import leaves

pytestmark = pytest.mark.cuda

ROUNDS = 3
FIELDS = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits", "rejected",
          "train_loss", "test_acc")


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def _spec(population=None, **kw):
    return ExperimentSpec(
        fed=FedConfig(n_devices=6, batch_size=8, theta=0.62, lr=0.05,
                      compress_updates=True),
        model="mnist_cnn_small", dataset="mnist", n_train=240, n_test=80,
        population=population, **kw)


def _run(spec):
    sim = spec.build()
    q_ops.launches = fm_ops.launches = 0
    state, res = sim.run(sim.init(3), max_rounds=ROUNDS, eval_every=2)
    return sim, state, res, {"quantize": q_ops.launches,
                             "fold_matmul": fm_ops.launches}


def _records(res):
    return [tuple(getattr(r, f) for f in FIELDS) for r in res.history]


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("backend", ["scan", "batched"])
@pytest.mark.parametrize("scenario", [None, "dropout"])
def test_K_eq_M_is_dense_bit_for_bit(cuda_device, scenario, backend):
    """Without a scenario the sampled run is promoted to 'uniform' and
    counts its participants, where the dense run records None (all M)."""
    _, _, dense, _ = _run(_spec(scenario=scenario, backend=backend))
    sim, _, sampled, launches = _run(_spec(
        PopulationSpec(M=6, cohort=CohortSpec(K=6)), scenario=scenario,
        backend=backend))
    assert sim.device.type == "cuda"
    assert launches["quantize"] == ROUNDS and launches["fold_matmul"] > 0
    assert _records(sampled) == _records(dense)
    assert [r.n_participants for r in sampled.history] == [
        6 if r.n_participants is None else r.n_participants
        for r in dense.history]
    assert _same_bits(sampled.params, dense.params)


@pytest.mark.parametrize("scenario", ["dropout", "unreliable_edge"])
def test_sampled_batched_equals_scan_bit_for_bit(cuda_device, scenario):
    pop = PopulationSpec(M=400, cohort=CohortSpec(K=12))
    _, _, scan, _ = _run(_spec(pop, scenario=scenario))
    sim, state, batched, launches = _run(_spec(pop, scenario=scenario,
                                               backend="batched"))
    assert launches["quantize"] == ROUNDS and launches["fold_matmul"] > 0
    assert all(leaf.shape[0] == 12 for leaf in leaves(state.params_C))
    assert compression.n_rows(sim.params(state)) > 0
    assert [r.n_participants for r in batched.history] == [
        r.n_participants for r in scan.history]
    assert _records(batched) == _records(scan)
    assert _same_bits(batched.params, scan.params)


def test_sampled_fleet_member_is_its_run_alone(cuda_device):
    spec = _spec(PopulationSpec(M=400, cohort=CohortSpec(K=12,
                                                         sampler="weighted")),
                 scenario="dropout")
    sim = spec.build()
    fleet = sim.run_fleet(seeds=(0, 1, 2), max_rounds=ROUNDS, eval_every=2)
    for seed, res in zip((0, 1, 2), fleet.results):
        _, alone = sim.run(sim.init(seed), max_rounds=ROUNDS, eval_every=2)
        assert _records(res) == _records(alone)
        assert _same_bits(res.params, alone.params)
    assert dataclasses.asdict(fleet.results[0].fed) == dataclasses.asdict(
        sim.fed)
