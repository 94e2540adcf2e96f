"""The per-round backends on the card, at `mnist_smoke` width: the batched
round repeats the chunked path bit for bit (the same step on the same
batches and noise), and the loop quantizes each participating client in
its own launch, with params equal to the batched round's bit for bit
(per-row quantize, the fold matmul's row independence).

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_backends_cuda.py

Without a card the tests skip (the kernels have no CPU form; the CPU
parity of the backends is held in tests/test_torch_backends.py).
"""
import dataclasses

import pytest
import torch

from repro_torch.federated import experiment
from repro_torch.kernels.fold_matmul import ops as fm_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.utils.tree import leaves

pytestmark = pytest.mark.cuda

ROUNDS = 3


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def _spec(backend, scenario=None):
    spec = experiment.get("mnist_smoke")
    return spec.replace(backend=backend, scenario=scenario, fed=dataclasses
                        .replace(spec.fed, compress_updates=True))


def _run(backend, scenario=None):
    sim = _spec(backend, scenario).build()
    q_ops.launches = fm_ops.launches = 0
    _, res = sim.run(sim.init(3), max_rounds=ROUNDS, eval_every=2)
    return res, {"quantize": q_ops.launches, "fold_matmul": fm_ops.launches}


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("scenario", [None, "hetero_storm"])
def test_batched_equals_scan_bit_for_bit(cuda_device, scenario):
    scan, _ = _run("scan", scenario)
    batched, launches = _run("batched", scenario)
    assert launches["quantize"] == ROUNDS and launches["fold_matmul"] > 0
    assert [(r.round, r.sim_time, r.uplink_bits, r.n_participants,
             r.train_loss, r.test_acc) for r in batched.history] == [
        (r.round, r.sim_time, r.uplink_bits, r.n_participants, r.train_loss,
         r.test_acc) for r in scan.history]
    assert _same_bits(batched.params, scan.params)


@pytest.mark.parametrize("scenario", [None, "hetero_storm"])
def test_loop_quantizes_each_participant_alone(cuda_device, scenario):
    loop, launches = _run("loop", scenario)
    batched, _ = _run("batched", scenario)
    M = _spec("loop").fed.n_devices
    per_round = [M if r.n_participants is None else r.n_participants
                 for r in loop.history]
    assert launches["quantize"] == sum(per_round)
    assert launches["fold_matmul"] > 0
    assert [(r.round, r.sim_time, r.uplink_bits, r.n_participants)
            for r in loop.history] == [
        (r.round, r.sim_time, r.uplink_bits, r.n_participants)
        for r in batched.history]
    assert _same_bits(loop.params, batched.params)
