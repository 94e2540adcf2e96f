"""`shard_clients` on the card, at `mnist_smoke` width (M = 4): an NCCL
group of one rank is the unsharded run bit for bit, and two gloo ranks
sharing the card (CUDA tensors through gloo) are within the member
contract of it, bit-equal to each other, with the fold matmul launched on
each rank and int8 codes on the wire in 'int8_shardmap'.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_shard_clients_cuda.py

Without a card the tests skip (the CPU parity of the sharded runs, on two
gloo ranks, is held in tests/test_torch_shard_clients.py). NCCL across
several cards needs a machine with several.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.federated import experiment, mesh_rounds
from repro_torch.kernels.fold_matmul import ops as fm_ops
from repro_torch.optim.sgd import sgd
from repro_torch.sharding import collectives
from repro_torch.utils.tree import leaves

pytestmark = pytest.mark.cuda

WORLD, ROUNDS = 2, 3
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-4
FIELDS = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits",
          "n_participants", "rejected")
SPEC = experiment.get("mnist_smoke")
SPEC = SPEC.replace(fed=dataclasses.replace(SPEC.fed, n_devices=4))


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def _summary(res):
    return ([tuple(getattr(r, f) for f in FIELDS) for r in res.history],
            [float(r.train_loss) for r in res.history],
            [x.detach().cpu().numpy().copy() for x in leaves(res.params)])


def _run(spec):
    sim = spec.build()
    fm_ops.launches = 0
    _, res = sim.run(sim.init(), max_rounds=ROUNDS, eval_every=ROUNDS)
    return _summary(res), fm_ops.launches


def _int8_round(device):
    """'int8_shardmap' against 'allreduce' on the reference test's
    quadratic round (C = 4, V = 3, weights 1/4), this rank's lanes."""
    def loss(params, batch):
        diff = params["w"] - batch["target"]
        return 0.5 * torch.sum(diff * diff)

    params = mesh_rounds.replicate_clients(
        {"w": torch.ones(8, device=device)}, 4)
    target = torch.stack([torch.full((3, 8), float(t), device=device)
                          for t in range(4)])
    weights = torch.full((4,), 0.25, device=device)
    vg = mesh_rounds.vmapped_value_and_grad(loss)
    plain = mesh_rounds.build_round_step(vg, sgd(0.05), "allreduce")
    want = plain(params, (), {"target": target}, weights)[0]["w"]
    dtypes, gather = [], collectives.gather_rows

    def recording(x, dim=0, group=None):
        dtypes.append(x.dtype)
        return gather(x, dim, group)

    mesh_rounds.collectives.gather_rows = recording
    lanes = collectives.lane_slice(4)
    step = mesh_rounds.build_round_step(vg, sgd(0.05), "int8_shardmap")
    got = step({"w": params["w"][lanes]}, (), {"target": target[lanes]},
               weights)[0]["w"]
    mesh_rounds.collectives.gather_rows = gather
    return float((got - want[lanes]).abs().max()), dtypes


def _rank_main(rank, rdzv, out):
    """One of two gloo ranks sharing the card."""
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=WORLD)
    res = {"run": _run(SPEC.replace(shard_clients=True)),
           "int8": _int8_round(torch.device("cuda"))}
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def test_nccl_world_of_one_is_the_unsharded_run(cuda_device):
    want, n_plain = _run(SPEC)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        sim = SPEC.replace(shard_clients=True).build()
        assert sim._shard and sim.device == torch.device("cuda", 0)
        got, n_shard = _run(SPEC.replace(shard_clients=True))
    finally:
        dist.destroy_process_group()
    assert got[0] == want[0] and got[1] == want[1]
    for x, y in zip(got[2], want[2]):
        np.testing.assert_array_equal(x, y)
    assert n_shard == n_plain > 0


def test_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src"),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp_path / "rdzv"),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    want, _ = _run(SPEC)
    for p in procs:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log
    results = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    (a, n_a), (b, n_b) = (res["run"] for res in results)
    assert a[0] == b[0] == want[0] and a[1] == b[1]
    for x, y, z in zip(a[2], b[2], want[2]):
        np.testing.assert_array_equal(x, y)
        assert np.abs(x - z).max() <= PARAM_ATOL
    np.testing.assert_allclose(a[1], want[1], rtol=LOSS_RTOL)
    assert n_a > 0 and n_b > 0
    for res in results:
        err, dtypes = res["int8"]
        assert err <= 2.0 / 127 + 1e-6
        assert torch.int8 in dtypes


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
