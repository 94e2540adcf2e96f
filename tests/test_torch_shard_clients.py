"""`shard_clients` across ranks: the client axis over a torch.distributed
group, here two gloo ranks on the CPU. The twin of the reference's
tests/test_sampled_shardmap.py (its shard_map over 2 virtual devices) and
of its int8 sync tests (tests/test_perf_paths.py:43-82,
tests/test_federated.py:111-127).

One module-scoped spawn of 2 ranks runs every sharded case of the file
(rendezvous through a file, so no TCP port is chosen); each rank pickles
its results, and the tests hold them against the reference's unsharded
run from the same numpy inputs (the reference pins its own sharded run
to it within these bounds) and against the port's unsharded run:
  * the reference test's quadratic sims under `dropout` (d = 16, M = 6, 5
    rounds, eval every 2), dense and K = 4: params and losses within
    1e-5 / 1e-6, sim_time, participants and uplink bits exact; the ranks'
    params bit-equal; with momentum, the gathered optimizer state;
  * a lane on rank 1 that the guard rejects every round, under a quorum
    of 4 that only the gathered mask meets (each rank holds 3 lanes);
  * `mnist_smoke` (M = 4) through ExperimentSpec(shard_clients=True): a
    run, a 2-seed fleet and a 2-arm Study (its checkpoints written once),
    each within the member contract of the unsharded port's; a checkpoint
    resumed on both ranks;
  * build_round_step's 'allreduce_shardmap' and 'int8_shardmap' against
    the reference's 'allreduce' (1e-6 and 2/127), with int8 codes on the
    wire; 'int8_gather' (one process) against the reference's.

The ranks run this file as a script, so JAX is imported only where the
parent runs the reference.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import FedConfig
from repro_torch.federated import experiment, mesh_rounds, scenarios
from repro_torch.federated.faults import FaultModel
from repro_torch.federated.simulation import (Simulator, load_state,
                                              save_state)
from repro_torch.federated.study import Study
from repro_torch.optim.sgd import sgd
from repro_torch.sharding import collectives
from repro_torch.utils.tree import leaves

WORLD = 2
# The reference's sharded bounds (tests/test_sampled_shardmap.py:69-77).
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6
# The member contract (Simulator.run_fleet, Study.run).
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-4
RECORD_FIELDS = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits",
                 "n_participants", "rejected")
# The guard case: lane 4 (rank 1's second lane) trains towards NaN; the
# guard rejects it every round, and a quorum of 4 passes only on the
# gathered mask (5 of 6 lanes), never on one rank's 3.
NAN_LANE, GUARD = 4, FaultModel(min_quorum=4)
SMOKE = experiment.get("mnist_smoke")
SMOKE = SMOKE.replace(fed=dataclasses.replace(SMOKE.fed, n_devices=4))
# build_round_step's cases: the reference tests' quadratic problems.
MODE_C, MODE_V, MODE_D = 4, 3, 8


# -- the port's side (every rank, and the parent's unsharded runs) ------------


def _quad_loss(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * torch.sum(diff * diff)


class _TargetIterator:
    def __init__(self, target, batch_size):
        self.target = np.asarray(target, np.float32)
        self.batch_size = batch_size

    def next_batch(self):
        return {"target": np.tile(self.target, (self.batch_size, 1))}


def _targets(M, d, nan_lane=None):
    out = [np.linspace(0.0, m, d) * 0.1 for m in range(M)]
    if nan_lane is not None:
        out[nan_lane] = np.full(d, np.nan)
    return out


def _quad(shard, K=None, M=6, scenario="dropout", faults=None, momentum=0.0,
          nan_lane=None):
    """The reference test's quadratic simulator (d = 16, b = 2)."""
    d, b = 16, 2
    scen = scenarios.get(scenario)
    fed = FedConfig(n_devices=M, batch_size=b, lr=0.05, seed=0)
    iters = [_TargetIterator(t, b) for t in _targets(M, d, nan_lane)]
    return Simulator(_quad_loss, {"w": np.zeros(d, np.float32)}, iters,
                     10 * np.arange(1, M + 1), fed, sgd(fed.lr, momentum),
                     scen.population(M, seed=0), scenario=scen,
                     faults=faults, cohort=K, shard_clients=shard,
                     device="cpu")


def _summary(res):
    """A SimResult as host values: (records, losses, test accs, params)."""
    return ([tuple(getattr(r, f) for f in RECORD_FIELDS)
             for r in res.history],
            [float(r.train_loss) for r in res.history],
            [r.test_acc for r in res.history],
            [x.detach().cpu().numpy().copy() for x in leaves(res.params)])


def _arms():
    fed = SMOKE.fed
    return [("b8", SMOKE), ("b4", SMOKE.replace(
        fed=dataclasses.replace(fed, batch_size=4)))]


def _mode_inputs():
    """The int8_shardmap test's round: C = 4 clients at w = 1, each pulled
    V = 3 steps towards its target t = 0..3, weights 1/4."""
    params = mesh_rounds.replicate_clients(
        {"w": torch.ones(MODE_D, dtype=torch.float32)}, MODE_C)
    target = torch.stack([torch.full((MODE_V, MODE_D), float(t))
                          for t in range(MODE_C)])
    weights = torch.full((MODE_C,), 0.25, dtype=torch.float32)
    return params, {"target": target}, weights


def _mode_step(mode, params, batches, weights):
    step = mesh_rounds.build_round_step(
        mesh_rounds.vmapped_value_and_grad(_quad_loss), sgd(0.05), mode)
    new_p, _, loss, _ = step(params, (), batches, weights)
    return new_p["w"].numpy().copy(), loss.numpy().copy()


def _rank_main(rank, rdzv, out):
    """One rank: every sharded case of the file, its results pickled."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=WORLD)
    out = Path(out)
    res = {}
    for K in (None, 4):
        sim = _quad(True, K)
        assert sim._shard and sim._lanes_local == (K or 6) // WORLD
        res[("quad", K)] = _summary(sim.run(sim.init(), max_rounds=5,
                                            eval_every=2)[1])
    sim = _quad(True, momentum=0.9)
    st, r = sim.run(sim.init(), max_rounds=5, eval_every=2)
    res["momentum"] = (_summary(r), st.opt_C["w"].numpy().copy())
    sim = _quad(True, scenario="uniform", faults=GUARD, nan_lane=NAN_LANE)
    res["guard"] = _summary(sim.run(sim.init(), max_rounds=3)[1])

    sim = SMOKE.replace(shard_clients=True).build(device="cpu")
    res["smoke"] = _summary(sim.run(sim.init(), max_rounds=2)[1])
    fleet = sim.run_fleet(seeds=[0, 1], max_rounds=2)
    res["fleet"] = [_summary(r) for r in fleet.results]
    st, _ = sim.run(sim.init(), max_rounds=1)
    save_state(str(out / "state.pkl"), st)
    st = load_state(str(out / "state.pkl"), like=sim.init())
    res["resume"] = _summary(sim.run(st, max_rounds=1)[1])
    arms = [(k, s.replace(shard_clients=True)) for k, s in _arms()]
    study = Study(arms=arms, seeds=(0,), max_rounds=2).run(
        device="cpu", checkpoint_dir=str(out / "study"))
    res["study"] = {k: _summary(study[k][0]) for k, _ in arms}
    res["study_files"] = sorted(p.name for p in (out / "study").iterdir())

    dtypes = []
    gather = collectives.gather_rows

    def recording(x, dim=0, group=None):
        dtypes.append(x.dtype)
        return gather(x, dim, group)

    mesh_rounds.collectives.gather_rows = recording
    params, batches, weights = _mode_inputs()
    lanes = collectives.lane_slice(MODE_C)
    local = ({"w": params["w"][lanes]}, {"target": batches["target"][lanes]})
    res["modes"] = {}
    for mode in ("allreduce_shardmap", "int8_shardmap"):
        dtypes.clear()
        res["modes"][mode] = (_mode_step(mode, *local, weights),
                              list(dtypes))
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


class _Ranks:
    """The spawned ranks of the module: started at once, read on demand."""

    def __init__(self, tmp: Path):
        self.dir = tmp
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(Path(__file__).resolve().parents[1] / "src"),
             os.environ.get("PYTHONPATH", "")]))
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(tmp / "rdzv"), str(tmp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            logs = [p.communicate(timeout=300)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log
            self._results = []
            for r in range(WORLD):
                with open(self.dir / f"rank{r}.pkl", "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spawned = _Ranks(tmp_path_factory.mktemp("shard_clients"))
    yield spawned
    spawned.close()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the parent's checks --------------------------------------------------------


def _j_quad(K):
    """The reference's unsharded quadratic simulator on the same inputs."""
    import jax.numpy as jnp
    from repro.configs.base import FedConfig as JFed
    from repro.federated import scenarios as j_scen
    from repro.federated.simulation import Simulator as JSim
    from repro.optim import sgd as j_sgd

    def loss(params, batch):
        diff = params["w"] - batch["target"]
        return 0.5 * jnp.sum(diff * diff), {}

    d, b, M = 16, 2, 6
    scen = j_scen.get("dropout")
    fed = JFed(n_devices=M, batch_size=b, lr=0.05, seed=0)
    iters = [_TargetIterator(t, b) for t in _targets(M, d)]
    return JSim(loss, {"w": jnp.zeros(d)}, iters, 10 * np.arange(1, M + 1),
                fed, j_sgd(fed.lr), scen.population(M, seed=0),
                backend="scan", scenario=scen, cohort=K)


def _assert_within(got, want, rtol, atol, loss_rtol=None):
    """Records exact; losses within loss_rtol (default rtol, atol) and
    params within (rtol, atol)."""
    g_rec, g_loss, _, g_par = got
    w_rec, w_loss, _, w_par = want
    assert g_rec == w_rec
    if loss_rtol is None:
        np.testing.assert_allclose(g_loss, w_loss, rtol=rtol, atol=atol)
    else:
        np.testing.assert_allclose(g_loss, w_loss, rtol=loss_rtol)
    for x, y in zip(g_par, w_par):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def _assert_ranks_equal(results, key):
    """Both ranks returned the same records and bit-equal params."""
    a, b = (r[key] for r in results)
    assert a[0] == b[0] and a[1] == b[1]
    for x, y in zip(a[3], b[3]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("K", [None, 4], ids=["dense", "K4"])
def test_quad_dropout_matches_the_references_unsharded_run(ranks, K):
    j_sim = _j_quad(K)
    _, j = j_sim.run(j_sim.init(), max_rounds=5, eval_every=2)
    want = ([tuple(getattr(r, f) for f in RECORD_FIELDS) for r in j.history],
            [float(r.train_loss) for r in j.history], None,
            [np.asarray(j.params["w"])])
    sim = _quad(False, K)
    port = _summary(sim.run(sim.init(), max_rounds=5, eval_every=2)[1])
    results = ranks.results()
    _assert_ranks_equal(results, ("quad", K))
    got = results[0][("quad", K)]
    # Clock, participants and bits exact; losses and params within the
    # reference's sharded bounds, of its run and of the port's.
    _assert_within(got, want, SHARD_RTOL, SHARD_ATOL)
    _assert_within(got, port, SHARD_RTOL, SHARD_ATOL)


def test_sharded_optimizer_state_is_gathered(ranks):
    """Momentum under `dropout`: a dropped lane keeps its momentum, so the
    lanes' optimizer states differ; the returned state holds all 6,
    gathered from both ranks."""
    sim = _quad(False, momentum=0.9)
    st, r = sim.run(sim.init(), max_rounds=5, eval_every=2)
    results = ranks.results()
    (got, opt0), (_, opt1) = (res["momentum"] for res in results)
    _assert_within(got, _summary(r), SHARD_RTOL, SHARD_ATOL)
    np.testing.assert_array_equal(opt0, opt1)
    assert opt0.shape == (6, 16)
    np.testing.assert_allclose(opt0, st.opt_C["w"].numpy(), rtol=SHARD_RTOL,
                               atol=SHARD_ATOL)


def test_guard_rejection_on_rank1_changes_every_ranks_weights(ranks):
    sim = _quad(False, scenario="uniform", faults=GUARD, nan_lane=NAN_LANE)
    want = _summary(sim.run(sim.init(), max_rounds=3)[1])
    results = ranks.results()
    _assert_ranks_equal(results, "guard")
    got = results[0]["guard"]
    # 5 of 6 lanes each round, and the quorum of 4 passed: it counted the
    # gathered mask.
    assert [r[5] for r in got[0]] == [5, 5, 5]
    assert [r[6] for r in got[0]] == [False, False, False]
    _assert_within(got, want, SHARD_RTOL, SHARD_ATOL)
    assert all(np.isfinite(p).all() for p in got[3])


def test_mnist_smoke_run_and_checkpoint(ranks):
    sim = SMOKE.build(device="cpu")
    want = _summary(sim.run(sim.init(), max_rounds=2)[1])
    results = ranks.results()
    for key in ("smoke", "resume"):
        _assert_ranks_equal(results, key)
    got = results[0]["smoke"]
    _assert_within(got, want, 0.0, PARAM_ATOL, loss_rtol=LOSS_RTOL)
    # Saved by rank 0 alone after round 1, loaded on both, round 2: the
    # uninterrupted run's second round.
    resumed = results[0]["resume"]
    assert resumed[0] == got[0][1:] and resumed[1] == got[1][1:]
    for x, y in zip(resumed[3], got[3]):
        np.testing.assert_array_equal(x, y)


def test_mnist_smoke_fleet_members_within_the_member_contract(ranks):
    sim = SMOKE.build(device="cpu")
    results = ranks.results()
    for i, seed in enumerate((0, 1)):
        want = _summary(sim.run(sim.init(seed), max_rounds=2)[1])
        a, b = (r["fleet"][i] for r in results)
        assert a[0] == b[0] and a[1] == b[1]
        _assert_within(a, want, 0.0, PARAM_ATOL, loss_rtol=LOSS_RTOL)


def test_mnist_smoke_study_within_the_member_contract(ranks):
    study = Study(arms=_arms(), seeds=(0,), max_rounds=2).run(device="cpu")
    results = ranks.results()
    assert results[0]["study_files"] == ["arm000_seed0.pkl",
                                         "arm001_seed0.pkl"]
    for label, _ in _arms():
        a, b = (r["study"][label] for r in results)
        assert a[0] == b[0] and a[1] == b[1]
        _assert_within(a, _summary(study[label][0]), 0.0, PARAM_ATOL,
                       loss_rtol=LOSS_RTOL)


def _j_mode(mode, C, targets, weights):
    """The reference's build_round_step(mode) on the quadratic problem."""
    import jax
    import jax.numpy as jnp
    from repro.federated import mesh_rounds as j_rounds
    from repro.optim import sgd as j_sgd

    def loss(params, batch):
        diff = params["w"] - batch["target"]
        return 0.5 * jnp.sum(diff * diff), {}

    stacked = j_rounds.replicate_clients(
        {"w": jnp.ones(MODE_D, jnp.float32)}, C)
    step = j_rounds.build_round_step(loss, j_sgd(0.05), MODE_V, mode)
    p, _, _ = jax.jit(step)(stacked, (), {"target": jnp.asarray(targets)},
                            jnp.asarray(weights))
    return np.asarray(p["w"])


@pytest.mark.parametrize("mode,tol", [("allreduce_shardmap", 1e-6),
                                      ("int8_shardmap", 2.0 / 127 + 1e-6)])
def test_sharded_round_step_modes_against_the_references_allreduce(
        ranks, mode, tol):
    params, batches, weights = _mode_inputs()
    ref = _j_mode("allreduce", MODE_C, batches["target"].numpy(),
                  weights.numpy())
    (p0, loss0), dtypes = ranks.results()[0]["modes"][mode]
    (p1, loss1), _ = ranks.results()[1]["modes"][mode]
    # Each rank returns its 2 lanes; every lane holds the aggregate.
    assert p0.shape == (MODE_C // WORLD, MODE_D)
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(loss0, loss1)
    assert np.max(np.abs(p0 - ref[:MODE_C // WORLD])) <= tol
    if mode == "int8_shardmap":
        # int8 codes on the wire, and float32 scales; the combine after the
        # gather is the one-process int8_gather's, bit for bit.
        assert torch.int8 in dtypes and torch.float32 in dtypes
        one, _ = _mode_step("int8_gather", params, batches, weights)
        np.testing.assert_array_equal(p0, one[:MODE_C // WORLD])
    else:
        assert dtypes == [torch.float32]


def test_int8_gather_codes_are_the_references():
    """The reference test's case (C = 2, targets 0 and 2, weights 1/2):
    the port's codes and scales are the reference's, its result within
    1e-6 of the reference's and within one int8 step of the clients'
    delta of 'allreduce'."""
    import jax.numpy as jnp
    from repro.federated import mesh_rounds as j_rounds
    C, V = 2, MODE_V
    target = torch.stack([torch.full((V, MODE_D), t) for t in (0.0, 2.0)])
    weights = torch.tensor([0.5, 0.5])
    params = mesh_rounds.replicate_clients({"w": torch.ones(MODE_D)}, C)
    got, _ = _mode_step("int8_gather", params, {"target": target}, weights)
    ref = _j_mode("int8_gather", C, target.numpy(), weights.numpy())
    plain = _j_mode("allreduce", C, target.numpy(), weights.numpy())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.max(np.abs(got - plain)) <= (1.0 - 0.95 ** V) / 127 + 1e-7
    # The codes: each client's delta through the port's quantizer, and
    # through the reference's with a one-hot weight and a zero old model
    # (its output row is then fl(code x scale) exactly).
    local = mesh_rounds.local_steps_fn(
        mesh_rounds.vmapped_value_and_grad(_quad_loss), sgd(0.05))
    new, _, _ = local(params, (), {"target": target})
    delta = (new["w"] - params["w"]).numpy()
    codes, scale = mesh_rounds._int8_rows(torch.from_numpy(delta))
    for c in range(C):
        onehot = np.eye(C, dtype=np.float32)[c]
        deq = np.asarray(j_rounds._int8_gather_mean_bcast(
            {"w": jnp.asarray(delta)}, {"w": jnp.zeros_like(delta)},
            jnp.asarray(onehot), key=None)["w"][0])
        np.testing.assert_array_equal(
            (codes[c].to(torch.float32) * scale[c]).numpy(), deq)
        np.testing.assert_array_equal(codes[c].numpy(),
                                      np.rint(deq / scale[c].numpy()))
    assert codes.dtype == torch.int8 and codes.abs().max() == 127


def test_collectives_without_a_group_are_the_identity():
    assert not collectives.initialized()
    assert (collectives.world(), collectives.rank()) == (1, 0)
    assert collectives.lane_slice(6) == slice(0, 6)
    x = torch.arange(6.0).reshape(3, 2)
    assert collectives.gather_rows(x, dim=1) is x
    (y,) = collectives.sum_partials([x])
    assert y is x
    assert collectives.device_for_rank("cpu") == torch.device("cpu")
    seen = []
    collectives.on_rank0(lambda: seen.append(1))
    assert seen == [1]


def test_world_of_one_is_the_unsharded_step():
    """'allreduce_shardmap' without a group and in a gloo group of one
    rank (its collectives run): the unsharded 'allreduce' bit for bit (the
    partial is the whole sum), and so is a sharded simulator's run."""
    params, batches, weights = _mode_inputs()
    a, la = _mode_step("allreduce", params, batches, weights)
    b, lb = _mode_step("allreduce_shardmap", params, batches, weights)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    sim = _quad(False)
    plain = _summary(sim.run(sim.init(), max_rounds=3)[1])
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        c, lc = _mode_step("allreduce_shardmap", params, batches, weights)
        sim = _quad(True)
        assert sim._shard and sim._lanes_local == 6
        one = _summary(sim.run(sim.init(), max_rounds=3)[1])
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(la, lc)
    assert one[:2] == plain[:2]
    for x, y in zip(one[3], plain[3]):
        np.testing.assert_array_equal(x, y)


if __name__ == "__main__":
    start = time.perf_counter()
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    print(f"rank {sys.argv[1]}: {time.perf_counter() - start:.1f} s")
