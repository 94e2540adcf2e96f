"""Sampled participation in the port: K-client cohorts drawn each round
from an M-client population, device state O(K). The twin of the
reference's tests/test_sampled.py, of the spare-cohort tests of its
tests/test_resilience.py and of its tests/test_sampled_shardmap.py.

Inside the port (the quadratic problem and the small CNNs, on the CPU):
  * K = M sampled is the dense run bit for bit (losses, clocks,
    participants, uplink bits, params) on every registered scenario, with
    and without compression, with and without faults; so is K + spare = M
    under a deadline;
  * sampled 'scan' equals 'batched' bit for bit at K < M, with the
    weighted sampler and spare cohorts too;
  * resume bit for bit, O(K) state, fleets, the spec API (validation,
    dense sugar, the dense-M warning, `mnist_sampled`, M = 100,000), the
    misuse errors, the Study's sampled arm and the `shard_clients` rule.

Against the reference:
  * its cohort draws, `ClientDataPool`, `partition_virtual` and cohort
    plans: exact (numpy copies);
  * compressed `mnist_sampled` at K < M with the reference's quantizer
    noise replayed (its keys are lane-indexed: row k of a round's (K,
    rows, 1024) draw goes to lane k): cohorts, clock, uplink bits and
    participants exact; each round from the reference's state within the
    member contract, losses 1e-5 relative and params 5e-4 absolute;
  * spare cohorts (the kept cohorts and the records) exact, and
    `shard_clients=True` on one CPU device within the member contract.
"""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFed
from repro.core import defl as j_defl
from repro.data import synthetic as j_synth
from repro.data.pipeline import ClientDataPool as JPool
from repro.federated import compression as j_comp
from repro.federated import experiment as j_exp
from repro.federated import partition as j_part
from repro.federated import scenarios as j_scen
from repro.federated import simulation as j_simulation
from repro.federated import study as j_study
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro.optim import sgd as j_sgd
from repro_torch.configs.base import ComputeConfig, FedConfig, WirelessConfig
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import delay
from repro_torch.data import synthetic as t_synth
from repro_torch.data.pipeline import BatchIterator, ClientDataPool
from repro_torch.federated import compression as t_comp
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import partition as t_part
from repro_torch.federated import scenarios
from repro_torch.federated import simulation
from repro_torch.federated import study as t_study
from repro_torch.federated.client import (stack_chunk_indices,
                                          stack_client_batches,
                                          stack_cohort_batches,
                                          stack_cohort_indices)
from repro_torch.federated.experiment import (CohortSpec, ExperimentSpec,
                                              PopulationSpec)
from repro_torch.federated.faults import FaultModel
from repro_torch.federated.simulation import (Simulator, load_state,
                                              save_state)
from repro_torch.optim.sgd import sgd
from repro_torch.utils.tree import leaves

# The member contract (Simulator.run_fleet): a round from equal states.
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
PLAN_FIELDS = ("b", "theta", "V", "H_pred", "T_cm", "T_cp", "T_round",
               "overall_pred", "update_bits")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small models run fastest on one intra-op thread, and the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the quadratic problem, in both packages ---------------------------------


def _quad_loss(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * torch.sum(diff * diff)


def _j_quad_loss(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * jnp.sum(diff * diff), {}


class _TargetIterator:
    """A batch source without the index protocol (the host-batch path)."""

    def __init__(self, target, batch_size):
        self.target = np.asarray(target, np.float32)
        self.batch_size = batch_size

    def next_batch(self):
        return {"target": np.tile(self.target, (self.batch_size, 1))}


def _quad(backend, scenario=None, *, M=6, K=None, sampler="uniform",
          spare=0, compress=False, faults=None, seed=0, momentum=0.0,
          heterogeneity=0.0, shard=False, ref=False, factory=False):
    """The reference's tests' quadratic simulator, in the port (or, with
    ref=True, in the reference, for the same inputs)."""
    d, b = 16, 2
    scen = (j_scen if ref else scenarios).get(scenario) if scenario else None
    pop = (scen.population(M, seed=seed) if scen is not None else
           delay.draw_population(M, ComputeConfig(), WirelessConfig(), 0,
                                 heterogeneity))
    iters = [_TargetIterator(np.linspace(0.0, m, d) * 0.1, b)
             for m in range(M)]
    if factory:  # per-seed iterators (run_fleet); these are stateless
        iters = (lambda its: lambda seed: list(its))(iters)
    kw = dict(backend=backend, scenario=scen, faults=faults, cohort=K,
              cohort_sampler=sampler, cohort_spare=spare,
              shard_clients=shard)
    if ref:
        fed = JFed(n_devices=M, batch_size=b, lr=0.05, seed=seed,
                   compress_updates=compress)
        if faults is not None:
            from repro.federated.faults import FaultModel as JFaults
            kw["faults"] = JFaults(**dataclasses.asdict(faults))
        return j_simulation.Simulator(
            _j_quad_loss, {"w": jnp.zeros(d)}, iters,
            10 * np.arange(1, M + 1), fed, j_sgd(fed.lr, momentum), pop, **kw)
    fed = FedConfig(n_devices=M, batch_size=b, lr=0.05, seed=seed,
                    compress_updates=compress)
    return Simulator(_quad_loss, {"w": np.zeros(d, np.float32)}, iters,
                     10 * np.arange(1, M + 1), fed, sgd(fed.lr, momentum),
                     pop, device="cpu", **kw)


def _run(sim, state=None, **kw):
    return sim.run(sim.init() if state is None else state, **kw)[1]


def _assert_bit_identical(a, b):
    """Two port runs: params and every record field, bit for bit."""
    for x, y in zip(leaves(a.params), leaves(b.params)):
        assert x.shape == y.shape
        assert torch.equal(x, y)
    assert len(a.history) == len(b.history)
    for ra, rb in zip(a.history, b.history):
        np.testing.assert_array_equal(ra.train_loss, rb.train_loss)
        assert (ra.round, ra.sim_time, ra.T_cm, ra.T_cp, ra.n_participants,
                ra.uplink_bits, bool(ra.rejected)) == (
            rb.round, rb.sim_time, rb.T_cm, rb.T_cp, rb.n_participants,
            rb.uplink_bits, bool(rb.rejected))


def _same_tree(a, b):
    """Host snapshots (stream and iterator states: dicts of numpy arrays,
    ints and generator states) equal value for value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- K = M is dense ------------------------------------------------------------

DEADLINE = FaultModel(deadline_factor=1.5, max_retries=1)


# 7 rounds at eval_every=3: a ragged final chunk included.
@pytest.mark.parametrize("faults", [None, DEADLINE], ids=["plain", "faults"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("scenario", list(scenarios.names()))
def test_sampled_K_eq_M_bit_identical_to_dense(scenario, compress, faults):
    kw = dict(M=4, compress=compress, faults=faults)
    dense = _run(_quad("scan", scenario, **kw), max_rounds=7, eval_every=3)
    sampled = _run(_quad("scan", scenario, K=4, **kw), max_rounds=7,
                   eval_every=3)
    _assert_bit_identical(sampled, dense)


def test_sampled_K_eq_M_batched_is_dense_batched():
    kw = dict(M=4, compress=True, faults=DEADLINE)
    dense = _run(_quad("batched", "stragglers", **kw), max_rounds=4)
    sampled = _run(_quad("batched", "stragglers", K=4, **kw), max_rounds=4)
    _assert_bit_identical(sampled, dense)


# -- sampled scan == batched ---------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("scenario", ["dropout", "unreliable_edge", None])
def test_sampled_scan_matches_batched(scenario, compress):
    kw = dict(M=6, K=3, compress=compress)
    rb = _run(_quad("batched", scenario, **kw), max_rounds=7, eval_every=3)
    rs = _run(_quad("scan", scenario, **kw), max_rounds=7, eval_every=3)
    _assert_bit_identical(rs, rb)


def test_sampled_faults_scan_matches_batched():
    fm = FaultModel(deadline_factor=1.5, max_retries=2)
    kw = dict(M=6, K=3, faults=fm)
    rb = _run(_quad("batched", "stragglers", **kw), max_rounds=6,
              eval_every=3)
    rs = _run(_quad("scan", "stragglers", **kw), max_rounds=6, eval_every=3)
    _assert_bit_identical(rs, rb)


def test_weighted_sampler_runs_and_matches_across_backends():
    kw = dict(M=6, K=3, sampler="weighted")
    rb = _run(_quad("batched", "dropout", **kw), max_rounds=5, eval_every=2)
    rs = _run(_quad("scan", "dropout", **kw), max_rounds=5, eval_every=2)
    _assert_bit_identical(rs, rb)
    assert all(r.n_participants <= 3 for r in rs.history)


def test_run_round_repeats_sampled_run():
    """run_round draws the round's cohort from the state's stream: twice
    from init it gives run()'s two rounds and the same host cursors."""
    sim = _quad("batched", "dropout", K=3, compress=True)
    end, res = sim.run(sim.init(), max_rounds=2)
    st, losses = sim.init(), []
    for _ in range(2):
        st, m = sim.run_round(st)
        losses.append(float(m["train_loss"]))
        assert m["n_participants"] <= 3
    np.testing.assert_array_equal(losses, [r.train_loss for r in res.history])
    assert torch.equal(sim.params(st)["w"], sim.params(end)["w"])
    _same_tree(st.stream, end.stream)


# -- cohort draws: the reference's, draw for draw ----------------------------------


def _streams(K, M=6, seed=0, weights=None):
    out = []
    for mod in (scenarios, j_scen):
        scen = mod.get("dropout")
        out.append(scen.stream(scen.population(M, seed=seed), seed,
                               cohort_size=K, cohort_weights=weights))
    return out


@pytest.mark.parametrize("K,weights", [
    (3, None), (6, None), (2, np.array([1e-6, 1e-6, 1e-6, 1.0, 1.0, 1.0]))],
    ids=["uniform", "K_eq_M", "weighted"])
def test_cohort_draws_are_the_references(K, weights):
    t, j = _streams(K, seed=3, weights=weights)
    np.testing.assert_array_equal(t.draw_cohorts(4), j.draw_cohorts(4))
    for _ in range(3):
        c = t.draw_cohort()
        np.testing.assert_array_equal(c, j.draw_cohort())
        assert c.dtype == np.int32 and (np.diff(c) > 0).all()
    snap = t.state()
    _same_tree(snap, j.state())
    ahead = t.draw_cohorts(3)
    t.set_state(snap)
    np.testing.assert_array_equal(t.draw_cohorts(3), ahead)


def test_cohort_draw_K_eq_M_consumes_no_rng():
    t, _ = _streams(6)
    before = t.state()["cohort_rng"]
    np.testing.assert_array_equal(t.draw_cohort(), np.arange(6))
    assert t.state()["cohort_rng"] == before


# -- data: the pool, the virtual partition and the cohort stacks ---------------------


def test_partition_virtual_and_pool_are_the_references():
    """`partition_virtual` and `ClientDataPool` equal the reference's array
    for array: the shards, the sizes, every batch, and the pool's state,
    which holds only the clients it has touched."""
    t_fn, t_sizes = t_part.partition_virtual(96, 100_000, seed=5)
    j_fn, j_sizes = j_part.partition_virtual(96, 100_000, seed=5)
    np.testing.assert_array_equal(t_sizes, j_sizes)
    for m in (0, 1, 4_321, 99_999):
        np.testing.assert_array_equal(t_fn(m), j_fn(m))
    t_pool = ClientDataPool(t_synth.make_mnist_like(96, seed=0), t_fn,
                            t_sizes, 8, seed=7)
    j_pool = JPool(j_synth.make_mnist_like(96, seed=0), j_fn, j_sizes, 8,
                   seed=7)
    assert len(t_pool) == len(j_pool) == 100_000
    for m in (3, 99_998, 3):
        for _ in range(13):  # past an epoch of the 64-row shard
            a, b = t_pool.client(m).next_batch(), j_pool.client(m).next_batch()
            np.testing.assert_array_equal(a["x"], b["x"])
            np.testing.assert_array_equal(a["y"], b["y"])
    assert set(t_pool.state()["clients"]) == {3, 99_998}
    _same_tree(t_pool.state(), j_pool.state())
    fresh = ClientDataPool(t_pool.data, t_fn, t_sizes, 8, seed=7)
    fresh.set_state(t_pool.state())
    np.testing.assert_array_equal(fresh.client(3).next_indices(),
                                  t_pool.client(3).next_indices())


def test_pool_restore_is_lazy_and_the_references():
    """A restored pool applies a client's snapshot when the client is next
    drawn (no iterator is rebuilt at restore), and from then on draws and
    snapshots what the reference's restored pool does, its snapshot's
    keys in the reference's order."""
    t_fn, sizes = t_part.partition_virtual(96, 500, seed=1)
    j_fn, _ = j_part.partition_virtual(96, 500, seed=1)
    t_data = t_synth.make_mnist_like(96, seed=0)
    j_data = j_synth.make_mnist_like(96, seed=0)
    src = ClientDataPool(t_data, t_fn, sizes, 8, seed=3)
    for m in (7, 2, 400, 7):
        for _ in range(9):
            src.client(m).next_indices()
    snap = src.state()
    t_pool = ClientDataPool(t_data, t_fn, sizes, 8, seed=3)
    j_pool = JPool(j_data, j_fn, sizes, 8, seed=3)
    t_pool.set_state(snap)
    j_pool.set_state(snap)
    assert not t_pool._iters  # nothing rebuilt at restore
    _same_tree(t_pool.state(), snap)
    for m in (400, 11, 7):
        for _ in range(5):
            np.testing.assert_array_equal(t_pool.client(m).next_indices(),
                                          j_pool.client(m).next_indices())
    assert list(t_pool.state()["clients"]) == list(
        j_pool.state()["clients"]) == [7, 2, 400, 11]
    _same_tree(t_pool.state(), j_pool.state())


def test_pool_from_parts_replays_the_dense_iterators():
    data = t_synth.make_mnist_like(64, seed=0)
    parts = [np.arange(m * 16, (m + 1) * 16) for m in range(4)]
    dense = [BatchIterator(data, p, 8, seed=7 + m)
             for m, p in enumerate(parts)]
    pool = ClientDataPool.from_parts(data, parts, 8, seed=7)
    np.testing.assert_array_equal(pool.sizes, [16] * 4)
    for m in range(4):
        for _ in range(3):
            a, b = dense[m].next_batch(), pool.client(m).next_batch()
            np.testing.assert_array_equal(a["x"], b["x"])
            np.testing.assert_array_equal(a["y"], b["y"])


def test_cohort_stacks_at_K_eq_M_are_the_dense_stacks():
    """Lane k of round r draws from client cohorts[r, k]; at K = M the
    cohort stacks draw what the dense stacks draw, and only the cohort's
    iterators advance."""
    data = t_synth.make_mnist_like(64, seed=0)
    parts = [np.arange(m * 16, (m + 1) * 16) for m in range(4)]

    def pool():
        return ClientDataPool.from_parts(data, parts, 4, seed=1)

    dense = [pool().client(m) for m in range(4)]
    full = np.tile(np.arange(4, dtype=np.int32), (3, 1))
    np.testing.assert_array_equal(stack_cohort_indices(pool(), full, 2),
                                  stack_chunk_indices(dense, 3, 2))
    a = stack_cohort_batches(pool(), np.arange(4), 2)
    b = stack_client_batches([pool().client(m) for m in range(4)], 2)
    np.testing.assert_array_equal(a["x"], b["x"])
    p = pool()
    idx = stack_cohort_indices(p, np.array([[1, 3], [0, 3]]), 2)
    assert idx.shape == (2, 2, 2, 4)
    assert set(p.state()["clients"]) == {0, 1, 3}


# -- plans at cohort_size ------------------------------------------------------------


@pytest.mark.parametrize("scenario,K,spare", [
    (None, 50, 0), ("unreliable_edge", 20, 5), ("dropout", 8, 0)])
def test_sampled_plans_are_the_references(scenario, K, spare):
    """The spec's DEFL plan at its cohort (defl.make_plan, and
    deadline_plan with spare under a deadline) and its batchable request
    equal the reference's."""
    def spec(exp):
        return exp.get("mnist_paper").replace(
            scenario=scenario, population=exp.PopulationSpec(
                M=200, cohort=exp.CohortSpec(K=K, spare=spare)))

    t, j = spec(t_exp).resolve_plan(), spec(j_exp).resolve_plan()
    assert [getattr(t, f) for f in PLAN_FIELDS] == [
        getattr(j, f) for f in PLAN_FIELDS]
    assert dataclasses.astuple(t.problem) == dataclasses.astuple(j.problem)
    assert t.problem.M <= K
    assert dataclasses.asdict(spec(t_exp).resolve_fed()) == \
        dataclasses.asdict(spec(j_exp).resolve_fed())
    tr, jr = spec(t_exp).plan_request(), spec(j_exp).plan_request()
    assert (tr is None) == (jr is None)
    if tr is not None:
        assert tr.cohort_size == jr.cohort_size == K
        assert tr.fed.n_devices == jr.fed.n_devices == 200


def test_make_plan_and_deadline_plan_at_cohort_size():
    fed = FedConfig(n_devices=1000, epsilon=0.01, nu=2.0)
    jfed = JFed(n_devices=1000, epsilon=0.01, nu=2.0)
    pop = delay.draw_population(16, ComputeConfig(), WirelessConfig(), 0, 0.5)
    from repro_torch.core import defl as t_defl
    for cohort in (None, 10):
        t = t_defl.make_plan(fed, pop, 8e6, cohort_size=cohort)
        j = j_defl.make_plan(jfed, pop, 8e6, cohort_size=cohort)
        assert [getattr(t, f) for f in PLAN_FIELDS] == [
            getattr(j, f) for f in PLAN_FIELDS]
        t = t_defl.deadline_plan(fed, pop, 8e6, 1e4, cohort_size=cohort)
        j = j_defl.deadline_plan(jfed, pop, 8e6, 1e4, cohort_size=cohort)
        assert dataclasses.astuple(t.problem) == dataclasses.astuple(j.problem)
    assert t.problem.M <= 10


# -- checkpoints, O(K) state, fleets ------------------------------------------------


def test_sampled_resume_bit_identical(tmp_path):
    kw = dict(K=3, seed=5, compress=True)
    full = _run(_quad("scan", "dropout", **kw), max_rounds=6, eval_every=2)
    sim_a = _quad("scan", "dropout", **kw)
    mid, _ = sim_a.run(sim_a.init(), max_rounds=3, eval_every=2)
    path = os.path.join(tmp_path, "state.pkl")
    save_state(path, mid)
    sim_b = _quad("scan", "dropout", **kw)
    resumed = _run(sim_b, load_state(path, like=sim_b.init()), max_rounds=3,
                   eval_every=2)
    full.history = full.history[3:]
    _assert_bit_identical(full, resumed)


def test_sampled_max_sim_time_rewind_resumes_bit_identical():
    """A max_sim_time stop inside a chunk rewinds the sampled host streams
    (cohorts, realization, data) to the stopping round: resuming from the
    returned state draws what an uninterrupted run draws next."""
    sim = _quad("scan", "unreliable_edge", K=3, spare=2)
    st = sim.init()
    _, probe = sim.run(st, max_rounds=6, eval_every=6)
    stop = probe.history[1].sim_time
    mid, res = sim.run(sim.init(), max_rounds=6, eval_every=6,
                       max_sim_time=stop)
    assert [r.round for r in res.history] == [1, 2]
    per_round = sim.init()
    for _ in range(2):
        per_round, _ = sim.run(per_round, max_rounds=1)
    _same_tree(mid.stream, per_round.stream)
    _same_tree(mid.data, per_round.data)


def test_sampled_device_state_is_O_K():
    sim = _quad("scan", "dropout", M=64, K=4)
    st = sim.init()
    assert all(leaf.shape[0] == 4 for leaf in leaves(st.params_C))
    st, _ = sim.run(st, max_rounds=2, eval_every=2)
    assert all(leaf.shape[0] == 4 for leaf in leaves(st.params_C))


def test_sampled_fleet_members_repeat_their_runs_alone():
    """run_fleet folds sampled members into the lane axis (S*K rows), each
    member drawing its own cohorts: records exact against its run alone,
    losses and params within the member contract."""
    sim = _quad("scan", "dropout", M=8, K=3, compress=True, factory=True)
    fleet = sim.run_fleet(seeds=(0, 1, 2), max_rounds=5, eval_every=2)
    for seed, st, res in zip((0, 1, 2), fleet.states, fleet.results):
        alone_st, alone = sim.run(sim.init(seed), max_rounds=5, eval_every=2)
        assert [(r.round, r.sim_time, r.n_participants, r.uplink_bits)
                for r in res.history] == [
            (r.round, r.sim_time, r.n_participants, r.uplink_bits)
            for r in alone.history]
        np.testing.assert_allclose([r.train_loss for r in res.history],
                                   [r.train_loss for r in alone.history],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(st.params_C["w"], alone_st.params_C["w"],
                                   rtol=0, atol=PARAM_ATOL)
        _same_tree(st.stream, alone_st.stream)


# -- the spec API ------------------------------------------------------------------


def test_population_spec_validation():
    for mod in (t_exp, j_exp):
        with pytest.raises(ValueError):
            mod.CohortSpec(K=0)
        with pytest.raises(ValueError):
            mod.CohortSpec(K=2, sampler="roulette")
        with pytest.raises(ValueError):
            mod.CohortSpec(K=2, spare=-1)
        with pytest.raises(ValueError):
            mod.PopulationSpec(M=4, cohort=mod.CohortSpec(K=8))
        with pytest.raises(ValueError):
            mod.PopulationSpec(M=4, cohort=mod.CohortSpec(K=3, spare=2))
        with pytest.raises(ValueError):
            mod.PopulationSpec(M=0)
    ok = PopulationSpec(M=4, cohort=CohortSpec(K=3, spare=1))
    assert ok.validate() is ok
    assert t_exp.DENSE_M_DEPRECATION_THRESHOLD == \
        j_exp.DENSE_M_DEPRECATION_THRESHOLD


def _tiny(**kw):
    return ExperimentSpec(
        fed=FedConfig(batch_size=4, theta=0.62, lr=0.05),
        model="mnist_cnn_tiny", dataset="mnist", n_train=48, n_test=16, **kw)


def test_population_spec_dense_sugar_bit_parity():
    via_fed = _tiny(scenario="dropout").replace(
        fed=FedConfig(n_devices=4, batch_size=4, theta=0.62, lr=0.05))
    via_pop = _tiny(scenario="dropout", population=PopulationSpec(M=4))
    assert via_pop.base_fed().n_devices == 4
    assert via_pop.cohort_spec() is None
    ra = _run(via_fed.build(device="cpu"), max_rounds=3, eval_every=3)
    rb = _run(via_pop.build(device="cpu"), max_rounds=3, eval_every=3)
    _assert_bit_identical(ra, rb)


def test_sampled_spec_K_eq_M_is_dense_spec():
    """The pool over the same Dirichlet partition, with the same seeds:
    a K = M sampled build runs the dense build's numbers."""
    dense = _tiny(scenario="dropout", population=PopulationSpec(M=4))
    sampled = _tiny(scenario="dropout",
                    population=PopulationSpec(M=4, cohort=CohortSpec(K=4)))
    sim = sampled.build(device="cpu")
    assert isinstance(sim._data_src(0), ClientDataPool)
    _assert_bit_identical(
        _run(sim, max_rounds=3, eval_every=2),
        _run(dense.build(device="cpu"), max_rounds=3, eval_every=2))


def test_sampled_K_eq_M_without_scenario_is_dense_without_scenario():
    """A sampled simulator without a scenario runs on 'uniform' (its cohort
    draws live on the stream): at K = M its compressed run is the
    scenario-less dense run bit for bit, the participants counted (M)
    where the dense records say None (chip_smoke.py phase 19 (a) on the
    card)."""
    fed = FedConfig(batch_size=4, theta=0.62, lr=0.05, compress_updates=True)
    dense = _tiny(population=PopulationSpec(M=4)).replace(fed=fed)
    sampled = _tiny(population=PopulationSpec(
        M=4, cohort=CohortSpec(K=4))).replace(fed=fed)
    rd = _run(dense.build(device="cpu"), max_rounds=3, eval_every=2)
    rs = _run(sampled.build(device="cpu"), max_rounds=3, eval_every=2)
    assert [r.n_participants for r in rd.history] == [None] * 3
    assert [r.n_participants for r in rs.history] == [4] * 3
    for r in rd.history:
        r.n_participants = 4
    _assert_bit_identical(rs, rd)


def test_dense_M_above_threshold_deprecated():
    spec = _tiny(population=PopulationSpec(
        M=t_exp.DENSE_M_DEPRECATION_THRESHOLD))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with pytest.raises(DeprecationWarning, match="PopulationSpec"):
            spec.build(device="cpu")


def test_registered_sampled_spec_is_the_references_and_runs():
    t, j = t_exp.get("mnist_sampled"), j_exp.get("mnist_sampled")
    assert dataclasses.asdict(t.population) == dataclasses.asdict(
        j.population)
    assert dataclasses.asdict(t.resolve_fed()) == dataclasses.asdict(
        j.resolve_fed())
    assert (t.model, t.n_train, t.scenario) == (j.model, j.n_train,
                                                 j.scenario)
    K = t.cohort_spec().K
    sim = t.build(device="cpu")
    st = sim.init(0)
    assert all(leaf.shape[0] == K for leaf in leaves(st.params_C))
    _, res = sim.run(st, max_rounds=2, eval_every=2)
    assert len(res.history) == 2
    assert all(r.n_participants <= K for r in res.history)


def test_population_scale_smoke():
    """M far beyond n_train (virtual shards, no M-long host lists) with
    O(K) device state."""
    spec = _tiny(scenario="dropout", population=PopulationSpec(
        M=100_000, cohort=CohortSpec(K=8))).replace(n_train=96)
    sim = spec.build(device="cpu")
    assert len(sim._data_src(0)) == 100_000
    st = sim.init(0)
    assert all(leaf.shape[0] == 8 for leaf in leaves(st.params_C))
    st, res = sim.run(st, max_rounds=2, eval_every=2)
    assert len(res.history) == 2
    assert all(r.n_participants <= 8 for r in res.history)
    assert 0 < len(st.data["clients"]) <= 16  # touched clients only


# -- misuse errors -------------------------------------------------------------------


def test_sampled_requires_stateless_local_opt():
    with pytest.raises(ValueError, match="stateless"):
        _quad("scan", K=3, momentum=0.9)


def test_sampled_rejects_loop_backend():
    with pytest.raises(ValueError, match="loop reference is dense-only"):
        _quad("loop", "dropout", K=3)


def test_sampled_run_round_rejects_predrawn_realization():
    sim = _quad("batched", "dropout", K=3)
    st = sim.init()
    real = sim._materialize(st)[1].next_round()
    with pytest.raises(ValueError, match="sampled cohorts"):
        sim.run_round(st, real=real)


def test_sampled_argument_checks():
    with pytest.raises(ValueError, match="cohort_sampler"):
        _quad("scan", K=3, sampler="roulette")
    with pytest.raises(ValueError, match=r"\[1, 6\]"):
        _quad("scan", K=7)
    with pytest.raises(ValueError, match="requires sampled"):
        _quad("scan", spare=1)
    with pytest.raises(ValueError, match="must not exceed"):
        _quad("scan", M=4, K=3, spare=2)
    spec = t_exp.get("mnist_sampled")
    sim = spec.build(device="cpu")
    with pytest.raises(ValueError, match="ClientDataPool"):
        Simulator(sim.loss_fn, sim._init_params, sim._data_src,
                  sim.data_sizes, sim.fed, sim.opt, sim.pop, device="cpu")


def test_sampled_without_scenario_runs_on_uniform_and_quorum_is_per_K():
    sim = _quad("scan", K=3, faults=FaultModel(min_quorum=0.99))
    assert sim.scenario is not None
    assert sim._quorum == 3  # ceil(0.99 * K), not of M
    assert _quad("scan", K=3).scenario.name == "uniform"


# -- spare cohorts (the reference's tests/test_resilience.py twins) --------------------


def test_spare_covering_population_matches_dense():
    """K + spare = M under a deadline that admits 2 clients: keeping the K
    deadline-feasible-fastest reproduces the dense run bit for bit; the
    bits count the cohort's attempts (3 clients) where dense counts M."""
    M = 5
    kw = dict(M=M, heterogeneity=0.5)
    probe = _quad("scan", faults=FaultModel(deadline=1e9), **kw)
    bits = probe._update_bits()
    t_cm = delay.per_client_uplink_time(bits, probe.wireless, probe.pop.p,
                                        probe.pop.h)
    finish = np.sort(delay.finish_times(probe._t_cp_clients, t_cm,
                                        probe.fed.local_rounds))
    fm = FaultModel(deadline=float((finish[1] + finish[2]) / 2))
    rd = _run(_quad("scan", faults=fm, **kw), max_rounds=6)
    assert [r.n_participants for r in rd.history] == [2] * 6
    rs = _run(_quad("scan", faults=fm, K=3, spare=2, **kw), max_rounds=6)
    for a, b in zip(rd.history, rs.history):
        np.testing.assert_array_equal(a.train_loss, b.train_loss)
        assert (a.sim_time, a.n_participants) == (b.sim_time,
                                                   b.n_participants)
    assert torch.equal(rd.params["w"], rs.params["w"])
    assert rd.history[0].uplink_bits == M * bits
    assert rs.history[0].uplink_bits == 3 * bits


def test_spare_parity_and_midrun_resume(tmp_path):
    kw = dict(faults=FaultModel(deadline_factor=1.2), M=6, K=3, spare=2)
    res_s = _run(_quad("scan", "stragglers", **kw), max_rounds=8)
    res_b = _run(_quad("batched", "stragglers", **kw), max_rounds=8)
    _assert_bit_identical(res_s, res_b)
    sim = _quad("scan", "stragglers", **kw)
    st4, _ = sim.run(sim.init(), max_rounds=4)
    path = os.path.join(tmp_path, "spare.pkl")
    save_state(path, st4)
    tail = _run(_quad("scan", "stragglers", **kw), load_state(path),
                max_rounds=4)
    res_s.history = res_s.history[4:]
    _assert_bit_identical(res_s, tail)


@pytest.mark.parametrize("policy,compress,quorum", [
    ("reject", False, 0.99), ("accept", True, 3)])
def test_sampled_quorum_parity_scan_vs_batched(policy, compress, quorum):
    fm = FaultModel(min_quorum=quorum, quorum_policy=policy,
                    redispatch_cost=0.25)
    kw = dict(faults=fm, compress=compress, K=3)
    res_s = _run(_quad("scan", "dropout", **kw), max_rounds=8)
    res_b = _run(_quad("batched", "dropout", **kw), max_rounds=8)
    _assert_bit_identical(res_s, res_b)
    assert res_s.rounds_rejected > 0


def test_spare_cohorts_are_the_references():
    """The K kept of K + spare (`_select_cohorts`, on the M-wide resolved
    uplink times) and every record equal the reference's, and so do the
    host streams after the run; params within the member contract."""
    kw = dict(faults=FaultModel(deadline_factor=1.2), M=6, K=3, spare=2)
    t_sim = _quad("scan", "stragglers", **kw)
    j_sim = _quad("scan", "stragglers", ref=True, **kw)
    t_st, t_res = t_sim.run(t_sim.init(), max_rounds=5, eval_every=2)
    j_st, j_res = j_sim.run(j_sim.init(), max_rounds=5, eval_every=2)
    for t, j in zip(t_res.history, j_res.history):
        assert (t.round, t.sim_time, t.T_cm, t.T_cp, t.n_participants,
                t.uplink_bits) == (j.round, j.sim_time, j.T_cm, j.T_cp,
                                   j.n_participants, j.uplink_bits)
        np.testing.assert_allclose(t.train_loss, j.train_loss,
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_res.params["w"], np.asarray(j_res.params["w"]),
                               rtol=0, atol=PARAM_ATOL)
    _same_tree(t_st.stream, j_st.stream)
    stream = t_sim._materialize(t_sim.init())[1]
    cands = stream.draw_cohorts(4)
    _, t_cm = t_sim._chunk_uplink(stream.draw_chunk(4))
    np.testing.assert_array_equal(t_sim._select_cohorts(cands, t_cm),
                                  j_sim._select_cohorts(cands, t_cm))


# -- against the reference: compressed mnist_sampled ------------------------------------

ROUNDS = 3


def _compressed(exp):
    spec = exp.get("mnist_sampled")
    return spec.replace(fed=dataclasses.replace(spec.fed,
                                                compress_updates=True))


def _jax_noise(seed, K, rows, rounds):
    """The reference's per-round (K, rows, 1024) quantizer noise: its
    lane-indexed keys (compression.sequential_client_keys over K lanes),
    lane k's noise in row k."""
    draw = jax.jit(jax.vmap(lambda k: j_noise(k, (rows, t_comp.ROW))))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, keys = j_comp.sequential_client_keys(key, K)
        out.append(np.asarray(draw(keys)))
    return out


def _port_state(t_sim, j_state):
    """The port's state equal to a host snapshot of the reference's."""
    return dataclasses.replace(
        t_sim.init(j_state.seed),
        params_C=to_torch(jax.tree.map(np.asarray, j_state.params_C),
                          device="cpu"),
        round=j_state.round, sim_time=j_state.sim_time,
        stream=j_state.stream, data=j_state.data)


@pytest.fixture(scope="module")
def ref_sampled():
    j_spec, t_spec = _compressed(j_exp), _compressed(t_exp)
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    st, before, j_hist = j_sim.init(), [], []
    for _ in range(ROUNDS):
        before.append(jax.device_get(st))
        st, res = j_sim.run(st, max_rounds=1)
        j_hist.extend(res.history)
    after = before[1:] + [jax.device_get(st)]
    K = j_spec.cohort_spec().K
    noise = _jax_noise(j_sim.fed.seed, K, t_comp.n_rows(params0), ROUNDS)
    replay = iter(noise)

    def replayed(g, shape):
        assert shape[0] == K
        return torch.tensor(next(replay))

    t_sim = t_spec.build(device="cpu", params=params0, noise=replayed)
    t_state, t_res = t_sim.run(t_sim.init(), max_rounds=ROUNDS, eval_every=2)
    current = {}
    one = t_spec.build(device="cpu", params=params0,
                       noise=lambda g, shape: torch.tensor(current["u"]))
    per_round = []
    for k in range(ROUNDS):
        current["u"] = noise[k]
        end, res = one.run(_port_state(one, before[k]), max_rounds=1)
        per_round.append((one.params(end), res.history[0]))
    return {"j_sim": j_sim, "j_hist": j_hist, "j_state": after[-1],
            "after": after, "t_sim": t_sim, "t_state": t_state,
            "t_res": t_res, "per_round": per_round}


def test_reference_cohorts_clock_bits_participants_exact(ref_sampled):
    t_sim, j_sim = ref_sampled["t_sim"], ref_sampled["j_sim"]
    np.testing.assert_array_equal(
        t_sim._materialize(t_sim.init())[1].draw_cohorts(ROUNDS),
        j_sim._materialize(j_sim.init())[1].draw_cohorts(ROUNDS))
    t_hist = ref_sampled["t_res"].history
    assert len(t_hist) == len(ref_sampled["j_hist"]) == ROUNDS
    for t, j in zip(t_hist, ref_sampled["j_hist"]):
        assert (t.round, t.sim_time, t.T_cm, t.T_cp, t.uplink_bits,
                t.n_participants) == (j.round, j.sim_time, j.T_cm, j.T_cp,
                                      j.uplink_bits, j.n_participants)
    # The same cohorts drawn, the same clients' batches consumed.
    t_state, j_state = ref_sampled["t_state"], ref_sampled["j_state"]
    _same_tree(t_state.stream, j_state.stream)
    _same_tree(t_state.data, j_state.data)
    assert all(leaf.shape[0] == 8 for leaf in leaves(t_state.params_C))


def test_reference_each_round_within_member_contract(ref_sampled):
    j_sim = ref_sampled["j_sim"]
    for (params, rec), j_rec, j_after in zip(
            ref_sampled["per_round"], ref_sampled["j_hist"],
            ref_sampled["after"]):
        assert (rec.round, rec.sim_time, rec.n_participants) == (
            j_rec.round, j_rec.sim_time, j_rec.n_participants)
        np.testing.assert_allclose(rec.train_loss, j_rec.train_loss,
                                   rtol=LOSS_RTOL)
        for t, j in zip(leaves(to_numpy(params)),
                        jax.tree.leaves(j_sim.params(j_after))):
            np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                       atol=PARAM_ATOL)


# -- the Study's sampled arm -------------------------------------------------------


def _study_arms(exp, spec_cls, fed_cls):
    fed = fed_cls(batch_size=8, theta=0.62, lr=0.05)
    base = dict(model="mnist_cnn_tiny", dataset="mnist", n_train=48,
                n_test=16, scenario="dropout")
    pop = exp.PopulationSpec(M=12, cohort=exp.CohortSpec(K=4))
    return [
        ("sA", spec_cls(fed=fed, population=pop, **base)),
        ("sB", spec_cls(fed=dataclasses.replace(fed, batch_size=4),
                        population=pop, **base)),
        ("dense", spec_cls(fed=dataclasses.replace(fed, n_devices=4),
                           **base)),
    ]


def test_study_sampled_arm_groups_and_table():
    """Sampled arms group by their PopulationSpec (the reference's
    grouping), run as one folded fleet of K-lane members under the (V, b)
    envelope, and fill the table's K column; each grouped member against
    its run alone: records exact, losses and params within the member
    contract."""
    arms = _study_arms(t_exp, ExperimentSpec, FedConfig)
    res = t_study.Study(arms=arms, seeds=(0,), max_rounds=3,
                        eval_every=3).run(device="cpu")
    j_groups = {}
    for label, spec in _study_arms(j_exp, j_exp.ExperimentSpec, JFed):
        j_groups.setdefault(j_study._group_signature(spec,
                                                     spec.resolve_fed()),
                            []).append(label)
    assert res.groups == tuple(tuple(g) for g in j_groups.values()) == (
        ("sA", "sB"), ("dense",))
    header, rows = res.table()
    cols = header.split(",")
    k_idx = cols.index("K")
    by_label = {r[0]: r for r in rows}
    assert by_label["sA"][k_idx] == 4 and by_label["dense"][k_idx] == ""
    assert res.to_json()["arms"]["sA"]["K"] == 4
    for label, spec in arms[:2]:
        sim = spec.build(device="cpu")
        _, solo = sim.run(sim.init(0), max_rounds=3, eval_every=3)
        got = res[label][0]
        assert [(r.round, r.sim_time, r.n_participants, r.uplink_bits)
                for r in got.history] == [
            (r.round, r.sim_time, r.n_participants, r.uplink_bits)
            for r in solo.history]
        np.testing.assert_allclose([r.train_loss for r in got.history],
                                   [r.train_loss for r in solo.history],
                                   rtol=LOSS_RTOL)
        for a, b in zip(leaves(got.params), leaves(solo.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=PARAM_ATOL)


# -- shard_clients -------------------------------------------------------------------


@pytest.mark.parametrize("K", [None, 4])
def test_shard_clients_is_the_unsharded_step(K):
    """On one device without a process group shard_clients runs the
    unsharded step: bit for bit
    the port's own run without it, and within the member contract of the
    reference's shard_map run on its one CPU device."""
    kw = dict(M=6, K=K)
    sharded = _quad("scan", "dropout", shard=True, **kw)
    assert sharded.shard_clients
    rs = _run(sharded, max_rounds=5, eval_every=2)
    _assert_bit_identical(rs, _run(_quad("scan", "dropout", **kw),
                                   max_rounds=5, eval_every=2))
    assert jax.device_count() == 1
    j_sim = _quad("scan", "dropout", shard=True, ref=True, **kw)
    _, rj = j_sim.run(j_sim.init(), max_rounds=5, eval_every=2)
    for t, j in zip(rs.history, rj.history):
        assert (t.sim_time, t.n_participants, t.uplink_bits) == (
            j.sim_time, j.n_participants, j.uplink_bits)
        np.testing.assert_allclose(t.train_loss, j.train_loss,
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(rs.params["w"], np.asarray(rj.params["w"]),
                               rtol=0, atol=PARAM_ATOL)


def test_shard_clients_checks(monkeypatch):
    with pytest.raises(ValueError, match="backend='scan'"):
        _quad("batched", "dropout", shard=True)
    with pytest.raises(ValueError, match="compress_updates"):
        _quad("scan", "dropout", shard=True, compress=True)
    spec = t_exp.get("mnist_sampled").replace(shard_clients=True)
    assert spec.build(device="cpu").shard_clients
    # More than one visible card and no process group: a sharded run needs
    # one process a card (torchrun) and never runs quietly on one; lanes
    # that do not divide over the cards raise first, as in the reference.
    monkeypatch.setattr(simulation, "resolve_device",
                        lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        _quad("scan", "dropout", shard=True, K=4)
    with pytest.raises(ValueError, match="divide evenly"):
        _quad("scan", "dropout", shard=True, K=3)
