"""The port's per-round backends ('loop', 'batched') and run_round: the
twin of the reference's tests/test_simulation_backends.py, and each
backend against the reference's same backend.

Backend parity inside the port (the reference's own bounds): the
per-client loop and the stacked batched round agree to atol 1e-5 on the
quadratic problem (uncompressed, compressed, with momentum) and on the
small CNN uncompressed; compressed CNN params to 2e-3 (a stochastic-
rounding code flipped by a float32 reduction-order difference moves a
weight by one quantizer step).

Against the reference (compressed `mnist_smoke`, the reference's noise
replayed through the `noise=` hook, row m of a round's (C, rows, 1024)
draw for client m on both backends): clock, uplink bits and participants
exact over the whole run; each round from the reference's state within
the member contract, losses 1e-5 relative and params 5e-4 absolute.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.federated import compression as j_comp
from repro.federated import experiment as j_exp
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro_torch.configs.base import ComputeConfig, FedConfig, WirelessConfig
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import delay
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.federated import compression as t_comp
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import simulation
from repro_torch.federated.partition import (partition_dirichlet,
                                             partition_sizes)
from repro_torch.federated.simulation import FLSimulation, Simulator
from repro_torch.models import cnn
from repro_torch.optim.sgd import sgd
from repro_torch.utils.tree import leaves, tree_bytes

QUAD_ATOL = 1e-5
CNN_ATOL = {False: 1e-5, True: 2e-3}
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small models run fastest on one intra-op thread, and the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad_loss(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * torch.sum(diff * diff)


class _TargetIterator:
    """Deterministic per-client batch source for the quadratic problem
    (no index protocol, no snapshots: the host-batch path)."""

    def __init__(self, target, batch_size):
        self.target = np.asarray(target, np.float32)
        self.batch_size = batch_size

    def next_batch(self):
        return {"target": np.tile(self.target, (self.batch_size, 1))}


def _quad_sim(backend, compress, momentum=0.0, seed=0):
    M, d, b = 4, 16, 2
    fed = FedConfig(n_devices=M, batch_size=b, lr=0.05, seed=seed,
                    compress_updates=compress)
    pop = delay.draw_population(M, ComputeConfig(), WirelessConfig(), 0, 0.0)
    iters = [_TargetIterator(np.linspace(0.0, m, d) * 0.1, b)
             for m in range(M)]
    return Simulator(_quad_loss, {"w": np.zeros(d, np.float32)}, iters,
                     np.array([10, 20, 30, 40]), fed, sgd(fed.lr, momentum),
                     pop, device="cpu", backend=backend)


def _cnn_sim(backend, compress, seed=0):
    M, b = 3, 8
    fed = FedConfig(n_devices=M, batch_size=b, theta=0.62, lr=0.05,
                    seed=seed, compress_updates=compress)
    cfg = cnn.mnist_cnn_small()
    data = make_mnist_like(240, seed=seed)
    parts = partition_dirichlet(data, M, alpha=1.0, seed=seed)
    pop = delay.draw_population(M, ComputeConfig(), WirelessConfig(), 0, 0.0)
    return Simulator(
        lambda p, batch: cnn.cnn_loss(cfg, p, batch),
        cnn.init_cnn(cfg, seed, torch.device("cpu")),
        lambda s: [BatchIterator(data, p, b, seed=s + i)
                   for i, p in enumerate(parts)],
        partition_sizes(parts), fed, sgd(fed.lr), pop, device="cpu",
        backend=backend,
        value_and_grad=lambda p, batch, m=None, n=None: (
            cnn.cnn_value_and_grad(cfg, p, batch, m, n)))


def _run(sim, **kw):
    _, res = sim.run(sim.init(), **kw)
    return res


def _run_pair(make_sim, rounds=5, **kw):
    return {backend: _run(make_sim(backend, **kw), max_rounds=rounds)
            for backend in ("loop", "batched")}


def _assert_parity(out, atol):
    for a, b in zip(leaves(out["loop"].params), leaves(out["batched"].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(
        [r.train_loss for r in out["loop"].history],
        [r.train_loss for r in out["batched"].history], rtol=0, atol=atol)
    assert ([(r.round, r.sim_time, r.uplink_bits) for r in out["loop"].history]
            == [(r.round, r.sim_time, r.uplink_bits)
                for r in out["batched"].history])


@pytest.mark.parametrize("compress", [False, True])
def test_backend_parity_quadratic(compress):
    """Elementwise model: loop and batched agree to float32 tolerance,
    with and without the int8 round trip (the same noise rows)."""
    _assert_parity(_run_pair(_quad_sim, compress=compress), QUAD_ATOL)


def test_backend_parity_quadratic_momentum():
    """Per-client optimizer state (momentum buffers) follows the same
    parity: the loop keeps M states, the stacked round one (C, ...)."""
    _assert_parity(_run_pair(_quad_sim, compress=True, momentum=0.9),
                   QUAD_ATOL)


@pytest.mark.parametrize("compress", [False, True])
def test_backend_parity_cnn(compress):
    _assert_parity(_run_pair(_cnn_sim, rounds=3, compress=compress),
                   CNN_ATOL[compress])


def test_scan_takes_host_batches_without_the_index_protocol():
    """A data source without the index protocol runs on 'scan' through
    host-stacked chunks (client.stack_chunk_batches), with the batched
    round's numbers: the same batches and noise, the same step."""
    scan = _run(_quad_sim("scan", compress=True), max_rounds=5, eval_every=2)
    batched = _run(_quad_sim("batched", compress=True), max_rounds=5)
    assert _quad_sim("scan", compress=True)._data_dev is None
    assert [r.train_loss for r in scan.history] == [
        r.train_loss for r in batched.history]
    for a, b in zip(leaves(scan.params), leaves(batched.params)):
        assert torch.equal(a, b)


def test_batched_resumed_run():
    """run() twice on one simulator: run 2 continues from run 1's state."""
    sim = _quad_sim("batched", compress=True)
    state = sim.init()
    state, r1 = sim.run(state, max_rounds=2)
    state, r2 = sim.run(state, max_rounds=2)
    assert r1.rounds == 2 and r2.rounds == 2 and state.round == 4
    for leaf in leaves(r2.params):
        assert bool(torch.isfinite(leaf).all())
    assert r2.history[-1].train_loss < r1.history[0].train_loss
    assert all(isinstance(r.train_loss, float) for r in r2.history)


@pytest.mark.parametrize("backend", ["batched", "loop"])
def test_eval_boundary_sync(backend):
    """Evaluation only at eval_every boundaries; the returned history holds
    host floats (the batched losses stay on the device in between)."""
    sim = _cnn_sim(backend, compress=False)
    calls = []
    sim.eval_fn = lambda p: calls.append(1) or {"acc": 0.0}
    res = _run(sim, max_rounds=4, eval_every=2)
    assert len(calls) == 2  # rounds 2 and 4 only
    assert [r.test_acc is not None for r in res.history] == [
        False, True, False, True]
    assert all(isinstance(r.train_loss, float) for r in res.history)


def test_compressed_bits_delay_accounting():
    """T_cm uses compression.compressed_bits (int8 payload + one float32
    scale per 1024-chunk), not the bits/4 approximation."""
    plain = _quad_sim("batched", compress=False)
    comp = _quad_sim("batched", compress=True)
    raw = tree_bytes(plain.params(plain.init())) * 8.0
    assert plain._update_bits() == raw
    assert comp._update_bits() == t_comp.compressed_bits(
        comp.params(comp.init()))
    assert comp._update_bits() != raw / 4.0
    assert comp._update_bits() < raw / 3.0


def test_run_round_argument_checks():
    """run_round refuses inputs it would silently ignore: a realization or
    uplink times on a scenario-less simulation, and ones not M wide."""
    plain = _quad_sim("batched", compress=False)
    storm = t_exp.get("mnist_smoke").replace(
        scenario="hetero_storm", backend="loop").build(device="cpu")
    real = storm.scenario.stream(storm.pop, 0).next_round()
    with pytest.raises(ValueError, match="no scenario"):
        plain.run_round(plain.init(), real=real)
    with pytest.raises(ValueError, match="no scenario"):
        plain.run_round(plain.init(), t_cm_clients=np.ones(4))
    short = dataclasses.replace(real, mask=real.mask[:2])
    with pytest.raises(ValueError, match="M=3"):
        storm.run_round(storm.init(), real=short)
    # A realization given is the one the round runs on.
    dropped = dataclasses.replace(real, mask=np.array([True, False, False]))
    _, m = storm.run_round(storm.init(), real=dropped)
    assert m["n_participants"] == 1


@pytest.mark.parametrize("backend", ["scan", "batched", "loop"])
def test_run_round_repeats_run(backend):
    """run_round x2 gives run()'s rounds (scan shares the batched step)."""
    spec = t_exp.get("mnist_smoke").replace(
        backend=backend, scenario="hetero_storm", with_eval=False,
        fed=FedConfig(n_devices=3, batch_size=8, theta=0.62, lr=0.05,
                      compress_updates=True))
    sim = spec.build(device="cpu")
    end, res = sim.run(sim.init(2), max_rounds=2)
    st, losses = sim.init(2), []
    for _ in range(2):
        st, m = sim.run_round(st)
        losses.append(float(m["train_loss"]))
    np.testing.assert_allclose(losses, [r.train_loss for r in res.history],
                               rtol=1e-6)
    assert st.round == end.round == 2
    assert repr(st.stream) == repr(end.stream)
    assert repr(st.data) == repr(end.data)


def test_unknown_and_async_backends_raise():
    spec = t_exp.get("mnist_smoke")
    # 'async' runs the event queue and needs its aggregation policy.
    with pytest.raises(ValueError, match="async_spec=events.AsyncSpec"):
        _quad_sim("async", compress=False)
    with pytest.raises(ValueError, match="unknown backend"):
        _quad_sim("vmap", compress=False)
    loop = spec.replace(backend="loop").build(device="cpu")
    for call in (lambda: loop.run_fleet(seeds=[0], max_rounds=1),
                 lambda: loop.run_chunk(loop.init(), 1)):
        with pytest.raises(ValueError, match="backend='scan'"):
            call()
    live = _quad_sim("scan", compress=False)
    with pytest.raises(ValueError, match="data factory"):
        live.run_fleet(seeds=[0], max_rounds=1)


def test_flsimulation_shim_warns_once_and_runs_as_simulator():
    """The deprecated shim warns once a process, and its run / run_round /
    run again are Simulator's over the threaded state, bit for bit."""
    def shim_args():
        sim = _quad_sim("batched", compress=True, momentum=0.9)
        return (sim.loss_fn, {"w": np.zeros(16, np.float32)}, sim._data_src,
                sim.data_sizes, sim.fed, sim.opt, sim.pop)

    simulation._FLSIM_WARNED = False
    with pytest.warns(DeprecationWarning, match="FLSimulation is deprecated"):
        shim = FLSimulation(*shim_args(), backend="batched", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        FLSimulation(*shim_args(), backend="batched", device="cpu")
    assert simulation._FLSIM_WARNED
    core = _quad_sim("batched", compress=True, momentum=0.9)
    state, ref = core.run(core.init(), max_rounds=3, eval_every=2)
    res = shim.run(max_rounds=3, eval_every=2)
    state, ref_m = core.run_round(state)
    m = shim.run_round()
    state, ref2 = core.run(state, max_rounds=2)
    res2 = shim.run(max_rounds=2)
    assert [r.train_loss for r in res.history + res2.history] == [
        r.train_loss for r in ref.history + ref2.history]
    assert float(m["train_loss"]) == float(ref_m["train_loss"])
    assert torch.equal(shim.params["w"], core.params(state)["w"])
    assert shim.state.round == state.round == 6
    assert shim._update_bits() == core._update_bits()
    calls = []
    shim.eval_fn = lambda p: calls.append(1) or {"acc": 0.5}
    assert shim.run(max_rounds=2, eval_every=2).history[-1].test_acc == 0.5
    assert calls == [1] and shim.sim.eval_batch_fn is not None


@pytest.mark.parametrize("backend", ["batched", "loop"])
def test_divergence_and_recovery_match_reference(backend):
    """mnist_smoke at lr 1e5 (tests/test_torch_resilience.py's diverging
    run) on a per-round backend: the DivergenceError's round and last-good
    round, and run(recovery=)'s audit trail and clock, are the reference's
    same backend's (the recovery's rebuilt simulator keeps the backend)."""
    from repro.federated.faults import DivergenceError as JDivergence
    from repro.federated.faults import FaultModel as JFaults
    from repro.federated.faults import RecoveryPolicy as JRecovery
    from repro_torch.federated.faults import DivergenceError as TDivergence
    from repro_torch.federated.faults import FaultModel as TFaults
    from repro_torch.federated.faults import RecoveryPolicy as TRecovery

    def diverging(exp, faults_cls):
        spec = exp.get("mnist_smoke")
        return spec.replace(
            backend=backend, fed=dataclasses.replace(spec.fed, lr=1e5),
            faults=faults_cls(max_update_norm=1e9, reject_nonfinite=False))

    j_spec = diverging(j_exp, JFaults)
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    t_sim = diverging(t_exp, TFaults).build(device="cpu", params=params0)
    with pytest.raises(JDivergence) as j_err:
        j_sim.run(j_sim.init(), max_rounds=6, eval_every=2)
    with pytest.raises(TDivergence) as t_err:
        t_sim.run(t_sim.init(), max_rounds=6, eval_every=2)
    assert (t_err.value.round, t_err.value.state.round) == (
        j_err.value.round, j_err.value.state.round)
    kw = dict(max_restarts=8, lr_backoff=1e-2, tighten_guard=0.5)
    _, j_res = j_sim.run(j_sim.init(), max_rounds=8, eval_every=3,
                         recovery=JRecovery(**kw))
    _, t_res = t_sim.run(t_sim.init(), max_rounds=8, eval_every=3,
                         recovery=TRecovery(**kw))
    keys = ("attempt", "round", "resume_round", "lr_scale", "max_update_norm")
    assert [[a[k] for k in keys] for a in t_res.restarts] == [
        [a[k] for k in keys] for a in j_res.restarts]
    assert len(t_res.restarts) >= 1
    assert [r.sim_time for r in t_res.history] == [
        r.sim_time for r in j_res.history]
    assert all(np.isfinite(r.train_loss) for r in t_res.history)


# -- against the reference's same backend -----------------------------------------

ROUNDS = 3


def _spec(exp, backend, scenario):
    spec = exp.get("mnist_smoke")
    return spec.replace(
        backend=backend, scenario=scenario, with_eval=False,
        fed=dataclasses.replace(spec.fed, compress_updates=True))


def _jax_noise(seed, C, rows, rounds):
    """The reference's per-round (C, rows, 1024) quantizer noise: its
    keys in the order both of its backends draw them
    (compression.sequential_client_keys), client m's noise in row m."""
    draw = jax.jit(jax.vmap(lambda k: j_noise(k, (rows, t_comp.ROW))))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, keys = j_comp.sequential_client_keys(key, C)
        out.append(np.asarray(draw(keys)))
    return out


def _port_state(t_sim, j_state):
    """The port's state equal to a host snapshot of the reference's (the
    loop's unstacked params and per-client states included)."""
    return dataclasses.replace(
        t_sim.init(j_state.seed),
        params_C=to_torch(jax.tree.map(np.asarray, j_state.params_C),
                          device="cpu"),
        round=j_state.round, sim_time=j_state.sim_time,
        stream=j_state.stream, data=j_state.data)


@pytest.fixture(scope="module", params=[
    ("loop", None), ("batched", None), ("loop", "hetero_storm"),
    ("batched", "hetero_storm")], ids=lambda p: f"{p[0]}-{p[1]}")
def ref_pair(request):
    backend, scenario = request.param
    j_spec = _spec(j_exp, backend, scenario)
    t_spec = _spec(t_exp, backend, scenario)
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    st, before, j_hist = j_sim.init(), [], []
    for _ in range(ROUNDS):
        before.append(jax.device_get(st))
        st, res = j_sim.run(st, max_rounds=1)
        j_hist.extend(res.history)
    after = before[1:] + [jax.device_get(st)]
    fed = j_sim.fed
    noise = _jax_noise(fed.seed, fed.n_devices, t_comp.n_rows(params0),
                       ROUNDS)
    replay = iter(noise)
    t_sim = t_spec.build(device="cpu", params=params0,
                         noise=lambda g, shape: torch.tensor(next(replay)))
    _, t_res = t_sim.run(t_sim.init(), max_rounds=ROUNDS, eval_every=2)
    current = {}
    one = t_spec.build(device="cpu", params=params0,
                       noise=lambda g, shape: torch.tensor(current["u"]))
    per_round = []
    for k in range(ROUNDS):
        current["u"] = noise[k]
        end, res = one.run(_port_state(one, before[k]), max_rounds=1)
        per_round.append((one.params(end), res.history[0]))
    return {"j_hist": j_hist, "after": after, "t_res": t_res,
            "per_round": per_round, "j_sim": j_sim, "backend": backend}


def test_reference_clock_bits_participants_exact(ref_pair):
    j_hist, t_hist = ref_pair["j_hist"], ref_pair["t_res"].history
    assert len(t_hist) == len(j_hist) == ROUNDS
    for j, t in zip(j_hist, t_hist):
        assert (t.round, t.sim_time, t.T_cm, t.T_cp, t.uplink_bits,
                t.n_participants) == (j.round, j.sim_time, j.T_cm, j.T_cp,
                                      j.uplink_bits, j.n_participants)


def test_reference_each_round_within_member_contract(ref_pair):
    j_sim = ref_pair["j_sim"]
    for (params, rec), j_rec, j_after in zip(
            ref_pair["per_round"], ref_pair["j_hist"], ref_pair["after"]):
        assert (rec.round, rec.sim_time, rec.n_participants) == (
            j_rec.round, j_rec.sim_time, j_rec.n_participants)
        np.testing.assert_allclose(rec.train_loss, j_rec.train_loss,
                                   rtol=LOSS_RTOL)
        for t, j in zip(leaves(to_numpy(params)),
                        jax.tree.leaves(j_sim.params(j_after))):
            np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                       atol=PARAM_ATOL)
