"""The port's asynchronous backend (federated/events.py,
mesh_rounds.build_async_chunk, Simulator(backend='async'), run_events,
defl.async_plan, mnist_async and the async-vs-sync example twin) against
the reference's: the twin of tests/test_async_events.py, with both
packages fed the same numpy inputs.

Exact against the reference: AsyncSpec and the knob checks (messages word
for word), the numpy staleness weights and schedule twin, every event's
client, time, drop, aggregation flag and staleness, and every record's
round, sim_time, T_cm, T_cp, uplink_bits and participants; async_plan.
Within float32 tolerance: params (2e-5 relative / 1e-6 absolute, the
reference's own bounds on the quadratic problem) and, on the compressed
MNIST CNN, each aggregation from the reference's state (losses 1e-5
relative, params 5e-4 absolute: the member contract).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ComputeConfig as JCompute
from repro.configs.base import FedConfig as JFed
from repro.configs.base import WirelessConfig as JWireless
from repro.core import defl as j_defl
from repro.core import delay as j_delay
from repro.federated import events as j_events
from repro.federated import experiment as j_exp
from repro.federated import faults as j_faults
from repro.federated import mesh_rounds as j_mesh
from repro.federated.simulation import Simulator as JSimulator
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro.optim import sgd as j_sgd
from repro_torch.configs.base import ComputeConfig, FedConfig, WirelessConfig
from repro_torch.convert import async_carry_to_torch, to_numpy, to_torch
from repro_torch.core import defl, delay
from repro_torch.federated import compression as t_comp
from repro_torch.federated import events, mesh_rounds
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import faults as t_faults
from repro_torch.federated import study as t_study
from repro_torch.federated.simulation import (Simulator, fetch_columns,
                                              load_state, save_state)
from repro_torch.optim.sgd import sgd
from repro_torch.utils.tree import leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUAD_RTOL, QUAD_ATOL = 2e-5, 1e-6
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
RECORD_FIELDS = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits",
                 "n_participants")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small models run fastest on one intra-op thread, and the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the reference's quadratic problem (tests/test_async_events.py) -----------

_M, _D, _B = 4, 16, 2
_SIZES = np.array([10, 20, 30, 40])


class _TargetIterator:
    def __init__(self, target, batch_size):
        self.target = np.asarray(target, np.float32)
        self.batch_size = batch_size

    def next_batch(self):
        return {"target": np.tile(self.target, (self.batch_size, 1))}


def _iters(seed):
    return [_TargetIterator(np.linspace(0.0, m, _D) * 0.1, _B)
            for m in range(_M)]


def _t_quad_loss(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * torch.sum(diff * diff)


def _j_quad_loss(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * jnp.sum(diff * diff), {}


def _quad(backend, spec=None, scenario=None, seed=0, heterogeneity=0.3,
          ref=False, compress=False, momentum=0.0, **kw):
    """The quadratic async simulator of the port, or with ref=True of the
    reference, from the same population and data."""
    if ref:
        fed = JFed(n_devices=_M, batch_size=_B, lr=0.05, seed=seed,
                   compress_updates=compress)
        pop = j_delay.draw_population(_M, JCompute(), JWireless(), seed,
                                      heterogeneity)
        return JSimulator(
            _j_quad_loss, {"w": jnp.zeros(_D)}, _iters, _SIZES, fed,
            j_sgd(fed.lr, momentum), pop, backend=backend,
            async_spec=spec, scenario=scenario, **kw)
    fed = FedConfig(n_devices=_M, batch_size=_B, lr=0.05, seed=seed,
                    compress_updates=compress)
    pop = delay.draw_population(_M, ComputeConfig(), WirelessConfig(), seed,
                                heterogeneity)
    return Simulator(
        _t_quad_loss, {"w": np.zeros(_D, np.float32)}, _iters, _SIZES, fed,
        sgd(fed.lr, momentum), pop, device="cpu", backend=backend,
        async_spec=spec, scenario=scenario, **kw)


def _specs(**kw):
    return events.AsyncSpec(**kw), j_events.AsyncSpec(**kw)


def _records(history):
    return [tuple(getattr(r, f) for f in RECORD_FIELDS) for r in history]


def _assert_params_close(t_params, j_params, rtol=QUAD_RTOL, atol=QUAD_ATOL):
    for t, j in zip(leaves(to_numpy(t_params)), jax.tree.leaves(j_params)):
        np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


# -- AsyncSpec, staleness weights, the knob checks ----------------------------


@pytest.mark.parametrize("bad", [
    dict(buffer_size=0), dict(buffer_size=2, staleness="bogus"),
    dict(buffer_size=2, mode="bogus"), dict(buffer_size=2, mode="fedasync"),
    dict(server_lr=0.0), dict(event_budget=0)])
def test_async_spec_validation(bad):
    """Every bad AsyncSpec raises the reference's message, word for word;
    the fields and defaults are the reference's."""
    assert _error(lambda: events.AsyncSpec(**bad)) == _error(
        lambda: j_events.AsyncSpec(**bad))
    spec = events.AsyncSpec(buffer_size=2).replace(staleness="exp",
                                                   staleness_a=0.3)
    assert spec.staleness == "exp" and spec.staleness_a == 0.3
    assert (dataclasses.asdict(events.AsyncSpec())
            == dataclasses.asdict(j_events.AsyncSpec()))


@pytest.mark.parametrize("staleness,a", [("constant", 0.5), ("poly", 0.5),
                                         ("poly", 0.7), ("exp", 0.3)])
def test_staleness_weights(staleness, a):
    """numpy exactly the reference's; a torch tensor within one ulp of the
    weight computed in float64 and rounded to float32 (numpy's own float32
    exp misses that by up to 2 ulp on some CPUs, so it is not the
    yardstick); fresh updates weight 1."""
    t_spec, j_spec = _specs(buffer_size=2, staleness=staleness,
                            staleness_a=a)
    s = np.arange(64, dtype=np.float32)
    want = j_events.staleness_weight(j_spec, s, np)
    got = events.staleness_weight(t_spec, s)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got_t = events.staleness_weight(t_spec, torch.from_numpy(s))
    assert got_t.dtype == torch.float32
    # Both forms take the float32 argument (1 + s, or -a * s) of the
    # reference's numpy arithmetic.
    a32 = np.float32(a)
    exact = {"constant": np.ones_like(s),
             "poly": (1.0 + s.astype(np.float64)) ** -np.float64(a32),
             "exp": np.exp((-a32 * s).astype(np.float64))}[staleness]
    exact = exact.astype(np.float32)
    np.testing.assert_array_max_ulp(got_t.numpy(), exact, maxulp=1)
    assert float(events.staleness_weight(t_spec, torch.zeros(()))) == 1.0


def _ref_knob_cases():
    J, T = j_faults.FaultModel, t_faults.FaultModel
    return {
        "no_spec": (dict(backend="async", spec=None), {}),
        "spec_on_scan": (dict(backend="scan", spec="K2"), {}),
        "buffer_over_M": (dict(backend="async", spec="K5"), {}),
        "cohort": (dict(backend="async", spec="K2", cohort=2), {}),
        "shard": (dict(backend="async", spec="K2", shard_clients=True), {}),
        "quorum": (dict(backend="async", spec="K2", scenario="uniform"),
                   {"faults": (J(deadline_factor=1.5, min_quorum=3),
                               T(deadline_factor=1.5, min_quorum=3))}),
        "norm": (dict(backend="async", spec="K2", scenario="uniform"),
                 {"faults": (J(deadline_factor=1.5, max_update_norm=1.0),
                             T(deadline_factor=1.5, max_update_norm=1.0))}),
        "stateful_opt": (dict(backend="async", spec="K2", momentum=0.9), {}),
    }


@pytest.mark.parametrize("case", sorted(_ref_knob_cases()))
def test_simulator_knob_validation(case):
    """The Simulator's async checks raise the reference's messages."""
    kw, pair = _ref_knob_cases()[case]
    kw = dict(kw)
    spec = kw.pop("spec")
    size = {"K2": 2, "K5": _M + 1}.get(spec)

    def make(ref):
        extra = {k: v[1 - ref] for k, v in pair.items()}
        cls = j_events.AsyncSpec if ref else events.AsyncSpec
        return _quad(spec=None if size is None else cls(buffer_size=size),
                     ref=ref, **kw, **extra)

    assert _error(lambda: make(False)) == _error(lambda: make(True))


def test_async_refuses_the_round_methods():
    """run_round, run(recovery=), run_fleet and run_chunk refuse the event
    queue with the reference's messages; run_events refuses the rounds."""
    t_spec, j_spec = _specs(buffer_size=2)
    t, j = _quad("async", t_spec), _quad("async", j_spec, ref=True)
    for fn in (lambda s: s.run_round(s.init()),
               lambda s: s.run_fleet(seeds=[0], max_rounds=1)):
        assert _error(lambda: fn(t)) == _error(lambda: fn(j))
    from repro.federated.faults import RecoveryPolicy as JRecovery
    assert _error(lambda: t.run(t.init(), 1, recovery=t_faults.RecoveryPolicy(
    ))) == _error(lambda: j.run(j.init(), 1, recovery=JRecovery()))
    with pytest.raises(ValueError, match="backend='scan'"):
        t.run_chunk(t.init(), 1)
    scan, j_scan = _quad("scan"), _quad("scan", ref=True)
    assert _error(lambda: scan.run_events(scan.init(), 3)) == _error(
        lambda: j_scan.run_events(j_scan.init(), 3))
    for bad in (0, 2.0):
        assert _error(lambda: t.run_events(t.init(), bad)) == _error(
            lambda: j.run_events(j.init(), bad))


def _spec_cases(exp, fm_cls, spec):
    pop = exp.PopulationSpec(M=40, cohort=exp.CohortSpec(K=8))
    return [
        dict(backend="async"),
        dict(async_spec=spec),
        dict(backend="async", async_spec=spec, population=pop),
        dict(backend="async", async_spec=spec, shard_clients=True),
        dict(backend="async", async_spec=spec,
             faults=fm_cls(deadline_factor=1.5, min_quorum=3)),
        dict(backend="async", async_spec=spec,
             faults=fm_cls(deadline_factor=1.5, max_update_norm=1.0)),
        dict(backend="pmap"),
    ]


@pytest.mark.parametrize("i", range(6))
def test_spec_knob_validation(i):
    """ExperimentSpec's mutually exclusive knobs fail at construction with
    the reference's messages (naming the fields); deadline, retransmission
    and crash faults compose with async."""
    t_case = _spec_cases(t_exp, t_faults.FaultModel,
                         events.AsyncSpec(buffer_size=2))[i]
    j_case = _spec_cases(j_exp, j_faults.FaultModel,
                         j_events.AsyncSpec(buffer_size=2))[i]
    assert _error(lambda: t_exp.ExperimentSpec(**t_case)) == _error(
        lambda: j_exp.ExperimentSpec(**j_case))
    ok = t_exp.ExperimentSpec(
        backend="async", async_spec=events.AsyncSpec(buffer_size=2),
        faults=t_faults.FaultModel(deadline_factor=1.5, max_retries=2),
        population=t_exp.PopulationSpec(M=10))
    assert ok.effective_faults() is not None
    # The port refuses an unknown backend at the spec (the reference at
    # build); every port backend is accepted.
    with pytest.raises(ValueError, match="unknown backend 'pmap'"):
        t_exp.ExperimentSpec(**_spec_cases(
            t_exp, t_faults.FaultModel, None)[-1])


def test_mnist_async_registered_as_the_references():
    t, j = t_exp.get("mnist_async"), j_exp.get("mnist_async")
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
        else:
            assert tv == jv, f.name
    names = [n for n in j_exp.names() if n in t_exp.names()]
    assert list(t_exp.names()) == names


# -- the schedule twin --------------------------------------------------------


@pytest.mark.parametrize("K,ties", [(1, False), (3, False), (3, True),
                                    (6, True)])
def test_twin_step_matches_reference(K, ties):
    """200 random events through both twins, from the same draws: every
    TwinEvent and every twin state exactly the reference's (float32 clock,
    first-minimum pops; with ties every service time is equal)."""
    rng = np.random.default_rng(K * 10 + ties)
    C = 6
    t_spec, j_spec = _specs(buffer_size=K)

    def draw():
        t_svc = (np.full(C, 0.25) if ties
                 else rng.uniform(0.1, 3.0, C)).astype(np.float32)
        drop = (rng.random(C) < 0.2).astype(np.float32)
        return t_svc, drop, rng.uniform(0.0, 1.0, C), rng.integers(1, 4, C)

    t_svc, drop, t_cm, att = draw()
    tw = events.twin_init(t_svc, drop, t_cm, att)
    jw = j_events.twin_init(t_svc, drop, t_cm, att)
    for _ in range(200):
        args = draw()
        a = events.twin_step(t_spec, tw, *args)
        b = j_events.twin_step(j_spec, jw, *args)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for f in dataclasses.fields(jw):
            np.testing.assert_array_equal(getattr(tw, f.name),
                                          getattr(jw, f.name))
        assert type(a.t_event) is type(b.t_event) is np.float32


# -- the device chunk against the reference's ---------------------------------


def _chunk_events(sim, n):
    """The port's chunk run for n events from init: (its fetched outputs,
    the twin's events, the state's pieces)."""
    state, mat, gen, twin, _ = sim._async_begin(sim.init())
    xs, evs, n_ev = sim._async_chunk_inputs(mat[0], twin, mat[1],
                                            stop_events=n)
    assert n_ev == n
    out = sim._async_call(state.params_C, state.opt_C, gen, state.async_c,
                          xs)
    return out, evs


def _draws(sim, ref):
    """reference_run's dispatch draw over `sim`'s own stream (seed 3)."""
    stream = sim.scenario.stream(sim.pop, 3)

    def draw():
        t_svc, drop, _, _ = sim._async_dispatch_draw(stream)
        return t_svc, drop

    return draw


def _next_batches(jax_tree, V):
    iters = _iters(0)

    def next_batches(c):
        bs = [iters[c].next_batch() for _ in range(V)]
        if jax_tree:
            return jax.tree.map(lambda *x: np.stack(x), *bs)
        return {"target": torch.from_numpy(
            np.stack([b["target"] for b in bs]))}

    return next_batches


@pytest.mark.parametrize("scenario,het", [(None, 0.3), ("dropout", 0.3),
                                          ("uniform", 0.0)])
def test_chunk_matches_reference_and_python_oracle(scenario, het):
    """The twin of test_scan_matches_python_reference: 11 events of the
    port's chunk against the reference's Simulator.run_events and its
    events.reference_run, and the port's reference_run against the
    reference's: client, event time, drop, aggregation and staleness
    exact, params within 2e-5 / 1e-6. ('uniform' with heterogeneity 0
    makes every pop a tie.)"""
    t_spec, j_spec = _specs(buffer_size=2, staleness="poly", staleness_a=0.7)
    t_sim = _quad("async", t_spec, scenario, seed=3, heterogeneity=het)
    j_sim = _quad("async", j_spec, scenario, seed=3, heterogeneity=het,
                  ref=True)
    n_ev = 11
    j_local = jax.jit(j_mesh.local_steps_fn(_j_quad_loss, j_sim.opt))
    p_ref, j_evs = j_events.reference_run(
        j_spec, n_ev, jax.device_get(j_sim._init_params),
        j_sim.opt.init(j_sim._init_params), lambda p, s, b: j_local(p, s, b),
        _next_batches(True, j_sim.fed.local_rounds), _SIZES,
        _draws(j_sim, True))
    t_local = mesh_rounds.local_steps_fn(t_sim.value_and_grad, t_sim.opt)

    def t_update(p, s, b):
        one = {"w": torch.from_numpy(p["w"])[None]}
        new, s2, loss = t_local(one, s, {k: v[None] for k, v in b.items()})
        return {"w": new["w"][0]}, s2, loss[0]

    p_port_ref, t_evs = events.reference_run(
        t_spec, n_ev, {"w": np.zeros(_D, np.float32)}, (), t_update,
        _next_batches(False, t_sim.fed.local_rounds), _SIZES,
        _draws(t_sim, False))
    assert t_evs == j_evs
    np.testing.assert_allclose(p_port_ref["w"], np.asarray(p_ref["w"]),
                               rtol=QUAD_RTOL, atol=QUAD_ATOL)
    (_, _, _, ys), evs = _chunk_events(t_sim, n_ev)
    np.testing.assert_array_equal(ys["client"], [e["client"] for e in j_evs])
    np.testing.assert_array_equal(ys["t_event"],
                                  [e["t_event"] for e in j_evs])
    np.testing.assert_array_equal(ys["dropped"] > 0,
                                  [e["dropped"] for e in j_evs])
    np.testing.assert_array_equal(ys["agg"] > 0,
                                  [e["aggregated"] for e in j_evs])
    np.testing.assert_array_equal(
        ys["staleness"], [0 if e["dropped"] else e["staleness"]
                          for e in j_evs])
    t_st, t_hist = t_sim.run_events(t_sim.init(), n_ev)
    j_st, j_hist = j_sim.run_events(j_sim.init(), n_ev)
    assert _records(t_hist) == _records(j_hist)
    assert len(t_hist) == sum(1 for e in j_evs if e["aggregated"])
    assert t_st.event == j_st.event == n_ev
    _assert_params_close(t_sim.params(t_st), p_ref)
    _assert_params_close(t_sim.params(t_st), j_sim.params(j_st))
    np.testing.assert_allclose([r.train_loss for r in t_hist],
                               [r.train_loss for r in j_hist],
                               rtol=QUAD_RTOL, atol=QUAD_ATOL)


def test_update_conservation():
    """Every event is consumed once: dropped, or buffered; each
    aggregation consumes exactly buffer_size updates — on the port's
    oracle and on its chunk's outputs."""
    K = 2
    t_spec, _ = _specs(buffer_size=K, staleness="poly")
    sim = _quad("async", t_spec, scenario="dropout", seed=3)
    (_, _, carry, ys), _ = _chunk_events(sim, 24)
    accepted = 0
    for d, agg, cnt in zip(ys["dropped"], ys["agg"], ys["cnt"]):
        if d:
            assert not agg
        else:
            accepted += 1
        if agg:
            assert accepted % K == 0 and cnt == 0
        else:
            assert cnt == accepted % K
    n_aggs = int(ys["agg"].sum())
    assert n_aggs == accepted // K
    assert int(carry["cnt"]) == accepted - K * n_aggs < K
    assert int(carry["version"]) == n_aggs


def test_skipped_events_are_exact_no_ops():
    """An event the host marks invalid is the reference's masked no-op:
    skipping one equals the chunk without it, and a chunk of only invalid
    events leaves params, optimizer state, carry and the quantizer
    generator unchanged, bit for bit."""
    t_spec, _ = _specs(buffer_size=2, staleness="poly")
    sim = _quad("async", t_spec, scenario="dropout", seed=3, compress=True)
    state, mat, gen, twin, _ = sim._async_begin(sim.init())
    xs, _, n = sim._async_chunk_inputs(mat[0], twin, mat[1], stop_events=6)
    assert set(xs) == {"t_svc", "drop_next", "batches"}

    def up(x):
        return {k: (v if k == "valid" else tree_map(torch.from_numpy, v))
                for k, v in x.items()}

    skip = 3
    masked = dict(xs, valid=np.arange(n) != skip)
    dropped = tree_map(lambda v: np.delete(v, skip, axis=0), xs)
    outs = []
    for x in (masked, dropped):
        g = sim._generator(state)
        outs.append(sim._chunk_fn(state.params_C, state.opt_C, g,
                                  state.async_c, sim._sizes, None, up(x))
                    + (g.get_state(),))
    for a, b in zip(leaves(outs[0]), leaves(outs[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    g = sim._generator(state)
    none = sim._chunk_fn(state.params_C, state.opt_C, g, state.async_c,
                         sim._sizes, None, up(dict(xs, valid=np.zeros(
                             n, bool))))
    assert none[3] == {}
    for a, b in zip(leaves(none[:3]), leaves((state.params_C, state.opt_C,
                                              state.async_c))):
        assert torch.equal(a, b)
    assert torch.equal(g.get_state(), state.rng)


def test_fetch_columns_is_exact():
    ys = {"t": torch.tensor([1.1, np.inf, np.nan], dtype=torch.float32),
          "c": torch.tensor([3, 0, 2], dtype=torch.int32),
          "b": torch.tensor([True, False, True])}
    out = fetch_columns(ys)
    np.testing.assert_array_equal(out["t"].astype(np.float32), ys["t"])
    np.testing.assert_array_equal(out["c"], [3, 0, 2])
    np.testing.assert_array_equal(out["b"], [1, 0, 1])


# -- runs: checkpoints, the sync limit, fedasync, faults, early stops ---------


def test_mid_buffer_checkpoint_bit_identity(tmp_path):
    """An odd event count strands updates mid-buffer; save_state /
    load_state / resume equals the uninterrupted run bit for bit, and the
    async fields survive the round trip."""
    t_spec, _ = _specs(buffer_size=2, staleness="poly")
    sim_a = _quad("async", t_spec, seed=1, compress=True)
    st_a, res_a = sim_a.run(sim_a.init(), max_rounds=8)
    sim_b = _quad("async", t_spec, seed=1, compress=True)
    st_b, hist_b = sim_b.run_events(sim_b.init(), 5)
    assert int(st_b.async_c["cnt"]) == 1  # mid-buffer
    path = str(tmp_path / "async_ck.pkl")
    save_state(path, st_b)
    loaded = load_state(path, like=sim_b.init())
    assert loaded.event == 5 and loaded.async_host["bits_acc"] == (
        st_b.async_host["bits_acc"])
    st_b, res_b = sim_b.run(loaded, max_rounds=8 - len(hist_b))
    for a, b in zip(leaves((sim_a.params(st_a), st_a.async_c)),
                    leaves((sim_b.params(st_b), st_b.async_c))):
        assert torch.equal(a, b)
    assert torch.equal(st_a.rng, st_b.rng)
    full_b = hist_b + res_b.history
    assert ([(r.train_loss,) + t for r, t in zip(res_a.history,
                                                 _records(res_a.history))]
            == [(r.train_loss,) + t for r, t in zip(full_b,
                                                    _records(full_b))])
    # A synchronous simulator's state does not load as an async one.
    with pytest.raises(ValueError, match="different spec"):
        load_state(path, like=_quad("scan").init())


def test_sync_limit_identity():
    """AsyncSpec(buffer_size=M, staleness='constant') under 'uniform' is
    synchronous FedAvg: the port's async against the port's scan and
    against the reference's async, within the reference's bounds; every
    aggregation saw the whole population."""
    t_spec, j_spec = _specs(buffer_size=_M, staleness="constant")
    t_a = _quad("async", t_spec, "uniform", seed=2)
    st_a, res_a = t_a.run(t_a.init(), max_rounds=5)
    t_s = _quad("scan", None, "uniform", seed=2)
    st_s, res_s = t_s.run(t_s.init(), max_rounds=5)
    la = [r.train_loss for r in res_a.history]
    np.testing.assert_allclose(la, [r.train_loss for r in res_s.history],
                               rtol=QUAD_RTOL, atol=QUAD_ATOL)
    for a, b in zip(leaves(t_a.params(st_a)), leaves(t_s.params(st_s))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=QUAD_RTOL,
                                   atol=QUAD_ATOL)
    assert all(r.n_participants == _M for r in res_a.history)
    j_a = _quad("async", j_spec, "uniform", seed=2, ref=True)
    j_st, j_res = j_a.run(j_a.init(), max_rounds=5)
    assert _records(res_a.history) == _records(j_res.history)
    np.testing.assert_allclose(la, [r.train_loss for r in j_res.history],
                               rtol=QUAD_RTOL, atol=QUAD_ATOL)
    _assert_params_close(t_a.params(st_a), j_a.params(j_st))


def test_fedasync_differs_from_fedbuff():
    """fedasync (K=1, server_lr 0.5) mixes at once and so differs from
    fedbuff at K=1; each matches the reference's same mode."""
    out = {}
    for mode, lr in (("fedbuff", 1.0), ("fedasync", 0.5)):
        t_spec, j_spec = _specs(buffer_size=1, mode=mode, server_lr=lr)
        t, j = _quad("async", t_spec), _quad("async", j_spec, ref=True)
        st, res = t.run(t.init(), max_rounds=4)
        jst, jres = j.run(j.init(), max_rounds=4)
        assert _records(res.history) == _records(jres.history)
        _assert_params_close(t.params(st), j.params(jst))
        out[mode] = t.params(st)["w"]
    assert not np.allclose(out["fedbuff"].numpy(), out["fedasync"].numpy())


def test_async_composes_with_faults():
    """Under 'unreliable_edge' (deadline, retransmission, crash) the
    records (every attempt's bits) equal the reference's; the clock is
    monotone."""
    t_spec, j_spec = _specs(buffer_size=2, staleness="poly")
    t = _quad("async", t_spec, "unreliable_edge", seed=4)
    j = _quad("async", j_spec, "unreliable_edge", seed=4, ref=True)
    assert t._faults is not None
    st, res = t.run(t.init(), max_rounds=5)
    jst, jres = j.run(j.init(), max_rounds=5)
    assert len(res.history) == 5
    assert _records(res.history) == _records(jres.history)
    times = [r.sim_time for r in res.history]
    assert all(b >= a for a, b in zip(times, times[1:]))
    assert all(r.uplink_bits > 0 for r in res.history)
    assert st.event == jst.event
    _assert_params_close(t.params(st), j.params(jst))


@pytest.mark.parametrize("kw", [dict(max_rounds=5, eval_every=2),
                                dict(max_rounds=50, max_sim_time=0.01),
                                dict(max_rounds=4, budget=3)])
def test_early_chunk_stops_match_reference(kw):
    """Chunks that end early (at eval_every's aggregation boundaries, at
    max_sim_time, or at a small event budget E) give the reference's
    padded chunks' records, event cursor, stream position and params."""
    kw = dict(kw)
    budget = kw.pop("budget", None)
    t_spec, j_spec = _specs(buffer_size=2, staleness="exp",
                            event_budget=budget)
    t = _quad("async", t_spec, "dropout", seed=5)
    j = _quad("async", j_spec, "dropout", seed=5, ref=True)
    st, res = t.run(t.init(), **kw)
    jst, jres = j.run(j.init(), **kw)
    assert _records(res.history) == _records(jres.history)
    assert (st.event, st.round, st.sim_time) == (jst.event, jst.round,
                                                 jst.sim_time)
    assert repr(st.stream) == repr(jst.stream)
    _assert_params_close(t.params(st), j.params(jst))
    if "max_sim_time" in kw:
        assert res.history[-1].sim_time >= kw["max_sim_time"]
        assert len(res.history) < kw["max_rounds"]


# -- the Study's solo async arm -----------------------------------------------


def test_async_arm_in_study(tmp_path):
    """An async arm runs solo beside a sync arm (never grouped) and names
    its regime in the table and the JSON, as the reference's; its history
    is its run alone's, and its member checkpoint (the event carry
    included) resumes the study."""
    sync = t_exp.ExperimentSpec(
        fed=FedConfig(n_devices=3, batch_size=8, theta=0.62, lr=0.05),
        model="mnist_cnn_tiny", dataset="mnist", n_train=96, n_test=48,
        label="sync")
    asyn = sync.replace(backend="async",
                        async_spec=events.AsyncSpec(buffer_size=2,
                                                    staleness="poly"),
                        label="asyn")
    study = t_study.Study(arms=[("sync", sync), ("asyn", asyn)], seeds=(0,),
                          max_rounds=3)
    res = study.run(device="cpu", checkpoint_dir=tmp_path)
    assert ("asyn",) in res.groups
    assert res.async_modes == {"sync": None, "asyn": "fedbuff/K=2/poly"}
    header, rows = res.table()
    assert ",agg," in header
    by_label = {r[0]: r for r in rows}
    assert by_label["sync"][4] == "sync"
    assert by_label["asyn"][4] == "fedbuff/K=2/poly"
    assert res.to_json()["arms"]["asyn"]["async"] == "fedbuff/K=2/poly"
    assert len(res["asyn"][0].history) == 3
    sim = asyn.build(device="cpu")
    _, alone = sim.run(sim.init(0), max_rounds=3)
    got = res["asyn"][0].history
    assert ([(r.train_loss, r.test_acc) + t for r, t in
             zip(got, _records(got))]
            == [(r.train_loss, r.test_acc) + t for r, t in
                zip(alone.history, _records(alone.history))])
    again = study.run(device="cpu", checkpoint_dir=tmp_path)
    st, st2 = res.states["asyn"][0], again.states["asyn"][0]
    assert st2.event == st.event > 0
    for a, b in zip(leaves(st.async_c), leaves(st2.async_c)):
        assert torch.equal(a, b)
    assert _records(again["asyn"][0].history) == _records(got)


# -- compressed mnist_async against the reference -----------------------------

AGGS = 6


def _compressed(exp):
    spec = exp.get("mnist_async")
    return spec.replace(fed=dataclasses.replace(spec.fed,
                                                compress_updates=True))


class _EventNoise:
    """The reference's per-event quantizer noise replayed: one
    sequential_client_keys(key, 1) split an event, its subkey's
    (rows, 1024) draw as the port's (1, rows, 1024)."""

    def __init__(self, rows):
        self.rows = rows
        self.key = None
        self.draw = jax.jit(lambda k: j_noise(k, (rows, t_comp.ROW)))

    def __call__(self, _generator, shape):
        assert tuple(shape) == (1, self.rows, t_comp.ROW)
        self.key, sub = jax.random.split(self.key)
        return torch.tensor(np.asarray(self.draw(sub)))[None]


def _port_state(t_sim, j_state):
    """The port's async state equal to a host snapshot of the
    reference's (its carry through convert.async_carry_to_torch)."""
    return dataclasses.replace(
        t_sim.init(j_state.seed),
        params_C=to_torch(jax.tree.map(np.asarray, j_state.params_C),
                          device="cpu"),
        round=j_state.round, sim_time=j_state.sim_time,
        stream=j_state.stream, data=j_state.data,
        async_c=async_carry_to_torch(j_state.async_c, device="cpu"),
        event=j_state.event, async_host=j_state.async_host)


@pytest.fixture(scope="module")
def ref_async():
    j_spec, t_spec = _compressed(j_exp), _compressed(t_exp)
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    st, before, j_hist = j_sim.init(), [], []
    for _ in range(AGGS):
        before.append(jax.device_get(st))
        st, res = j_sim.run(st, max_rounds=1)
        j_hist.extend(res.history)
    after = before[1:] + [jax.device_get(st)]
    noise = _EventNoise(t_comp.n_rows(params0))
    noise.key = jax.random.PRNGKey(j_spec.fed.seed)
    t_sim = t_spec.build(device="cpu", params=params0, noise=noise)
    t_state, t_res = t_sim.run(t_sim.init(), max_rounds=AGGS, eval_every=3)
    per_agg = []
    for b in before:
        noise.key = b.key
        end, res = t_sim.run(_port_state(t_sim, b), max_rounds=1)
        per_agg.append((t_sim.params(end), res.history[0], end.event))
    return {"j_sim": j_sim, "j_hist": j_hist, "j_state": after[-1],
            "after": after, "t_sim": t_sim, "t_state": t_state,
            "t_res": t_res, "per_agg": per_agg}


def test_mnist_async_records_clock_bits_exact(ref_async):
    """Compressed mnist_async ('stragglers', K=4, poly): every record, the
    event cursor, the stream and the data positions exactly the
    reference's over 6 aggregations; the event clock is monotone and each
    record's bits are the compressed update's times the arrivals paid."""
    t_hist, j_hist = ref_async["t_res"].history, ref_async["j_hist"]
    assert len(t_hist) == len(j_hist) == AGGS
    assert _records(t_hist) == _records(j_hist)
    t_state, j_state = ref_async["t_state"], ref_async["j_state"]
    assert t_state.event == j_state.event
    assert repr(t_state.stream) == repr(j_state.stream)
    assert repr(t_state.data) == repr(j_state.data)
    np.testing.assert_array_equal(t_state.async_host["t_cm_disp"],
                                  j_state.async_host["t_cm_disp"])
    times = [r.sim_time for r in t_hist]
    assert all(b >= a for a, b in zip(times, times[1:]))
    bits = t_comp.compressed_bits(ref_async["t_sim"].params(t_state))
    assert all(r.uplink_bits % bits == 0 and r.uplink_bits >= 4 * bits
               for r in t_hist)
    for k in ("t_finish", "t_next", "now", "version", "version_C", "cnt",
              "drop_C"):
        got = t_state.async_c[k].numpy()
        assert got.dtype == np.asarray(j_state.async_c[k]).dtype, k
        np.testing.assert_array_equal(got, np.asarray(j_state.async_c[k]))


def test_mnist_async_each_aggregation_within_contract(ref_async):
    """Each aggregation from the reference's state (carried over by
    convert.async_carry_to_torch) with its noise replayed: records exact,
    losses within 1e-5 relative, params within 5e-4."""
    j_sim = ref_async["j_sim"]
    for (params, rec, ev), j_rec, j_after in zip(
            ref_async["per_agg"], ref_async["j_hist"], ref_async["after"]):
        assert _records([rec]) == _records([j_rec])
        assert ev == j_after.event
        np.testing.assert_allclose(rec.train_loss, j_rec.train_loss,
                                   rtol=LOSS_RTOL)
        for t, j in zip(leaves(to_numpy(params)),
                        jax.tree.leaves(j_sim.params(j_after))):
            np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                       atol=PARAM_ATOL)


def test_async_carry_conversion_checks():
    carry = {"params_g": {"w": np.zeros(3, np.float32)},
             "buf": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="keys"):
        async_carry_to_torch(carry, device="cpu")
    carry.update({k: np.zeros((), np.float32) for k in (
        "buf_w", "cnt", "loss_sum", "t_finish", "t_next", "now", "version",
        "version_C", "drop_C")})
    with pytest.raises(ValueError, match="'cnt'"):
        async_carry_to_torch(carry, device="cpu")


# -- async_plan and the example twin ------------------------------------------


@pytest.mark.parametrize("M,K,het,compress", [(10, 4, 0.4, False),
                                              (10, 1, 0.0, True),
                                              (10, 10, 0.4, False),
                                              (20, 7, 0.8, False)])
def test_async_plan_exact(M, K, het, compress):
    """defl.async_plan gives the reference's DEFLPlan, field for field (a
    twin of tests/test_plan_batch.py::test_async_plan_model)."""
    t_fed = FedConfig(n_devices=M, epsilon=0.01, nu=2.0, c=4.0,
                      compress_updates=compress)
    j_fed = JFed(n_devices=M, epsilon=0.01, nu=2.0, c=4.0,
                 compress_updates=compress)
    t_pop = delay.draw_population(M, t_exp.CALIBRATED_COMPUTE,
                                  WirelessConfig(), 0, het)
    j_pop = j_delay.draw_population(M, j_exp.CALIBRATED_COMPUTE,
                                    JWireless(), 0, het)
    t = defl.async_plan(t_fed, t_pop, 1e6, buffer_size=K)
    j = j_defl.async_plan(j_fed, j_pop, 1e6, buffer_size=K)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.solution.method == "async_grid" and t.problem.M == K
    assert _error(lambda: defl.async_plan(t_fed, t_pop, 1e6,
                                          buffer_size=M + 1)) == _error(
        lambda: j_defl.async_plan(j_fed, j_pop, 1e6, buffer_size=M + 1))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scenario", ["uniform", "stragglers", "dropout"])
def test_example_twin_arms_and_predictions(scenario):
    """examples/async_vs_sync_torch.py's arms (quick and full) and
    predicted overall times exactly those of benchmarks/async_vs_sync.py
    (numpy only: nothing is trained)."""
    from benchmarks import async_vs_sync as ref
    twin = _load(ROOT / "examples" / "async_vs_sync_torch.py",
                 "async_vs_sync_torch")
    assert twin.SCENARIO_NAMES == ref.SCENARIO_NAMES
    assert (twin.ASYNC_BUFFER, twin.M, twin.TARGET_ACC) == (
        ref.ASYNC_BUFFER, ref.M, ref.TARGET_ACC)
    assert twin.HEADER in ref.run.__code__.co_consts
    for quick in (True, False):
        t_arms = twin.arm_specs(scenario, quick=quick)
        j_arms = ref.arm_specs(scenario, quick=quick)
        assert [a for a, _ in t_arms] == [a for a, _ in j_arms]
        for (_, t), (_, j) in zip(t_arms, j_arms):
            for f in dataclasses.fields(t):
                tv, jv = getattr(t, f.name), getattr(j, f.name)
                if dataclasses.is_dataclass(tv):
                    assert (dataclasses.asdict(tv)
                            == dataclasses.asdict(jv)), f.name
                else:
                    assert tv == jv, f.name
            want = (j_defl.async_plan(
                j.base_fed(), j.device_population(), j.update_bits(),
                buffer_size=j.async_spec.buffer_size,
                wireless=j.wireless).overall_pred
                if j.backend == "async" else j.analytic_plan().overall_pred)
            assert twin.predicted_overall_s(t) == want
    study = twin.study_for(scenario, quick=True)
    j_study = ref.study_for(scenario, quick=True)
    assert (study.seeds, study.max_rounds, study.eval_every,
            study.target_acc) == (j_study.seeds, j_study.max_rounds,
                                  j_study.eval_every, j_study.target_acc)
