"""The port's online planner (federated/planner.py) against the
reference's, case by case as tests/test_planner.py:

  * telemetry ingest (validation, latest-wins, slope encoding, staleness
    eviction, the participation EWMA, realized rounds) leaves the
    reference's snapshots and estimates;
  * every `PlannerService` query equals the reference's plan field for
    field, and `plan_batch` at Q = 256 (mixed participation, cohort sizes
    and both solver methods) equals the port's scalar `plan()` and the
    reference's, lane by lane;
  * `replan_trace(...).to_json()` and `table()` equal the reference's on
    several traces, targets and methods; its one batched dispatch, its
    causality and `_walk`'s linear credit are the reference's;
  * the demo twin (examples/planner_service_demo_torch.py): `run(quick=
    True)`'s report, the printed lines, the JSON file and the exit codes
    equal the reference demo's.

Everything here is numpy on the host in both packages, so every number
is held to the bit.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

from repro.configs.base import FedConfig as JFed
from repro.core import delay as j_delay
from repro.federated import planner as j_pl
from repro.federated import scenarios as j_scen
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.core import delay as t_delay
from repro_torch.federated import planner as t_pl
from repro_torch.federated import scenarios as t_scen

BITS = 8e5
FED = dict(n_devices=16, epsilon=0.01, nu=2.0, c=4.0)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _updates(pl, m=16, seed=0):
    rng = np.random.default_rng(seed)
    return [pl.DeviceStateUpdate(
        i, g=float(rng.uniform(1e-4, 2e-3)), p=0.2,
        h=float(rng.uniform(1e-9, 1e-8)), t=float(i)) for i in range(m)]


def _services(m=16, **kw):
    """The same observed service in both packages."""
    t = t_pl.PlannerService(TFed(**FED), BITS, **kw)
    j = j_pl.PlannerService(JFed(**FED), BITS, **kw)
    t.observe(_updates(t_pl, m))
    j.observe(_updates(j_pl, m))
    return t, j


def _pops_equal(t, j):
    assert t.n == j.n
    for f in ("G", "f", "p", "h"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def _plans_equal(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


# -- telemetry ingest ---------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(client_id=-1, g=1e-3, p=0.2, h=1e-9),
    dict(client_id=0, g=0.0, p=0.2, h=1e-9),
    dict(client_id=0, g=1e-3, p=-1.0, h=1e-9),
    dict(client_id=0, g=1e-3, p=0.2, h=0.0)])
def test_update_validation_is_the_references(bad):
    assert _error(lambda: t_pl.DeviceStateUpdate(**bad)) == _error(
        lambda: j_pl.DeviceStateUpdate(**bad))


def test_observe_latest_wins_and_snapshot_sorted():
    snaps = []
    for pl, fed in ((t_pl, TFed), (j_pl, JFed)):
        svc = pl.PlannerService(fed(**FED), BITS)
        svc.observe(pl.DeviceStateUpdate(3, g=2e-3, p=0.2, h=1e-9))
        svc.observe([pl.DeviceStateUpdate(1, g=1e-3, p=0.2, h=2e-9),
                     pl.DeviceStateUpdate(3, g=5e-3, p=0.3, h=3e-9)])
        assert svc.n_devices == 2
        snaps.append(svc.population())
    _pops_equal(*snaps)
    np.testing.assert_array_equal(snaps[0].G, [1e-3, 5e-3])
    np.testing.assert_array_equal(snaps[0].f, [1.0, 1.0])


def test_observe_population_encodes_slope():
    arrays = dict(G=np.array([10.0, 20.0, 7.0]), f=np.array([2.0, 4.0, 3.0]),
                  p=np.array([0.2, 0.2, 0.1]), h=np.array([1e-9, 2e-9, 3e-9]))
    snaps = []
    for pl, fed, dl in ((t_pl, TFed, t_delay), (j_pl, JFed, j_delay)):
        svc = pl.PlannerService(fed(**FED), BITS)
        svc.observe_population(dl.DevicePopulation(**arrays), t=2.0)
        snaps.append(svc.population())
    _pops_equal(*snaps)
    np.testing.assert_array_equal(snaps[0].G / snaps[0].f,
                                  arrays["G"] / arrays["f"])


def test_staleness_eviction_is_the_references():
    t, j = _services(m=4, stale_after=1.5)
    _pops_equal(t.population(now=3.0), j.population(now=3.0))
    assert t.population(now=3.0).n == 2
    _pops_equal(t.population(), j.population())
    assert _error(lambda: t.population(now=100.0)) == _error(
        lambda: j.population(now=100.0))
    assert _error(t_pl.PlannerService(TFed(**FED), BITS).population) == \
        _error(j_pl.PlannerService(JFed(**FED), BITS).population)


def test_participation_ewma_is_the_references():
    t, j = (pl.PlannerService(fed(**FED), BITS)
            for pl, fed in ((t_pl, TFed), (j_pl, JFed)))
    assert t.participation_estimate(default=0.7) == 0.7
    for f in (0.8, 0.4, 2.0, -1.0, 0.33):
        t.observe_participation(f)
        j.observe_participation(f)
        assert t.participation_estimate() == j.participation_estimate()
    assert 0.0 <= t.participation_estimate() <= 1.0


@pytest.mark.parametrize("name", ["hetero_storm", "diurnal_edge"])
def test_observe_round_is_the_references(name):
    t, j = _services(m=6)
    ts, js = t_scen.get(name), j_scen.get(name)
    t_st = ts.stream(ts.population(6, seed=0), seed=0)
    j_st = js.stream(js.population(6, seed=0), seed=0)
    for k in range(4):
        t.observe_round(t_st.next_round(), t=9.0 + k)
        j.observe_round(j_st.next_round(), t=9.0 + k)
        _pops_equal(t.population(), j.population())
        assert t.participation_estimate() == j.participation_estimate()


# -- solves -----------------------------------------------------------------------


def test_plan_batch_empty():
    assert t_pl.PlannerService(TFed(**FED), BITS).plan_batch([]) == []


@pytest.mark.parametrize("method", ["closed_form", "numerical", "corrected"])
def test_plan_on_the_snapshot_is_the_references(method):
    t, j = _services(method=method)
    tp, jp = t.plan(), j.plan()
    _plans_equal(tp, jp)
    assert tp.b >= 1 and tp.V >= 1 and np.isfinite(tp.T_round)


def _queries(pl, n=256):
    rng = np.random.default_rng(42)
    return [pl.PlanQuery(
        participation=float(rng.uniform(0.3, 1.0)),
        cohort_size=int(rng.integers(4, 17)),
        method="numerical" if i % 4 == 0 else "closed_form",
        tag=f"q{i}") for i in range(n)]


def test_plan_batch_q256_lanes_are_the_scalar_and_the_references():
    """Q = 256 heterogeneous queries: each lane of the port's plan_batch
    equals the port's scalar plan() and the reference's, bit for bit."""
    t, j = _services()
    tq, jq = _queries(t_pl), _queries(j_pl)
    batched = t.plan_batch(tq)
    assert len(batched) == 256
    for q_t, q_j, bp in zip(tq, jq, batched):
        sp = t.plan(q_t)
        _plans_equal(bp, sp)
        _plans_equal(sp, j.plan(q_j))


def test_plan_batch_explicit_pop_is_the_references():
    plans = []
    for pl, fed, sc in ((t_pl, TFed, t_scen), (j_pl, JFed, j_scen)):
        pop = sc.get("uniform").population(8, seed=0)
        svc = pl.PlannerService(fed(**FED), BITS)  # observed nothing
        plans.append(svc.plan_batch([pl.PlanQuery(pop=pop, participation=0.9),
                                     pl.PlanQuery(pop=pop, participation=0.5)]))
    for tp, jp in zip(*plans):
        _plans_equal(tp, jp)
    assert plans[0][1].problem.M < plans[0][0].problem.M


def test_query_overrides_are_the_references():
    t, j = _services()
    loose = dict(n_devices=16, epsilon=0.1, nu=2.0, c=4.0)
    tp = t.plan_batch([t_pl.PlanQuery(),
                       t_pl.PlanQuery(fed=TFed(**loose), update_bits=1e4)])
    jp = j.plan_batch([j_pl.PlanQuery(),
                       j_pl.PlanQuery(fed=JFed(**loose), update_bits=1e4)])
    for a, b in zip(tp, jp):
        _plans_equal(a, b)
    assert tp[1].problem.eps == pytest.approx(0.1)
    assert tp[1].update_bits == 1e4 and tp[0].update_bits == BITS


# -- the replanning driver -----------------------------------------------------------

# (scenario, fed kwargs, replan_trace kwargs): the reference test's quick
# report, an explicit and an unreachable target, another seed and method,
# compressed updates, and a registry scenario without a trace.
QUICK = dict(n_devices=12, epsilon=0.1, nu=2.0, c=1.0)
REPLANS = {
    "quick": ("diurnal_edge", QUICK, dict()),
    "target": ("diurnal_edge", QUICK, dict(target=0.05)),
    "unreachable": ("diurnal_edge", QUICK, dict(target=1e9)),
    "seed3_numerical": ("diurnal_edge", QUICK,
                        dict(seed=3, method="numerical")),
    "compressed": ("diurnal_edge", dict(QUICK, compress_updates=True),
                   dict(epochs=3, rounds_per_epoch=6)),
    "hetero_storm": ("hetero_storm", dict(QUICK, n_devices=8), dict()),
}


def _replan(pl, fed_cls, case):
    name, fed_kw, kw = REPLANS[case]
    kw = dict(dict(epochs=4, rounds_per_epoch=8, seed=0), **kw)
    return pl.replan_trace(name, fed_cls(**fed_kw), update_bits=1e5, **kw)


@pytest.mark.parametrize("case", sorted(REPLANS))
def test_replan_report_is_the_references(case):
    t, j = _replan(t_pl, TFed, case), _replan(j_pl, JFed, case)
    # As text: an unreachable target's regret is inf - inf = nan.
    assert json.dumps(t.to_json(), default=float) == json.dumps(
        j.to_json(), default=float)
    assert t.table() == j.table()
    assert tuple(dataclasses.asdict(p) for p in t.plans) == tuple(
        dataclasses.asdict(p) for p in j.plans)
    assert "b1.V1" in t.fixed_times and "b64.V16" in t.fixed_times
    assert t.oracle_time == min(t.fixed_times.values())
    np.testing.assert_equal(t.regret, t.replanned_time - t.oracle_time)
    if case == "unreachable":
        assert t.replanned_time == np.inf
        assert all(v == np.inf for v in t.fixed_times.values())


def test_replan_single_batched_dispatch():
    calls = []

    class Counting(t_pl.PlannerService):
        def plan_batch(self, queries):
            calls.append(len(queries))
            return super().plan_batch(queries)

    fed = TFed(**QUICK)
    rep = t_pl.replan_trace("diurnal_edge", fed, update_bits=1e5, epochs=4,
                            rounds_per_epoch=8, seed=0,
                            service=Counting(fed, 1e5))
    assert calls == [4] and len(rep.plans) == 4
    assert rep.to_json() == _replan(j_pl, JFed, "quick").to_json()


def test_replan_causality():
    rep = _replan(t_pl, TFed, "quick")
    prior = t_scen.get("diurnal_edge").expected_participation
    assert prior == j_scen.get("diurnal_edge").expected_participation
    assert rep.plans[0].participation == pytest.approx(prior)
    assert any(abs(p.participation - prior) > 1e-6 for p in rep.plans[1:])
    assert rep.beats_worst()


def test_walk_is_the_references():
    out = []
    for pl, fed_cls, sc in ((t_pl, TFed, t_scen), (j_pl, JFed, j_scen)):
        fed = fed_cls(n_devices=2, epsilon=0.1, nu=2.0, c=1.0)
        scen = sc.get("uniform")
        pop = scen.population(2, seed=0)
        chunk = scen.stream(pop, seed=0).draw_chunk(4)
        wc = pl.WirelessConfig()
        t_full, prog = pl._walk(fed, wc, pop, 1e5, [chunk], [(2, 2)])
        t_half = pl._walk(fed, wc, pop, 1e5, [chunk], [(2, 2)],
                          target=1.5 * prog / 4.0)
        out.append((t_full, prog, t_half))
    assert out[0] == out[1]
    t_full, _, t_half = out[0]
    assert t_half == pytest.approx(1.5 / 4.0 * t_full, rel=1e-9)


# -- the demo twin ---------------------------------------------------------------


def _load(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_demo_twin_is_the_references(tmp_path, capsys):
    """run(quick=True)'s report, main(--quick --check --json)'s lines and
    file, and --check's exit code when replanning loses: the reference
    demo's."""
    twin = _load("planner_service_demo_torch")
    ref = _load("planner_service_demo")
    assert twin.run(quick=True).to_json() == ref.run(quick=True).to_json()
    out = {}
    for name, mod in (("t", twin), ("j", ref)):
        path = os.path.join(tmp_path, f"{name}.json")
        mod.main(["--quick", "--check", "--json", path])
        out[name] = (capsys.readouterr().out, open(path).read())
    assert out["t"] == out["j"]
    assert "check: replanned" in out["t"][0]
    assert json.loads(out["t"][1])["beats_worst"] is True
    # --check exits 1, with the reference's line, when replanning does not
    # beat the worst fixed plan.
    codes = {}
    for name, mod in (("t", twin), ("j", ref)):
        real = mod.run

        def losing(quick=False, seed=0, real=real):
            rep = real(quick=quick, seed=seed)
            return dataclasses.replace(rep, replanned_time=float("inf"))

        mod.run = losing
        with pytest.raises(SystemExit) as ei:
            mod.main(["--quick", "--check"])
        codes[name] = (ei.value.code, capsys.readouterr().out)
    assert codes["t"] == codes["j"]
    assert codes["t"][0] == 1 and "FAIL" in codes["t"][1]
