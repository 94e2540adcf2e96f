"""The port's batched plan solving against the reference's and its own
scalar path.

  * `kkt.solve_batch` is bit-identical, lane by lane, to the reference's
    `solve_batch` and to the port's scalar `solve`, under all three
    methods;
  * `defl.make_plan_batch` is bit-identical to the reference's and to the
    port's scalar `make_plan`, with partial participation and cohorts;
  * `ExperimentSpec.plan_request()` is the reference's (None where the
    reference's is None), and `Study.plans()` equals the reference's and
    per-arm `analytic_plan()` exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import FedConfig as JFed
from repro.configs.base import WirelessConfig as JWireless
from repro.core import defl as j_defl
from repro.core import delay as j_delay
from repro.core import kkt as j_kkt
from repro.federated import experiment as j_exp
from repro.federated.faults import FaultModel as JFaults
from repro.federated.study import Study as JStudy
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import WirelessConfig as TWireless
from repro_torch.core import defl as t_defl
from repro_torch.core import delay as t_delay
from repro_torch.core import kkt as t_kkt
from repro_torch.federated import experiment as t_exp
from repro_torch.federated.faults import FaultModel as TFaults
from repro_torch.federated.study import Study as TStudy

METHODS = ["closed_form", "numerical", "corrected"]
SOL_FIELDS = ("b", "alpha", "T_cp", "H", "T_round", "overall", "V", "theta")
PLAN_FIELDS = ("b", "theta", "V", "H_pred", "T_cm", "T_cp", "T_round",
               "overall_pred", "update_bits")


def _problems(kkt):
    return [
        kkt.DelayProblem(T_cm=t, g=g, M=m, eps=e, nu=2.0, c=4.0)
        for t in (0.01, 0.5, 3.0)
        for g in (1e-4, 2e-3)
        for m in (2, 10, 64)
        for e in (0.01, 0.1)
    ]


def _sol(s):
    return [float(getattr(s, f)) for f in SOL_FIELDS] + [s.method]


@pytest.mark.parametrize("method", METHODS)
def test_solve_batch_bit_identical_to_reference_and_scalar(method):
    t_probs, j_probs = _problems(t_kkt), _problems(j_kkt)
    t_batch = t_kkt.solve_batch(t_probs, method=method)
    j_batch = j_kkt.solve_batch(j_probs, method=method)
    assert len(t_batch) == len(t_probs) == 36
    for p, tb, jb in zip(t_probs, t_batch, j_batch):
        assert _sol(tb) == _sol(jb)
        assert _sol(tb) == _sol(t_kkt.solve(p, method=method))


def test_solve_batch_empty_and_unknown_method():
    assert t_kkt.solve_batch([]) == []
    with pytest.raises(ValueError):
        t_kkt.solve_batch(_problems(t_kkt)[:2], method="nope")


def test_batch_helpers_bit_identical_to_reference():
    """The grid seed and the lane-wise golden section, on their own."""
    rng = np.random.default_rng(0)
    lanes = [rng.uniform(lo, hi, 9) for lo, hi in
             ((0.01, 3.0), (1e-4, 2e-3), (2, 64), (0.01, 0.1), (1.5, 3),
              (1, 8))]
    for a, b in zip(t_kkt._grid_search_batch(*lanes),
                    j_kkt._grid_search_batch(*lanes)):
        np.testing.assert_array_equal(a, b)
    b0, a0 = rng.uniform(1, 64, 9), rng.uniform(0.5, 20, 9)
    for a, b in zip(t_kkt._coordinate_descent_batch(*lanes, b0, a0),
                    j_kkt._coordinate_descent_batch(*lanes, b0, a0)):
        np.testing.assert_array_equal(a, b)
    f = lambda x: (x - 3.0) ** 2 + np.log(x)  # noqa: E731
    lo, hi = np.full(4, 0.5), np.array([4.0, 8.0, 16.0, 32.0])
    vec = t_kkt._golden_min_vec(f, lo, hi)
    np.testing.assert_array_equal(vec, j_kkt._golden_min_vec(f, lo, hi))
    assert list(vec) == [t_kkt._golden_min(f, a, b) for a, b in zip(lo, hi)]


def _requests(fed_cls, wl_cls, delay, defl, method):
    fed = fed_cls(n_devices=10, epsilon=0.01, nu=2.0, c=4.0)
    reqs = []
    for seed, het, part, K in [(0, 0.0, 1.0, None), (1, 0.4, 0.7, None),
                               (2, 0.8, 1.0, 6), (3, 0.2, 0.9, 4)]:
        pop = delay.draw_population(
            10, t_exp.CALIBRATED_COMPUTE, wl_cls(), seed, het)
        reqs.append(defl.PlanRequest(
            fed=fed, pop=pop, update_bits=1e6, method=method,
            participation=part, cohort_size=K))
    return reqs


def _plan(p):
    return [getattr(p, f) for f in PLAN_FIELDS] + [
        p.solution.alpha, p.solution.method, dataclasses.astuple(p.problem)]


@pytest.mark.parametrize("method", METHODS)
def test_make_plan_batch_bit_identical(method):
    t_reqs = _requests(TFed, TWireless, t_delay, t_defl, method)
    j_reqs = _requests(JFed, JWireless, j_delay, j_defl, method)
    t_plans = t_defl.make_plan_batch(t_reqs)
    j_plans = j_defl.make_plan_batch(j_reqs)
    for r, tp, jp in zip(t_reqs, t_plans, j_plans):
        assert _plan(tp) == _plan(jp)
        scalar = t_defl.make_plan(
            r.fed, r.pop, r.update_bits, wireless=r.wireless,
            method=r.method, participation=r.participation,
            cohort_size=r.cohort_size)
        assert _plan(tp) == _plan(scalar)


def test_make_plan_batch_mixed_methods_keep_order():
    reqs = [r for m in METHODS
            for r in _requests(TFed, TWireless, t_delay, t_defl, m)[:2]]
    reqs = reqs[::-1]
    for r, p in zip(reqs, t_defl.make_plan_batch(reqs)):
        assert p.solution.method == r.method + "+quant"
        assert _plan(p) == _plan(t_defl.make_plan(
            r.fed, r.pop, r.update_bits, method=r.method,
            participation=r.participation, cohort_size=r.cohort_size))


def _arms(exp, faults_cls):
    paper = exp.get("mnist_paper")
    return [
        ("defl", paper),
        ("storm", exp.get("mnist_storm")),  # a scenario, no deadline
        ("numerical", paper.replace(plan_method="numerical")),
        ("deadline", paper.replace(scenario="unreliable_edge")),
        ("extra_faults", paper.replace(
            scenario="dropout", faults=faults_cls(deadline=2.0))),
        ("fedavg", paper.replace(plan=False, label="fedavg")),
        ("smoke", exp.get("mnist_smoke")),  # plan=False
    ]


def test_plan_request_is_the_references():
    for (label, t), (_, j) in zip(_arms(t_exp, TFaults),
                                  _arms(j_exp, JFaults)):
        tr, jr = t.plan_request(), j.plan_request()
        assert (tr is None) == (jr is None), label
        if tr is None:
            continue
        assert tr.cohort_size is None and jr.cohort_size is None
        assert (tr.update_bits, tr.method, tr.participation) == (
            jr.update_bits, jr.method, jr.participation)
        assert dataclasses.asdict(tr.fed) == dataclasses.asdict(jr.fed)
        for f in ("G", "f", "p", "h"):
            np.testing.assert_array_equal(getattr(tr.pop, f),
                                          getattr(jr.pop, f))
    assert t_exp.get("mnist_paper").replace(
        scenario="unreliable_edge").plan_request() is None


def test_study_plans_match_reference_and_scalar():
    t_plans = TStudy(arms=_arms(t_exp, TFaults)).plans()
    j_plans = JStudy(arms=_arms(j_exp, JFaults)).plans()
    assert list(t_plans) == list(j_plans)
    for label, spec in _arms(t_exp, TFaults):
        assert _plan(t_plans[label]) == _plan(j_plans[label]), label
        assert _plan(t_plans[label]) == _plan(spec.analytic_plan()), label
    assert t_plans["fedavg"].b == t_exp.get("mnist_paper").fed.batch_size
