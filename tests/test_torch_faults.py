"""The port's fault layer against the reference.

  * `FaultModel`'s resolutions (`resolve_deadline`, `resolve_quorum`,
    `guard_spec`, `backoff_waits`, `link_success`, `availability`) and its
    validation give the reference's results exactly;
  * the fault path's delay functions (`effective_uplink_times`,
    `finish_times`, `round_time(deadline=)`, `masked_round_times`,
    `chunk_round_times`) and the planners `make_plan(participation=,
    cohort_size=)` and `deadline_plan` are exact;
  * the update guard on a compressed `mnist_smoke` run, the port's
    quantizer noise replaced by the reference's: with `max_update_norm`
    binding (every client's norm at least 1.5x it, so no clip decision is
    within float32 reach of the threshold), each round from the
    reference's state gives a loss within 1e-5 relative and params within
    5e-4; a client whose data is NaN is rejected from every round (the
    participant counts exact, the loss and params finite and within the
    same bounds of the reference's).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFed
from repro.configs.base import WirelessConfig as JWireless
from repro.core import defl as j_defl
from repro.core import delay as j_delay
from repro.federated import compression as j_comp
from repro.federated import experiment as j_exp
from repro.federated.faults import FaultModel as JFaults
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import WirelessConfig as TWireless
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import defl as t_defl
from repro_torch.core import delay as t_delay
from repro_torch.federated import compression as t_comp
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import mesh_rounds as t_rounds
from repro_torch.federated.client import stack_chunk_indices
from repro_torch.federated.faults import FaultModel as TFaults
from repro_torch.utils.tree import leaves

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
ROUNDS = 4

FAULT_MODELS = [
    dict(),
    dict(deadline=0.3, max_retries=2, backoff_base=0.05),
    dict(deadline_factor=1.5, max_retries=3, backoff_base=0.01,
         backoff_factor=3.0, crash_rate=0.05, rejoin_rounds=3),
    dict(max_update_norm=2.5, reject_nonfinite=False),
    dict(min_quorum=4, quorum_policy="accept", redispatch_cost=0.5),
    dict(min_quorum=0.35, divergence_guard=False),
    dict(min_quorum=1.0),
]


@pytest.mark.parametrize("kw", FAULT_MODELS)
def test_fault_model_resolutions_match(kw):
    j, t = JFaults(**kw), TFaults(**kw)
    j.validate()
    t.validate()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.active, t.n_attempts) == (j.active, j.n_attempts)
    for nominal in (0.0123, 1.0, 7.5):
        assert t.resolve_deadline(nominal) == j.resolve_deadline(nominal)
    for cohort in (4, 10, 37):
        assert t.resolve_quorum(cohort) == j.resolve_quorum(cohort)
    assert t.guard_spec() == j.guard_spec()
    for q in (0.0, 0.05, 0.2, 0.9):
        assert t.link_success(q) == j.link_success(q)
    assert t.availability() == j.availability()
    attempts = np.random.default_rng(0).integers(0, t.n_attempts + 1, (5, 7))
    got, want = t.backoff_waits(attempts), j.backoff_waits(attempts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [
    dict(deadline=0.0), dict(deadline_factor=-1.0),
    dict(deadline=1.0, deadline_factor=1.0), dict(max_retries=-1),
    dict(backoff_base=-0.1), dict(backoff_factor=0.5), dict(crash_rate=1.0),
    dict(rejoin_rounds=0), dict(max_update_norm=0.0), dict(min_quorum=0),
    dict(min_quorum=1.5), dict(min_quorum=True), dict(quorum_policy="drop"),
    dict(redispatch_cost=-1.0),
])
def test_fault_model_validation_matches(bad):
    for cls in (JFaults, TFaults):
        with pytest.raises(ValueError):
            cls(**bad).validate()
    with pytest.raises(ValueError):
        TFaults(min_quorum=11).resolve_quorum(10)


def test_fault_path_delay_functions_exact():
    rng = np.random.default_rng(5)
    R, M, A = 4, 9, 3
    p = np.full(M, 0.2)
    h_att = 10 ** rng.uniform(-9, -7, (R, M, A))
    attempts = rng.integers(0, A + 1, (R, M))
    bits = 1.3e6
    for base, factor in ((0.0, 2.0), (0.05, 2.0), (0.01, 3.0)):
        got = t_delay.effective_uplink_times(bits, TWireless(), p, h_att,
                                             attempts, base, factor)
        want = j_delay.effective_uplink_times(bits, JWireless(), p, h_att,
                                              attempts, base, factor)
        np.testing.assert_array_equal(got, want)
        # Each round of the chunk equals the per-round call.
        np.testing.assert_array_equal(got[1], t_delay.effective_uplink_times(
            bits, TWireless(), p, h_att[1], attempts[1], base, factor))
    t_cp = rng.uniform(0.001, 0.01, M)
    t_cm = rng.uniform(0.01, 0.1, (R, M))
    np.testing.assert_array_equal(t_delay.finish_times(t_cp, t_cm, 3),
                                  j_delay.finish_times(t_cp, t_cm, 3))
    mask = rng.random((R, M)) < 0.5
    mask[2] = False  # a zero-participation round: full-population max
    for a, b in zip(t_delay.chunk_round_times(t_cp, t_cm, mask),
                    j_delay.chunk_round_times(t_cp, t_cm, mask)):
        np.testing.assert_array_equal(a, b)
    for r in range(R):
        assert t_delay.masked_round_times(t_cp, t_cm[r], mask[r]) == \
            j_delay.masked_round_times(t_cp, t_cm[r], mask[r])
    for deadline in (None, 0.05, 10.0):
        assert t_delay.round_time(0.04, 0.003, 3, deadline=deadline) == \
            j_delay.round_time(0.04, 0.003, 3, deadline=deadline)


def test_chunk_uplink_rows_are_the_references_fault_rounds():
    """The port resolves retransmission and the deadline cut a chunk at a
    time (`_chunk_uplink`); each row equals the reference's per-round
    resolution (`_fault_round`) of the same realization."""
    sims = []
    for exp in (j_exp, t_exp):
        spec = exp.get("mnist_smoke").replace(scenario="unreliable_edge")
        sims.append(spec.build(**({"device": "cpu"} if exp is t_exp
                                  else {})))
    j_sim, t_sim = sims
    assert t_sim._deadline == j_sim._deadline is not None
    np.testing.assert_array_equal(t_sim._t_cp_clients, j_sim._t_cp_clients)
    j_stream = j_sim.scenario.stream(j_sim.pop, 4)
    chunk = t_sim.scenario.stream(t_sim.pop, 4).draw_chunk(12)
    mask, t_cm = t_sim._chunk_uplink(chunk)
    for r in range(12):
        real, j_t_cm, attempts = j_sim._fault_round(j_stream.next_round())
        np.testing.assert_array_equal(mask[r], real.mask)
        np.testing.assert_array_equal(t_cm[r], j_t_cm)
        assert int(chunk.attempts[r].sum()) == attempts
    assert not mask.all()  # the deadline or the losses cut someone


PLAN_FIELDS = ("b", "theta", "V", "H_pred", "T_cm", "T_cp", "T_round",
               "overall_pred", "update_bits")


def _plan_inputs(heterogeneity):
    kw = dict(n_devices=10, epsilon=0.01, nu=2.0, c=4.0, lr=0.05)
    spec = t_exp.get("mnist_paper").replace(heterogeneity=heterogeneity)
    return JFed(**kw), TFed(**kw), spec.device_population(), \
        spec.update_bits()


@pytest.mark.parametrize("heterogeneity", [0.0, 0.4])
def test_planners_with_participation_and_deadline_exact(heterogeneity):
    j_fed, t_fed, pop, bits = _plan_inputs(heterogeneity)
    for participation, cohort in ((1.0, None), (0.63, None), (0.8, 4)):
        j = j_defl.make_plan(j_fed, pop, bits, participation=participation,
                             cohort_size=cohort)
        t = t_defl.make_plan(t_fed, pop, bits, participation=participation,
                             cohort_size=cohort)
        assert [getattr(t, f) for f in PLAN_FIELDS] == [
            getattr(j, f) for f in PLAN_FIELDS]
        assert dataclasses.astuple(t.problem) == dataclasses.astuple(j.problem)
    nominal = j_defl.make_plan(j_fed, pop, bits).T_round
    for factor, participation, cohort, spare in (
            (1.5, 1.0, None, 0), (0.8, 0.7, None, 0), (1.2, 0.9, 4, 2)):
        D = factor * nominal
        j = j_defl.deadline_plan(j_fed, pop, bits, D,
                                 participation=participation,
                                 cohort_size=cohort, spare=spare)
        t = t_defl.deadline_plan(t_fed, pop, bits, D,
                                 participation=participation,
                                 cohort_size=cohort, spare=spare)
        assert [getattr(t, f) for f in PLAN_FIELDS] == [
            getattr(j, f) for f in PLAN_FIELDS]
        assert dataclasses.astuple(t.problem) == dataclasses.astuple(j.problem)
        assert t.solution.method == j.solution.method == "deadline_grid"
    with pytest.raises(ValueError, match="infeasible"):
        t_defl.deadline_plan(t_fed, pop, bits, 1e-9)
    with pytest.raises(ValueError, match="cohort_size"):
        t_defl.deadline_plan(t_fed, pop, bits, nominal, spare=1)


# -- the guard on a run ---------------------------------------------------------

# Every client's update norm in these rounds is 0.2-0.9 (unclipped), so a
# 0.1 threshold clips every client, each by a wide margin.
MAX_NORM = 0.1


def _specs(faults_kw):
    out = []
    for exp, cls in ((j_exp, JFaults), (t_exp, TFaults)):
        spec = exp.get("mnist_smoke")
        out.append(spec.replace(
            fed=dataclasses.replace(spec.fed, compress_updates=True),
            faults=cls(**faults_kw)))
    return out


def _jax_noise(seed, C, rows, rounds):
    draw = jax.jit(jax.vmap(lambda k: j_noise(k, (rows, t_comp.ROW))))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, keys = j_comp.sequential_client_keys(key, C)
        out.append(np.asarray(draw(keys)))
    return out


def _per_round_pair(faults_kw, poison=None):
    """The reference round by round, and the port's same round from each of
    the reference's states with the reference's noise: [(port state before,
    port state after, port record, reference record, reference params
    after)]. poison(data, sim) poisons a sim's device dataset."""
    j_spec, t_spec = _specs(faults_kw)
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    current = {}
    t_sim = t_spec.build(device="cpu", params=params0,
                         noise=lambda g, shape: torch.tensor(current["u"]))
    if poison is not None:
        j_sim._data_dev = poison(j_sim._data_dev, j_sim)
        t_sim._data_dev = poison(t_sim._data_dev, t_sim)
    noise = _jax_noise(j_sim.fed.seed, j_sim.fed.n_devices,
                       t_comp.n_rows(params0), ROUNDS)
    st, out = j_sim.init(), []
    for k in range(ROUNDS):
        j_before = jax.device_get(st)
        st, res = j_sim.run(st, max_rounds=1)
        current["u"] = noise[k]
        start = dataclasses.replace(
            t_sim.init(j_before.seed),
            params_C=to_torch(jax.tree.map(np.asarray, j_before.params_C),
                              device="cpu"),
            round=j_before.round, sim_time=j_before.sim_time,
            stream=j_before.stream, data=j_before.data)
        end, t_res = t_sim.run(start, max_rounds=1)
        out.append((start, end, t_res.history[0], res.history[0],
                    jax.device_get(st.params_C)))
    return t_sim, out


def _assert_round(rec, j_rec, end, j_params):
    assert (rec.round, rec.sim_time, rec.uplink_bits, rec.n_participants,
            rec.rejected) == (j_rec.round, j_rec.sim_time, j_rec.uplink_bits,
                              j_rec.n_participants, j_rec.rejected)
    np.testing.assert_allclose(rec.train_loss, j_rec.train_loss,
                               rtol=LOSS_RTOL)
    for t, j in zip(leaves(to_numpy(end.params_C)), jax.tree.leaves(j_params)):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=PARAM_ATOL)


def test_update_norm_clipping_matches_reference():
    t_sim, rounds = _per_round_pair(dict(max_update_norm=MAX_NORM))
    assert t_sim._guard == (MAX_NORM, True)
    local = t_rounds.local_steps_fn(t_sim.value_and_grad, t_sim.opt)
    for start, end, rec, j_rec, j_params in rounds:
        # The unclipped norms of this round: every one well above the
        # threshold, so the frameworks' sum orders cannot flip a decision.
        iters, _ = t_sim._materialize(start)
        idx = stack_chunk_indices(iters, 1, t_sim.fed.local_rounds)[0]
        batch = type(iters[0]).batch_from(
            t_sim._data_dev, torch.from_numpy(idx.astype(np.int64)))
        new_p, _, _ = local(start.params_C, start.opt_C, batch)
        norms = torch.sqrt(sum(
            torch.sum((a - b).reshape(a.shape[0], -1) ** 2, dim=1)
            for a, b in zip(leaves(new_p), leaves(start.params_C))))
        assert float(norms.min()) >= 1.5 * MAX_NORM, norms
        _assert_round(rec, j_rec, end, j_params)
        # The aggregate moved by at most the clip norm.
        moved = torch.sqrt(sum(torch.sum((a[0] - b[0]) ** 2) for a, b in
                               zip(leaves(end.params_C),
                                   leaves(start.params_C))))
        assert float(moved) <= MAX_NORM * (1 + 1e-5)


def _poison_client0(data, sim):
    """NaN in every sample of client 0's partition."""
    rows = sim._data_src(0)[0].indices
    x = np.array(data["x"])
    x[rows] = np.nan
    if isinstance(data["x"], torch.Tensor):
        return {**data, "x": torch.from_numpy(x)}
    return {**data, "x": jax.numpy.asarray(x)}


def test_nan_client_rejected_from_aggregation():
    # min_quorum=1 makes the model active: the guard rejects only.
    t_sim, rounds = _per_round_pair(dict(min_quorum=1), poison=_poison_client0)
    assert t_sim._guard == (float("inf"), True)
    for start, end, rec, j_rec, j_params in rounds:
        assert rec.n_participants == t_sim.fed.n_devices - 1
        assert rec.rejected is False
        assert np.isfinite(rec.train_loss)
        assert all(bool(torch.isfinite(p).all()) for p in leaves(end.params_C))
        _assert_round(rec, j_rec, end, j_params)
