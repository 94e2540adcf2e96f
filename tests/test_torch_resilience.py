"""Resilience in the port: zero participation, the divergence guard,
auto-recovery and fleets under a scenario.

  * a round in which no client participates leaves the params bit for
    bit as they were and reports a NaN loss, on the rounds the
    reference's does (participant counts and clock exact, the run
    uncompressed within 1e-5 / 5e-4 of the reference's);
  * a run that diverges (lr 1e5 with the guard letting non-finite
    updates through) raises DivergenceError on the reference's round,
    with its guard and finite mask, carrying the last-good state: the
    state before the offending chunk, equal bit for bit to a run that
    stops there; no tensor of a state passed to run() is written;
  * run(recovery=RecoveryPolicy(...)) restarts with the reference's audit
    trail (attempt, rounds, lr scale, guard norm) and clock, and an
    exhausted budget re-raises;
  * a compressed fleet under `dropout` (and under `unreliable_edge` with
    a quorum) repeats its members' runs alone: clock, bits, participant
    counts and quorum flags exact, losses within 1e-5 relative, params
    within 5e-4, final states' cursors and host streams equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.federated import experiment as j_exp
from repro.federated import scenarios as j_scen
from repro.federated.faults import DivergenceError as JDivergence
from repro.federated.faults import FaultModel as JFaults
from repro.federated.faults import RecoveryPolicy as JRecovery
from repro.models import cnn as j_cnn
from repro_torch.convert import to_numpy
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import scenarios as t_scen
from repro_torch.federated.faults import DivergenceError as TDivergence
from repro_torch.federated.faults import FaultModel as TFaults
from repro_torch.federated.faults import RecoveryPolicy as TRecovery
from repro_torch.utils.tree import leaves

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4


def _params0(spec):
    return jax.device_get(j_cnn.init_cnn(spec.model_config(),
                                         jax.random.PRNGKey(spec.seed)))


def _state_tensors(state):
    return leaves(state.params_C) + leaves(state.opt_C) + [state.rng]


# -- zero participation ----------------------------------------------------------

def _blackout(mod):
    # M = 3 at 70% dropout: about one round in three has no participant.
    return mod.Scenario("blackout", "heavy dropout", dropout=0.7)


def test_zero_participation_round_keeps_params():
    j_spec = j_exp.get("mnist_smoke").replace(scenario=_blackout(j_scen))
    t_spec = t_exp.get("mnist_smoke").replace(scenario=_blackout(t_scen))
    j_sim = j_spec.build()
    t_sim = t_spec.build(device="cpu", params=_params0(j_spec))
    j_st, t_st = j_sim.init(), t_sim.init()
    zero = 0
    for _ in range(6):
        j_st, j_res = j_sim.run(j_st, max_rounds=1)
        before = t_st
        t_st, t_res = t_sim.run(t_st, max_rounds=1)
        j, t = j_res.history[0], t_res.history[0]
        assert (t.round, t.sim_time, t.T_cm, t.T_cp, t.uplink_bits,
                t.n_participants) == (j.round, j.sim_time, j.T_cm, j.T_cp,
                                      j.uplink_bits, j.n_participants)
        if t.n_participants == 0:
            zero += 1
            assert np.isnan(t.train_loss) and np.isnan(j.train_loss)
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(t_st.params_C), leaves(before.params_C)))
        else:
            np.testing.assert_allclose(t.train_loss, j.train_loss,
                                       rtol=LOSS_RTOL)
        for a, b in zip(leaves(to_numpy(t_st.params_C)),
                        jax.tree.leaves(j_st.params_C)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL)
    assert 0 < zero < 6


# -- divergence and recovery -------------------------------------------------------

DIVERGE = dict(max_update_norm=1e9, reject_nonfinite=False)


def _diverging(exp, faults_cls, lr=1e5):
    """mnist_smoke at lr 1e5: the loss goes non-finite at round 3; the
    guard clips at a norm nothing reaches and lets non-finite updates
    through, so the run-level divergence guard is what catches it."""
    spec = exp.get("mnist_smoke")
    return spec.replace(fed=dataclasses.replace(spec.fed, lr=lr),
                        faults=faults_cls(**DIVERGE))


@pytest.fixture(scope="module")
def diverging():
    j_spec = _diverging(j_exp, JFaults)
    params0 = _params0(j_spec)
    return (j_spec.build(),
            _diverging(t_exp, TFaults).build(device="cpu", params=params0))


def test_divergence_error_carries_last_good_state(diverging):
    j_sim, t_sim = diverging
    with pytest.raises(JDivergence) as j_err:
        j_sim.run(j_sim.init(), max_rounds=6, eval_every=2)
    state0 = t_sim.init()
    copies = [x.clone() for x in _state_tensors(state0)]
    with pytest.raises(TDivergence) as t_err:
        t_sim.run(state0, max_rounds=6, eval_every=2)
    j, t = j_err.value, t_err.value
    assert t.round == j.round == 3
    assert t.guard == j.guard == (1e9, False)
    assert t.faults == TFaults(**DIVERGE)
    assert [r.round for r in t.history] == [r.round for r in j.history]
    np.testing.assert_array_equal(t.finite_mask, j.finite_mask)
    assert t.finite_mask.dtype == np.bool_
    # The last-good state is the one at the start of the offending chunk.
    assert t.state.round == j.state.round == 2
    assert t.state.sim_time == j.state.sim_time
    assert repr(t.state.stream) == repr(j.state.stream)
    assert repr(t.state.data) == repr(j.state.data)
    good, _ = t_sim.run(t_sim.init(), max_rounds=2)
    assert all(torch.equal(a, b) for a, b in
               zip(_state_tensors(t.state), _state_tensors(good)))
    assert repr(t.state.data) == repr(good.data)
    # run() wrote into no tensor of the state it was given.
    assert all(torch.equal(a, b) for a, b in
               zip(_state_tensors(state0), copies))


def test_recovery_audit_trail_matches_reference(diverging):
    j_sim, t_sim = diverging
    kw = dict(max_restarts=8, lr_backoff=1e-2, tighten_guard=0.5)
    # Chunks of 3: the last-good state is round 0's (round 2's params
    # have already blown up to ~1e21, from which no lr recovers).
    _, j_res = j_sim.run(j_sim.init(), max_rounds=8, eval_every=3,
                         recovery=JRecovery(**kw))
    _, t_res = t_sim.run(t_sim.init(), max_rounds=8, eval_every=3,
                         recovery=TRecovery(**kw))
    keys = ("attempt", "round", "resume_round", "lr_scale", "max_update_norm")
    assert len(t_res.restarts) == len(j_res.restarts) == 1
    assert [[a[k] for k in keys] for a in t_res.restarts] == [
        [a[k] for k in keys] for a in j_res.restarts]
    assert t_res.restarts[0]["max_update_norm"] == 5e8
    assert [r.round for r in t_res.history] == list(range(1, 9))
    assert [r.sim_time for r in t_res.history] == [
        r.sim_time for r in j_res.history]
    assert all(np.isfinite(r.train_loss) for r in t_res.history)


def test_recovery_budget_exhausted_reraises(diverging):
    _, t_sim = diverging
    with pytest.raises(TDivergence) as err:
        t_sim.run(t_sim.init(), max_rounds=6, eval_every=2,
                  recovery=TRecovery(max_restarts=1, lr_backoff=0.9))
    assert err.value.round == 3
    with pytest.raises(ValueError, match="lr_backoff"):
        t_sim.run(t_sim.init(), max_rounds=2,
                  recovery=TRecovery(lr_backoff=0.0))


# -- fleets under a scenario --------------------------------------------------------

SEEDS = (0, 1, 2)


@pytest.mark.parametrize("scenario, faults", [
    ("dropout", None),
    ("unreliable_edge", TFaults(min_quorum=3, quorum_policy="reject")),
])
def test_scenario_fleet_members_repeat_runs_alone(scenario, faults):
    spec = t_exp.get("mnist_smoke")
    sim = spec.replace(
        fed=dataclasses.replace(spec.fed, compress_updates=True),
        scenario=scenario, faults=faults).build(device="cpu")
    fleet = sim.run_fleet(seeds=SEEDS, max_rounds=5, eval_every=2)
    participants = set()
    for s, st, res in zip(SEEDS, fleet.states, fleet.results):
        solo_state, solo = sim.run(sim.init(s), max_rounds=5, eval_every=2)
        assert len(res.history) == len(solo.history) == 5
        for f, o in zip(res.history, solo.history):
            assert (f.round, f.sim_time, f.T_cm, f.T_cp, f.uplink_bits,
                    f.n_participants, f.rejected, f.test_acc) == (
                o.round, o.sim_time, o.T_cm, o.T_cp, o.uplink_bits,
                o.n_participants, o.rejected, o.test_acc)
            participants.add(f.n_participants)
        np.testing.assert_allclose([f.train_loss for f in res.history],
                                   [o.train_loss for o in solo.history],
                                   rtol=LOSS_RTOL)
        for a, b in zip(leaves(st.params_C), leaves(solo_state.params_C)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=PARAM_ATOL)
        assert (st.round, st.sim_time) == (solo_state.round,
                                           solo_state.sim_time)
        assert repr(st.stream) == repr(solo_state.stream)
        assert repr(st.data) == repr(solo_state.data)
        assert torch.equal(st.rng, solo_state.rng)
    # The members' masks differ: the fleet saw more than one count.
    assert len(participants) > 1
