"""`Simulator.run_fleet`: the members folded into the client axis.

Against runs alone (the member contract, run_fleet's docstring): on the
CPU every fleet member repeats `run(init(s))` — clock, bits and rounds
exactly, losses within LOSS_RTOL and params within PARAM_ATOL over whole
histories (a member fed another member's noise misses the loss bound
~900-fold within 5 rounds) — with compression, and with the early stops
(target_acc, max_sim_time) against runs alone that stop the same way,
down to their final states. Against the reference: an uncompressed fleet
of `mnist_smoke` from the reference's initial model matches the
reference's `run_fleet` member by member (clock exact, losses and params
within the same bounds, test accuracy exact). A compressed fleet round
quantizes all members' clients in ONE call; `states=` with mixed round
cursors raises; `summary()` is the reference's formula.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.federated import experiment as j_exp
from repro.federated import simulation as j_simulation
from repro.models import cnn as j_cnn
from repro_torch.convert import to_numpy
from repro_torch.federated import compression
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import simulation
from repro_torch.federated.client import stack_chunk_indices
from repro_torch.utils.tree import leaves

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
SEEDS = (0, 1, 2)


def _sim(compress=True, **kw):
    spec = t_exp.get("mnist_smoke")
    spec = spec.replace(fed=dataclasses.replace(spec.fed,
                                                compress_updates=compress),
                        **kw)
    return spec.build(device="cpu")


def _assert_member(fleet_res, fleet_state, solo_res, solo_state):
    """A fleet member against the run alone: the contract's bounds over
    the whole history, and the final state's cursors exactly."""
    assert len(fleet_res.history) == len(solo_res.history)
    for f, s in zip(fleet_res.history, solo_res.history):
        assert (f.round, f.sim_time, f.T_cm, f.T_cp, f.uplink_bits,
                f.test_acc) == (s.round, s.sim_time, s.T_cm, s.T_cp,
                                s.uplink_bits, s.test_acc)
    np.testing.assert_allclose([f.train_loss for f in fleet_res.history],
                               [s.train_loss for s in solo_res.history],
                               rtol=LOSS_RTOL)
    for f, s in zip(leaves(fleet_state.params_C), leaves(solo_state.params_C)):
        assert f.shape == s.shape
        np.testing.assert_allclose(f.numpy(), s.numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    assert (fleet_state.seed, fleet_state.round, fleet_state.sim_time) == (
        solo_state.seed, solo_state.round, solo_state.sim_time)
    assert torch.equal(fleet_state.rng, solo_state.rng)
    assert repr(fleet_state.data) == repr(solo_state.data)


def test_compressed_fleet_members_repeat_runs_alone(record_property):
    sim = _sim()
    fleet = sim.run_fleet(seeds=SEEDS, max_rounds=5, eval_every=2)
    assert len(fleet) == len(SEEDS)
    identical = 0
    for s, st, res in zip(SEEDS, fleet.states, fleet.results):
        solo_state, solo = sim.run(sim.init(s), max_rounds=5, eval_every=2)
        _assert_member(res, st, solo, solo_state)
        assert res.label == f"mnist_smoke[seed={s}]"
        assert [r.round for r in res.history] == [1, 2, 3, 4, 5]
        assert [r.test_acc is not None for r in res.history] == [
            False, True, False, True, True]
        identical += all(torch.equal(a, b) for a, b in
                         zip(leaves(st.params_C), leaves(solo_state.params_C)))
    record_property("members_bit_identical", identical)
    # The members drew different batches and noise: their runs differ.
    finals = {r.history[-1].train_loss for r in fleet.results}
    assert len(finals) == len(SEEDS)
    # A fleet continues from its states as the runs alone continue.
    more = sim.run_fleet(states=fleet.states, max_rounds=2, eval_every=2)
    for st, res, s in zip(more.states, more.results, SEEDS):
        solo_state, _ = sim.run(sim.init(s), max_rounds=5, eval_every=2)
        solo_state, solo = sim.run(solo_state, max_rounds=2, eval_every=2)
        _assert_member(res, st, solo, solo_state)


def test_fleet_quantizes_once_a_round(monkeypatch):
    sim = _sim()
    rows = compression.n_rows(sim.params(sim.init()))
    calls = []
    quantize = compression.ops.quantize

    def counting(x, u):
        calls.append(tuple(x.shape))
        return quantize(x, u)

    monkeypatch.setattr(compression.ops, "quantize", counting)
    sim.run_fleet(seeds=SEEDS, max_rounds=4, eval_every=3)
    C = sim.fed.n_devices
    assert calls == [(len(SEEDS) * C * rows, compression.ROW)] * 4


def test_uncompressed_fleet_matches_reference_fleet():
    j_spec = j_exp.get("mnist_smoke")
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_fleet = j_spec.build().run_fleet(seeds=SEEDS, max_rounds=4,
                                       eval_every=2)
    t_sim = t_exp.get("mnist_smoke").build(device="cpu", params=params0)
    t_fleet = t_sim.run_fleet(seeds=SEEDS, max_rounds=4, eval_every=2)
    for j, t in zip(j_fleet.results, t_fleet.results):
        assert t.label == j.label
        assert len(t.history) == len(j.history) == 4
        for a, b in zip(t.history, j.history):
            assert (a.round, a.sim_time, a.T_cm, a.T_cp, a.uplink_bits,
                    a.test_acc) == (b.round, b.sim_time, b.T_cm, b.T_cp,
                                    b.uplink_bits, b.test_acc)
            np.testing.assert_allclose(a.train_loss, b.train_loss,
                                       rtol=LOSS_RTOL)
            # The eval hooks report accuracy only: test_loss is NaN where
            # an eval ran, None elsewhere, on both sides.
            assert (a.test_loss is None) == (b.test_loss is None) == (
                b.test_acc is None)
            if b.test_loss is not None:
                assert np.isnan(a.test_loss) and np.isnan(b.test_loss)
        for a, b in zip(leaves(to_numpy(t.params)),
                        jax.tree.leaves(jax.device_get(j.params))):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_array_equal(t_fleet.total_times(),
                                  j_fleet.total_times())


def test_target_acc_members_stop_as_runs_alone():
    sim = _sim()
    alone = [sim.run(sim.init(s), max_rounds=6, eval_every=2)[1]
             for s in SEEDS]
    # The target one member reaches at round 2 and another does not: the
    # fleet must slice a stopped member out while the others go on.
    accs = [[r.test_acc for r in res.history if r.test_acc is not None]
            for res in alone]
    target = max(a[0] for a in accs)
    assert any(max(a) < target for a in accs)
    fleet = sim.run_fleet(seeds=SEEDS, max_rounds=6, eval_every=2,
                          target_acc=target)
    rounds = set()
    for s, st, res in zip(SEEDS, fleet.states, fleet.results):
        solo_state, solo = sim.run(sim.init(s), max_rounds=6, eval_every=2,
                                   target_acc=target)
        _assert_member(res, st, solo, solo_state)
        rounds.add(len(res.history))
    assert len(rounds) > 1


def test_max_sim_time_members_stop_and_resume_as_runs_alone():
    sim = _sim()
    T = sim.run(sim.init(), max_rounds=1)[1].history[0].sim_time
    budget = 2.5 * T  # reached at round 3, inside the chunk of rounds 3-4
    fleet = sim.run_fleet(seeds=SEEDS, max_rounds=6, eval_every=2,
                          max_sim_time=budget)
    V = sim.fed.local_rounds
    for s, st, res in zip(SEEDS, fleet.states, fleet.results):
        solo_state, solo = sim.run(sim.init(s), max_rounds=6, eval_every=2,
                                   max_sim_time=budget)
        _assert_member(res, st, solo, solo_state)
        assert [r.round for r in res.history] == [1, 2, 3]
        assert res.history[-1].test_acc is None  # no eval inside a chunk
        # The state's iterators were rewound to round 3: they draw round
        # 4's batches next, as an uninterrupted run's iterators do.
        fresh = sim._data_src(s)
        want = stack_chunk_indices(fresh, 4, V)[3]
        got = stack_chunk_indices(sim._materialize(st)[0], 1, V)[0]
        np.testing.assert_array_equal(got, want)
        # ... and a resumed fleet member continues as the resumed run.
        more = sim.run_fleet(states=[st], max_rounds=2, eval_every=2)
        solo_state, solo = sim.run(solo_state, max_rounds=2, eval_every=2)
        _assert_member(more.results[0], more.states[0], solo, solo_state)
        assert [r.round for r in solo.history] == [4, 5]


def test_fleet_argument_checks():
    sim = _sim()
    st = sim.init(0)
    later, _ = sim.run(sim.init(1), max_rounds=1)
    with pytest.raises(ValueError, match="share a round cursor"):
        sim.run_fleet(states=[st, later], max_rounds=1)
    with pytest.raises(ValueError, match="seeds=... or states="):
        sim.run_fleet(max_rounds=1)
    with pytest.raises(ValueError, match="at least one member"):
        sim.run_fleet(seeds=[], max_rounds=1)
    with pytest.raises(ValueError, match="at least one member"):
        sim.run_fleet(states=[], max_rounds=1)
    with pytest.raises(ValueError, match="max_rounds"):
        sim.run_fleet(seeds=[0], max_rounds=0)
    with pytest.raises(ValueError, match="eval_every"):
        sim.run_fleet(seeds=[0], max_rounds=1, eval_every=0)
    no_eval = _sim(with_eval=False)
    with pytest.raises(ValueError, match="with_eval=True"):
        no_eval.run_fleet(seeds=[0], max_rounds=1, target_acc=0.5)
    # run evaluates with eval_fn, run_fleet with eval_batch_fn: one alone
    # would leave the other without an eval.
    for hooks in ({"eval_fn": sim.eval_fn},
                  {"eval_batch_fn": sim.eval_batch_fn}):
        with pytest.raises(ValueError, match="eval_fn and eval_batch_fn"):
            simulation.Simulator(None, {}, lambda s: [], [], sim.fed, None,
                                 None, device="cpu", **hooks)


def test_summary_is_the_reference_formula():
    sim = _sim(with_eval=False)
    fleet = sim.run_fleet(seeds=SEEDS, max_rounds=3, eval_every=3)
    ref = j_simulation.FleetResult(states=fleet.states,
                                   results=fleet.results)
    assert fleet.summary() == ref.summary()
    np.testing.assert_array_equal(fleet.loss_history(), ref.loss_history())
    np.testing.assert_array_equal(fleet.total_times(), ref.total_times())
    assert fleet.loss_history().shape == (len(SEEDS), 3)
    assert list(fleet) == fleet.results
