"""The port's scenario engine and scenario runs against the reference.

  * every registered scenario's population and per-round draws
    (`draw_chunk`: masks, channel, retransmission attempts) are the
    reference's exactly, for two seeds, and a stream restored from
    `state()` in the middle of a crash epoch continues the reference's;
  * `plan_for_scenario` (with `deadline_plan` under a deadline) and the
    registered `mnist_storm`'s population and plan are exact;
  * compressed `mnist_smoke` runs under `dropout`, `hetero_storm` and
    `unreliable_edge` (with a quorum that rejects rounds), the port's
    quantizer noise replaced by the reference's: the clock, uplink bits,
    participant counts and quorum flags of a 6-round run are exact; each
    round, from the reference's state before it, gives a train loss
    within 1e-5 relative and params within 5e-4; a rejected round leaves
    the params bit for bit as they were; uncompressed, the whole 6-round
    histories hold the same bounds.

Over a whole compressed history the losses are not held to 1e-5: one
stochastic-rounding code that flips between the frameworks (a float32
sum in another order) moves a parameter by a quantizer step, and the
run amplifies it (hetero_storm's round-6 loss differs by 6e-4 after a
flip, while the same run uncompressed agrees to 4e-7). So the float
bounds are stated per round from equal states, as run_fleet's member
contract is.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFed
from repro.federated import compression as j_comp
from repro.federated import experiment as j_exp
from repro.federated import scenarios as j_scen
from repro.federated.faults import FaultModel as JFaults
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.convert import to_numpy, to_torch
from repro_torch.federated import compression as t_comp
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import scenarios as t_scen
from repro_torch.federated.faults import FaultModel as TFaults
from repro_torch.utils.tree import leaves

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
ROUNDS = 6
# The seven scenarios scenarios.py registers and `diurnal_edge`, which
# traces.py registers (experiment.py imports it).
NAMES = t_scen.names()
PLAN_FIELDS = ("b", "theta", "V", "H_pred", "T_cm", "T_cp", "T_round",
               "overall_pred", "update_bits")


def test_registry_is_the_references():
    assert len(NAMES) == 8
    assert NAMES == j_scen.names()
    for name in NAMES:
        j, t = j_scen.get(name), t_scen.get(name)
        j_fields = dataclasses.asdict(j)
        t_fields = dataclasses.asdict(t)
        assert t_fields == j_fields
        assert t.expected_participation == j.expected_participation


def _realizations_equal(t, j):
    for f in ("mask", "clock_mask", "h", "attempts", "h_att"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", NAMES)
def test_population_and_draw_chunk_match(name, seed):
    M = 10
    j_pop = j_scen.get(name).population(M, seed=seed)
    t_pop = t_scen.get(name).population(M, seed=seed)
    for f in ("G", "f", "p", "h"):
        np.testing.assert_array_equal(getattr(t_pop, f), getattr(j_pop, f))
    j_st = j_scen.get(name).stream(j_pop, seed)
    t_st = t_scen.get(name).stream(t_pop, seed)
    for rounds in (1, 5, 4):
        _realizations_equal(t_st.draw_chunk(rounds), j_st.draw_chunk(rounds))
    # One round at a time continues the same stream.
    _realizations_equal(t_st.next_round(), j_st.next_round())


def test_state_roundtrip_mid_crash_epoch():
    """A stream restored from a snapshot taken while clients are down
    (crash/rejoin) continues the reference's draws."""
    sc_j, sc_t = j_scen.get("unreliable_edge"), t_scen.get("unreliable_edge")
    pop = sc_t.population(10, seed=3)
    j_st, t_st = sc_j.stream(sc_j.population(10, seed=3), 3), sc_t.stream(
        pop, 3)
    for _ in range(50):
        _realizations_equal(t_st.draw_chunk(1), j_st.draw_chunk(1))
        if t_st.state()["down"].any():
            break
    snap = t_st.state()
    assert snap["down"].any(), "no crash epoch in 50 rounds"
    np.testing.assert_array_equal(snap["down"], j_st.state()["down"])
    restored = sc_t.stream(pop, 3)
    restored.set_state(snap)
    want = j_st.draw_chunk(6)
    _realizations_equal(restored.draw_chunk(6), want)
    _realizations_equal(t_st.draw_chunk(6), want)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_plan_for_scenario_exact(name, compress):
    kw = dict(n_devices=10, epsilon=0.01, nu=2.0, c=4.0, lr=0.05,
              compress_updates=compress)
    bits = t_exp.get("mnist_paper").update_bits()
    j = j_scen.plan_for_scenario(JFed(**kw), name, bits, seed=1)
    t = t_scen.plan_for_scenario(TFed(**kw), name, bits, seed=1)
    assert [getattr(t, f) for f in PLAN_FIELDS] == [
        getattr(j, f) for f in PLAN_FIELDS]
    assert t.solution.method == j.solution.method
    assert t.problem.M == j.problem.M


def test_mnist_storm_population_and_plan_exact():
    j, t = j_exp.get("mnist_storm"), t_exp.get("mnist_storm")
    assert t.scenario == j.scenario == "hetero_storm"
    assert t.effective_faults() is None and j.effective_faults() is None
    j_pop, t_pop = j.device_population(), t.device_population()
    for f in ("G", "f", "p", "h"):
        np.testing.assert_array_equal(getattr(t_pop, f), getattr(j_pop, f))
    jp, tp = j.resolve_plan(), t.resolve_plan()
    assert [getattr(tp, f) for f in PLAN_FIELDS] == [
        getattr(jp, f) for f in PLAN_FIELDS]
    assert dataclasses.asdict(t.resolve_fed()) == dataclasses.asdict(
        j.resolve_fed())
    ja, ta = j.analytic_plan(), t.analytic_plan()
    assert [getattr(ta, f) for f in PLAN_FIELDS] == [
        getattr(ja, f) for f in PLAN_FIELDS]


# -- runs --------------------------------------------------------------------

# scenario: the FaultModel laid over it (kwargs), or None.
RUNS = {
    "dropout": None,
    "hetero_storm": None,
    # All 3 clients must report: rounds that lose one are rejected.
    "unreliable_edge": dict(min_quorum=3, quorum_policy="reject",
                            redispatch_cost=0.25),
}


def _spec(exp, faults_cls, name):
    spec = exp.get("mnist_smoke")
    fk = RUNS[name]
    return spec.replace(
        fed=dataclasses.replace(spec.fed, compress_updates=True),
        scenario=name, faults=None if fk is None else faults_cls(**fk))


def _jax_noise(seed, C, rows, rounds):
    """The reference's per-round (C, rows, 1024) quantizer noise, its keys
    drawn in the order its scan chunk draws them."""
    draw = jax.jit(jax.vmap(lambda k: j_noise(k, (rows, t_comp.ROW))))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, keys = j_comp.sequential_client_keys(key, C)
        out.append(np.asarray(draw(keys)))
    return out


def _port_state(t_sim, j_state):
    """The port's state equal to a host snapshot of the reference's: the
    same params, cursors and host streams (the snapshot formats are the
    same); the noise comes from the replay, not from the generator."""
    return dataclasses.replace(
        t_sim.init(j_state.seed),
        params_C=to_torch(jax.tree.map(np.asarray, j_state.params_C),
                          device="cpu"),
        round=j_state.round, sim_time=j_state.sim_time,
        stream=j_state.stream, data=j_state.data)


@pytest.fixture(scope="module", params=list(RUNS))
def run_pair(request):
    name = request.param
    j_spec, t_spec = _spec(j_exp, JFaults, name), _spec(t_exp, TFaults, name)
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    # The reference round by round: its state before each round, and each
    # round's record (its clock continues through the state).
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
    t_state, t_res = t_sim.run(t_sim.init(), max_rounds=ROUNDS, eval_every=3)
    current = {}
    one = t_spec.build(device="cpu", params=params0,
                       noise=lambda g, shape: torch.tensor(current["u"]))
    per_round = []
    for k in range(ROUNDS):
        current["u"] = noise[k]
        start = _port_state(one, before[k])
        end, res = one.run(start, max_rounds=1)
        per_round.append((start, end, res.history[0]))
    return {"name": name, "j_hist": j_hist, "after": after,
            "t_res": t_res, "t_state": t_state, "j_final": after[-1],
            "per_round": per_round, "t_sim": t_sim}


def test_run_clock_bits_participants_exact(run_pair):
    j_hist, t_hist = run_pair["j_hist"], run_pair["t_res"].history
    assert len(t_hist) == len(j_hist) == ROUNDS
    for j, t in zip(j_hist, t_hist):
        assert (t.round, t.sim_time, t.T_cm, t.T_cp, t.uplink_bits,
                t.n_participants, t.rejected) == (
            j.round, j.sim_time, j.T_cm, j.T_cp, j.uplink_bits,
            j.n_participants, j.rejected)
    assert isinstance(t_hist[0].n_participants, int)
    final = run_pair["j_final"]
    st = run_pair["t_state"]
    assert (st.round, st.sim_time) == (final.round, final.sim_time)
    # The stream snapshot in the state is the reference's, value for value.
    assert repr(st.stream) == repr(final.stream)
    assert repr(st.data) == repr(final.data)
    assert run_pair["t_sim"].label == "mnist_smoke"
    if run_pair["name"] == "unreliable_edge":
        assert 0 < run_pair["t_res"].rounds_rejected < ROUNDS
    else:
        assert all(r.rejected is None for r in t_hist)
        assert min(r.n_participants for r in t_hist) < 3


def test_each_round_from_equal_states_within_tolerance(run_pair):
    for (start, end, rec), j_rec, j_after in zip(
            run_pair["per_round"], run_pair["j_hist"], run_pair["after"]):
        assert (rec.round, rec.sim_time, rec.n_participants,
                rec.rejected) == (j_rec.round, j_rec.sim_time,
                                  j_rec.n_participants, j_rec.rejected)
        np.testing.assert_allclose(rec.train_loss, j_rec.train_loss,
                                   rtol=LOSS_RTOL)
        for t, j in zip(leaves(to_numpy(end.params_C)),
                        jax.tree.leaves(j_after.params_C)):
            np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                       atol=PARAM_ATOL)
        if rec.rejected:
            # A quorum-rejected round is a no-op on the model, bit for bit.
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(end.params_C), leaves(start.params_C)))


def _max_gaps(t_hist, j_hist, t_params, j_params):
    """(largest relative loss gap a round, largest params gap at the end)."""
    loss = [abs(t.train_loss - j.train_loss) / abs(j.train_loss)
            for t, j in zip(t_hist, j_hist)]
    param = max(float(np.abs(t - np.asarray(j)).max()) for t, j in
                zip(leaves(to_numpy(t_params)), jax.tree.leaves(j_params)))
    return loss, param


@pytest.mark.parametrize("name", list(RUNS))
def test_uncompressed_whole_histories_within_tolerance(name, record_property):
    """Without compression no stochastic-rounding code can flip, and the
    whole 6-round history holds the float bounds. Beside it, the
    compressed run's whole-history gaps are printed (the drift the module
    docstring describes; the per-round test bounds them)."""
    specs = []
    for exp, cls in ((j_exp, JFaults), (t_exp, TFaults)):
        spec = _spec(exp, cls, name)
        specs.append(spec.replace(fed=dataclasses.replace(
            spec.fed, compress_updates=False)))
    params0 = jax.device_get(j_cnn.init_cnn(specs[0].model_config(),
                                            jax.random.PRNGKey(0)))
    j_sim, t_sim = specs[0].build(), specs[1].build(device="cpu",
                                                    params=params0)
    _, j_res = j_sim.run(j_sim.init(), max_rounds=ROUNDS, eval_every=3)
    _, t_res = t_sim.run(t_sim.init(), max_rounds=ROUNDS, eval_every=3)
    for t, j in zip(t_res.history, j_res.history):
        assert (t.round, t.sim_time, t.uplink_bits, t.n_participants,
                t.rejected) == (j.round, j.sim_time, j.uplink_bits,
                                j.n_participants, j.rejected)
    loss, param = _max_gaps(t_res.history, j_res.history, t_res.params,
                            j_res.params)
    assert max(loss) <= LOSS_RTOL
    assert param <= PARAM_ATOL
    print(f"{name} uncompressed: loss gaps a round "
          f"{[float(f'{g:.2g}') for g in loss]}, params gap {param:.2g}")
    record_property("uncompressed", (loss, param))


def test_compressed_whole_history_gaps_printed(run_pair, record_property):
    """The compressed run's whole-history gaps against the reference's,
    printed (not bounded: see the module docstring)."""
    t_res = run_pair["t_res"]
    loss, param = _max_gaps(t_res.history, run_pair["j_hist"],
                            run_pair["t_state"].params_C,
                            run_pair["j_final"].params_C)
    print(f"{run_pair['name']} compressed: loss gaps a round "
          f"{[float(f'{g:.2g}') for g in loss]}, params gap {param:.2g}")
    record_property("compressed", (loss, param))
    assert all(np.isfinite(loss)) and np.isfinite(param)
