"""The port's Study API against the reference's and against its own runs
alone.

  * `cnn_loss_masked` equals the reference's at equal params (loss and
    gradients), and the port's `cnn_loss` on the unpadded batch;
  * a three-arm study with distinct (b, V), uncompressed and under
    `dropout` with compression, mirroring tests/test_study.py: its groups
    are the reference's; the plans, clocks, uplink bits and participants
    of every member are exact against the reference's `Study.run` (run
    from the reference's initial model, with its quantizer noise
    replayed in member order); each round, from the reference's state
    before it, gives losses within LOSS_RTOL and params within
    PARAM_ATOL;
  * each member against its own port `Simulator.run` (the contract of
    `Study.run`'s docstring), and the target_acc and max_sim_time stops
    against port runs alone that stop the same way (the reference's own
    fleet early-stop test fails on this tree, so the port's stops are
    held against its runs alone);
  * grouping='exact', scenarios grouping apart, the solo fallback, the
    validation errors, table()/to_json() against the reference's,
    checkpoint and resume, and the bit_check probe;
  * the envelope's live-prefix local steps against a frozen copy of the
    padded form they replace, the group's stack order (members by V,
    largest first, results in the caller's order), the schedule derived
    again when a member stops, and the envelope's counters.

The reference's per-round states come from its runs alone, which its own
tests hold bit-identical to its study members.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.configs.base import FedConfig as JFed
from repro.federated import compression as j_comp
from repro.federated import study as j_study
from repro.federated.experiment import ExperimentSpec as JSpec
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.convert import to_numpy, to_torch
from repro_torch.federated import compression as t_comp
from repro_torch.federated import mesh_rounds
from repro_torch.federated import study as t_study
from repro_torch.federated.experiment import ExperimentSpec as TSpec
from repro_torch.models import cnn as t_cnn
from repro_torch.optim.api import apply_updates
from repro_torch.optim.sgd import sgd
from repro_torch.utils import spans
from repro_torch.utils.tree import leaves, tree_map

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
ROUNDS = 5
SEEDS = (0, 1)
# label, b, V: the reference test's three arms.
ARMS = (("A", 4, 2), ("B", 8, 1), ("C", 6, 3))
RECORD = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits",
          "n_participants", "rejected")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny models run fastest on one intra-op thread, and the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(spec_cls, fed_cls, b, V, scenario=None, compress=False,
          with_eval=False, lr=0.05):
    return spec_cls(
        fed=fed_cls(n_devices=3, batch_size=b,
                    theta=float(np.exp(-V / 2.0)), nu=2.0, lr=lr,
                    compress_updates=compress),
        model="mnist_cnn_tiny", dataset="mnist", n_train=120, n_test=40,
        seed=0, scenario=scenario, with_eval=with_eval)


def _arms(spec_cls, fed_cls, scenario=None, compress=False, with_eval=False,
          arms=ARMS):
    return [(label, _tiny(spec_cls, fed_cls, b, V, scenario, compress,
                          with_eval)) for label, b, V in arms]


def _params0(cfg_name="mnist_cnn_tiny"):
    """The reference's initial model of the tiny specs (seed 0)."""
    cfg = getattr(j_cnn, cfg_name)()
    return jax.device_get(j_cnn.init_cnn(cfg, jax.random.PRNGKey(0)))


def _record(r):
    return tuple(getattr(r, f) for f in RECORD)


def _jax_noise(seed, C, rows, rounds):
    """The reference's per-round (C, rows, 1024) quantizer noise of a run
    at `seed`, its keys drawn in the order its chunk draws them."""
    draw = jax.jit(jax.vmap(lambda k: j_noise(k, (rows, t_comp.ROW))))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, keys = j_comp.sequential_client_keys(key, C)
        out.append(np.asarray(draw(keys)))
    return out


def _replay(arrays):
    """A noise draw that hands out `arrays` in order (the group draws its
    members' noise in member order, round by round)."""
    it = iter(arrays)
    return lambda g, shape: torch.tensor(next(it))


def _port_state(t_sim, j_state):
    """The port's state equal to a host snapshot of the reference's (the
    stream and data snapshot formats are the same)."""
    return dataclasses.replace(
        t_sim.init(j_state.seed),
        params_C=to_torch(jax.tree.map(np.asarray, j_state.params_C),
                          device="cpu"),
        round=j_state.round, sim_time=j_state.sim_time,
        stream=j_state.stream, data=j_state.data)


def _params_gap(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(leaves(to_numpy(a)), jax.tree.leaves(b)))


def _assert_contract(got, alone, got_state=None, alone_state=None):
    """A study member against its port run alone on the CPU: records
    exact, the whole history's losses and params within the bounds."""
    assert [_record(r) for r in got.history] == [
        _record(r) for r in alone.history]
    assert [r.test_acc for r in got.history] == [
        r.test_acc for r in alone.history]
    np.testing.assert_allclose([r.train_loss for r in got.history],
                               [r.train_loss for r in alone.history],
                               rtol=LOSS_RTOL)
    for x, y in zip(leaves(got.params), leaves(alone.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    if got_state is not None:
        assert (got_state.seed, got_state.round, got_state.sim_time) == (
            alone_state.seed, alone_state.round, alone_state.sim_time)
        assert torch.equal(got_state.rng, alone_state.rng)
        assert repr(got_state.data) == repr(alone_state.data)
        assert repr(got_state.stream) == repr(alone_state.stream)


# -- the masked loss ------------------------------------------------------------


def test_cnn_loss_masked_matches_reference_and_unpadded():
    j_cfg, t_cfg = j_cnn.mnist_cnn_small(), t_cnn.mnist_cnn_small()
    params = jax.device_get(j_cnn.init_cnn(j_cfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    B_env, b = 8, 5
    x = rng.standard_normal((B_env, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, B_env).astype(np.int32)
    mask = (np.arange(B_env) < b).astype(np.float32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_cnn.cnn_loss_masked(j_cfg, p, {"x": x, "y": y}, mask,
                                        np.float32(b))[0]))(params)
    tp = to_torch(params, device="cpu")
    batch = {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}
    t_grads, t_loss = grad_and_value(
        lambda p: t_cnn.cnn_loss_masked(t_cfg, p, batch, torch.tensor(mask),
                                        torch.tensor(np.float32(b))))(tp)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    for t, j in zip(leaves(to_numpy(t_grads)), jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(j).max()))
    # The port's unmasked loss on the unpadded batch.
    u_grads, u_loss = grad_and_value(lambda p: t_cnn.cnn_loss(
        t_cfg, p, {k: v[:b] for k, v in batch.items()}))(tp)
    np.testing.assert_allclose(float(t_loss), float(u_loss), rtol=1e-6)
    for t, u in zip(leaves(t_grads), leaves(u_grads)):
        np.testing.assert_allclose(t.numpy(), u.numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, float(u.abs().max())))
    # A padded row whose cross-entropy is not finite adds an exact 0 to
    # the loss (a multiply by 0 would give NaN).
    xb = batch["x"].clone()
    xb[b:] = float("inf")
    bad = torch.nn.functional.cross_entropy(
        t_cnn.cnn_forward(t_cfg, tp, xb[b:]), batch["y"][b:],
        reduction="none")
    assert not bool(torch.isfinite(bad).any())
    f_loss = t_cnn.cnn_loss_masked(t_cfg, tp, {"x": xb, "y": batch["y"]},
                                   torch.tensor(mask),
                                   torch.tensor(np.float32(b)))
    assert float(f_loss) == float(t_loss)


# -- three arms with distinct (b, V), against the reference ----------------------


@pytest.fixture(scope="module", params=[(None, False), ("dropout", True)],
                ids=["plain", "dropout-compressed"])
def three_arms(request):
    scenario, compress = request.param
    with_eval = scenario is None
    kw = dict(seeds=SEEDS, max_rounds=ROUNDS, eval_every=2,
              target_acc=0.999 if with_eval else None)
    j_arms = _arms(JSpec, JFed, scenario, compress, with_eval)
    t_arms = _arms(TSpec, TFed, scenario, compress, with_eval)
    j_res = j_study.Study(arms=j_arms, bit_check=True, **kw).run()
    params0 = _params0()
    rows = t_comp.n_rows(to_torch(params0, device="cpu"))
    noise = {s: _jax_noise(s, 3, rows, ROUNDS) for s in SEEDS}
    members = [(label, s) for label, _ in t_arms for s in SEEDS]

    def sims_with(arrays):
        replay = _replay(arrays)
        return {label: spec.build(device="cpu", params=params0, noise=replay)
                for label, spec in t_arms}

    # The port's whole study, from the reference's initial model, its
    # noise in member order.
    t_res = t_study.Study(arms=t_arms, **kw).run(sims=sims_with(
        [noise[s][k] for k in range(ROUNDS) for _, s in members]))
    # The reference round by round: each member's state before each round.
    before, j_hist = {}, {}
    for label, spec in j_arms:
        sim = spec.build()
        for s in SEEDS:
            st, states, hist = sim.init(s), [], []
            for _ in range(ROUNDS):
                states.append(jax.device_get(st))
                st, res = sim.run(st, max_rounds=1)
                hist.extend(res.history)
            before[label, s] = states + [jax.device_get(st)]
            j_hist[label, s] = hist
    # Each round as a one-round group from the reference's states.
    per_round = []
    for k in range(ROUNDS):
        sims = sims_with([noise[s][k] for _, s in members])
        group = [t_study._Member(arm=a, label=label, sim=sims[label], seed=s,
                                 state=_port_state(sims[label],
                                                   before[label, s][k]))
                 for a, (label, s) in enumerate(members)]
        per_round.append(t_study._run_group(group, 1, 1, None, None))
    return {"scenario": scenario, "compress": compress, "kw": kw,
            "j_arms": j_arms, "t_arms": t_arms, "j_res": j_res,
            "t_res": t_res, "before": before, "j_hist": j_hist,
            "members": members, "per_round": per_round}


def test_groups_plans_and_records_exact_against_reference(three_arms):
    j_res, t_res = three_arms["j_res"], three_arms["t_res"]
    assert t_res.groups == j_res.groups == (("A", "B", "C"),)
    assert t_res.labels == j_res.labels and t_res.seeds == j_res.seeds
    for label, b, V in ARMS:
        for i, _ in enumerate(SEEDS):
            t, j = t_res[label][i], j_res[label][i]
            assert (t.fed.batch_size, t.fed.local_rounds) == (b, V)
            assert dataclasses.asdict(t.fed) == dataclasses.asdict(j.fed)
            assert t.label == j.label
            assert [_record(r) for r in t.history] == [
                _record(r) for r in j.history]
            assert len(t.history) == ROUNDS
    if three_arms["scenario"] == "dropout":
        parts = [r.n_participants for label, _, _ in ARMS
                 for res in t_res[label] for r in res.history]
        assert min(parts) < 3


def test_each_round_from_reference_state_within_tolerance(three_arms):
    before, j_hist = three_arms["before"], three_arms["j_hist"]
    for k, outs in enumerate(three_arms["per_round"]):
        for (label, s), (st, res) in zip(three_arms["members"], outs):
            rec, j_rec = res.history[0], j_hist[label, s][k]
            assert _record(rec) == _record(j_rec)
            np.testing.assert_allclose(rec.train_loss, j_rec.train_loss,
                                       rtol=LOSS_RTOL)
            assert _params_gap(st.params_C,
                               before[label, s][k + 1].params_C) \
                <= PARAM_ATOL
            assert (st.round, st.sim_time) == (
                before[label, s][k + 1].round,
                before[label, s][k + 1].sim_time)
            assert repr(st.data) == repr(before[label, s][k + 1].data)
            assert repr(st.stream) == repr(before[label, s][k + 1].stream)


def test_members_hold_the_contract_against_port_runs_alone(three_arms):
    """A study with the port's own noise against `run` of each member's
    simulator, seed by seed."""
    t_arms, kw = three_arms["t_arms"], three_arms["kw"]
    res = t_study.Study(arms=t_arms, bit_check=True, **kw).run(device="cpu")
    for label, spec in t_arms:
        sim = spec.build(device="cpu")
        for i, seed in enumerate(SEEDS):
            st, alone = sim.run(sim.init(seed), max_rounds=ROUNDS,
                                eval_every=2, target_acc=kw["target_acc"])
            _assert_contract(res[label][i], alone, res.states[label][i], st)
            assert res[label][i].label == f"{label}[seed={seed}]"


def test_table_and_json_match_reference(three_arms):
    j_res, t_res = three_arms["j_res"], three_arms["t_res"]
    j_head, j_rows = j_res.table()
    t_head, t_rows = t_res.table()
    assert t_head == j_head
    cols = t_head.split(",")
    acc = cols.index("acc")
    for t, j in zip(t_rows, j_rows):
        assert [v for i, v in enumerate(t) if i != acc] == [
            v for i, v in enumerate(j) if i != acc]
        # mean+-std over the seeds: each within one of the 40 test samples
        assert (t[acc] == "") == (j[acc] == "")
        if j[acc] != "":
            for a, b in zip(t[acc].split("+-"), j[acc].split("+-")):
                assert abs(float(a) - float(b)) <= 1 / 40
    t_js, j_js = t_res.to_json(), j_res.to_json()
    assert set(t_js) == set(j_js)
    for k in ("seeds", "target_acc", "max_sim_time", "groups"):
        assert t_js[k] == j_js[k]
    for label in t_res.labels:
        ta, ja = t_js["arms"][label], j_js["arms"][label]
        assert set(ta) == set(ja)
        for k in ("b", "V", "lr", "K", "async", "compress_updates"):
            assert ta[k] == ja[k]
        for t, j in zip(ta["per_seed"], ja["per_seed"]):
            assert set(t) == set(j) and set(t["history"]) == set(j["history"])
            for k in ("seed", "rounds", "total_time", "time_to_target",
                      "rounds_rejected", "restarts"):
                assert t[k] == j[k]
            for k in ("round", "sim_time", "n_participants", "uplink_bits",
                      "rejected"):
                assert t["history"][k] == j["history"][k]
        ts, js = t_res.summary(label), j_res.summary(label)
        for k in ("total_time_mean", "total_time_std", "rounds_mean",
                  "mean_participants", "target_hit_rate", "rounds_rejected",
                  "restarts"):
            np.testing.assert_equal(ts[k], js[k])
    assert np.isfinite(t_res.reduction("A", "B"))
    np.testing.assert_equal(t_res.reduction("A", "B"),
                            j_res.reduction("A", "B"))


# -- grouping ---------------------------------------------------------------------


def _reference_groups(arms, grouping="envelope"):
    """The reference Study's grouping of `arms` (its signature function
    over its specs: what its run() groups by)."""
    order = {}
    for label, spec in arms:
        fed = spec.resolve_fed()
        sig = j_study._group_signature(spec, fed)
        if grouping == "exact":
            sig = sig + (fed.batch_size, fed.local_rounds)
        order.setdefault(sig, []).append(label)
    return tuple(tuple(g) for g in order.values())


def test_exact_grouping_splits_and_matches_runs_alone():
    shape = (("A", 4, 2), ("B", 8, 1))
    arms = _arms(TSpec, TFed, arms=shape)
    res = t_study.Study(arms=arms, seeds=(0,), max_rounds=3,
                        grouping="exact").run(device="cpu")
    assert res.groups == _reference_groups(
        _arms(JSpec, JFed, arms=shape), "exact") == (("A",), ("B",))
    for label, spec in arms:
        sim = spec.build(device="cpu")
        _, alone = sim.run(sim.init(0), max_rounds=3)
        _assert_contract(res[label][0], alone)


def test_different_scenarios_group_separately():
    shape = (("u1", 4, 2), ("u2", 8, 1), ("d1", 4, 2))
    scen = {"u1": "uniform", "u2": "uniform", "d1": "dropout"}

    def arms(spec_cls, fed_cls):
        return [(label, spec.replace(scenario=scen[label]))
                for label, spec in _arms(spec_cls, fed_cls, arms=shape)]

    res = t_study.Study(arms=arms(TSpec, TFed), seeds=(0,),
                        max_rounds=2).run(device="cpu")
    assert res.groups == _reference_groups(arms(JSpec, JFed)) == (
        ("u1", "u2"), ("d1",))


# -- early stops against runs alone --------------------------------------------------


def test_max_sim_time_stops_members_as_runs_alone():
    """Arms with larger V cross the clock budget earlier and leave the
    stack (with their envelope masks): the slow arm comes first, so the
    fast arm's rows move up the stack when it stops."""
    shape = (("slow", 4, 3), ("fast", 4, 1))
    arms = _arms(TSpec, TFed, arms=shape)
    budget = 0.5
    res = t_study.Study(arms=arms, seeds=SEEDS, max_rounds=6, eval_every=2,
                        max_sim_time=budget).run(device="cpu")
    assert res["slow"][0].rounds < res["fast"][0].rounds
    for label, spec in arms:
        sim = spec.build(device="cpu")
        for i, seed in enumerate(SEEDS):
            st, alone = sim.run(sim.init(seed), max_rounds=6, eval_every=2,
                                max_sim_time=budget)
            _assert_contract(res[label][i], alone, res.states[label][i], st)
    # The stop falls on the reference's round too.
    j_arms = _arms(JSpec, JFed, arms=shape)
    for label, spec in j_arms:
        sim = spec.build()
        _, j_alone = sim.run(sim.init(0), max_rounds=6, eval_every=2,
                             max_sim_time=budget)
        assert [_record(r) for r in res[label][0].history] == [
            _record(r) for r in j_alone.history]


def test_target_acc_stops_members_as_runs_alone():
    """A member that reaches target_acc leaves the group while the others
    go on; its history and final state are its run alone's."""
    base = TSpec(fed=TFed(n_devices=3, batch_size=8, theta=0.62, lr=0.2),
                 model="mnist_cnn_small", dataset="mnist", n_train=240,
                 n_test=80)
    arms = [("b8", base),
            ("b4", base.replace(fed=dataclasses.replace(base.fed,
                                                        batch_size=4)))]
    seeds, target = (0, 1, 2), 0.15
    res = t_study.Study(arms=arms, seeds=seeds, max_rounds=8, eval_every=2,
                        target_acc=target).run(device="cpu")
    rounds = [r.rounds for label, _ in arms for r in res[label]]
    assert min(rounds) < 8 and max(rounds) == 8, rounds
    for label, spec in arms:
        sim = spec.build(device="cpu")
        for i, seed in enumerate(seeds):
            st, alone = sim.run(sim.init(seed), max_rounds=8, eval_every=2,
                                target_acc=target)
            _assert_contract(res[label][i], alone, res.states[label][i], st)


def test_target_acc_requires_eval():
    with pytest.raises(ValueError, match="eval"):
        t_study.Study(arms=[("A", _tiny(TSpec, TFed, 4, 1))], target_acc=0.5,
                      max_rounds=2).run(device="cpu")


# -- fallbacks, validation, padding ----------------------------------------------------


def test_solo_fallback_for_sims_without_masked_loss():
    spec_a, spec_b = _tiny(TSpec, TFed, 4, 2), _tiny(TSpec, TFed, 8, 1)
    sims = {"A": spec_a.build(device="cpu"), "B": spec_b.build(device="cpu")}
    sims["B"].masked_loss_fn = None  # strip the envelope capability
    res = t_study.Study(arms=[("A", spec_a), ("B", spec_b)], seeds=SEEDS,
                        max_rounds=3).run(sims=sims)
    assert res.groups == (("A",), ("B",))
    for label, spec in (("A", spec_a), ("B", spec_b)):
        sim = spec.build(device="cpu")
        for i, seed in enumerate(SEEDS):
            _, alone = sim.run(sim.init(seed), max_rounds=3)
            _assert_contract(res[label][i], alone)
            if label == "B":  # run alone: the very same computation
                assert res[label][i].history[-1].train_loss == \
                    alone.history[-1].train_loss


def test_study_validation():
    spec = _tiny(TSpec, TFed, 4, 1)
    with pytest.raises(ValueError, match="at least one arm"):
        t_study.Study(arms=[])
    with pytest.raises(ValueError, match="duplicate"):
        t_study.Study(arms=[("A", spec), ("A", spec)])
    with pytest.raises(ValueError, match="at least one seed"):
        t_study.Study(arms=[("A", spec)], seeds=())
    with pytest.raises(ValueError, match="grouping"):
        t_study.Study(arms=[("A", spec)], grouping="nope")
    with pytest.raises(TypeError, match="ExperimentSpec"):
        t_study.Study(arms=[("A", object())])
    with pytest.raises(ValueError, match="max_rounds"):
        t_study.Study(arms=[("A", spec)], max_rounds=0).run(device="cpu")
    with pytest.raises(ValueError, match="eval_every"):
        t_study.Study(arms=[("A", spec)], eval_every=0).run(device="cpu")
    st = t_study.Study(arms=[("A", spec)], seeds=range(3))
    assert st.seeds == (0, 1, 2)
    assert st.replace(max_rounds=7).max_rounds == 7


def test_backend_groups_and_non_scan_arms_raise():
    """`backend` is part of the group signature, as in the reference, and
    a study refuses an arm off the chunked path, as the reference does
    for every synchronous backend but 'scan'."""
    t_spec, j_spec = _tiny(TSpec, TFed, 4, 1), _tiny(JSpec, JFed, 4, 1)
    for spec, study in ((t_spec, t_study), (j_spec, j_study)):
        fed = spec.resolve_fed()
        assert (study._group_signature(spec, fed)
                != study._group_signature(spec.replace(backend="batched"),
                                          fed))
        for backend in ("batched", "loop"):
            with pytest.raises(ValueError, match="backend='scan'"):
                study.Study(arms=[("A", spec.replace(backend=backend))])


def test_chunk_inputs_pad_without_extra_draws():
    """The envelope zero-pads a member's native draws: the same indices in
    the valid corner, zeros elsewhere, and the iterators and the stream
    where a native draw leaves them."""
    sim = _tiny(TSpec, TFed, 4, 2, scenario="dropout").build(device="cpu")
    st = sim.init(5)
    native, padded = sim._materialize(st), sim._materialize(st)
    a = sim._chunk_inputs(*native, 3)
    b = sim._chunk_inputs(*padded, 3, envelope=(5, 7))
    assert a[0].shape == (3, 3, 2, 4) and b[0].shape == (3, 3, 5, 7)
    np.testing.assert_array_equal(b[0][:, :, :2, :4], a[0])
    assert not b[0][:, :, 2:].any() and not b[0][:, :, :, 4:].any()
    np.testing.assert_array_equal(a[1], b[1])
    assert repr([it.state() for it in native[0]]) == repr(
        [it.state() for it in padded[0]])
    assert repr(native[1].state()) == repr(padded[1].state())


# -- checkpoints and the bit probe ------------------------------------------------------


def test_checkpoint_resume(tmp_path):
    arms = _arms(TSpec, TFed, arms=(("A", 4, 2), ("B", 8, 1)))
    study = t_study.Study(arms=arms, seeds=SEEDS, max_rounds=3)
    first = study.run(checkpoint_dir=tmp_path, device="cpu")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["arm000_seed0.pkl", "arm000_seed1.pkl",
                     "arm001_seed0.pkl", "arm001_seed1.pkl"]
    (tmp_path / "arm001_seed1.pkl").unlink()
    (tmp_path / "arm000_seed0.pkl.tmpxyz").write_bytes(b"torn")  # ignored
    again = study.run(checkpoint_dir=tmp_path, device="cpu")
    for label, _ in arms:
        for i, _ in enumerate(SEEDS):
            a, b = first[label][i], again[label][i]
            assert [_record(r) for r in a.history] == [
                _record(r) for r in b.history]
            assert [r.train_loss for r in a.history] == [
                r.train_loss for r in b.history]
            for x, y in zip(leaves(a.params), leaves(b.params)):
                assert torch.equal(x, y)
            sa, sb = first.states[label][i], again.states[label][i]
            assert (sa.round, sa.sim_time, repr(sa.data)) == (
                sb.round, sb.sim_time, repr(sb.data))
            assert torch.equal(sa.rng, sb.rng)
            for x, y in zip(leaves(sa.params_C), leaves(sb.params_C)):
                assert torch.equal(x, y) and x.device.type == "cpu"
    # A study whose arms changed does not read another study's members.
    renamed = study.replace(arms=[("Z", arms[0][1]), arms[1]])
    with pytest.raises(ValueError, match="changed"):
        renamed.run(checkpoint_dir=tmp_path, device="cpu")
    (tmp_path / "arm000_seed0.pkl").write_bytes(b"\x80\x04junk")
    with pytest.raises(ValueError, match="checkpoint"):
        study.run(checkpoint_dir=tmp_path, device="cpu")
    fresh = study.run(checkpoint_dir=tmp_path, resume=False, device="cpu")
    assert [_record(r) for r in fresh["A"][0].history] == [
        _record(r) for r in first["A"][0].history]


def test_bit_check_raises_when_the_padding_is_not_inert():
    """The probe passes on the shipped masked gradient (the three-arm
    studies above run with it) and raises on one whose padded samples leak
    into the loss."""
    arms = _arms(TSpec, TFed, arms=(("A", 4, 2), ("B", 8, 1)))
    sims = {label: spec.build(device="cpu") for label, spec in arms}
    cfg = t_cnn.mnist_cnn_tiny()

    def leaky(p, batch, sample_mask=None, n=None):
        return t_cnn.cnn_value_and_grad(cfg, p, batch)  # every row counts

    sims["A"].value_and_grad = leaky
    sims["B"].value_and_grad = leaky
    study = t_study.Study(arms=arms, seeds=(0,), max_rounds=2,
                          bit_check=True)
    with pytest.raises(ValueError, match="bit_check: arm 'A' diverges"):
        study.run(sims=sims)
    assert study.replace(bit_check=False).run(sims=sims).groups == (
        ("A", "B"),)


# -- the envelope's live-prefix local steps ---------------------------------------------


def _padded_local_steps(value_and_grad, opt):
    """The envelope's local steps before the live-prefix schedule, frozen
    as the oracle: every step on every lane at B_env rows, a dead step's
    writes dropped with torch.where over the whole stack."""

    def run(params, opt_state, batches, env):
        total = 0.0
        for v in range(env["v_mask"].shape[1]):
            grads, loss = value_and_grad(
                params, {k: b[:, v] for k, b in batches.items()},
                env["sample_mask"], env["n_samples"])
            updates, new_s = opt.update(grads, opt_state, params)
            new_p = apply_updates(params, updates)
            valid = torch.as_tensor(env["v_mask"][:, v], dtype=torch.float32)
            params = mesh_rounds._select_participating_state(new_p, params,
                                                             valid)
            opt_state = mesh_rounds._select_participating_state(
                new_s, opt_state, valid)
            total = total + torch.where(valid > 0, loss, 0.0)
        return params, opt_state, total / env["v_count"]

    return run


def _envelope_stack(plans, C=2, seed=0):
    """A stack of members with (V, b) `plans`, stacked as `_run_group`
    stacks them, C lanes each, every lane's params its own, the momentum
    state nonzero, and real V x b draws zero-padded to the envelope:
    (value_and_grad, opt, params, opt_state, batches, env)."""
    cfg = t_cnn.mnist_cnn_tiny()
    N = C * len(plans)
    V_env = max(V for V, _ in plans)
    B_env = max(b for _, b in plans)
    gen = torch.Generator().manual_seed(seed)
    base = t_cnn.init_cnn(cfg, seed, torch.device("cpu"))
    params = tree_map(lambda x: x[None] + 0.01 * torch.randn(
        (N,) + x.shape, generator=gen), base)
    opt = sgd(0.05, momentum=0.9)
    opt_state = tree_map(lambda x: 0.01 * torch.randn(x.shape, generator=gen),
                         params)
    x = torch.zeros(N, V_env, B_env, 28, 28, 1)
    y = torch.zeros(N, V_env, B_env, dtype=torch.int64)
    for i, (V, b) in enumerate(plans):
        lanes = slice(i * C, (i + 1) * C)
        x[lanes, :V, :b] = torch.rand(C, V, b, 28, 28, 1, generator=gen)
        y[lanes, :V, :b] = torch.randint(0, 10, (C, V, b), generator=gen)
    env = {"v_mask": np.repeat(
        np.stack([np.arange(V_env) < V for V, _ in plans]), C, axis=0),
        "rows": np.repeat(np.array([b for _, b in plans]), C),
        "sample_mask": torch.as_tensor(np.repeat(np.stack(
            [np.arange(B_env) < b for _, b in plans]), C, axis=0),
            dtype=torch.float32),
        "n_samples": torch.tensor([float(b) for _, b in plans]
                                  ).repeat_interleave(C),
        "v_count": torch.tensor([float(V) for V, _ in plans]
                                ).repeat_interleave(C)}

    def value_and_grad(p, batch, m=None, n=None):
        return t_cnn.cnn_value_and_grad(cfg, p, batch, m, n)

    return value_and_grad, opt, params, opt_state, {"x": x, "y": y}, env


def _storages(tree):
    return {x.untyped_storage().data_ptr() for x in leaves(tree)}


def test_envelope_local_steps_against_the_padded_form():
    """Three arms whose b does not follow their V, stacked by V, and a
    block of lanes that never steps (V 0): the dead lanes come back bit
    for bit, the live ones within the member contract of the padded form
    and of each member's unpadded steps alone (whose loss divides by its
    own V), and the output shares no storage with the input, which stays
    as it was."""
    plans = [(4, 3), (3, 6), (1, 2), (0, 5)]
    C = 2
    vg, opt, params, opt_state, batches, env = _envelope_stack(plans, C)
    assert mesh_rounds.envelope_schedule(env["v_mask"], env["rows"]) == [
        (6, 6), (4, 6), (4, 6), (2, 3)]
    before = tree_map(torch.clone, (params, opt_state))
    got_p, got_s, got_l = mesh_rounds.envelope_local_steps_fn(vg, opt)(
        params, opt_state, batches, env)
    want_p, want_s, want_l = _padded_local_steps(vg, opt)(
        params, opt_state, batches, env)
    for x, y in zip(leaves((params, opt_state)), leaves(before)):
        assert torch.equal(x, y)
    assert not _storages((got_p, got_s)) & _storages((params, opt_state))
    live = slice(0, 3 * C)
    for got, want, old in zip(leaves((got_p, got_s)), leaves((want_p, want_s)),
                              leaves(before)):
        assert torch.equal(got[live.stop:], old[live.stop:])
        np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                                   rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(got_l[live].numpy(), want_l[live].numpy(),
                               rtol=LOSS_RTOL)
    assert bool(torch.isnan(got_l[live.stop:]).all())  # V 0: 0 / 0
    # Each member's V steps alone, on its unpadded batches.
    alone = mesh_rounds.local_steps_fn(vg, opt)
    for i, (V, b) in enumerate(plans[:3]):
        lanes = slice(i * C, (i + 1) * C)
        p, s, loss = alone(
            tree_map(lambda x: x[lanes], params),
            tree_map(lambda x: x[lanes], opt_state),
            {k: x[lanes, :V, :b] for k, x in batches.items()})
        np.testing.assert_allclose(got_l[lanes].numpy(), loss.numpy(),
                                   rtol=LOSS_RTOL)
        for x, y in zip(leaves((got_p, got_s)), leaves((p, s))):
            np.testing.assert_allclose(x[lanes].numpy(), y.numpy(), rtol=0,
                                       atol=PARAM_ATOL)


def test_a_shared_plan_computes_what_the_padded_form_does():
    """Members that share one plan step every lane at B_env rows on every
    step: the padded form's computation, bit for bit."""
    vg, opt, params, opt_state, batches, env = _envelope_stack(
        [(3, 4), (3, 4)])
    assert mesh_rounds.envelope_schedule(env["v_mask"], env["rows"]) == [
        (4, 4)] * 3
    got = mesh_rounds.envelope_local_steps_fn(vg, opt)(
        params, opt_state, batches, env)
    want = _padded_local_steps(vg, opt)(params, opt_state, batches, env)
    for x, y in zip(leaves(got), leaves(want)):
        assert torch.equal(x, y)


def test_envelope_schedule_needs_the_stack_by_v():
    v_mask = np.repeat(np.stack([np.arange(3) < V for V in (1, 3)]), 2,
                       axis=0)
    with pytest.raises(ValueError, match="largest first"):
        mesh_rounds.envelope_schedule(v_mask, np.array([4, 4, 2, 2]))


def test_run_group_returns_the_callers_order():
    """Members given out of V order come back in the caller's order, with
    the records and the params of the same members given by V, largest
    first (the stack both calls run)."""
    arms = _arms(TSpec, TFed, with_eval=True)  # A (b 4, V 2), B (8, 1), C (6, 3)
    by_label = dict(arms)
    runs = {}
    for order in (("B", "A", "C"), ("C", "A", "B")):
        sims = {label: by_label[label].build(device="cpu") for label in order}
        group = [t_study._Member(arm=a, label=label, sim=sims[label], seed=s)
                 for a, label in enumerate(order) for s in SEEDS]
        assert [group[i].label for i in t_study._stack_order(group)] == [
            label for label in ("C", "A", "B") for _ in SEEDS]
        out = t_study._run_group(group, 3, 2, None, None)
        assert [res.label for _, res in out] == [
            f"{label}[seed={s}]" for label in order for s in SEEDS]
        runs[order] = {res.label: (st, res) for st, res in out}
    a, b = runs.values()
    for name, (st, res) in a.items():
        st2, res2 = b[name]
        assert [_record(r) for r in res.history] == [
            _record(r) for r in res2.history]
        assert [(r.train_loss, r.test_acc) for r in res.history] == [
            (r.train_loss, r.test_acc) for r in res2.history]
        for x, y in zip(leaves((st.params_C, res.params)),
                        leaves((st2.params_C, res2.params))):
            assert torch.equal(x, y)


def test_target_acc_stop_derives_the_schedule_again(monkeypatch):
    """A member that reaches target_acc leaves the stack, and the chunks
    after it step the members left on the schedule of their own plans:
    each member against its run alone, as
    test_target_acc_stops_members_as_runs_alone holds them."""
    base = TSpec(fed=TFed(n_devices=3, batch_size=8, theta=0.62, lr=0.2),
                 model="mnist_cnn_small", dataset="mnist", n_train=240,
                 n_test=80)
    arms = [("b8", base),
            ("b4", base.replace(fed=dataclasses.replace(
                base.fed, batch_size=4, theta=0.3)))]
    schedules = []
    real = mesh_rounds.envelope_schedule

    def spy(v_mask, rows):
        out = real(v_mask, rows)
        schedules.append((len(rows), out))
        return out

    monkeypatch.setattr(mesh_rounds, "envelope_schedule", spy)
    seeds, target = (0, 1, 2), 0.15
    res = t_study.Study(arms=arms, seeds=seeds, max_rounds=8, eval_every=2,
                        target_acc=target).run(device="cpu")
    rounds = {(label, i): r.rounds for label, _ in arms
              for i, r in enumerate(res[label])}
    assert min(rounds.values()) < 8 and max(rounds.values()) == 8, rounds
    plan = {label: (res[label][0].fed.local_rounds,
                    res[label][0].fed.batch_size) for label, _ in arms}
    assert plan["b8"][0] != plan["b4"][0], plan
    C = 3
    for r in range(8):
        stack = sorted((plan[label] for (label, i), n in rounds.items()
                        if n > r), key=lambda vb: -vb[0])
        N, got = schedules[r]
        assert N == C * len(stack)
        assert got == [(C * sum(V > v for V, _ in stack),
                        max([b for V, b in stack if V > v], default=0))
                       for v in range(max(V for V, _ in plan.values()))]
    assert len({N for N, _ in schedules}) > 1
    for label, spec in arms:
        sim = spec.build(device="cpu")
        for i, seed in enumerate(seeds):
            st, alone = sim.run(sim.init(seed), max_rounds=8, eval_every=2,
                                target_acc=target)
            _assert_contract(res[label][i], alone, res.states[label][i], st)


@pytest.mark.parametrize("arms,steps,skipped", [
    # A (b 4, V 2), B (8, 1), C (6, 3), stacked C, A, B, 3 lanes each:
    # step 0 9 lanes x 8 rows, step 1 6 x 6, step 2 3 x 6, of 9 x 3 x 8.
    (ARMS, (9 * 8 + 6 * 6 + 3 * 6, 9 * 3 * 8), 1 - 126 / 216),
    # One plan: nothing skipped.
    ((("A", 4, 2), ("D", 4, 2)), (6 * 4 + 6 * 4, 6 * 2 * 4), 0.0),
], ids=["three-plans", "one-plan"])
def test_envelope_counters_under_a_profiler(arms, steps, skipped):
    """fl.envelope.sample_steps and fl.envelope.full_sample_steps are the
    schedule's host arithmetic, a round each, and only under a profiler."""
    from torch.profiler import ProfilerActivity, profile
    t_arms = _arms(TSpec, TFed, arms=arms)
    group = [t_study._Member(arm=a, label=label, sim=spec.build(device="cpu"),
                             seed=0) for a, (label, spec) in enumerate(t_arms)]
    rounds = 2
    spans.reset()
    t_study._run_group(group, rounds, rounds, None, None)
    assert spans.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        t_study._run_group(group, rounds, rounds, None, None)
    counters = spans.snapshot()["counters"]
    spans.reset()
    done, full = steps
    assert counters["fl.envelope.sample_steps"] == rounds * done
    assert counters["fl.envelope.full_sample_steps"] == rounds * full
    assert 1 - (counters["fl.envelope.sample_steps"]
                / counters["fl.envelope.full_sample_steps"]) == skipped
