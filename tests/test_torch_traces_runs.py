"""The port's simulator on trace-driven fleets against the reference's:

  * compressed `mnist_diurnal` (the `diurnal_edge` device-class fleet,
    M = 12) and a `TraceSpec` replay of a recorded `hetero_storm` trace
    under `mnist_smoke`, with the reference's quantizer noise replayed:
    the clock, uplink bits and participants of a 6-round run exact (the
    participants also equal to a host recomputation from the trace
    stream), and each round, from the reference's state before it,
    within 1e-5 of the loss (relative) and 5e-4 of the params;
  * `save_state` after 3 rounds and `load_state` into a fresh simulator:
    3 more rounds bit for bit against 6 straight;
  * a 2-arm Study on one TraceSpec: one group, as in the reference, with
    the reference's records; arms on different traces never share a
    group;
  * the async backend on a trace: its dispatch draws come from the trace
    stream; records, events and stream positions the reference's, losses
    and params within the bounds, and the same errors where the
    reference refuses a spec.

The trace streams themselves are tests/test_torch_traces.py's.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFed
from repro.federated import compression as j_comp
from repro.federated import experiment as j_exp
from repro.federated import study as j_study
from repro.federated import traces as j_tr
from repro.federated.events import AsyncSpec as JAsync
from repro.federated.faults import FaultModel as JFaults
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.convert import to_numpy, to_torch
from repro_torch.federated import compression as t_comp
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import scenarios as t_scen
from repro_torch.federated import study as t_study
from repro_torch.federated import traces as t_tr
from repro_torch.federated.events import AsyncSpec as TAsync
from repro_torch.federated.faults import FaultModel as TFaults
from repro_torch.federated.simulation import load_state, save_state
from repro_torch.utils.tree import leaves

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
ROUNDS = 6
RECORD = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits",
          "n_participants", "rejected")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The small models run fastest on one intra-op thread, and the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b, path="state"):
    """Deep equality of two snapshots: arrays by value and dtype, floats
    to the bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _same_error(t_fn, j_fn):
    """Both packages raise ValueError with the same message."""
    msgs = []
    for fn in (t_fn, j_fn):
        with pytest.raises(ValueError) as ei:
            fn()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _jax_noise(seed, C, rows, rounds):
    """The reference's per-round (C, rows, 1024) quantizer noise, its keys
    drawn in the order its chunk draws them."""
    draw = jax.jit(jax.vmap(lambda k: j_noise(k, (rows, t_comp.ROW))))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, keys = j_comp.sequential_client_keys(key, C)
        out.append(np.asarray(draw(keys)))
    return out


def _port_state(t_sim, j_state):
    """The port's state equal to a host snapshot of the reference's (the
    trace stream's snapshot format is the same)."""
    return dataclasses.replace(
        t_sim.init(j_state.seed),
        params_C=to_torch(jax.tree.map(np.asarray, j_state.params_C),
                          device="cpu"),
        round=j_state.round, sim_time=j_state.sim_time,
        stream=j_state.stream, data=j_state.data)


def _record(r):
    return tuple(getattr(r, f) for f in RECORD)


def _compressed(spec):
    return spec.replace(with_eval=False, fed=dataclasses.replace(
        spec.fed, compress_updates=True))


def _specs(kind, tmp_path):
    """(reference spec, port spec): compressed mnist_diurnal, or a
    recorded hetero_storm trace replayed under mnist_smoke."""
    if kind == "diurnal":
        return (_compressed(j_exp.get("mnist_diurnal")),
                _compressed(t_exp.get("mnist_diurnal")))
    path = os.path.join(tmp_path, "replay.jsonl")
    t_tr.record_trace("hetero_storm", 3, 8, path, seed=1)
    return (_compressed(j_exp.get("mnist_smoke")).replace(
                scenario=None, trace=j_tr.TraceSpec(path)),
            _compressed(t_exp.get("mnist_smoke")).replace(
                scenario=None, trace=t_tr.TraceSpec(path)))


@pytest.fixture(scope="module", params=["diurnal", "replay"])
def run_pair(request, tmp_path_factory):
    j_spec, t_spec = _specs(request.param, tmp_path_factory.mktemp("run"))
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
    t_state, t_res = t_sim.run(t_sim.init(), max_rounds=ROUNDS)
    current = {}
    one = t_spec.build(device="cpu", params=params0,
                       noise=lambda g, shape: torch.tensor(current["u"]))
    per_round = []
    for k in range(ROUNDS):
        current["u"] = noise[k]
        end, res = one.run(_port_state(one, before[k]), max_rounds=1)
        per_round.append((end, res.history[0]))
    return {"kind": request.param, "t_spec": t_spec, "j_hist": j_hist,
            "after": after, "t_res": t_res, "t_state": t_state,
            "per_round": per_round, "t_sim": t_sim}


def test_run_clock_bits_participants_exact(run_pair):
    j_hist, t_hist = run_pair["j_hist"], run_pair["t_res"].history
    assert [_record(r) for r in t_hist] == [_record(r) for r in j_hist]
    assert len(t_hist) == ROUNDS
    final, st = run_pair["after"][-1], run_pair["t_state"]
    assert (st.round, st.sim_time) == (final.round, final.sim_time)
    _same(st.stream, final.stream)
    assert repr(st.data) == repr(final.data)
    # The trace gates presence: some round runs without every client.
    M = run_pair["t_sim"].fed.n_devices
    assert min(r.n_participants for r in t_hist) < M
    # Participants are the stream's own arrivals, recomputed on the host.
    spec = run_pair["t_spec"]
    scen = t_scen.get(spec.scenario_ref())
    pop = scen.population(M, spec.compute, spec.wireless, seed=spec.seed)
    chunk = scen.stream(pop, seed=spec.fed.seed).draw_chunk(ROUNDS)
    assert [r.n_participants for r in t_hist] == \
        chunk.n_participants.tolist()
    bits = t_comp.compressed_bits(run_pair["t_sim"].params(st))
    assert [r.uplink_bits for r in t_hist] == [
        r.n_participants * bits for r in t_hist]


def test_each_round_from_equal_states_within_tolerance(run_pair):
    for (end, rec), j_rec, j_after in zip(
            run_pair["per_round"], run_pair["j_hist"], run_pair["after"]):
        assert _record(rec) == _record(j_rec)
        np.testing.assert_allclose(rec.train_loss, j_rec.train_loss,
                                   rtol=LOSS_RTOL)
        for t, j in zip(leaves(to_numpy(end.params_C)),
                        jax.tree.leaves(j_after.params_C)):
            np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                       atol=PARAM_ATOL)
        _same(end.stream, j_after.stream)


def test_checkpoint_resume_bit_identical(run_pair, tmp_path):
    """save_state after 3 rounds, load_state into a fresh simulator, 3 more
    rounds: bit for bit against 6 straight (the trace's machines and
    cursor ride the stream snapshot)."""
    spec = run_pair["t_spec"]
    whole = spec.build(device="cpu")
    w_state, w_res = whole.run(whole.init(), max_rounds=ROUNDS)
    first = spec.build(device="cpu")
    mid, head = first.run(first.init(), max_rounds=3)
    path = os.path.join(tmp_path, "ckpt.pkl")
    save_state(path, mid)
    fresh = spec.build(device="cpu")
    end, tail = fresh.run(load_state(path, like=fresh.init()), max_rounds=3)
    got = head.history + tail.history
    assert [(_record(r), r.train_loss) for r in got] == [
        (_record(r), r.train_loss) for r in w_res.history]
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(end.params_C), leaves(w_state.params_C)))
    assert torch.equal(end.rng, w_state.rng)
    _same(end.stream, w_state.stream)


def _tiny_arms(exp, fed_cls, tr, path):
    """Two arms of distinct (b, V) on one recorded trace."""
    spec = exp.get("mnist_smoke").replace(
        scenario=None, trace=tr.TraceSpec(path), with_eval=False,
        model="mnist_cnn_tiny", n_train=120, n_test=40)
    return [(label, spec.replace(fed=fed_cls(
        n_devices=3, batch_size=b, theta=float(np.exp(-V / 2.0)), nu=2.0,
        lr=0.05))) for label, b, V in (("A", 4, 2), ("B", 8, 1))]


def test_study_on_a_trace_is_the_references(tmp_path):
    """Two arms on one TraceSpec fold into one group, as in the
    reference, with the reference's records; arms on two different
    traces never fold."""
    path = os.path.join(tmp_path, "study.jsonl")
    t_tr.record_trace("diurnal_edge", 3, 8, path, seed=2)
    kw = dict(seeds=(0,), max_rounds=3)
    t_arms = _tiny_arms(t_exp, TFed, t_tr, path)
    j_arms = _tiny_arms(j_exp, JFed, j_tr, path)
    t_res = t_study.Study(arms=t_arms, **kw).run(device="cpu")
    j_res = j_study.Study(arms=j_arms, **kw).run()
    assert t_res.groups == j_res.groups == (("A", "B"),)
    for label, _ in t_arms:
        t, j = t_res[label][0], j_res[label][0]
        assert [_record(r) for r in t.history] == [
            _record(r) for r in j.history]
        np.testing.assert_allclose([r.train_loss for r in t.history],
                                   [r.train_loss for r in j.history],
                                   rtol=LOSS_RTOL)
    other = os.path.join(tmp_path, "other.jsonl")
    t_tr.record_trace("diurnal_edge", 3, 8, other, seed=3)
    label, spec = t_arms[1]
    mixed = [t_arms[0], (label, spec.replace(trace=t_tr.TraceSpec(other)))]
    sigs = {t_study._group_signature(s, s.resolve_fed()) for _, s in mixed}
    assert len(sigs) == 2
    assert len({t_study._group_signature(s, s.resolve_fed())
                for _, s in t_arms}) == 1


def test_async_on_a_trace_is_the_references():
    """Uncompressed mnist_diurnal on the event queue: its dispatch draws
    come from the trace stream. Records, event count, stream and data
    positions exactly the reference's; losses and params within the
    bounds."""
    kw = dict(backend="async", with_eval=False)
    j_spec = j_exp.get("mnist_diurnal").replace(
        async_spec=JAsync(buffer_size=4, staleness="poly"), **kw)
    t_spec = t_exp.get("mnist_diurnal").replace(
        async_spec=TAsync(buffer_size=4, staleness="poly"), **kw)
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    j_state, j_res = j_sim.run(j_sim.init(), max_rounds=3)
    t_sim = t_spec.build(device="cpu", params=params0)
    t_state, t_res = t_sim.run(t_sim.init(), max_rounds=3)
    assert [_record(r) for r in t_res.history] == [
        _record(r) for r in j_res.history]
    assert t_state.event == j_state.event
    _same(t_state.stream, j_state.stream)
    assert repr(t_state.data) == repr(j_state.data)
    np.testing.assert_allclose([r.train_loss for r in t_res.history],
                               [r.train_loss for r in j_res.history],
                               rtol=LOSS_RTOL)
    for t, j in zip(leaves(to_numpy(t_sim.params(t_state))),
                    jax.tree.leaves(j_sim.params(j_state))):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("knob", ["cohort", "quorum"])
def test_async_on_a_trace_refuses_what_the_reference_refuses(tmp_path, knob):
    path = os.path.join(tmp_path, "a.jsonl")
    t_tr.record_trace("diurnal_edge", 12, 4, path, seed=0)

    def spec(exp, tr, asy, fm):
        base = exp.get("mnist_diurnal").replace(
            scenario=None, trace=tr.TraceSpec(path), backend="async",
            async_spec=asy(buffer_size=4))
        if knob == "cohort":
            return base.replace(population=exp.PopulationSpec(
                M=12, cohort=exp.CohortSpec(K=4)))
        return base.replace(faults=fm(min_quorum=3))

    _same_error(lambda: spec(t_exp, t_tr, TAsync, TFaults),
                lambda: spec(j_exp, j_tr, JAsync, JFaults))
