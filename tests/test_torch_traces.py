"""The port's trace-driven fleets (federated/traces.py) against the
reference's, case by case as tests/test_traces.py, on the same seeds:

  * the device classes, `class_index`, the population and every draw of a
    `TraceStream` (masks, clock masks, realized channel) exactly the
    reference's; `draw_chunk(R)` equal to R `next_round()` calls; the
    snapshot (battery, thermal, tick, trace RNG) the reference's, and a
    stream restored from either package's snapshot continues the
    reference's draws;
  * `record_trace` writes the reference's file byte for byte, and the
    replay (every `on_end` mode, recorded losses under retransmission,
    cohorts and faults over traces) realizes the reference's rounds;
  * every validation error is the reference's, word for word;
  * `ExperimentSpec.trace` (its exclusion of `scenario`) and the
    registered `mnist_diurnal` are the reference's.

The simulator's runs on traces are tests/test_torch_traces_runs.py's.

Every JSONL file is written once, under tmp_path, and both packages read
it: each package keeps its own parse cache, which only its own
`write_trace` clears.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.federated import experiment as j_exp
from repro.federated import scenarios as j_scen
from repro.federated import traces as j_tr
from repro.federated.faults import FaultModel as JFaults
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import scenarios as t_scen
from repro_torch.federated import traces as t_tr
from repro_torch.federated.faults import FaultModel as TFaults

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


def _realizations_equal(t, j):
    for f in ("mask", "clock_mask", "h", "attempts", "h_att"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _error(fn, exc=Exception):
    with pytest.raises(exc) as ei:
        fn()
    return type(ei.value), str(ei.value)


def _same_error(t_fn, j_fn, exc=Exception):
    """Both packages raise, with the same type and message."""
    t, j = _error(t_fn, exc), _error(j_fn, exc)
    assert t[0].__name__ == j[0].__name__
    assert t[1] == j[1]
    return t[1]


def _pair(name):
    return t_scen.get(name), j_scen.get(name)


# -- device classes and the generative TraceScenario ----------------------------


def test_diurnal_edge_registered_as_the_references():
    t, j = _pair("diurnal_edge")
    assert isinstance(t, t_tr.TraceScenario)
    assert t_scen.get(t) is t
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.expected_participation == j.expected_participation
    assert 0.0 < t.expected_participation < 1.0
    assert t_scen.names() == j_scen.names()


def test_presets_are_the_references():
    for t, j in ((t_tr.PHONE, j_tr.PHONE), (t_tr.TABLET, j_tr.TABLET),
                 (t_tr.IOT, j_tr.IOT)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert abs(sum(c.frac for c in (t_tr.PHONE, t_tr.TABLET, t_tr.IOT))
               - 1.0) < 1e-9


BAD_CLASSES = [
    ("DeviceClassSpec", ("bad",), dict(frac=0.0)),
    ("DeviceClassSpec", ("bad",), dict(frac=0.5, compute_scale=-1.0)),
    ("DeviceClassSpec", ("bad",), dict(frac=0.5, avail_base=1.5)),
    ("DeviceClassSpec", ("bad",), dict(frac=0.5, thermal_limit=-0.1)),
    ("TraceScenario", ("t", "empty"), dict(classes=())),
    ("TraceScenario", ("t", "bad"), dict(battery_init=(0.9, 0.2))),
    ("TraceScenario", ("t", "bad"), dict(round_seconds=0.0)),
]


@pytest.mark.parametrize("case", range(len(BAD_CLASSES)))
def test_device_class_validation_is_the_references(case):
    cls, args, kw = BAD_CLASSES[case]
    _same_error(lambda: getattr(t_tr, cls)(*args, **kw),
                lambda: getattr(j_tr, cls)(*args, **kw), ValueError)


def test_class_index_is_the_references():
    t, j = _pair("diurnal_edge")
    assert np.bincount(t.class_index(12), minlength=3).tolist() == [7, 3, 2]
    assert np.bincount(t.class_index(3), minlength=3).tolist() == [2, 1, 0]
    for n in (1, 2, 3, 7, 12, 40, 97):
        got, want = t.class_index(n), j.class_index(n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.class_fracs(), j.class_fracs())


@pytest.mark.parametrize("M,seed", [(12, 0), (40, 3)])
def test_population_is_the_references(M, seed):
    t, j = _pair("diurnal_edge")
    tp, jp = t.population(M, seed=seed), j.population(M, seed=seed)
    for f in ("G", "f", "p", "h"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    idx = t.class_index(M)
    slope = tp.G / tp.f
    assert np.median(slope[idx == 2]) > 2.0 * np.median(slope[idx == 0])


@pytest.mark.parametrize("M,seed", [(24, 3), (10, 7)])
def test_trace_stream_draws_and_snapshot_are_the_references(M, seed):
    """20 rounds one at a time: masks, clock masks and channels exactly
    the reference's, and the state machines' snapshot after each round."""
    t, j = _pair("diurnal_edge")
    ts = t.stream(t.population(M, seed=seed), seed=seed)
    js = j.stream(j.population(M, seed=seed), seed=seed)
    _same(ts.state(), js.state())
    for _ in range(20):
        _realizations_equal(ts.next_round(), js.next_round())
        _same(ts.state(), js.state())
    s = ts.state()["trace"]
    assert s["tick"] == 20
    assert np.all((s["battery"] >= 0) & (s["battery"] <= 1))
    assert np.all((s["thermal"] >= 0) & (s["thermal"] <= 1))


def test_trace_draw_chunk_equals_sequential_and_the_references():
    t, j = _pair("diurnal_edge")
    pop = t.population(10, seed=2)
    seq, chk = t.stream(pop, seed=7), t.stream(pop, seed=7)
    ref = j.stream(j.population(10, seed=2), seed=7)
    reals = [seq.next_round() for _ in range(17)]
    chunk = chk.draw_chunk(17)
    _realizations_equal(chunk, ref.draw_chunk(17))
    for f in ("mask", "clock_mask", "h"):
        np.testing.assert_array_equal(
            np.stack([getattr(r, f) for r in reals]), getattr(chunk, f))
    more = [seq.next_round() for _ in range(6)]
    mix = [chk.next_round().clock_mask, *chk.draw_chunk(4).clock_mask,
           chk.next_round().clock_mask]
    np.testing.assert_array_equal(np.stack([r.clock_mask for r in more]),
                                  np.stack(mix))
    _same(chk.state(), seq.state())


def test_stream_diurnal_wave_moves_participation():
    t, j = _pair("diurnal_edge")
    chunk = t.stream(t.population(24, seed=3), seed=3).draw_chunk(96)
    _realizations_equal(
        chunk, j.stream(j.population(24, seed=3), seed=3).draw_chunk(96))
    frac = chunk.clock_mask.mean(axis=1)
    assert 0.0 < frac.mean() < 1.0 and np.ptp(frac) > 0.2


def test_trace_overlay_only_gates_presence():
    """With the state machines vacuous, a TraceScenario realizes a plain
    Scenario's stream at the same seed (the overlay draws from its own
    generator), in both packages alike."""
    knobs = dict(dropout=0.2, link_failure=0.1, drift_sigma=0.15,
                 drift_rho=0.9)
    chunks = []
    for tr, sc in ((t_tr, t_scen), (j_tr, j_scen)):
        on = tr.DeviceClassSpec(
            "on", frac=1.0, avail_base=1.0, battery_min=0.0,
            battery_drain=0.0, battery_idle_drain=0.0, heat_per_round=0.0)
        tscen = tr.TraceScenario("t_on", "vacuous", classes=(on,), **knobs)
        plain = sc.Scenario("plain", "same knobs", **knobs)
        pop = plain.population(9, seed=5)
        tc = tscen.stream(pop, seed=5).draw_chunk(30)
        _realizations_equal(tc, plain.stream(pop, seed=5).draw_chunk(30))
        chunks.append(tc)
    _realizations_equal(*chunks)


@pytest.mark.parametrize("source", ["port", "reference"])
def test_trace_stream_resumes_from_either_snapshot(source):
    """A fresh port stream restored from a snapshot taken mid-stream (by
    the port or by the reference: the formats are the same) continues the
    reference's draws bit for bit."""
    t, j = _pair("diurnal_edge")
    pop = t.population(12, seed=1)
    full = j.stream(j.population(12, seed=1), seed=4).draw_chunk(25)
    a = (t if source == "port" else j).stream(pop, seed=4)
    a.draw_chunk(11)
    b = t.stream(pop, seed=4)
    b.set_state(a.state())
    tail = b.draw_chunk(14)
    for f in ("mask", "clock_mask", "h"):
        np.testing.assert_array_equal(getattr(full, f)[11:],
                                      getattr(tail, f))
    # A snapshot without trace state restarts the machines.
    c = t.stream(pop, seed=4)
    c.draw_chunk(3)
    snap = c.state()
    del snap["trace"]
    c.set_state(snap)
    assert c.state()["trace"]["tick"] == 0


# -- record and replay ------------------------------------------------------------


def _record_both(tmp_path, name, M, R, seed):
    tp, jp = (os.path.join(tmp_path, f"{w}.jsonl") for w in ("t", "j"))
    t_spec = t_tr.record_trace(name, M, R, tp, seed=seed)
    j_spec = j_tr.record_trace(name, M, R, jp, seed=seed)
    return t_spec, j_spec


@pytest.mark.parametrize("name,M,R,seed", [
    ("hetero_storm", 8, 15, 2), ("diurnal_edge", 12, 8, 0),
    ("unreliable_edge", 6, 10, 1)])
def test_record_trace_writes_the_references_file(tmp_path, name, M, R, seed):
    t_spec, j_spec = _record_both(tmp_path, name, M, R, seed)
    assert isinstance(t_spec, t_tr.TraceSpec)
    with open(t_spec.path, "rb") as f, open(j_spec.path, "rb") as g:
        assert f.read() == g.read()
    # Both packages replay the one file alike, and the replay is the
    # recorded stream: masks exact, channels within a divide/multiply.
    ts, js = (tr.replay_scenario(tr.TraceSpec(t_spec.path))
              for tr in (t_tr, j_tr))
    assert ts.expected_participation == js.expected_participation
    tp, jp = ts.population(M, seed=seed), js.population(M, seed=seed)
    for f in ("G", "f", "p", "h"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    chunk = ts.stream(tp, seed=seed).draw_chunk(R)
    _realizations_equal(chunk, js.stream(jp, seed=seed).draw_chunk(R))
    src = t_scen.get(name)
    src_pop = src.population(M, seed=seed)
    src_chunk = src.stream(src_pop, seed=seed).draw_chunk(R)
    np.testing.assert_array_equal(src_chunk.clock_mask, chunk.clock_mask)
    if src.faults is None:
        np.testing.assert_array_equal(src_chunk.mask, chunk.mask)
        np.testing.assert_allclose(src_chunk.h, chunk.h, rtol=1e-12)
    np.testing.assert_allclose(tp.G / tp.f, src_pop.G / src_pop.f,
                               rtol=1e-12)


def test_replay_stream_checkpoint_resume(tmp_path):
    t_spec, _ = _record_both(tmp_path, "hetero_storm", 8, 12, 0)
    t = t_tr.replay_scenario(t_spec)
    j = j_tr.replay_scenario(j_tr.TraceSpec(t_spec.path))
    pop = t.population(8, seed=0)
    full = j.stream(j.population(8, seed=0), seed=0).draw_chunk(12)
    a = t.stream(pop, seed=0)
    a.draw_chunk(5)
    b = t.stream(pop, seed=0)
    b.set_state(a.state())
    assert b.state()["replay_cursor"] == 5
    tail = b.draw_chunk(7)
    np.testing.assert_array_equal(full.mask[5:], tail.mask)
    np.testing.assert_array_equal(full.h[5:], tail.h)


@pytest.mark.parametrize("on_end", ["cycle", "hold", "error"])
def test_replay_on_end_modes(tmp_path, on_end):
    path = os.path.join(tmp_path, "short.jsonl")
    t_tr.write_trace(path, [{"present": [0, 1]}, {"present": [1]},
                            {"present": [2]}], meta={"devices": 3})
    pop = t_scen.get("uniform").population(3, seed=0)

    def masks(tr, rounds):
        scen = tr.replay_scenario(tr.TraceSpec(path, on_end=on_end),
                                  name=f"t_{on_end}")
        return scen.stream(pop, seed=0).draw_chunk(rounds).clock_mask

    if on_end == "error":
        np.testing.assert_array_equal(masks(t_tr, 3), masks(j_tr, 3))
        _same_error(lambda: masks(t_tr, 4), lambda: masks(j_tr, 4),
                    RuntimeError)
        return
    got = masks(t_tr, 5)
    np.testing.assert_array_equal(got, masks(j_tr, 5))
    want = [0, 1, 2, 0, 1] if on_end == "cycle" else [0, 1, 2, 2, 2]
    np.testing.assert_array_equal(got, got[want])


# name: (records, meta, what raises): each a file of its own.
BAD_TRACES = {
    "meta_not_first": ([{"present": [0]}, {"meta": {"devices": 2}}], None,
                       "load"),
    "no_present": ([{"lost": [0]}], None, "load"),
    "no_records": ([], None, "load"),
    "out_of_range": ([{"present": [0, 9]}], {"devices": 4}, "stream"),
    "bad_h_scale": ([{"present": [0], "h_scale": [1.0, 1.0]}],
                    {"devices": 4}, "stream"),
    "fleet_size": ([{"present": [0]}], {"devices": 7}, "population"),
}


@pytest.mark.parametrize("case", sorted(BAD_TRACES))
def test_trace_validation_is_the_references(tmp_path, case):
    recs, meta, where = BAD_TRACES[case]
    path = os.path.join(tmp_path, f"{case}.jsonl")
    if case == "meta_not_first":
        # write_trace puts the meta first: this file is written by hand.
        with open(path, "w") as f:
            f.write('{"present": [0]}\n{"meta": {"devices": 2}}\n')
    else:
        t_tr.write_trace(path, recs, meta=meta)
    pop = t_scen.get("uniform").population(4, seed=0)

    def call(tr):
        if where == "load":
            return tr._load_trace(path)
        scen = tr.replay_scenario(tr.TraceSpec(path), name=f"t_{case}")
        if where == "population":
            return scen.population(4, seed=0)
        return scen.stream(pop, seed=0).next_round()

    _same_error(lambda: call(t_tr), lambda: call(j_tr), ValueError)


def test_spec_validation_is_the_references():
    _same_error(lambda: t_tr.TraceSpec("x.jsonl", on_end="loop"),
                lambda: j_tr.TraceSpec("x.jsonl", on_end="loop"),
                ValueError)
    _same_error(lambda: t_tr.ReplayScenario("r", "no trace"),
                lambda: j_tr.ReplayScenario("r", "no trace"), ValueError)
    assert t_tr.TraceSpec("a/b/x.jsonl").name == "trace:x.jsonl"


# -- composition: faults and cohorts over traces --------------------------------


def test_replay_lost_final_under_retransmission(tmp_path):
    path = os.path.join(tmp_path, "lossy.jsonl")
    t_tr.write_trace(path, [{"present": [0, 1, 2, 3], "lost": [1, 2]}] * 6,
                     meta={"devices": 4})
    chunks = []
    for tr, fm in ((t_tr, TFaults), (j_tr, JFaults)):
        scen = tr.replay_scenario(tr.TraceSpec(path), name="t_lossy",
                                  faults=fm(max_retries=3))
        chunks.append(scen.stream(scen.population(4, seed=0),
                                  seed=0).draw_chunk(6))
    _realizations_equal(*chunks)
    chunk = chunks[0]
    assert not chunk.mask[:, 1].any() and not chunk.mask[:, 2].any()
    assert chunk.mask[:, 0].all() and chunk.mask[:, 3].all()
    assert chunk.clock_mask.all() and chunk.attempts is not None


def test_trace_composes_with_cohort_sampling():
    t, j = _pair("diurnal_edge")
    pop = t.population(20, seed=0)
    coh = t.stream(pop, seed=0, cohort_size=6)
    ref = j.stream(j.population(20, seed=0), seed=0, cohort_size=6)
    dense = t.stream(pop, seed=0)
    ids = coh.draw_cohorts(8)
    np.testing.assert_array_equal(ids, ref.draw_cohorts(8))
    assert ids.shape == (8, 6)
    cc = coh.draw_chunk(8)
    _realizations_equal(cc, ref.draw_chunk(8))
    _realizations_equal(cc, dense.draw_chunk(8))
    snap = coh.state()
    _same(snap, ref.state())
    fresh = t.stream(pop, seed=0, cohort_size=6)
    fresh.set_state(snap)
    np.testing.assert_array_equal(fresh.draw_cohorts(5), ref.draw_cohorts(5))
    _realizations_equal(fresh.draw_chunk(5), ref.draw_chunk(5))


def test_trace_composes_with_faults():
    t, j = _pair("diurnal_edge")
    kw = dict(max_retries=2, crash_rate=0.1, rejoin_rounds=3)
    ts = dataclasses.replace(t, name="diurnal_faulty", faults=TFaults(**kw))
    js = dataclasses.replace(j, name="diurnal_faulty", faults=JFaults(**kw))
    assert isinstance(ts, t_tr.TraceScenario)  # the subclass survives
    chunk = ts.stream(ts.population(12, seed=0), seed=0).draw_chunk(20)
    _realizations_equal(
        chunk, js.stream(js.population(12, seed=0), seed=0).draw_chunk(20))
    assert chunk.h_att.shape == (20, 12, 3)
    assert not np.any(chunk.mask & ~chunk.clock_mask)
    assert 0.0 < chunk.clock_mask.mean() < 1.0


# -- ExperimentSpec ------------------------------------------------------------------


def test_trace_and_scenario_exclude_each_other(tmp_path):
    path = os.path.join(tmp_path, "x.jsonl")
    t_tr.write_trace(path, [{"present": [0]}])
    # The trace's check comes first, as in the reference: a bad backend
    # beside it does not change the error.
    for kw in (dict(scenario="dropout"),
               dict(scenario="dropout", backend="async")):
        msg = _same_error(
            lambda: t_exp.get("mnist_smoke").replace(
                trace=t_tr.TraceSpec(path), **kw),
            lambda: j_exp.get("mnist_smoke").replace(
                trace=j_tr.TraceSpec(path), **kw), ValueError)
        assert "scenario" in msg and "trace" in msg


def test_mnist_diurnal_registered_as_the_references():
    t, j = t_exp.get("mnist_diurnal"), j_exp.get("mnist_diurnal")
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
        else:
            assert tv == jv, f.name
    assert [n for n in j_exp.names() if n in t_exp.names()] == list(
        t_exp.names())
    assert isinstance(t_scen.get(t.scenario_ref()), t_tr.TraceScenario)
    assert t.n_devices() == 12
    tp, jp = t.resolve_plan(), j.resolve_plan()
    assert (tp.b, tp.V, tp.theta, tp.T_round) == (jp.b, jp.V, jp.theta,
                                                  jp.T_round)
    for f in ("G", "f", "p", "h"):
        np.testing.assert_array_equal(getattr(t.device_population(), f),
                                      getattr(j.device_population(), f))
