"""The port's spans and counters (repro_torch.utils.spans) in the FL round
loop (`Simulator._drive`), on a small sampled run (two `Simulator.run`
calls) and a two-arm Study group (two one-round `_run_group` calls):

  * with no profiler running, nothing records: no profiler range is
    entered, no CUDA event is made, and the registry stays empty;
  * under `torch.profiler`, each `fl.*` host span is a range on the
    profiler's timeline with an aten op's function scope (a user-scope
    range would also be mirrored onto the card's timeline), the spans
    are disjoint, and the counters count the calls, the rounds, the
    bytes uploaded and the Study's envelope sample-steps;
  * records and final params are bit-identical with the profiler on and
    off;
  * on the card, no span shows on the card's timeline, and the round's
    device spans resolve to positive times that add up to no more than
    the profiled wall time.

Imports no JAX:

  PYTHONPATH=src python -m pytest tests/test_torch_spans.py
"""
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import FedConfig
from repro_torch.federated import study
from repro_torch.federated.experiment import (CohortSpec, ExperimentSpec,
                                              PopulationSpec)
from repro_torch.utils import spans
from repro_torch.utils.tree import leaves

CASES = ("sampled", "study")
CALLS = 2
SAMPLED_ROUNDS = 2  # rounds a sampled call; a Study call drives one
K = 5
HOST = ("fl.drive.enter", "fl.drive.draws", "fl.drive.upload",
        "fl.drive.call", "fl.drive.fetch", "fl.drive.records",
        "fl.drive.eval", "fl.drive.exit")
DEVICE = ("fl.round.local", "fl.round.aggregate")
EMPTY = {"spans": {}, "device": {}, "counters": {}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fed(b, theta, compress=False):
    return FedConfig(n_devices=3, batch_size=b, theta=theta, lr=0.05,
                     compress_updates=compress)


def _spec(**kw):
    return ExperimentSpec(model="mnist_cnn_tiny", dataset="mnist",
                          n_train=48, n_test=16, **kw)


def _run_sampled(device):
    """Two 2-round calls of a compressed run over 5 of 400 clients: (every
    record, final params, the upload's bytes: indices (R, K, V, B) int64,
    the mask (R, K) and the cohort sizes (R, 1, K) float32)."""
    sim = _spec(fed=_fed(4, 0.62, compress=True),
                population=PopulationSpec(M=400, cohort=CohortSpec(K=K)),
                ).build(device=device)
    state, hist = sim.init(7), []
    for _ in range(CALLS):
        state, res = sim.run(state, max_rounds=SAMPLED_ROUNDS,
                             eval_every=SAMPLED_ROUNDS)
        hist.extend(res.history)
    R, V, B = SAMPLED_ROUNDS, sim.fed.local_rounds, sim.fed.batch_size
    h2d = CALLS * (R * K * V * B * 8 + R * K * 4 + R * K * 4)
    return hist, leaves(sim.params(state)), h2d


def _run_study(device):
    """Two one-round calls of a group of two arms, (b 4, V of theta
    0.62) and (b 2, V 1), under the dropout scenario, padded to one
    envelope: (every record, final params, the upload's bytes: indices
    (1, 2 C, V_env, B_env) int64 and the mask (1, 2 C) float32)."""
    arms = [("A", _fed(4, 0.62)), ("B", _fed(2, 0.05))]
    group = [study._Member(arm=a, label=label,
                           sim=_spec(fed=fed, scenario="dropout",
                                     label=label).build(device=device),
                           seed=3)
             for a, (label, fed) in enumerate(arms)]
    hist = [[] for _ in group]
    for _ in range(CALLS):
        out = study._run_group(group, 1, 1, None, None)
        for m, h, (state, res) in zip(group, hist, out):
            m.state = state
            h.extend(res.history)
    V_env = max(m.sim.fed.local_rounds for m in group)
    B_env = max(m.sim.fed.batch_size for m in group)
    assert {m.sim.fed.local_rounds for m in group} != {V_env}, \
        "the arms should differ in V, so that the envelope pads"
    C = group[0].sim.fed.n_devices
    h2d = CALLS * (2 * C * V_env * B_env * 8 + 2 * C * 4)
    params = [p for m in group for p in leaves(m.sim.params(m.state))]
    return [r for h in hist for r in h], params, h2d


RUN = {"sampled": _run_sampled, "study": _run_study}
ROUNDS = {"sampled": CALLS * SAMPLED_ROUNDS, "study": CALLS}
# The Study group's envelope counters over its calls: B (b 2, V 6) stacked
# before A (b 4, V 1), 3 lanes each; step 0 steps 6 lanes x 4 rows, steps
# 1-5 B's 3 lanes x 2 rows, of 6 lanes x 6 steps x 4 rows a round.
ENVELOPE = {"sampled": {},
            "study": {"fl.envelope.sample_steps": CALLS * (6 * 4 + 5 * 3 * 2),
                      "fl.envelope.full_sample_steps": CALLS * 6 * 6 * 4}}


def _raise(*a, **k):
    raise AssertionError("a span recorded with no profiler running")


@pytest.fixture(scope="module")
def runs():
    """Each case run with no profiler (the profiler's ranges and
    torch.cuda.Event made to raise) and under a CPU profiler: {case:
    {"off": (result, snapshot), "on": (result, snapshot, profiler
    events)}}."""
    out = {}
    for case in CASES:
        spans.reset()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.profiler, "record_function", _raise)
            mp.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
            mp.setattr(torch.cuda, "Event", _raise)
            off = RUN[case]("cpu")
        off_snap = spans.snapshot()
        spans.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = RUN[case]("cpu")
        events = [(e.name, e.time_range.start, e.time_range.end, e.scope)
                  for e in prof.events() if e.name.startswith("fl.")]
        out[case] = {"off": (off, off_snap),
                     "on": (on, spans.snapshot(), events)}
        spans.reset()
    return out


@pytest.mark.parametrize("case", CASES)
def test_no_profiler_records_nothing(runs, case):
    _, snap = runs[case]["off"]
    assert snap == EMPTY


@pytest.mark.parametrize("case", CASES)
def test_profiler_sees_every_span_and_the_counters(runs, case):
    (_, _, h2d), snap, events = runs[case]["on"]
    names = set(HOST) | ({"fl.group.setup"} if case == "study" else set())
    assert {n for n, _, _, _ in events} == names
    # The function scope of an aten op, never the user scope.
    assert {scope for _, _, _, scope in events} == {0}
    assert set(snap["spans"]) == names
    assert snap["device"] == {}  # no CUDA stream on the CPU
    assert snap["counters"] == {"fl.drive.calls": CALLS,
                                "fl.drive.rounds": ROUNDS[case],
                                "fl.drive.h2d_bytes": h2d,
                                **ENVELOPE[case]}
    for name in names:
        assert snap["spans"][name]["n"] == CALLS, name
        assert snap["spans"][name]["s"] > 0, name


@pytest.mark.parametrize("case", CASES)
def test_host_spans_are_disjoint(runs, case):
    _, _, events = runs[case]["on"]
    ranges = sorted((s, e, n) for n, s, e, _ in events)
    for (_, end, a), (start, _, b) in zip(ranges, ranges[1:]):
        assert end <= start, (a, b)


@pytest.mark.parametrize("case", CASES)
def test_profiler_changes_no_bit(runs, case):
    (hist_off, params_off, _), _ = runs[case]["off"]
    (hist_on, params_on, _), _, _ = runs[case]["on"]
    assert hist_off == hist_on
    assert len(params_off) == len(params_on)
    for a, b in zip(params_off, params_on):
        assert torch.equal(a, b)


def test_registry_counts_only_under_a_profiler():
    spans.reset()
    with spans.span("fl.test"):
        spans.count("fl.test.n", 3)
    assert spans.snapshot() == EMPTY
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("fl.test"):
            spans.count("fl.test.n", 3)
        with spans.span("fl.test"), \
                spans.device_span("fl.test.dev", torch.zeros(1)):
            spans.count("fl.test.n", 2)
    snap = spans.snapshot()
    assert snap["spans"]["fl.test"]["n"] == 2
    assert snap["counters"] == {"fl.test.n": 5}
    assert snap["device"] == {}
    spans.reset()
    assert spans.snapshot() == EMPTY


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_device_spans_on_the_card(case):
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU form")
    RUN[case]("cuda")  # builds the kernels outside the profiled window
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        RUN[case]("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    snap = spans.snapshot()
    spans.reset()
    # The host spans stay on the host's timeline: none is mirrored onto
    # the card's as a GPU user annotation, which would count as busy time.
    on_card = {e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA}
    assert not {n for n in on_card if n.startswith("fl.")}
    assert on_card  # the card's kernels were traced
    assert set(snap["device"]) == set(DEVICE)
    for name in DEVICE:
        dev = snap["device"][name]
        assert dev["n"] >= ROUNDS[case], name
        assert dev["s"] > 0, name
    total = sum(d["s"] for d in snap["device"].values())
    assert total <= wall
    assert np.isfinite(total)
