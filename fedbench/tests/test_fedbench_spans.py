"""The readers of the program's spans and counters (repro_torch.utils.spans):
nothing where the run recorded nothing or the program has no registry, the
right number from a hand-built snapshot, and numbers from a small cell's
calls run under a CPU profiler."""
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fedbench.harness import cell, manifest
from fedbench.tests.small import small
from repro_torch.utils import spans

READERS = ("drive.exposed_share", "drive.draws_ms", "round.local_ms",
           "round.aggregate_ms")
CTX = {"window_s": 4.0}
SNAPSHOT = {
    "spans": {"fl.group.setup": {"n": 10, "s": 0.05},
              "fl.drive.enter": {"n": 10, "s": 0.10},
              "fl.drive.draws": {"n": 10, "s": 0.30},
              "fl.drive.upload": {"n": 10, "s": 0.02},
              "fl.drive.call": {"n": 10, "s": 1.50},
              "fl.drive.fetch": {"n": 10, "s": 1.00},
              "fl.drive.records": {"n": 12, "s": 0.08},
              "fl.drive.eval": {"n": 10, "s": 0.40},
              "fl.drive.exit": {"n": 10, "s": 0.05}},
    "device": {"fl.round.local": {"n": 100, "s": 2.0},
               "fl.round.aggregate": {"n": 200, "s": 0.5}},
    "counters": {"fl.drive.calls": 10, "fl.drive.rounds": 100,
                 "fl.drive.h2d_bytes": 1234},
}
# exposed: (0.05 + 0.10 + 0.30 + 0.02 + 0.08 + 0.05) s of 4 s; per round:
# 0.3 s, 2 s and 0.5 s over 100 rounds.
WANT = {"drive.exposed_share": 15.0, "drive.draws_ms": 3.0,
        "round.local_ms": 20.0, "round.aggregate_ms": 5.0}


def _read(name, ctx=CTX):
    return manifest.metric(name).read(ctx)


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_nothing(name):
    spans.reset()
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_registry_reads_nothing(name, monkeypatch):
    # An entry of None in sys.modules makes the import raise ImportError,
    # as it does in a checkout whose program has no utils/spans.py.
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_reads_a_hand_built_snapshot(name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert _read(name) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("cell_name", ["mnist_paper.study_fig2",
                                       "mnist_paper.sampled_k50"])
def test_a_small_cell_under_a_cpu_profiler(cell_name):
    """The host readers read a small cell's calls; the device readers read
    nothing on the CPU (no CUDA stream to time)."""
    bench, cfg, traffic, _ = small(cell_name)
    kind = manifest.kind(traffic["kind"])
    seed = cell.seed_base(2 ** 31 + 5)
    device = torch.device("cpu")
    init = manifest.family(cfg["family"]).init_params(cfg, seed, device)
    run = kind.Program(cfg, traffic, seed, device, init)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for _ in range(2):
            run.advance(traffic["rounds_per_call"], traffic["eval_every"])
        window_s = time.perf_counter() - t0
    ctx = {"window_s": window_s}
    snap = spans.snapshot()
    assert snap["counters"]["fl.drive.calls"] == 2
    assert snap["counters"]["fl.drive.rounds"] == \
        2 * traffic["rounds_per_call"]
    assert 0 < _read("drive.exposed_share", ctx) < 100
    assert 0 < _read("drive.draws_ms", ctx) < 1e3 * window_s
    assert _read("round.local_ms", ctx) is None
    assert _read("round.aggregate_ms", ctx) is None
    spans.reset()
