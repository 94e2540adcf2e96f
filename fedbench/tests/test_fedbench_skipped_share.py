"""The reader of study.skipped_share, the share of a Study group's envelope
sample-steps its local steps skip (the program's counters
fl.envelope.sample_steps and fl.envelope.full_sample_steps): nothing where
the run recorded nothing, the program has no registry or no such
counters, the right number from a hand-built snapshot, and a small Study
cell's calls under a CPU profiler read as its members' plans reckon."""
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fedbench.harness import cell, manifest, program
from fedbench.reference import clock
from fedbench.tests.small import small
from repro_torch.utils import spans

NAME = "study.skipped_share"
CTX = {"window_s": 4.0}
# The MNIST Study's schedule a client of each of its four arms: 818 of
# 2,560 envelope sample-steps computed.
SNAPSHOT = {"spans": {}, "device": {},
            "counters": {"fl.drive.rounds": 10,
                         "fl.envelope.sample_steps": 818,
                         "fl.envelope.full_sample_steps": 2560}}


def _read(ctx=CTX):
    return manifest.metric(NAME).read(ctx)


def test_nothing_recorded_reads_nothing():
    spans.reset()
    assert _read() is None


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)
    assert _read() is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    """A program whose spans have no envelope counters (the fleet and
    sampled cells', or a program before them)."""
    snap = {**SNAPSHOT, "counters": {"fl.drive.rounds": 10}}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    assert _read() is None


def test_reads_a_hand_built_snapshot(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert _read() == pytest.approx(100.0 * (1 - 818 / 2560), rel=1e-12)


def test_a_small_study_under_a_cpu_profiler():
    bench, cfg, traffic, _ = small("mnist_paper.study_fig2")
    kind = manifest.kind(traffic["kind"])
    seed = cell.seed_base(2 ** 31 + 7)
    device = torch.device("cpu")
    init = program.init_params(clock.param_shapes(cfg["model"]), seed,
                               device)
    run = kind.Program(cfg, traffic, seed, device, init)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            run.advance(traffic["rounds_per_call"], traffic["eval_every"])
    got = _read()
    spans.reset()
    # The members by V, largest first: step v computes the lanes whose
    # member has V > v, at the largest b among them.
    plans = sorted(run.plans(), key=lambda bV: -bV[1])
    C = cfg["fed"]["n_devices"]
    V_env = max(V for _, V in plans)
    B_env = max(b for b, _ in plans)
    done = sum(C * sum(V > v for _, V in plans)
               * max(b for b, V in plans if V > v) for v in range(V_env))
    full = C * len(plans) * V_env * B_env
    assert len({bV for bV in plans}) > 1
    assert got == pytest.approx(100.0 * (1 - done / full), rel=1e-12)
    assert 0 < got < 100
