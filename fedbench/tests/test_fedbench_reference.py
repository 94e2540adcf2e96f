"""The plain reference agrees with repro_torch at mnist_cnn_small width on
the CPU over the window's first call: one Study member-round (every arm
padded into the group's envelope but the one that sets it), a chunk of
int8 fleet rounds and a chunk of sampled rounds: the plan and the Eq. 8
records exactly, the loss and each leaf's change to float32 rounding. And
the control (the reference in TF32) and planted faults (a half-batch
step; in the Study, a padded step's loss divided by B_env) are told apart
from it by the cells' limits."""
import pytest
import torch

from fedbench.harness import cell, manifest
from fedbench.tests.small import small

CELLS = ["mnist_paper.study_fig2", "mnist_paper.fleet16_int8",
         "mnist_paper.sampled_k50"]
DEV = torch.device("cpu")


def _followed(cell_name, calls=1, seed=2 ** 31 + 3):
    bench, cfg, traffic, limits = small(cell_name)
    traffic["check_rounds"] = calls * traffic["rounds_per_call"]
    kind = manifest.kind(traffic["kind"])
    base = cell.seed_base(seed)
    init = manifest.family(cfg["family"]).init_params(cfg, base, DEV)
    run = kind.Program(cfg, traffic, base, DEV, init)
    followed = cell.first_rounds(run, init, traffic)
    members, ref = cell.reference(kind, cfg, traffic, base, init, DEV)
    return run, followed, members, ref, (kind, cfg, traffic, base, init,
                                         limits)


@pytest.mark.parametrize("cell_name", CELLS)
def test_one_round_agrees_with_the_program(cell_name):
    run, followed, members, ref, _ = _followed(cell_name)
    assert run.plans() == [(m.b, m.V) for m in members]
    assert cell.record_mismatches(run.hist, members) == 0
    got = cell.readings(followed, ref, members)
    assert got["loss_gap"] < 1e-5, got
    assert got["stepn_gap"] < 1e-4 and got["stepn_total_gap"] < 1e-5, got


def test_study_members_are_padded():
    run, *_ = _followed("mnist_paper.study_fig2")
    envelope = (max(V for _, V in run.plans()), max(b for b, _ in
                                                    run.plans()))
    assert sum((V, b) != envelope for b, V in run.plans()) >= 2
    assert 0.0 < run.extras()["padding_share"] < 1.0


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_and_half_batch_fail_the_limits(cell_name):
    """The planted faults fail the cell's limits. The limits are set for
    the card's sizes, where the TF32 control reads above them (PERF.md);
    at this width it has to read over a hundred times the sound run's
    worst on some compared number."""
    calls = 3 if cell_name.endswith("study_fig2") else 1
    _, followed, members, ref, (kind, cfg, traffic, base, init, limits) = \
        _followed(cell_name, calls)
    sound = cell.readings(followed, ref, members)
    compared = [k for k in limits["limits"] if k in sound]
    _, tf32 = cell.reference(kind, cfg, traffic, base, init, DEV, mode="tf32")
    got = cell.readings(tf32, ref, members)
    assert any(got[k] > 100 * max(sound[k], 1e-9) for k in compared), got
    faults = [{"half_batch": True}]
    if cell_name.endswith("study_fig2"):
        faults.append({"mean_over_envelope": True})
    for kw in faults:
        _, other = cell.reference(kind, cfg, traffic, base, init, DEV, **kw)
        got = cell.readings(other, ref, members)
        assert any(got[k] > v for k, v in limits["limits"].items()
                   if k in got), (kw, got)


def test_member_median_holds_the_fleet_and_not_its_one_far_member():
    """The worst member's gap swings with one member that a rounding tie
    carries far; the median over the members does not, and a fault that
    moves every member moves both."""
    from types import SimpleNamespace

    from fedbench.reference.rounds import Trace

    change = {10: {"a": 1.0, "b": 2.0}}
    ref = [Trace(losses=[1.0, 0.5], changes=change) for _ in range(5)]
    runs = [Trace(losses=[1.0 + 1e-7, 0.5], changes=change)
            for _ in range(4)]
    runs.append(Trace(losses=[1.0 + 4e-4, 0.5], changes=change))
    members = [SimpleNamespace(label="run")] * 5
    got = cell.readings(runs, ref, members)
    assert abs(got["loss_gap_r1"] - 4e-4) < 1e-9
    assert abs(got["member_median.loss_gap_r1"] - 1e-7) < 1e-12
    every = [Trace(losses=[1.0 + 3e-4, 0.5], changes=change)
             for _ in range(5)]
    got = cell.readings(every, ref, members)
    assert abs(got["member_median.loss_gap_r1"] - 3e-4) < 1e-9
