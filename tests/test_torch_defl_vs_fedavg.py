"""examples/defl_vs_fedavg_torch.py, the port's twin of
examples/defl_vs_fedavg.py: `--quick --scenario uniform` on the CPU
against the reference script's rows and JSON.

The twin runs from the reference's initial model (its specs' build() is
handed the reference's He-normal draw; the port's own init draws other
values from torch's generator). Its header and the columns the plans and
the host clock fix (method, b, V, rounds, mean_participants,
overall_time_s, time_to_90) are exact, and so are every record's
sim_time, uplink bits and participants; the accuracies are within
ACC_ATOL (20 of the 400 test samples); the DEFL arm's train losses
(V=4) within LOSS_RTOL over the whole history.

The FedAvg (V=20) and Rand (V=15) arms' losses are printed, not bounded:
at the full MNIST CNN these many local steps from a loss of 5-17 turn a
float32 sum order into a different run. Rand's round 1, from equal
models, is 3.6e-4 of the loss and 2.1e-3 in the params from the
reference's, and one-ulp nudges of the initial model move the port's own
round 1 by as much (ROADMAP queue 3); the accuracies differ by up to
0.025 in this run.
"""
import dataclasses
import importlib.util
import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from repro.models import cnn as j_cnn
from repro_torch.federated import experiment as t_exp

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARGS = ["--quick", "--scenario", "uniform"]
ACC_ATOL = 20 / 400
LOSS_RTOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(text):
    lines = [ln for ln in text.strip().splitlines() if ln]
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fig2")
    mp = pytest.MonkeyPatch()
    capture = {}
    try:
        ref = _load("defl_vs_fedavg")
        mp.setattr(sys, "argv", ["defl_vs_fedavg.py", *ARGS, "--json",
                                 str(tmp / "ref.json")])
        with redirect_stdout(io.StringIO()) as out:
            ref.main()
        capture["ref"] = _printed(out.getvalue())
        twin = _load("defl_vs_fedavg_torch")
        build = t_exp.ExperimentSpec.build
        inits = {}

        def from_reference_init(self, device=None, params=None, **kw):
            key = (self.model, self.seed)
            if key not in inits:
                inits[key] = jax.device_get(j_cnn.init_cnn(
                    self.model_config(), jax.random.PRNGKey(self.seed)))
            return build(self, device=device, params=inits[key], **kw)

        mp.setattr(t_exp.ExperimentSpec, "build", from_reference_init)
        with redirect_stdout(io.StringIO()) as out:
            header, rows, _ = twin.main(
                [*ARGS, "--device", "cpu", "--json", str(tmp / "port.json")])
        capture["port"] = _printed(out.getvalue())
        capture["returned"] = (header, rows)
    finally:
        mp.undo()
    return capture | {
        "ref_json": json.loads((tmp / "ref.json").read_text()),
        "port_json": json.loads((tmp / "port.json").read_text())}


def test_header_and_exact_columns(outputs):
    (j_head, j_rows), (t_head, t_rows) = outputs["ref"], outputs["port"]
    assert t_head == j_head
    header, rows = outputs["returned"]
    assert header == t_head
    assert [[str(x) for x in r] for r in rows] == t_rows
    assert [r[3] for r in t_rows] == ["DEFL", "FedAvg", "Rand",
                                      "reduction_vs_fedavg"]
    cols = t_head.split(",")
    exact = [cols.index(c) for c in ("name", "scenario", "dataset", "method",
                                     "b", "V", "rounds", "mean_participants")]
    for t, j in zip(t_rows, j_rows):
        assert [t[i] for i in exact] == [j[i] for i in exact]
    # The rounds agree, so the clock columns are exact too.
    t_i = cols.index("overall_time_s")
    assert [r[t_i] for r in t_rows] == [r[t_i] for r in j_rows]
    assert [r[cols.index("time_to_90")] for r in t_rows] == [
        r[cols.index("time_to_90")] for r in j_rows]


def test_accuracy_within_tolerance(outputs):
    (j_head, j_rows), (_, t_rows) = outputs["ref"], outputs["port"]
    a = j_head.split(",").index("acc")
    for t, j in zip(t_rows[:3], j_rows[:3]):
        assert abs(float(t[a]) - float(j[a])) <= ACC_ATOL, (t, j)


def test_json_histories(outputs):
    j_js, t_js = outputs["ref_json"], outputs["port_json"]
    assert list(t_js) == list(j_js) == ["uniform/mnist"]
    j_st, t_st = j_js["uniform/mnist"], t_js["uniform/mnist"]
    assert t_st["groups"] == j_st["groups"] == [["DEFL", "FedAvg", "Rand"]]
    for k in ("seeds", "target_acc", "max_sim_time"):
        assert t_st[k] == j_st[k]
    for label, j_arm in j_st["arms"].items():
        t_arm = t_st["arms"][label]
        for k in ("b", "V", "lr", "K", "async", "compress_updates"):
            assert t_arm[k] == j_arm[k], (label, k)
        assert set(t_arm["summary"]) == set(j_arm["summary"])
        for t, j in zip(t_arm["per_seed"], j_arm["per_seed"]):
            assert (t["seed"], t["rounds"], t["total_time"]) == (
                j["seed"], j["rounds"], j["total_time"])
            th, jh = t["history"], j["history"]
            for k in ("round", "sim_time", "n_participants", "uplink_bits",
                      "rejected"):
                assert th[k] == jh[k], (label, k)
            gaps = [abs(a - b) / abs(b) for a, b in
                    zip(th["train_loss"], jh["train_loss"])]
            print(f"{label}: relative loss gaps a round "
                  f"{[float(f'{g:.2g}') for g in gaps]}")
            assert all(np.isfinite(th["train_loss"]))
            if label == "DEFL":
                assert max(gaps) <= LOSS_RTOL, gaps
            for a, b in zip(th["test_acc"], jh["test_acc"]):
                assert abs(a - b) <= ACC_ATOL, (label, a, b)


def test_arm_specs_are_the_references(monkeypatch):
    """The twin's arm specs carry the reference's fields (those the port
    has), so the plans and the fixed baselines are the same runs."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks.fig2_defl_vs_fedavg import arm_specs as j_arm_specs
    twin = _load("defl_vs_fedavg_torch")
    for ds in ("mnist", "cifar"):
        for (jl, js), (tl, ts) in zip(j_arm_specs(ds, "dropout", seed=3),
                                      twin.arm_specs(ds, "dropout", seed=3)):
            assert jl == tl
            t_fields = dataclasses.asdict(ts)
            j_fields = dataclasses.asdict(js)
            for k, v in t_fields.items():
                assert v == j_fields[k], (ds, tl, k)
            assert dataclasses.asdict(ts.resolve_fed()) == \
                dataclasses.asdict(js.resolve_fed())
