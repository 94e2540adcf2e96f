"""examples/quickstart_torch.py, the port's twin of examples/quickstart.py.

Its spec is the reference quickstart's, field for field (read from that
script's own ExperimentSpec call), and its DEFL plan equals the
reference's exactly. Five rounds from the reference's initial model, as
the quickstart runs them: Eq. 8 clock exact, losses within LOSS_RTOL and
params within PARAM_ATOL (tests/test_torch_simulator.py's bounds). The
script runs to its end on the CPU in a subprocess.
"""
import dataclasses
import importlib.util
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.federated import experiment as j_exp
from repro.models import cnn as j_cnn
from repro_torch.convert import to_numpy
from repro_torch.utils.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def specs():
    """(the reference quickstart's spec, the twin's SPEC): the reference's
    is captured from its main() at its ExperimentSpec call."""
    ref = _load("quickstart")

    def capture(**kw):
        raise _Captured(kw)

    ref.ExperimentSpec = capture
    with pytest.raises(_Captured) as caught:
        ref.main()
    return (j_exp.ExperimentSpec(**caught.value.args[0]),
            _load("quickstart_torch").SPEC)


def test_spec_and_plan_equal_the_reference_quickstarts(specs):
    j_spec, t_spec = specs
    j_fields = dataclasses.asdict(j_spec)
    for name, value in dataclasses.asdict(t_spec).items():
        assert value == j_fields[name], name
    assert (t_spec.heterogeneity, t_spec.with_eval, t_spec.dataset) == (
        0.2, False, "mnist")
    for method in ("closed_form", "corrected", "numerical"):
        jp = j_spec.replace(plan_method=method).resolve_plan()
        tp = t_spec.replace(plan_method=method).resolve_plan()
        for f in ("b", "theta", "V", "H_pred", "T_cm", "T_cp", "T_round",
                  "overall_pred", "update_bits"):
            assert getattr(tp, f) == getattr(jp, f), (method, f)
        assert (dataclasses.asdict(tp.solution)
                == dataclasses.asdict(jp.solution))
    assert (dataclasses.asdict(t_spec.resolve_fed())
            == dataclasses.asdict(j_spec.resolve_fed()))


def test_five_rounds_agree_with_the_reference(specs):
    j_spec, t_spec = specs
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    _, j_res = j_sim.run(j_sim.init(), max_rounds=5)
    t_sim = t_spec.build(device="cpu", params=params0)
    _, t_res = t_sim.run(t_sim.init(), max_rounds=5)
    assert len(t_res.history) == len(j_res.history) == 5
    for t, j in zip(t_res.history, j_res.history):
        assert (t.round, t.sim_time, t.T_cm, t.T_cp, t.uplink_bits) == (
            j.round, j.sim_time, j.T_cm, j.T_cp, j.uplink_bits)
        assert t.test_acc is None and j.test_acc is None
    np.testing.assert_allclose([t.train_loss for t in t_res.history],
                               [j.train_loss for j in j_res.history],
                               rtol=LOSS_RTOL)
    for t, j in zip(leaves(to_numpy(t_res.params)),
                    jax.tree.leaves(jax.device_get(j_res.params))):
        np.testing.assert_allclose(t, j, rtol=0, atol=PARAM_ATOL)


def test_script_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("DEFL plan: b*=")
    assert [ln.split(":")[0] for ln in lines[1:6]] == [
        f"round {r}" for r in range(1, 6)]
    assert lines[6].startswith("fleet over 4 seeds: final loss ")
