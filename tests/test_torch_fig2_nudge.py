"""Fig. 2's many-local-step arms: round 1 of the port against the reference,
bounded by the reference's own sensitivity to a one-ulp nudge.

examples/defl_vs_fedavg_torch.py's FedAvg (b=10, V=20) and Rand (b=16,
V=15) arms, `--quick` data (600 samples), the full MNIST CNN, `uniform`,
on the CPU. tests/test_torch_defl_vs_fedavg.py prints these arms'
histories instead of bounding them: at these V a float32 sum order
becomes a different run. Measured here, one round from equal models:
the reference's own round 1 moves, when every weight of its initial model
is nudged by at most one ulp (x (1 + k 2^-23), k in {-1, 0, 1}), by as
much as the port's round 1 differs from it. So the port's gap is held to
a V-aware bound: the member contract (1e-5 of the loss, 5e-4 in the
params), or a multiple of the reference's own one-ulp move at that arm,
whichever is larger. The move is the largest over NUDGE_SEEDS draws of
the nudge: at Rand most draws flip one discrete event of the round and
move it by the same amount, some flip none. The multiples: 4 in the
loss, 1 in the params. On a 2-core CPU container (one torch thread)
Rand's gap reads about 2x the largest move in the loss and 0.6x in the
params (the test's printed line); FedAvg's sits inside the member
contract. Where the bound is looser than the member contract, the test
also runs the port with one local step fewer (V - 1) and requires that
gap to exceed the bound: the bound catches a skipped step.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.fig2_defl_vs_fedavg import arm_specs as j_arm_specs
from repro.federated.mesh_rounds import replicate_clients as j_replicate
from repro.models import cnn as j_cnn
from repro_torch.utils.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
LOSS_NUDGE_FACTOR = 4.0
PARAM_NUDGE_FACTOR = 1.0
NUDGE_SEEDS = (11, 12, 13, 14)


def _twin():
    spec = importlib.util.spec_from_file_location(
        "defl_vs_fedavg_torch", ROOT / "examples" / "defl_vs_fedavg_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nudged(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (x * (1 + rng.choice([-1.0, 0.0, 1.0], size=x.shape)
                        * 2.0 ** -23)).astype(np.float32), params)


def _reference_rounds(spec, models):
    """Round 1 of the reference from each initial model, on one simulator
    (one compilation)."""
    sim = spec.replace(with_eval=False).build()
    out = []
    for params in models:
        st = dataclasses.replace(sim.init(), params_C=j_replicate(
            jax.tree.map(jnp.asarray, params), sim.fed.n_devices))
        st, res = sim.run(st, max_rounds=1)
        out.append((res.history[0].train_loss,
                    [np.asarray(x) for x in jax.tree.leaves(sim.params(st))]))
    return out


def _port_round(spec, params):
    sim = spec.replace(with_eval=False).build(device="cpu", params=params)
    st, res = sim.run(sim.init(), max_rounds=1)
    return res.history[0].train_loss, [x.numpy() for x in
                                       leaves(sim.params(st))]


def _gap(a, b):
    return (abs(a[0] - b[0]) / abs(b[0]),
            max(float(np.abs(x - y).max()) for x, y in zip(a[1], b[1])))


@pytest.mark.parametrize("arm,V", [("FedAvg", 20), ("Rand", 15)])
def test_round_one_within_the_references_own_nudge(arm, V, record_property):
    j_spec = dict(j_arm_specs("mnist", "uniform", n_train=600))[arm]
    t_spec = dict(_twin().arm_specs("mnist", "uniform", n_train=600))[arm]
    assert j_spec.fed.local_rounds == t_spec.fed.local_rounds == V
    params0 = jax.device_get(j_cnn.init_cnn(
        j_spec.model_config(), jax.random.PRNGKey(j_spec.seed)))
    ref, *nudged = _reference_rounds(
        j_spec, [params0] + [_nudged(params0, s) for s in NUDGE_SEEDS])
    moves = [_gap(n, ref) for n in nudged]
    ref_move = (max(m[0] for m in moves), max(m[1] for m in moves))
    port_gap = _gap(_port_round(t_spec, params0), ref)
    bound = (max(LOSS_RTOL, LOSS_NUDGE_FACTOR * ref_move[0]),
             max(PARAM_ATOL, PARAM_NUDGE_FACTOR * ref_move[1]))
    for name, value in (("ref_nudge_loss", ref_move[0]),
                        ("ref_nudge_params", ref_move[1]),
                        ("port_gap_loss", port_gap[0]),
                        ("port_gap_params", port_gap[1])):
        record_property(name, value)
    print(f"{arm} (V={V}) round 1: reference's one-ulp moves (loss, params) "
          + ", ".join(f"{m[0]:.4g}/{m[1]:.4g}" for m in moves)
          + f"; port vs reference loss {port_gap[0]:.4g} params "
          f"{port_gap[1]:.4g}; bound {bound[0]:.4g} / {bound[1]:.4g}")
    assert port_gap[0] <= bound[0]
    assert port_gap[1] <= bound[1]
    if bound != (LOSS_RTOL, PARAM_ATOL):
        fed = dataclasses.replace(t_spec.fed, theta=float(
            np.exp(-(V - 1) / t_spec.fed.nu)))
        assert fed.local_rounds == V - 1
        skipped = _gap(_port_round(t_spec.replace(fed=fed), params0), ref)
        print(f"{arm}: port with V - 1 local steps vs reference loss "
              f"{skipped[0]:.4g} params {skipped[1]:.4g}")
        assert skipped[0] > bound[0] and skipped[1] > bound[1]
