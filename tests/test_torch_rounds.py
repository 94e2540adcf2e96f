"""One DEFL round step of the port against the reference's, per aggregation
mode: the same stacked params and batches (numpy, from a seed),
the same FedAvg weights and, for int8, the reference's quantizer noise.

Per-client losses agree to float32 reduction order (rtol 1e-5). The
aggregated params agree to 1e-6 per unit of their magnitude for the
float32 mean; with int8 a flipped stochastic-rounding code may move a
parameter by one quantizer step times its client's weight (<= 5e-4 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import compression as j_comp
from repro.federated import mesh_rounds as j_rounds
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro.optim import sgd as j_sgd
from repro_torch.convert import to_numpy, to_torch
from repro_torch.federated import compression as t_comp
from repro_torch.federated import mesh_rounds as t_rounds
from repro_torch.models import cnn as t_cnn
from repro_torch.optim.sgd import sgd as t_sgd
from repro_torch.utils.tree import leaves

C, V, B, LR = 3, 2, 4, 0.05
ATOL = {"allreduce": 1e-6, "int8_stochastic": 5e-4}


@pytest.mark.parametrize("aggregation", ["allreduce", "int8_stochastic"])
def test_round_step_matches_jax(aggregation):
    j_cfg, t_cfg = j_cnn.mnist_cnn_small(), t_cnn.mnist_cnn_small()
    rng = np.random.default_rng(2)
    p0 = {name: {k: (rng.normal(0, 0.1, shape)).astype(np.float32)
                 for k, shape in layer.items()}
          for name, layer in t_cnn.param_shapes(t_cfg).items()}
    stacked = jax.tree.map(lambda a: np.stack([a] * C), p0)
    x = rng.normal(0, 1, (C, V, B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (C, V, B)).astype(np.int32)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    _, keys = j_comp.sequential_client_keys(jax.random.PRNGKey(9), C)

    j_step = jax.jit(j_rounds.build_round_step(
        lambda p, b: j_cnn.cnn_loss(j_cfg, p, b), j_sgd(LR), V,
        aggregation=aggregation))
    j_p, _, j_m = j_step(jax.tree.map(jnp.asarray, stacked), (),
                         {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         jnp.asarray(w),
                         keys=keys if aggregation != "allreduce" else None)

    u = None
    if aggregation == "int8_stochastic":
        rows = t_comp.n_rows(p0)
        u = torch.tensor(np.stack([np.asarray(j_noise(k, (rows, t_comp.ROW)))
                                   for k in keys]))
    t_step = t_rounds.build_round_step(
        lambda p, b: t_cnn.cnn_stacked_value_and_grad(t_cfg, p, b),
        t_sgd(LR),
        aggregation)
    t_p, _, t_loss, _ = t_step(
        to_torch(stacked, device="cpu"), (),
        {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)},
        torch.tensor(w), u)

    np.testing.assert_allclose(t_loss.numpy(),
                               np.asarray(j_m["per_client_loss"]), rtol=1e-5)
    for t, j in zip(leaves(to_numpy(t_p)), jax.tree.leaves(j_p)):
        j = np.asarray(j)
        assert t.shape == j.shape
        assert (t == t[0]).all()  # every client row holds the global model
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL[aggregation] * scale)
