"""The port's server.py and client.py against the reference's
(tests/test_federated.py's aggregation, local-update and round-step
tests), from the same numpy inputs.

FedAvg, one client's V local steps and the stacked round against the
per-client loop: float32 tolerance, rtol 1e-5 (the reference's own
bound; the port's FedAvg is one fma chain a weight, the reference's a
multiply and an add a client). The reference's int8_gather aggregation
has no counterpart: it belongs with client sharding (ROADMAP.md,
queue 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import client as j_client
from repro.federated import server as j_server
from repro.federated.mesh_rounds import build_round_step as j_round_step
from repro.federated.mesh_rounds import replicate_clients as j_replicate
from repro.optim import sgd as j_sgd
from repro_torch.federated import client as t_client
from repro_torch.federated import mesh_rounds as t_rounds
from repro_torch.federated import server as t_server
from repro_torch.optim.sgd import sgd as t_sgd

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """Small models run fastest on one intra-op thread, and the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_quad(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * jnp.sum(diff * diff), {}


def _t_quad(params, batch):
    diff = params["w"] - batch["target"]
    return 0.5 * torch.sum(diff * diff)


T_VG = t_rounds.vmapped_value_and_grad(_t_quad)


def test_aggregate_weighted_mean():
    g = np.zeros(3, np.float32)
    deltas = [np.ones(3, np.float32), 3 * np.ones(3, np.float32)]
    t_out = t_server.aggregate_updates(
        {"w": torch.tensor(g)}, [{"w": torch.tensor(d)} for d in deltas],
        [1, 3])
    j_out = j_server.aggregate_updates(
        {"w": jnp.asarray(g)}, [{"w": jnp.asarray(d)} for d in deltas],
        [1, 3])
    np.testing.assert_allclose(t_out["w"].numpy(), 2.5 * np.ones(3))
    np.testing.assert_allclose(t_out["w"].numpy(), np.asarray(j_out["w"]),
                               rtol=RTOL)


def test_aggregate_many_clients_matches_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 5)).astype(np.float32)
    deltas = [rng.standard_normal((4, 5)).astype(np.float32) * 1e-2
              for _ in range(7)]
    sizes = rng.integers(10, 200, size=7)
    t_out = t_server.aggregate_updates(
        {"a": {"w": torch.tensor(g)}},
        [{"a": {"w": torch.tensor(d)}} for d in deltas], sizes)
    j_out = j_server.aggregate_updates(
        {"a": {"w": jnp.asarray(g)}},
        [{"a": {"w": jnp.asarray(d)}} for d in deltas], sizes)
    np.testing.assert_allclose(t_out["a"]["w"].numpy(),
                               np.asarray(j_out["a"]["w"]), rtol=RTOL,
                               atol=1e-7)
    assert t_server.broadcast(t_out, 3) == [t_out] * 3


def test_local_update_descends_quadratic():
    opt = t_sgd(0.1)
    params = {"w": torch.zeros(4)}
    lu = t_client.make_local_update(T_VG, opt)
    target = np.ones(4, np.float32)
    batches = {"target": torch.tensor(np.tile(target[None, None], (10, 1, 1)))}
    delta, _, losses = t_client.client_round(lu, params, opt.init(params),
                                             batches)
    assert losses.shape == (10,)
    assert float(losses[-1]) < float(losses[0])
    # 10 steps of lr=0.1 on the quadratic: w -> 1 - 0.9^10
    np.testing.assert_allclose(delta["w"].numpy(),
                               (1 - 0.9 ** 10) * np.ones(4), rtol=RTOL)
    j_lu = j_client.make_local_update(_j_quad, j_sgd(0.1))
    j_delta, _, j_losses = j_client.client_round(
        j_lu, {"w": jnp.zeros(4)}, (),
        {"target": jnp.asarray(np.tile(target[None, None], (10, 1, 1)))})
    np.testing.assert_allclose(delta["w"].numpy(), np.asarray(j_delta["w"]),
                               rtol=RTOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=RTOL)


def test_local_update_is_a_row_of_the_stacked_steps():
    """make_local_update runs mesh_rounds.local_steps on a one-row stack:
    with momentum, its params, optimizer state and V-step mean loss are
    the stacked steps' row (elementwise model: bit for bit)."""
    rng = np.random.default_rng(1)
    opt = t_sgd(0.05, momentum=0.9)
    C, V = 3, 4
    targets = torch.tensor(rng.standard_normal((C, V, 2, 6)).astype(
        np.float32))
    w0 = torch.tensor(rng.standard_normal(6).astype(np.float32))
    stacked = t_rounds.replicate_clients({"w": w0}, C)
    p_C, s_C, loss_C = t_rounds.local_steps_fn(T_VG, opt)(
        stacked, opt.init(stacked), {"target": targets})
    lu = t_client.make_local_update(T_VG, opt)
    for c in range(C):
        p, s, losses = lu({"w": w0}, opt.init({"w": w0}),
                          {"target": targets[c]})
        assert torch.equal(p["w"], p_C["w"][c])
        assert torch.equal(s["w"], s_C["w"][c])
        assert torch.equal(t_rounds.fold_mean(list(losses)), loss_C[c])


def test_stacking_helpers_consume_in_loop_order():
    """stack_client_batches and stack_chunk_batches draw round by round,
    client by client, step by step: the reference's helpers' output."""
    from repro.data import BatchIterator as JIter
    from repro.data import make_mnist_like
    from repro_torch.data.pipeline import BatchIterator as TIter

    data = make_mnist_like(120, seed=0)
    parts = np.array_split(np.arange(120), 3)

    def iters(cls):
        return [cls(data, p, 8, seed=i) for i, p in enumerate(parts)]

    t_its, j_its = iters(TIter), iters(JIter)
    t_one = t_client.stack_client_batches(t_its, 2)
    j_one = j_client.stack_client_batches(j_its, 2)
    t_chunk = t_client.stack_chunk_batches(t_its, 3, 2)
    j_chunk = j_client.stack_chunk_batches(j_its, 3, 2)
    for t, j in ((t_one, j_one), (t_chunk, j_chunk)):
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k], np.asarray(j[k]))
    assert t_chunk["x"].shape == (3, 3, 2, 8, 28, 28, 1)
    stacked = t_client.stack_batches([{"a": np.ones(2)}, {"a": np.zeros(2)}])
    np.testing.assert_array_equal(stacked["a"], [[1.0, 1.0], [0.0, 0.0]])


def test_mesh_round_step_equals_host_fedavg():
    """The stacked round step == the per-client loop + the weighted mean
    (reference: test_federated.py), and == the reference's stacked step."""
    C, V = 3, 5
    params = np.arange(4, dtype=np.float32)
    targets = np.stack([np.full(4, t, np.float32) for t in (0.0, 1.0, 2.0)])
    batches = np.stack([np.tile(targets[c][None, None], (V, 1, 1))
                        for c in range(C)])
    weights = np.asarray([0.2, 0.3, 0.5], np.float32)
    opt = t_sgd(0.1)
    step = t_rounds.build_round_step(T_VG, opt)
    stacked = t_rounds.replicate_clients({"w": torch.tensor(params)}, C)
    new_p, _, _, _ = step(stacked, (), {"target": torch.tensor(batches)},
                          torch.tensor(weights))
    lu = t_client.make_local_update(T_VG, opt)
    client_params = [lu({"w": torch.tensor(params)}, (),
                        {"target": torch.tensor(batches[c])})[0]["w"].numpy()
                     for c in range(C)]
    expect = sum(w * p for w, p in zip(weights, client_params))
    j_step = j_round_step(_j_quad, j_sgd(0.1), V)
    j_p, _, _ = j_step(j_replicate({"w": jnp.asarray(params)}, C), (),
                       {"target": jnp.asarray(batches)}, jnp.asarray(weights))
    for c in range(C):  # broadcast: every row equals the aggregate
        np.testing.assert_allclose(new_p["w"][c].numpy(), expect, rtol=RTOL)
        np.testing.assert_allclose(new_p["w"][c].numpy(),
                                   np.asarray(j_p["w"][c]), rtol=RTOL)
