"""The port's simulator end to end against the JAX reference's scan driver.

`mnist_smoke` with int8 compression, 3 rounds at eval_every=2 (two
chunks), from the same JAX-initialised model, with the port's quantizer
noise replaced by the reference's (its keys drawn in the order its scan
chunk draws them, mesh_rounds.build_round_chunk):

  * plan, FedConfig, data, partition and batch indices: identical;
  * Eq. 8 clock (sim_time, T_cm, T_cp) and uplink bits: exactly equal
    (both are the same float64 numpy host model);
  * per-round train loss and final params: float32 tolerance (the
    frameworks reduce convolutions and sums in different orders), with
    an allowance of a few flipped stochastic-rounding codes, each of
    which moves a parameter by at most one quantizer step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import compression as j_comp
from repro.federated import experiment as j_exp
from repro.federated import mesh_rounds as j_rounds
from repro.federated.client import stack_chunk_indices as j_stack
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro.optim import sgd as j_sgd
from repro_torch.convert import to_numpy, to_torch
from repro_torch.federated import compression as t_comp
from repro_torch.federated import experiment as t_exp
from repro_torch.federated import mesh_rounds as t_rounds
from repro_torch.federated.client import stack_chunk_indices as t_stack
from repro_torch.models import cnn as t_cnn
from repro_torch.optim.sgd import sgd as t_sgd
from repro_torch.utils.tree import leaves

ROUNDS, EVAL_EVERY = 3, 2
# Loss: the float32 reduction-order gap after a few SGD steps.
LOSS_RTOL = 1e-5
# Params: one flipped int8 code moves a parameter by one quantizer step,
# scale / C at most (scale = absmax(delta) / 127 <= 1e-3 here).
PARAM_ATOL = 5e-4
# At most this fraction of a round's codes may flip between frameworks:
# a flip needs x / scale + u within a float32 rounding error of an integer.
CODE_FLIP_FRACTION = 1e-3


def _compressed(exp, name):
    spec = exp.get(name)
    return spec.replace(fed=dataclasses.replace(spec.fed,
                                                compress_updates=True))


def _jax_noise(seed, C, rows, rounds):
    """The reference's per-round (C, rows, 1024) quantizer noise."""
    draw = jax.jit(jax.vmap(lambda k: j_noise(k, (rows, t_comp.ROW))))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, keys = j_comp.sequential_client_keys(key, C)
        out.append(np.asarray(draw(keys)))
    return out


@pytest.fixture(scope="module")
def runs():
    j_spec = _compressed(j_exp, "mnist_smoke")
    t_spec = _compressed(t_exp, "mnist_smoke")
    params0 = jax.device_get(j_cnn.init_cnn(j_spec.model_config(),
                                            jax.random.PRNGKey(j_spec.seed)))
    j_sim = j_spec.build()
    j_state, j_res = j_sim.run(j_sim.init(), max_rounds=ROUNDS,
                               eval_every=EVAL_EVERY)
    fed = j_sim.fed
    replay = iter(_jax_noise(fed.seed, fed.n_devices, t_comp.n_rows(params0),
                             ROUNDS))

    def noise(generator, shape):
        u = next(replay)
        assert u.shape == shape
        return torch.tensor(u)

    t_sim = t_spec.build(device="cpu", params=params0, noise=noise)
    t_state, t_res = t_sim.run(t_sim.init(), max_rounds=ROUNDS,
                               eval_every=EVAL_EVERY)
    return {"j_sim": j_sim, "j_res": j_res, "j_state": j_state,
            "t_sim": t_sim, "t_res": t_res, "t_state": t_state,
            "params0": params0}


def test_fed_data_partition_and_batches_identical(runs):
    j_sim, t_sim = runs["j_sim"], runs["t_sim"]
    assert dataclasses.asdict(t_sim.fed) == dataclasses.asdict(j_sim.fed)
    np.testing.assert_array_equal(t_sim.data_sizes, j_sim.data_sizes)
    j_its, t_its = j_sim._data_src(0), t_sim._data_src(0)
    for j_it, t_it in zip(j_its, t_its):
        np.testing.assert_array_equal(t_it.indices, j_it.indices)
    np.testing.assert_array_equal(t_its[0].data.x, j_its[0].data.x)
    np.testing.assert_array_equal(t_its[0].data.y, j_its[0].data.y)
    V = t_sim.fed.local_rounds
    np.testing.assert_array_equal(t_stack(t_its, ROUNDS, V),
                                  j_stack(j_its, ROUNDS, V))


def test_clock_and_uplink_bits_exact(runs):
    j_hist, t_hist = runs["j_res"].history, runs["t_res"].history
    assert len(t_hist) == len(j_hist) == ROUNDS
    for j, t in zip(j_hist, t_hist):
        assert (t.round, t.sim_time, t.T_cm, t.T_cp, t.uplink_bits) == (
            j.round, j.sim_time, j.T_cm, j.T_cp, j.uplink_bits)
        assert (t.test_acc is None) == (j.test_acc is None)
    assert runs["t_state"].round == runs["j_state"].round == ROUNDS
    assert runs["t_state"].sim_time == runs["j_state"].sim_time


def test_loss_and_params_within_tolerance(runs):
    j_hist, t_hist = runs["j_res"].history, runs["t_res"].history
    np.testing.assert_allclose([t.train_loss for t in t_hist],
                               [j.train_loss for j in j_hist],
                               rtol=LOSS_RTOL)
    j_params = jax.device_get(runs["j_res"].params)
    for t, j in zip(leaves(to_numpy(runs["t_res"].params)),
                    jax.tree.leaves(j_params)):
        np.testing.assert_allclose(t, j, rtol=0, atol=PARAM_ATOL)


def test_round_codes_match_up_to_rare_flips(runs, record_property):
    """One round's local training and quantization, side by side: count
    the int8 codes that differ between the frameworks on the same noise."""
    j_sim, t_sim, params0 = runs["j_sim"], runs["t_sim"], runs["params0"]
    fed, cfg = j_sim.fed, t_sim.fed
    C, V = fed.n_devices, fed.local_rounds
    its = t_sim._data_src(0)
    idx = t_stack(its, 1, V)[0]
    x, y = its[0].data.x[idx], its[0].data.y[idx]
    m_cfg = j_cnn.mnist_cnn_small()
    stack = lambda a: np.broadcast_to(a[None], (C,) + a.shape)  # noqa: E731
    j_local = jax.jit(jax.vmap(j_rounds.local_steps_fn(
        lambda p, b: j_cnn.cnn_loss(m_cfg, p, b), j_sgd(cfg.lr))))
    j_new, _, j_loss = j_local(jax.tree.map(stack, params0), (),
                               {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    t_local = t_rounds.local_steps_fn(
        lambda p, b: t_cnn.cnn_loss(t_cnn.mnist_cnn_small(), p, b),
        t_sgd(cfg.lr))
    t_new, _, t_loss = t_local(
        to_torch(jax.tree.map(stack, params0), device="cpu"), (),
        {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)})
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss),
                               rtol=LOSS_RTOL)
    u = _jax_noise(fed.seed, C, t_comp.n_rows(params0), 1)[0]
    d_j = jax.tree.map(lambda n, o: np.asarray(n) - o[None], j_new, params0)
    d_t = jax.tree.map(lambda n, o: n.numpy() - o[None], t_new, params0)
    q_j = t_comp.compress_update(to_torch(d_j, device="cpu"),
                                  torch.tensor(u))["q"]
    q_t = t_comp.compress_update(to_torch(d_t, device="cpu"),
                                  torch.tensor(u))["q"]
    diff = (q_t.to(torch.int32) - q_j.to(torch.int32)).abs()
    flips = int((diff > 0).sum())
    record_property("int8_codes_differing", flips)
    print(f"int8 codes differing: {flips} of {q_t.numel()}")
    assert int(diff.max()) <= 1
    assert flips <= CODE_FLIP_FRACTION * q_t.numel()


def test_mnist_paper_plan_exact():
    plans = {}
    for compress in (False, True):
        j_spec, t_spec = j_exp.get("mnist_paper"), t_exp.get("mnist_paper")
        if compress:
            j_spec, t_spec = (_compressed(j_exp, "mnist_paper"),
                              _compressed(t_exp, "mnist_paper"))
        jp, tp = j_spec.resolve_plan(), t_spec.resolve_plan()
        for f in ("b", "theta", "V", "H_pred", "T_cm", "T_cp", "T_round",
                  "overall_pred", "update_bits"):
            assert getattr(tp, f) == getattr(jp, f), f
        assert dataclasses.asdict(tp.problem) == dataclasses.asdict(jp.problem)
        assert (dataclasses.asdict(t_spec.resolve_fed())
                == dataclasses.asdict(j_spec.resolve_fed()))
        assert t_spec.update_bits() == j_spec.update_bits()
        plans[compress] = (tp.b, tp.V)
    # int8 uplinks cut T_cm 4x, which moves the operating point to a
    # smaller batch and fewer local steps.
    assert plans == {False: (32, 4), True: (16, 2)}


def test_state_is_a_value_and_runs_resume_exactly():
    """A SimState is never consumed: two runs from one state agree, and
    chunk-by-chunk runs continue the noise and batch streams exactly."""
    sim = _compressed(t_exp, "mnist_smoke").build(device="cpu")
    s0 = sim.init()
    a, res = sim.run(s0, max_rounds=4, eval_every=2)
    b, first = sim.run_chunk(s0, 2)
    b, second = sim.run_chunk(b, 2)
    assert [r.train_loss for r in res.history] == [
        r.train_loss for r in first + second]
    assert [r.sim_time for r in res.history] == [
        r.sim_time for r in first + second]
    assert (a.round, a.sim_time) == (b.round, b.sim_time)
    for x, y in zip(leaves(a.params_C), leaves(b.params_C)):
        assert torch.equal(x, y)
