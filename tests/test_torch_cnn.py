"""The port's FedAvg CNN against the JAX reference.

JAX-initialised parameters carried over by convert.py, the same numpy
images: logits, loss and every gradient agree to rtol 1e-5 and an atol of
1e-6 per unit of the compared tensor's largest magnitude. The two
frameworks sum their float32 convolutions and matmuls in a different
order (XLA's im2col GEMM against oneDNN's direct convolution), which errs
by a few ulps of the largest terms of a sum, not of its result: an entry
that cancels to near zero (a logit of the full-width model, after a
3136-long fc1 sum) needs the absolute term at the tensor's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.models import cnn as j_cnn
from repro_torch.convert import to_numpy, to_torch
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.tree import leaves

RTOL, ATOL = 1e-5, 1e-6


def assert_close(actual, desired):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=RTOL, atol=ATOL * scale)

MODELS = ("mnist_cnn_tiny", "mnist_cnn_small", "mnist_cnn")


@pytest.fixture(scope="module")
def jax_params():
    """JAX-initialised params of every model, from one compiled init."""
    init = jax.jit(lambda k: {m: j_cnn.init_cnn(getattr(j_cnn, m)(), k)
                              for m in MODELS})
    return init(jax.random.PRNGKey(3))


@pytest.mark.parametrize("model", MODELS)
def test_cnn_matches_jax(model, jax_params):
    j_cfg = getattr(j_cnn, model)()
    t_cfg = getattr(t_cnn, model)()
    j_params = jax_params[model]
    t_params = to_torch(jax.tree.map(np.asarray, j_params), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 28, 28, 1)).astype(np.float32)
    y = np.array([3, 7], np.int32)

    logits_j = jax.jit(lambda p, x: j_cnn.cnn_forward(j_cfg, p, x))(
        j_params, jnp.asarray(x))
    logits_t = t_cnn.cnn_forward(t_cfg, t_params, torch.tensor(x))
    assert_close(logits_t.numpy(), logits_j)

    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: j_cnn.cnn_loss(j_cfg, p, {"x": jnp.asarray(x),
                                            "y": jnp.asarray(y)}),
        has_aux=True))(j_params)
    grads_t, loss_t = grad_and_value(
        lambda p: t_cnn.cnn_loss(t_cfg, p, {
            "x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)})
    )(t_params)
    assert_close(float(loss_t), float(loss_j))
    for g_t, g_j in zip(leaves(to_numpy(grads_t)), jax.tree.leaves(grads_j)):
        assert g_t.shape == g_j.shape
        assert_close(g_t, g_j)


def test_param_shapes_match_jax():
    for model in ("mnist_cnn_tiny", "mnist_cnn_small", "mnist_cnn",
                  "cifar_cnn"):
        j_params = jax.eval_shape(
            lambda k: j_cnn.init_cnn(getattr(j_cnn, model)(), k),
            jax.random.PRNGKey(0))
        t_params = t_cnn.init_cnn(getattr(t_cnn, model)(), 0, "cpu")
        assert [tuple(x.shape) for x in leaves(t_params)] == [
            tuple(x.shape) for x in jax.tree.leaves(j_params)]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    """Three SGD steps on the same gradients: same params and state."""
    from repro.optim import sgd as j_sgd
    from repro_torch.optim.api import apply_updates
    from repro_torch.optim.sgd import sgd as t_sgd

    rng = np.random.default_rng(1)
    p0 = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                          p0) for _ in range(3)]
    j_opt, t_opt = j_sgd(0.05, momentum), t_sgd(0.05, momentum)
    jp, tp = jax.tree.map(jnp.asarray, p0), to_torch(p0, device="cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for g in grads:
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, ts = t_opt.update(to_torch(g, device="cpu"), ts, tp)
        tp = apply_updates(tp, tu)
    for t, j in zip(leaves(to_numpy(tp)) + leaves(to_numpy(ts)),
                    jax.tree.leaves(jp) + jax.tree.leaves(js)):
        np.testing.assert_array_equal(t, np.asarray(j))
