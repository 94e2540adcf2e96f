"""The CNN's stacked gradient (cnn.cnn_stacked_value_and_grad) and the fold
matmul under it, against the JAX reference and the port's autograd.

cnn_stacked_value_and_grad writes the CNN's forward and backward out by
hand over the stacked client axis, every product a fold_matmul (on the CPU
its plain version, torch.matmul). The same numpy inputs go through the
reference's jax.value_and_grad of cnn_loss / cnn_loss_masked, client by client, and
through torch.func's autograd of the port's cnn_loss: losses and every
gradient agree to rtol 1e-5 with an atol of 1e-6 per unit of the tensor's
largest magnitude (tests/test_torch_cnn.py says why). That the products'
sums do not move with N or with padding holds on the card only
(tests/test_torch_fold_matmul_cuda.py, chip_smoke.py's Study phase).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.models import cnn as j_cnn
from repro_torch.convert import to_numpy, to_torch
from repro_torch.kernels.fold_matmul import ops as fm_ops
from repro_torch.kernels.fold_matmul.ref import fold_matmul_ref
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.tree import leaves, tree_map

RTOL, ATOL = 1e-5, 1e-6
MODELS = ("mnist_cnn_tiny", "mnist_cnn_small", "mnist_cnn", "cifar_cnn")
N, B_ENV, B = 3, 6, 4


def assert_close(actual, desired):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=RTOL, atol=ATOL * scale)


def _inputs(model, seed=0):
    """N clients' JAX-initialised params (one init a client) and a padded
    batch: numpy."""
    cfg = getattr(j_cnn, model)()
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    params = jax.device_get(jax.vmap(lambda k: j_cnn.init_cnn(cfg, k))(keys))
    rng = np.random.default_rng(seed)
    h, w = cfg.input_hw
    x = rng.standard_normal((N, B_ENV, h, w, cfg.in_channels)).astype(
        np.float32)
    y = rng.integers(0, 10, (N, B_ENV)).astype(np.int32)
    return params, x, y


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_stacked_grad_matches_reference(model, masked):
    j_cfg, t_cfg = getattr(j_cnn, model)(), getattr(t_cnn, model)()
    params, x, y = _inputs(model)
    mask = (np.arange(B_ENV) < B).astype(np.float32)
    if masked:
        masks = np.tile(mask, (N, 1))
        j_loss, j_grads = jax.jit(jax.vmap(jax.value_and_grad(
            lambda p, x, y: j_cnn.cnn_loss_masked(
                j_cfg, p, {"x": x, "y": y}, mask, np.float32(B))[0])))(
                    params, x, y)
        t_grads, t_loss = t_cnn.cnn_stacked_value_and_grad(
            t_cfg, to_torch(params, device="cpu"),
            {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)},
            torch.tensor(masks), torch.full((N,), float(B)))
    else:
        j_loss, j_grads = jax.jit(jax.vmap(jax.value_and_grad(
            lambda p, x, y: j_cnn.cnn_loss(j_cfg, p, {"x": x, "y": y})[0])))(
                params, x, y)
        t_grads, t_loss = t_cnn.cnn_stacked_value_and_grad(
            t_cfg, to_torch(params, device="cpu"),
            {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)})
    assert_close(t_loss.numpy(), j_loss)
    for t, j in zip(leaves(to_numpy(t_grads)), jax.tree.leaves(j_grads)):
        assert t.shape == j.shape
        assert_close(t, j)


@pytest.mark.parametrize("model", MODELS)
def test_stacked_grad_matches_autograd(model):
    """The hand-written backward against torch.func on the port's own
    cnn_loss, and the masked form against the unpadded batch."""
    cfg = getattr(t_cnn, model)()
    params, x, y = _inputs(model, seed=1)
    tp = to_torch(params, device="cpu")
    batch = {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}
    a_grads, a_loss = vmap(grad_and_value(
        lambda p, b: t_cnn.cnn_loss(cfg, p, b)))(tp, batch)
    s_grads, s_loss = t_cnn.cnn_stacked_value_and_grad(cfg, tp, batch)
    assert_close(s_loss.numpy(), a_loss.numpy())
    for s, a in zip(leaves(s_grads), leaves(a_grads)):
        assert_close(s.numpy(), a.numpy())
    unpadded = {k: v[:, :B] for k, v in batch.items()}
    u_grads, u_loss = t_cnn.cnn_stacked_value_and_grad(cfg, tp, unpadded)
    mask = torch.zeros(N, B_ENV)
    mask[:, :B] = 1.0
    m_grads, m_loss = t_cnn.cnn_stacked_value_and_grad(
        cfg, tp, batch, mask, torch.full((N,), float(B)))
    assert_close(m_loss.numpy(), u_loss.numpy())
    for m, u in zip(leaves(m_grads), leaves(u_grads)):
        assert_close(m.numpy(), u.numpy())


def test_value_and_grad_on_the_cpu_is_torch_func():
    """cnn_value_and_grad takes the hand-written path on the card only: on
    CPU tensors it is torch.func's vmap of cnn_loss / cnn_loss_masked."""
    cfg = t_cnn.mnist_cnn_tiny()
    params, x, y = _inputs("mnist_cnn_tiny", seed=4)
    tp = to_torch(params, device="cpu")
    batch = {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}
    mask = torch.zeros(N, B_ENV)
    mask[:, :B] = 1.0
    n = torch.full((N,), float(B))
    got = t_cnn.cnn_value_and_grad(cfg, tp, batch, mask, n)
    want = vmap(grad_and_value(lambda p, b, m, k: t_cnn.cnn_loss_masked(
        cfg, p, b, m, k)))(tp, batch, mask, n)
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    before = fm_ops.launches
    t_cnn.cnn_value_and_grad(cfg, tp, batch)
    assert fm_ops.launches == before


def test_padded_nonfinite_sample_does_not_leak():
    """A padded sample's image never reaches a product (it is replaced by
    zeros with torch.where), so an Inf or NaN there leaves the loss and
    every gradient as they were."""
    cfg = t_cnn.mnist_cnn_small()
    params, x, y = _inputs("mnist_cnn_small", seed=2)
    tp = to_torch(params, device="cpu")
    mask = torch.zeros(N, B_ENV)
    mask[:, :B] = 1.0
    n = torch.full((N,), float(B))
    batch = {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}
    g0, l0 = t_cnn.cnn_stacked_value_and_grad(cfg, tp, batch, mask, n)
    bad = dict(batch, x=batch["x"].clone())
    bad["x"][:, B] = float("nan")
    bad["x"][:, B + 1] = float("inf")
    g1, l1 = t_cnn.cnn_stacked_value_and_grad(cfg, tp, bad, mask, n)
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", ("mnist_cnn_small", "cifar_cnn"))
def test_logits_stacked_match_reference_forward(model):
    j_cfg, t_cfg = getattr(j_cnn, model)(), getattr(t_cnn, model)()
    params, x, _ = _inputs(model, seed=3)
    images = x[0]
    j_logits = jax.jit(jax.vmap(
        lambda p: j_cnn.cnn_forward(j_cfg, p, jnp.asarray(images))))(params)
    t_logits = t_cnn.cnn_logits_stacked(
        t_cfg, to_torch(params, device="cpu"), torch.tensor(images))
    assert t_logits.shape == (N, B_ENV, 10)
    assert_close(t_logits.numpy(), j_logits)
    one = t_cnn.cnn_logits_stacked(
        t_cfg, tree_map(lambda v: v[1:2], to_torch(params, device="cpu")),
        torch.tensor(images))
    assert torch.equal(one[0], t_logits[1])


@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "broadcast_a"])
def test_fold_matmul_plain_version_on_cpu(layout):
    """On CPU tensors the wrapper is its plain version (counting no
    launch), at any strides, against a float64 product."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 37, 21, generator=g)
    b = torch.randn(3, 21, 70, generator=g)
    if layout == "tn":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "nt":
        b = b.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "broadcast_a":
        a = a[:1].expand(3, 37, 21)
    before = fm_ops.launches
    c = fm_ops.fold_matmul(a, b)
    assert fm_ops.launches == before
    assert c.shape == (3, 37, 70) and c.is_contiguous()
    assert torch.equal(c, fold_matmul_ref(a, b))
    np.testing.assert_allclose(c.double().numpy(),
                               torch.matmul(a.double(), b.double()).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_fold_matmul_rejects_what_the_kernel_does_not_take():
    a, b = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="chain"):
        fm_ops.fold_matmul(a, torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="batch"):
        fm_ops.fold_matmul(a[0], b[0])
    with pytest.raises(TypeError, match="float32"):
        fm_ops.fold_matmul(a.double(), b.double())


def test_fold_matmul_route_follows_the_shape():
    """Few rows, or too few 64 x 64 tiles to fill the card, take the row
    route; the rest the tile route (the two give the same bits, held on the
    card by tests/test_torch_fold_matmul_cuda.py)."""
    assert fm_ops.route_for(60, 1, 64) == "rows"  # a bias gradient
    assert fm_ops.route_for(6, 1, 1605632) == "rows"  # FedAvg's client sum
    assert fm_ops.route_for(60, 25, 32) == "rows"  # conv1's weight gradient
    assert fm_ops.route_for(60, 800, 64) == "tiles"  # conv2's
    assert fm_ops.route_for(60, 6272, 64) == "tiles"  # conv2's forward
