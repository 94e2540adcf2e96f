"""The port's update compression against the JAX reference.

Same deltas (numpy, from a seed), same rounding noise (the reference's
key drawn through its `stochastic_noise`): codes, scales and the
reconstructed tree must be EXACTLY equal, and the wire accounting equal
for every registered model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import compression as j_comp
from repro.federated import experiment as j_exp
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro.models import cnn as j_cnn
from repro_torch.convert import to_numpy, to_torch
from repro_torch.federated import compression as t_comp
from repro_torch.federated import experiment as t_exp
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.tree import leaves


def _deltas(lead=()):
    """A mnist_cnn_small-shaped tree of deltas with leading dims `lead`."""
    rng = np.random.default_rng(11)
    shapes = t_cnn.param_shapes(t_cnn.mnist_cnn_small())
    return {name: {k: (rng.normal(0, 0.01, lead + s)).astype(np.float32)
                   for k, s in layer.items()}
            for name, layer in shapes.items()}


def _assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_compress_roundtrip_matches_jax_exactly():
    d = _deltas()
    key = jax.random.PRNGKey(5)
    comp_j = j_comp.compress_update(jax.tree.map(jnp.asarray, d), key)
    rows = comp_j["q"].shape[0]
    assert rows == t_comp.n_rows(d)
    u = torch.tensor(np.asarray(j_noise(key, (rows, t_comp.ROW))))
    comp_t = t_comp.compress_update(to_torch(d, device="cpu"), u)
    np.testing.assert_array_equal(comp_t["q"].numpy(), np.asarray(comp_j["q"]))
    np.testing.assert_array_equal(comp_t["scale"].numpy(),
                                  np.asarray(comp_j["scale"]))
    rec_t = t_comp.decompress_update(comp_t)
    _assert_trees_equal(to_numpy(rec_t), j_comp.decompress_update(comp_j))
    for x, y in zip(leaves(rec_t), leaves(d)):
        assert x.shape == y.shape


def test_client_batched_roundtrip_matches_per_client_jax():
    """All C clients in one quantize call == the reference's per-client
    roundtrip under its sequential client keys (the simulator's form)."""
    C = 3
    d = _deltas((C,))
    _, keys = j_comp.sequential_client_keys(jax.random.PRNGKey(2), C)
    rows = t_comp.n_rows(_deltas())
    u = torch.tensor(np.stack([np.asarray(j_noise(k, (rows, t_comp.ROW)))
                               for k in keys]))
    rec_j = jax.vmap(lambda t, k: j_comp.decompress_update(
        j_comp.compress_update(t, k)))(jax.tree.map(jnp.asarray, d), keys)
    comp_t = t_comp.compress_update(to_torch(d, device="cpu"), u)
    assert comp_t["q"].shape == (C, rows, t_comp.ROW)
    _assert_trees_equal(to_numpy(t_comp.decompress_update(comp_t)), rec_j)


@pytest.mark.parametrize("model", sorted(t_exp.MODELS))
def test_wire_bits_match_jax(model):
    assert sorted(t_exp.MODELS) == sorted(j_exp.MODELS)
    j_params = jax.eval_shape(
        lambda k: j_cnn.init_cnn(j_exp.MODELS[model](), k),
        jax.random.PRNGKey(0))
    t_params = t_cnn.init_cnn(t_exp.MODELS[model](), 0, "cpu")
    assert t_comp.compressed_bits(t_params) == j_comp.compressed_bits(j_params)
    assert t_comp.raw_bits(t_params) == j_comp.raw_bits(j_params)
