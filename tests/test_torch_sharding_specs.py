"""The port's sharding specs (repro_torch/sharding/specs.py) against the
reference's (repro/sharding/specs.py), leaf for leaf, for all ten archs
on both production meshes: `param_specs` without and with the client
axes (the train pair's client-stacked params) and `cache_specs` at
decode_32k and long_500k, on the port's own fake-tensor params and
caches beside the reference's `jax.eval_shape` of its own.

The reference's specs read only the mesh's `.shape`, so it gets a
duck-typed mesh: no 256 or 512 placeholder devices are made here. Also
`shard_shape` / `sharded_bytes` (the stand-ins for `named_shardings`)
and the mesh objects.
"""
import functools
import types
from collections import OrderedDict

import jax
import pytest
import torch
from jax.sharding import PartitionSpec
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as j_registry
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import MeshConfig as JMeshConfig
from repro.launch.specs_inputs import adapt_config as j_adapt
from repro.models import transformer as j_tfm
from repro.sharding import specs as j_specs
from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, MeshConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.specs_inputs import TensorSpec, adapt_config
from repro_torch.models import transformer as tfm
from repro_torch.sharding import specs
from repro_torch.utils.tree import leaves_with_path, tree_map

MESHES = {"single": False, "multi": True}


def _duck(multi):
    mc = JMeshConfig(multi_pod=multi)
    return types.SimpleNamespace(shape=OrderedDict(zip(mc.axes, mc.shape)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The dry run's fake params (the port's init_params tree)."""
    with FakeTensorMode():
        p = dryrun._abstract_params(registry.get_config(arch))
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), p)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(functools.partial(
        j_tfm.init_params, j_registry.get_config(arch)),
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_cache(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    cfg = adapt_config(registry.get_config(arch), shape)
    with FakeTensorMode():
        cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="cpu")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else t, cache)


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape_name):
    shape = J_SHAPES[shape_name]
    j_cfg = j_adapt(j_registry.get_config(arch), shape)
    return jax.eval_shape(functools.partial(
        j_tfm.init_cache, j_cfg, shape.global_batch, shape.seq_len))


def _ref_flat(spec_tree):
    """{path of str keys: spec tuple} of a reference PartitionSpec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(s) for path, s in flat}


def _port_flat(abstract, spec_tree):
    return {tuple(str(k) for k in path): specs.at_path(spec_tree, path)
            for path, _ in leaves_with_path(abstract)}


def _ref_shapes(abstract):
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(x.shape) for path, x in flat}


def _port_shapes(abstract):
    return {tuple(str(k) for k in path): tuple(getattr(x, "shape", ()))
            for path, x in leaves_with_path(abstract)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_match_the_reference(arch, mesh_name):
    multi = MESHES[mesh_name]
    duck = _duck(multi)
    mesh = port_mesh.make_production_mesh(multi_pod=multi)
    assert mesh.shape == duck.shape
    port, ref = _port_params(arch), _ref_params(arch)
    assert _port_shapes(port) == _ref_shapes(ref)
    got = _port_flat(port, specs.param_specs(port, mesh))
    assert got == _ref_flat(j_specs.param_specs(ref, duck))
    # The train pair's client-stacked params, client axes first.
    C = MeshConfig(multi_pod=multi).n_clients
    axes = MeshConfig(multi_pod=multi).client_axes
    port_C = tree_map(lambda s: TensorSpec((C, *s.shape), s.dtype), port)
    ref_C = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct((C, *s.shape), s.dtype), ref)
    got = _port_flat(port_C, specs.param_specs(port_C, mesh,
                                               client_axes=axes))
    want = _ref_flat(j_specs.param_specs(ref_C, duck, client_axes=axes))
    assert got == want
    assert all(s[0] == (axes if multi else axes[0]) for s in got.values())


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cache_specs_match_the_reference(arch, mesh_name, shape_name):
    multi = MESHES[mesh_name]
    duck = _duck(multi)
    mesh = port_mesh.make_production_mesh(multi_pod=multi)
    B = INPUT_SHAPES[shape_name].global_batch
    axes = JMeshConfig(multi_pod=multi).client_axes
    bsize = 32 if multi else 16
    b_ax = tuple(axes) if B % bsize == 0 else None
    cache, ref = _port_cache(arch, shape_name), _ref_cache(arch, shape_name)
    assert _port_shapes(cache) == _ref_shapes(ref)
    got = _port_flat(cache, specs.cache_specs(cache, mesh, batch_axes=b_ax))
    assert got == _ref_flat(j_specs.cache_specs(ref, duck, batch_axes=b_ax))
    assert got[("pos",)] == ()


def test_shard_shape_and_bytes():
    mesh = port_mesh.make_test_mesh((2, 4), ("data", "model"))
    assert mesh.size == 8 and list(mesh.shape) == ["data", "model"]
    assert specs.shard_shape((8, 12, 3), ("data", "model", None),
                             mesh) == (4, 3, 3)
    assert specs.shard_shape((8, 12), (("data", "model"),), mesh) == (1, 12)
    assert specs.shard_shape((8, 12), (), mesh) == (8, 12)
    with pytest.raises(ValueError):
        specs.shard_shape((8,), (None, None), mesh)
    tree = {"a": TensorSpec((8, 12), torch.float32),
            "b": TensorSpec((6,), torch.bfloat16), "pos": 3}
    spec_tree = {"a": ("data", "model"), "b": (), "pos": ()}
    assert specs.sharded_bytes(tree, spec_tree, mesh) == 4 * 3 * 4 + 6 * 2
    # On a (1, 1) mesh a device holds every byte.
    one = port_mesh.make_test_mesh((1, 1))
    assert specs.sharded_bytes(tree, spec_tree, one) == 8 * 12 * 4 + 12


def test_meshes():
    for multi, n in ((False, 256), (True, 512)):
        mc = MeshConfig(multi_pod=multi)
        m = port_mesh.make_mesh_from_config(mc)
        assert m.size == mc.n_devices == n
        assert tuple(m.shape) == mc.axes
        assert tuple(m.shape.values()) == mc.shape
        assert dict(m.shape) == dict(_duck(multi).shape)
    with pytest.raises(ValueError):
        port_mesh.make_test_mesh((2, 2), ("data",))
    with pytest.raises(ValueError):
        port_mesh.make_test_mesh((2, 2), ("data", "data"))
