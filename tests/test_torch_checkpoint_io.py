"""The port's checkpoint/io.py against the reference's: the same file
layout, bit for bit.

A file either package writes is read by the other with equal leaves; for
the same tree and metadata the port's bytes equal the reference's (its
own msgpack codec against the msgpack package); restores are checked
against a template (missing, extra and shape each raise ValueError); an
AdamState (a NamedTuple, keys ".step", ".mu/...", ".nu/...") round-trips.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import io, load_checkpoint, save_checkpoint
from repro_torch.convert import to_torch
from repro_torch.optim import AdamState, adamw
from repro_torch.utils.tree import leaves, structure

META = {"round": 7, "arch": "qwen2-0.5b", "lr": 0.05, "ok": True,
        "none": None, "sizes": [1, 2, 300, -5], "nested": {"b": 2, "a": 1},
        "big": 2 ** 40, "neg": -70_000}


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": rng.normal(0, 1, (4, 5)).astype(np.float32),
                      "b": np.arange(3.0, dtype=np.float32)},
            "step": np.asarray(7, np.int32),
            "ids": rng.integers(-9, 9, (2, 3)).astype(np.int64),
            "blocks": [rng.normal(0, 1, 300).astype(np.float32),
                       np.zeros((0, 2), np.float32)],
            "flags": np.asarray([True, False]),
            "half": rng.normal(0, 1, 6).astype(np.float16)}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_bytes_equal_the_reference_and_files_cross(tmp_path):
    tree = _tree()
    j_path, t_path = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    # numpy leaves: jnp.asarray would narrow int64 to int32 (no x64).
    j_save(j_path, tree, metadata=META)
    save_checkpoint(t_path, to_torch(tree, device="cpu"), metadata=META)
    assert _bytes(t_path) == _bytes(j_path)
    assert not os.path.exists(t_path + ".tmp")
    # Each package reads the other's file.
    got, meta = load_checkpoint(j_path, to_torch(tree, device="cpu"))
    assert meta == META
    for a, b in zip(leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == torch.as_tensor(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    back, meta = j_load(t_path, jax.tree.map(np.zeros_like, tree))
    assert meta == META
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bfloat16_leaves_cross_bit_for_bit(tmp_path):
    x = np.random.default_rng(1).normal(0, 1, (3, 7)).astype(np.float32)
    j_path, t_path = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    j_save(j_path, {"x": jnp.asarray(x, jnp.bfloat16)})
    save_checkpoint(t_path, {"x": torch.tensor(x).to(torch.bfloat16)})
    assert _bytes(t_path) == _bytes(j_path)
    got, _ = load_checkpoint(j_path, {"x": torch.zeros(3, 7)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], torch.tensor(x).to(torch.bfloat16))


def test_codec_equals_msgpack_package():
    objs = [0, 127, 128, 255, 256, 65_536, 2 ** 32, 2 ** 64 - 1, -1, -32,
            -33, -129, -32_769, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, None,
            True, False, "", "a" * 31, "a" * 32, "é" * 200, "a" * 70_000,
            b"", b"x" * 256, b"x" * 70_000, list(range(16)),
            {str(i): i for i in range(16)}, {"m": {"n": [1, {"o": b"p"}]}}]
    for obj in objs:
        want = msgpack.packb(obj, use_bin_type=True)
        assert io.packb(obj) == want, repr(obj)[:40]
        assert io.unpackb(want) == msgpack.unpackb(want, raw=False)
    with pytest.raises(ValueError, match="trailing"):
        io.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(TypeError):
        io.packb({"x": object()})


def test_mismatched_template_raises(tmp_path):
    path = str(tmp_path / "c.msgpack")
    save_checkpoint(path, {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"w": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(path, {"w": torch.zeros(2, 2), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="extra"):
        load_checkpoint(path, {})
    with pytest.raises(ValueError, match="missing={'w2'}"):
        load_checkpoint(path, {"w2": torch.zeros(2, 2)})


def test_adam_state_round_trips_and_crosses(tmp_path):
    params = {"w": torch.randn(3, 4), "b": [torch.zeros(2), torch.ones(1)]}
    opt = adamw(0.1)
    state = opt.init(params)
    _, state = opt.update({"w": torch.ones(3, 4),
                           "b": [torch.ones(2), torch.ones(1)]}, state, params)
    path = str(tmp_path / "adam.msgpack")
    save_checkpoint(path, {"params": params, "opt": state},
                    metadata={"round": 1})
    # JAX's paths: NamedTuple fields as ".name", in field order.
    assert list(msgpack.unpackb(_bytes(path))["arrays"]) == [
        "opt/.step", "opt/.mu/b/0", "opt/.mu/b/1", "opt/.mu/w",
        "opt/.nu/b/0", "opt/.nu/b/1", "opt/.nu/w",
        "params/b/0", "params/b/1", "params/w"]
    template = {"params": params, "opt": opt.init(params)}
    got, meta = load_checkpoint(path, template)
    assert meta == {"round": 1} and isinstance(got["opt"], AdamState)
    assert structure(got) == structure(template)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 1
    for a, b in zip(leaves(got), leaves({"params": params, "opt": state})):
        assert torch.equal(a, b)
    # The reference's AdamState of the same tree reads the port's file.
    j_params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    j_tmpl = {"params": j_params, "opt": j_adamw(0.1).init(j_params)}
    back, _ = j_load(path, j_tmpl)
    assert int(back["opt"].step) == 1
    np.testing.assert_array_equal(back["opt"].mu["w"], state.mu["w"].numpy())
