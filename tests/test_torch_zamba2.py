"""The port's zamba2-2.7b serving path against the JAX reference: the
mamba2 mixer in models/transformer.py and the tied shared attention block
that runs after every scan group, with its own KV cache per group.

JAX-initialised parameters carried over by convert.to_torch (the `shared`
subtree and the mamba2 leaves included), the same numpy tokens given to
both, for the smoke config (2 layers in one group, shared block of 4
heads of 32) and a variant at the full config's shared-block head_dim 80
(d_model 160, 2 shared heads of 80, 10 mamba2 heads of 32), whose prefill
attention goes through the flash kernel's head_dim 80 (on the CPU, its
plain version):

- configs equal field for field, full and smoke, param_count included;
  the shared block's attention config equals the reference's;
- the parameter tree and the cache tree (layers' conv and h, the shared
  block's k and v per group) equal the reference's in keys and shapes;
- forward and prefill logits and every cache against the reference's
  impl="xla" and "blocked";
- a 4-token greedy generate against the reference's prefill plus
  decode_step loop: float32 tokens equal.

Tolerances as in tests/test_torch_transformer.py and
tests/test_torch_mamba2.py: float32 1e-5 of the compared tensor's scale,
1e-4 for decode logits (the shared block's KV cache is bf16 even in a
float32 config); bf16 3e-2 of scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import transformer as j_tfm
from repro_torch.configs import registry
from repro_torch.convert import to_numpy, to_torch
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves, tree_map

ARCH = "zamba2-2.7b"
F32_TOL = 1e-5
F32_DECODE_TOL = 1e-4
BF16_TOL = 3e-2
# The smoke config, and the smoke config at the full shared block's
# head_dim (d_model 160 / 2 heads = 80).
VARIANTS = {"smoke": {}, "hd80": {"d_model": 160, "shared_attn_heads": 2}}


def _close(actual, desired, tol):
    """|actual - desired| <= tol * max(1, max |desired|), elementwise."""
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _cfgs(variant, dtype="bfloat16"):
    kw = dict(VARIANTS[variant], dtype=dtype)
    return (j_registry.get_config(ARCH, smoke=True).replace(**kw),
            registry.get_config(ARCH, smoke=True).replace(**kw))


@pytest.fixture(scope="module")
def params():
    """variant -> (reference params, port params)."""
    out = {}
    for variant in VARIANTS:
        j_cfg, _ = _cfgs(variant)
        pj = j_tfm.init_params(j_cfg, jax.random.PRNGKey(0))
        out[variant] = (pj, to_torch(jax.tree.map(np.asarray, pj),
                                     device="cpu"))
    return out


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _shape_tree(tree):
    return jax.tree.map(lambda t: tuple(t.shape), tree)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference_field_for_field(smoke):
    j_cfg = j_registry.get_config(ARCH, smoke=smoke)
    t_cfg = registry.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.n_scan_groups == j_cfg.n_scan_groups
    assert (dataclasses.asdict(tfm.shared_attn_cfg(t_cfg))
            == dataclasses.asdict(j_tfm._shared_attn_cfg(j_cfg)))
    if not smoke:
        assert tfm.shared_attn_cfg(t_cfg).head_dim == 80
        assert t_cfg.n_scan_groups == 9
        assert round(t_cfg.param_count()[0] / 1e9, 2) == 2.34
    assert ARCH in registry.ARCH_IDS and ARCH not in registry.NOT_YET_PORTED


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_to_torch_carries_shared_and_mamba2_leaves(variant, params):
    pj, pt = params[variant]
    assert sorted(pt) == sorted(pj) == ["embed", "layers", "ln_f", "shared"]
    assert sorted(pt["shared"]) == ["attn", "ln1", "ln2", "mlp"]
    for a, b in zip(leaves(to_numpy(pt)), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, np.asarray(b))
    _, t_cfg = _cfgs(variant)
    own = tfm.init_params(t_cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    spec = tree_map(lambda t: (tuple(t.shape), t.dtype), own)
    assert spec == tree_map(lambda t: (tuple(t.shape), t.dtype), pt)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_cache_matches_reference_tree(variant):
    j_cfg, t_cfg = _cfgs(variant)
    want = j_tfm.init_cache(j_cfg, 3, 20)
    got = tfm.init_cache(t_cfg, 3, 20, device="cpu")
    assert got["pos"] == 0
    got_shapes = tree_map(lambda t: tuple(t.shape),
                          {k: v for k, v in got.items() if k != "pos"})
    want_shapes = _shape_tree({k: v for k, v in want.items() if k != "pos"})
    assert got_shapes == want_shapes
    assert got["shared"]["k"].dtype == torch.bfloat16
    assert got["layers"]["h"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_prefill_match_reference(dtype, variant, params):
    """S=40 (a chunk of 32 and a ragged one of 8): logits, the mamba2
    caches and the shared block's KV caches."""
    j_cfg, t_cfg = _cfgs(variant, dtype)
    pj, pt = params[variant]
    toks = _tokens(2, 40)
    tt = torch.tensor(toks, dtype=torch.int64)
    tol = _tol(dtype)
    for impl in ("xla", "blocked"):
        want, _, _ = jax.jit(lambda p, t, impl=impl: j_tfm.forward(
            j_cfg, p, t, impl=impl))(pj, jnp.asarray(toks))
        want_pre, want_cache = jax.jit(lambda p, t, impl=impl: j_tfm.prefill(
            j_cfg, p, t, max_len=48, impl=impl))(pj, jnp.asarray(toks))
        for t_impl in ("plain", "kernel"):
            got, _, _ = tfm.forward(t_cfg, pt, tt, t_impl)
            _close(got, want, tol)
            pre, cache = tfm.prefill(t_cfg, pt, tt, max_len=48, impl=t_impl)
            assert pre.shape == (2, 1, 512) and cache["pos"] == 40
            _close(pre, want_pre, tol)
            for group in ("layers", "shared"):
                for name, t in cache[group].items():
                    w = want_cache[group][name]
                    assert tuple(t.shape) == w.shape
                    _close(t, w, tol if group == "layers" else BF16_TOL)


def test_prefill_refuses_a_prompt_shorter_than_the_conv_tail(params):
    _, t_cfg = _cfgs("smoke", "float32")
    _, pt = params["smoke"]
    with pytest.raises(ValueError, match="d_conv - 1"):
        tfm.prefill(t_cfg, pt, torch.zeros(1, 2, dtype=torch.int64))


def _j_generate(j_cfg, j_params, toks, gen):
    """The reference serve loop: prefill, greedy argmax, decode steps."""
    B, S = toks.shape
    prefill = jax.jit(lambda p, t: j_tfm.prefill(j_cfg, p, t, max_len=S + gen))
    decode = jax.jit(lambda p, c, t: j_tfm.decode_step(j_cfg, p, c, t))
    logits, cache = prefill(j_params, jnp.asarray(toks))
    first = logits
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32).reshape(B, 1)
    out = [np.asarray(tok)]
    for _ in range(gen - 1):
        logits, cache = decode(j_params, cache, tok)
        tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32).reshape(B, 1)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1), first, logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_matches_reference_serve_loop(dtype, variant, params):
    j_cfg, t_cfg = _cfgs(variant, dtype)
    pj, pt = params[variant]
    toks = _tokens(3, 24, seed=5)
    want_toks, want_first, want_last = _j_generate(j_cfg, pj, toks, 4)
    res = serve.generate(t_cfg, pt, torch.tensor(toks, dtype=torch.int64),
                         4, device="cpu")
    assert res.tokens.shape == (3, 4)
    _close(res.prefill_logits, want_first, _tol(dtype))
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens.numpy(), want_toks)
        _close(res.last_logits, want_last, F32_DECODE_TOL)
    else:
        # A bf16 near-tie may flip a greedy token, after which the two
        # runs decode different sequences: compare the last logits only
        # where every earlier token agreed.
        same = (res.tokens.numpy() == want_toks).all(axis=1)
        assert same.any()
        _close(res.last_logits[torch.tensor(same)],
               np.asarray(want_last)[same], _tol(dtype))


def test_serve_main_serves_zamba2_on_cpu():
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert toks.shape == (2, 3) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
