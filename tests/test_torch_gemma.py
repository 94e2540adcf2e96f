"""The port's gemma-7b serving path against the JAX reference.

gemma-7b is a dense decoder like qwen2-0.5b, with GeGLU (tanh gelu), MHA
(KV = H), no QKV bias, tied embeddings, rope_theta 10000 and head_dim 256;
its prefill attention runs through the flash kernel at head_dim 256 (on
the CPU, the kernel's plain version). JAX-initialised parameters carried
over by convert.to_torch, the same numpy tokens and activations given to
both, for the smoke config (head_dim 32) and a variant of it at the full
config's head_dim 256 (2 heads of 256 on d_model 128):

- configs equal field for field, full and smoke, param_count included;
- the GeGLU MLP and the attention layer at head_dim 256 (forward by all
  three impls, prefill with its cache, decode);
- forward and prefill logits against the reference's impl="xla" and
  "blocked";
- a 4-token greedy generate against the reference's prefill plus
  decode_step loop: float32 tokens equal.

Tolerances as in tests/test_torch_transformer.py: float32 1e-5 of the
compared tensor's scale (GEMMs summed in another order), 1e-4 for decode
logits (the KV cache is bf16 even in a float32 config); bf16 2e-2 for one
op, 3e-2 for the model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.models import attention as j_attn
from repro.models import mlp as j_mlp
from repro.models import transformer as j_tfm
from repro_torch.configs import registry
from repro_torch.configs.base import AttentionConfig
from repro_torch.convert import to_numpy, to_torch
from repro_torch.launch import serve
from repro_torch.models import attention, mlp
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves, tree_map

ARCH = "gemma-7b"
F32_TOL = 1e-5
F32_DECODE_TOL = 1e-4
BF16_TOL = {"op": 2e-2, "model": 3e-2}
# The smoke config, and the smoke config at the full config's head_dim.
VARIANTS = ("smoke", "hd256")


def _close(actual, desired, tol):
    """|actual - desired| <= tol * max(1, max |desired|), elementwise."""
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


def _tol(dtype, what="model"):
    return F32_TOL if dtype == "float32" else BF16_TOL[what]


def _cfgs(variant, dtype="bfloat16"):
    j_cfg = j_registry.get_config(ARCH, smoke=True).replace(dtype=dtype)
    t_cfg = registry.get_config(ARCH, smoke=True).replace(dtype=dtype)
    if variant == "hd256":
        j_cfg = j_cfg.replace(attention=JAttentionConfig(
            n_heads=2, n_kv_heads=2, head_dim=256))
        t_cfg = t_cfg.replace(attention=AttentionConfig(
            n_heads=2, n_kv_heads=2, head_dim=256))
    return j_cfg, t_cfg


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


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return (torch.tensor(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference_field_for_field(smoke):
    j_cfg = j_registry.get_config(ARCH, smoke=smoke)
    t_cfg = registry.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    if not smoke:
        assert t_cfg.attention.head_dim == 256 and t_cfg.act == "gelu"
        assert round(t_cfg.param_count()[0] / 1e9, 2) == 8.54
    assert ARCH in registry.ARCH_IDS and ARCH not in registry.NOT_YET_PORTED


@pytest.mark.parametrize("variant", VARIANTS)
def test_to_torch_carries_init_params_unchanged(variant, params):
    pj, pt = params[variant]
    for a, b in zip(leaves(to_numpy(pt)), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, np.asarray(b))
    _, t_cfg = _cfgs(variant)
    own = tfm.init_params(t_cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    spec = tree_map(lambda t: (tuple(t.shape), t.dtype), own)
    assert spec == tree_map(lambda t: (tuple(t.shape), t.dtype), pt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_mlp_matches_reference(dtype, params):
    pj, pt = params["smoke"]
    lj = jax.tree.map(lambda t: t[0, 0], pj["layers"]["mlp"])
    lt = tree_map(lambda t: t[0, 0], pt["layers"]["mlp"])
    x_t, x_j = _x((2, 9, 128), dtype)
    _close(mlp.mlp_forward(lt, x_t, "gelu"), j_mlp.mlp_forward(lj, x_j, "gelu"),
           _tol(dtype, "op"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["plain", "blocked", "kernel"])
def test_attention_at_head_dim_256_matches_reference(dtype, impl, params):
    """Forward by every impl, then prefill (cache written) and two decode
    steps, against the reference's."""
    j_cfg, t_cfg = _cfgs("hd256", dtype)
    pj, pt = params["hd256"]
    aj = jax.tree.map(lambda t: t[0, 0], pj["layers"]["attn"])
    at = tree_map(lambda t: t[0, 0], pt["layers"]["attn"])
    x_t, x_j = _x((2, 24, 128), dtype)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    j_impl = {"plain": "xla", "blocked": "blocked", "kernel": "xla"}[impl]
    got = attention.attention_forward(at, x_t, t_cfg.attention,
                                      torch.tensor(pos), impl)
    _close(got, j_attn.attention_forward(aj, x_j, j_cfg.attention,
                                         jnp.asarray(pos), j_impl),
           _tol(dtype, "op"))
    c_t = attention.init_kv_cache(2, 27, t_cfg.attention)
    c_j = j_attn.init_kv_cache(2, 27, j_cfg.attention)
    out_t, c_t = attention.attention_prefill(at, x_t, t_cfg.attention,
                                             torch.tensor(pos), c_t, impl)
    out_j, c_j = j_attn.attention_prefill(aj, x_j, j_cfg.attention,
                                          jnp.asarray(pos), c_j, j_impl)
    _close(out_t, out_j, _tol(dtype, "op"))
    for step in range(2):
        d_t, d_j = _x((2, 1, 128), dtype, seed=20 + step)
        out_t, c_t = attention.attention_decode_step(
            at, d_t, t_cfg.attention, 24 + step, c_t)
        out_j, c_j = j_attn.attention_decode_step(
            aj, d_j, j_cfg.attention, jnp.int32(24 + step), c_j)
        _close(out_t, out_j, F32_DECODE_TOL if dtype == "float32"
               else _tol(dtype, "op"))
        for name in ("k", "v"):
            _close(c_t[name], c_j[name], _tol("bfloat16", "op"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_and_prefill_logits_match_reference(dtype, variant, params):
    j_cfg, t_cfg = _cfgs(variant, dtype)
    pj, pt = params[variant]
    toks = _tokens(2, 40)
    tt = torch.tensor(toks, dtype=torch.int64)
    tol = _tol(dtype)
    for impl in ("xla", "blocked"):
        want, _, _ = jax.jit(lambda p, t, impl=impl: j_tfm.forward(
            j_cfg, p, t, impl=impl))(pj, jnp.asarray(toks))
        want_pre, _ = jax.jit(lambda p, t, impl=impl: j_tfm.prefill(
            j_cfg, p, t, max_len=48, impl=impl))(pj, jnp.asarray(toks))
        for t_impl in ("plain", "kernel"):
            got, _, _ = tfm.forward(t_cfg, pt, tt, t_impl)
            _close(got, want, tol)
            pre, cache = tfm.prefill(t_cfg, pt, tt, max_len=48, impl=t_impl)
            assert pre.shape == (2, 1, 512) and cache["pos"] == 40
            _close(pre, want_pre, tol)


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
@pytest.mark.parametrize("variant", VARIANTS)
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


def test_serve_main_serves_gemma_on_cpu():
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert toks.shape == (2, 3) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
