"""The port's LLM serving path (qwen2-0.5b) against the JAX reference.

JAX-initialised parameters of the smoke config carried over by
convert.to_torch, the same numpy tokens and activations given to both:

- configs equal field for field, full and smoke;
- rms_norm, rope, the MLP and each attention function (forward by all
  three impls, prefill with its cache, decode, the sliding-window ring
  buffer) agree with the reference;
- forward and prefill logits agree with the reference's impl="xla" and
  impl="blocked" (the port's "plain" and "blocked"), and the port's
  impl="kernel" (its plain version on the CPU) with both;
- a 4-token greedy generate agrees with the reference's prefill plus
  decode_step loop.

Tolerances: float32 runs sum their GEMMs in another order (XLA's Eigen
against oneDNN), a few ulps of the largest terms, so 1e-5 of the
compared tensor's scale (`_close`), and greedy tokens identical. Decode
logits get 1e-4: the KV cache is bf16 even in a float32 config, and a key
the two frameworks compute a few float32 ulps apart can round to
neighbouring bf16 values, 2**-8 apart. bf16
runs round every activation to 8 bits of mantissa; where one side's sum
lands on the other side of a rounding boundary the two differ by a bf16
ulp (2**-8 relative), and the difference travels on through the layers:
2e-2 of the tensor's scale for one op, 3e-2 for the whole model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import attention as j_attn
from repro.models import mlp as j_mlp
from repro.models import norms as j_norms
from repro.models import rope as j_rope
from repro.models import transformer as j_tfm
from repro_torch.configs import registry
from repro_torch.convert import to_numpy, to_torch
from repro_torch.launch import serve
from repro_torch.models import attention, mlp, norms, rope
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves, tree_map

ARCH = "qwen2-0.5b"
F32_TOL = 1e-5
F32_DECODE_TOL = 1e-4
BF16_TOL = {"op": 2e-2, "model": 3e-2}
IMPLS = {"plain": "xla", "blocked": "blocked", "kernel": "xla"}


def _close(actual, desired, tol):
    """|actual - desired| <= tol * max(1, max |desired|), elementwise."""
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


def _cfgs(dtype):
    j_cfg = j_registry.get_config(ARCH, smoke=True).replace(dtype=dtype)
    t_cfg = registry.get_config(ARCH, smoke=True).replace(dtype=dtype)
    return j_cfg, t_cfg


def _tol(dtype, what="model"):
    return F32_TOL if dtype == "float32" else BF16_TOL[what]


@pytest.fixture(scope="module")
def j_params():
    return j_tfm.init_params(j_registry.get_config(ARCH, smoke=True),
                             jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def t_params(j_params):
    return to_torch(jax.tree.map(np.asarray, j_params), device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return (torch.tensor(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference_field_for_field(smoke):
    j_cfg = j_registry.get_config(ARCH, smoke=smoke)
    t_cfg = registry.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert ([f.name for f in dataclasses.fields(t_cfg)]
            == [f.name for f in dataclasses.fields(j_cfg)])
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.n_scan_groups == j_cfg.n_scan_groups


def test_registry_names_unported_archs_and_never_falls_back():
    # Every arch of the reference is served: none is left unported.
    assert registry.NOT_YET_PORTED == ()
    assert sorted(registry.ARCH_IDS) == sorted(j_registry.ARCH_IDS)
    for arch in registry.ARCH_IDS:
        assert registry.get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("qwen2-0.6b")
    # The MoE channel mixer on this arch's attention: no longer refused.
    moe = j_registry.get_config("qwen3-moe-30b-a3b", smoke=True)
    t_moe = registry.get_config(ARCH, smoke=True).replace(
        mlp="moe", moe=moe.moe)
    p = tfm.init_params(t_moe, torch.Generator(), device="cpu")
    assert sorted(p["layers"]["moe"]) == ["router", "wg", "wi", "wo"]


def test_to_torch_carries_init_params_unchanged(j_params, t_params):
    assert [tuple(x.shape) for x in leaves(t_params)] == [
        x.shape for x in jax.tree.leaves(j_params)]
    for a, b in zip(leaves(to_numpy(t_params)), jax.tree.leaves(j_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # The port's own init draws the same tree: keys, shapes, dtypes.
    own = tfm.init_params(registry.get_config(ARCH, smoke=True),
                          torch.Generator().manual_seed(0), device="cpu")
    spec = tree_map(lambda t: (tuple(t.shape), t.dtype), own)
    assert spec == tree_map(lambda t: (tuple(t.shape), t.dtype), t_params)
    assert own["layers"]["attn"]["wq"].shape[:2] == (2, 1)  # (G, sg, ...)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_mlp_match_reference(dtype, j_params, t_params):
    x_t, x_j = _x((2, 12, 4, 32), dtype)
    scale = np.random.default_rng(2).normal(0, 0.1, 32).astype(np.float32)
    _close(norms.rms_norm(x_t, torch.tensor(scale), 1e-6),
           j_norms.rms_norm(x_j, jnp.asarray(scale), 1e-6), _tol(dtype, "op"))
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0) + 5
    for theta in (1e4, 1e6):
        _close(rope.apply_rope(x_t, torch.tensor(pos), theta),
               j_rope.apply_rope(x_j, jnp.asarray(pos), theta),
               _tol(dtype, "op"))
    _close(rope.rope_freqs(32, 1e6), j_rope.rope_freqs(32, 1e6), F32_TOL)
    h_t, h_j = _x((2, 12, 128), dtype)
    pm_j = jax.tree.map(lambda t: t[0, 0], j_params["layers"]["mlp"])
    pm_t = tree_map(lambda t: t[0, 0], t_params["layers"]["mlp"])
    for act in ("silu", "gelu"):
        _close(mlp.mlp_forward(pm_t, h_t, act),
               j_mlp.mlp_forward(pm_j, h_j, act), _tol(dtype, "op"))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attn_layer(j_params, t_params, bias_seed=3):
    """Layer 0's attention params, with nonzero QKV biases (init leaves
    them 0) so the bias path is exercised."""
    pj = jax.tree.map(lambda t: np.asarray(t[0, 0]), j_params["layers"]["attn"])
    rng = np.random.default_rng(bias_seed)
    for name in ("bq", "bk", "bv"):
        pj[name] = rng.normal(0, 0.1, pj[name].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, pj), to_torch(pj, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_attention_forward_matches_reference(dtype, impl, j_params, t_params):
    _, t_cfg = _cfgs(dtype)
    a_cfg = t_cfg.attention
    pj, pt = _attn_layer(j_params, t_params)
    x_t, x_j = _x((2, 40, 128), dtype)
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    got = attention.attention_forward(pt, x_t, a_cfg, torch.tensor(pos), impl)
    want = j_attn.attention_forward(pj, x_j, a_cfg, jnp.asarray(pos),
                                    IMPLS[impl])
    assert got.dtype == x_t.dtype
    _close(got, want, _tol(dtype, "op"))


def test_blocked_sdpa_matches_reference_across_blocks():
    """Several query blocks, with and without a window."""
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, 50, 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 50, 2, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 50, 2, 32)).astype(np.float32)
    for window in (None, 12):
        got = attention._blocked_causal_sdpa(
            *map(torch.tensor, (q, k, v)), window, block=16)
        want = j_attn._blocked_causal_sdpa(
            *map(jnp.asarray, (q, k, v)), window, block=16)
        _close(got, want, F32_TOL)
        plain = attention._sdpa(*map(torch.tensor, (q, k, v)),
                                attention._causal_mask(50, window))
        _close(got, plain.numpy(), F32_TOL)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_prefill_and_decode_match_reference(dtype, window,
                                                      j_params, t_params):
    """Prefill fills the cache (ring buffer when S > window), then three
    decode steps; outputs and caches against the reference's."""
    _, t_cfg = _cfgs(dtype)
    a_cfg = dataclasses.replace(t_cfg.attention, sliding_window=window)
    pj, pt = _attn_layer(j_params, t_params)
    S, max_len = 20, 24
    x_t, x_j = _x((2, S, 128), dtype)
    pos = np.arange(S, dtype=np.int32)[None].repeat(2, 0)
    c_t = attention.init_kv_cache(2, max_len, a_cfg)
    c_j = j_attn.init_kv_cache(2, max_len, a_cfg)
    assert c_t["k"].shape == c_j["k"].shape and c_t["k"].dtype == torch.bfloat16
    out_t, c_t = attention.attention_prefill(pt, x_t, a_cfg, torch.tensor(pos),
                                             c_t, "kernel")
    out_j, c_j = j_attn.attention_prefill(pj, x_j, a_cfg, jnp.asarray(pos),
                                          c_j, "xla")
    _close(out_t, out_j, _tol(dtype, "op"))
    for name in ("k", "v"):
        _close(c_t[name], c_j[name], _tol("bfloat16", "op"))
    for step in range(3):
        d_t, d_j = _x((2, 1, 128), dtype, seed=10 + step)
        out_t, c_t = attention.attention_decode_step(pt, d_t, a_cfg, S + step,
                                                     c_t)
        out_j, c_j = j_attn.attention_decode_step(pj, d_j, a_cfg,
                                                  jnp.int32(S + step), c_j)
        _close(out_t, out_j, _tol(dtype, "op"))
        for name in ("k", "v"):
            _close(c_t[name], c_j[name], _tol("bfloat16", "op"))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_logits_match_reference(dtype, j_params, t_params):
    j_cfg, t_cfg = _cfgs(dtype)
    toks = _tokens(2, 40)
    tt = torch.tensor(toks, dtype=torch.int64)
    tol = _tol(dtype)
    for impl in ("xla", "blocked"):
        want, aux, plen = jax.jit(lambda p, t, impl=impl: j_tfm.forward(
            j_cfg, p, t, impl=impl))(j_params, jnp.asarray(toks))
        want_pre, _ = jax.jit(lambda p, t, impl=impl: j_tfm.prefill(
            j_cfg, p, t, max_len=48, impl=impl))(j_params, jnp.asarray(toks))
        for t_impl in ("plain", "blocked", "kernel"):
            got, t_aux, t_plen = tfm.forward(t_cfg, t_params, tt, t_impl)
            assert got.dtype == torch.float32 and t_plen == plen == 0
            assert float(t_aux) == float(aux) == 0.0
            _close(got, want, tol)
            pre, cache = tfm.prefill(t_cfg, t_params, tt, max_len=48,
                                     impl=t_impl)
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
def test_generate_matches_reference_serve_loop(dtype, j_params, t_params):
    j_cfg, t_cfg = _cfgs(dtype)
    toks = _tokens(3, 24, seed=5)
    want_toks, want_first, want_last = _j_generate(j_cfg, j_params, toks, 4)
    res = serve.generate(t_cfg, t_params, torch.tensor(toks, dtype=torch.int64),
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


def test_serve_main_on_cpu():
    toks = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "16", "--gen", "3"])
    assert toks.shape == (2, 3) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
