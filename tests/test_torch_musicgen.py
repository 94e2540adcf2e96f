"""The port's musicgen-large (audio: K summed codebook embeddings, a
projected conditioning prefix, K untied LM heads) against the JAX
reference, and the reference's per-arch smoke checks on the port.

The reference's init_params carried over by convert.to_torch, the same
numpy codebook tokens and prefix embeddings given to both. Tolerances as
in tests/test_torch_transformer.py, scaled by the largest |logit|:
float32 1e-5 (the GEMMs sum in another order), 1e-3 for decode logits
(the KV cache is bf16 even in a float32 config, so a key or value a few
float32 ulps apart can round to neighbouring bf16 values, 2**-8 = 3.9e-3
apart: with the two caches made equal the decode logits agree within
1e-6 of scale until a step writes such an element, which moves them by
up to 1.5e-4 of scale at this config's 4 heads and 4 codebook heads);
bf16 5e-2 (every
activation rounds to 8 bits of mantissa, and a value on the other side
of a rounding boundary travels on through the layers and the K heads).
The summed codebook embedding is float32 adds in the reference's order:
exact.
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
from repro_torch.convert import to_torch
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves, tree_map

ARCH = "musicgen-large"
F32_TOL, F32_DECODE_TOL, BF16_TOL = 1e-5, 1e-3, 5e-2
K, V = 4, 256  # the smoke config's codebooks and vocabulary


def _close(actual, desired, tol):
    """|actual - desired| <= tol * max(1, max |desired|), elementwise."""
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _cfgs(dtype):
    return (j_registry.get_config(ARCH, smoke=True).replace(dtype=dtype),
            registry.get_config(ARCH, smoke=True).replace(dtype=dtype))


@pytest.fixture(scope="module")
def j_params():
    return j_tfm.init_params(j_registry.get_config(ARCH, smoke=True),
                             jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def t_params(j_params):
    return to_torch(jax.tree.map(np.asarray, j_params), device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, S, K)).astype(
        np.int32)


def _prefix(B, seed=1):
    cfg = registry.get_config(ARCH, smoke=True)
    m = cfg.modality
    return np.random.default_rng(seed).normal(
        0, 1, (B, m.prefix_len, m.embed_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference_field_for_field(smoke):
    j_cfg = j_registry.get_config(ARCH, smoke=smoke)
    t_cfg = registry.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    assert ARCH in registry.ARCH_IDS and ARCH not in registry.NOT_YET_PORTED
    if not smoke:
        assert t_cfg.param_count()[0] == 3_258_126_336


def test_init_params_tree_and_shapes_equal_reference(j_params, t_params):
    cfg = registry.get_config(ARCH, smoke=True)
    own = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    spec = tree_map(lambda t: (tuple(t.shape), t.dtype), own)
    assert spec == tree_map(lambda t: (tuple(t.shape), t.dtype), t_params)
    assert own["embed"].shape == (K, V, 128)
    assert own["projector"]["w"].shape == (64, 128)
    assert own["lm_head"].shape == (K, 128, V)
    assert not bool(own["projector"]["b"].any())
    # The scales of the reference's draws: 0.02, 1/sqrt(embed_dim),
    # 1/sqrt(d_model).
    for name, want in (("embed", 0.02), ("lm_head", 128 ** -0.5)):
        assert float(own[name].std()) == pytest.approx(want, rel=0.05)
    assert float(own["projector"]["w"].std()) == pytest.approx(
        64 ** -0.5, rel=0.1)
    assert sum(t.numel() for t in leaves(own)) == cfg.param_count()[0]


def test_codebook_sum_and_prefix_embedding(j_params, t_params):
    """embed_inputs in float32: the K-codebook sum exact, the projected
    prefix first, prefix_len returned."""
    j_cfg, t_cfg = _cfgs("float32")
    toks, pre = _tokens(2, 9), _prefix(2)
    x, P = tfm.embed_inputs(t_cfg, t_params, torch.tensor(toks))
    jx, jP = j_tfm.embed_inputs(j_cfg, j_params, jnp.asarray(toks))
    assert P == jP == 0
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    x, P = tfm.embed_inputs(t_cfg, t_params, torch.tensor(toks),
                            torch.tensor(pre))
    jx, jP = j_tfm.embed_inputs(j_cfg, j_params, jnp.asarray(toks),
                                jnp.asarray(pre))
    assert P == jP == 8 and x.shape == (2, 8 + 9, 128)
    np.testing.assert_array_equal(x[:, P:].numpy(), np.asarray(jx)[:, P:])
    _close(x[:, :P], np.asarray(jx)[:, :P], F32_TOL)


# ---------------------------------------------------------------------------
# Forward, prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype, prefix, j_params, t_params):
    j_cfg, t_cfg = _cfgs(dtype)
    toks = _tokens(2, 20)
    pre = _prefix(2) if prefix else None
    want, aux, plen = jax.jit(lambda p, t, e: j_tfm.forward(j_cfg, p, t, e))(
        j_params, jnp.asarray(toks), None if pre is None else jnp.asarray(pre))
    for impl in ("plain", "kernel"):
        got, t_aux, t_plen = tfm.forward(
            t_cfg, t_params, torch.tensor(toks), impl,
            prefix_embeds=None if pre is None else torch.tensor(pre))
        assert t_plen == plen == (8 if prefix else 0)
        assert got.shape == (2, t_plen + 20, K, V) and got.dtype == torch.float32
        assert float(t_aux) == float(aux) == 0.0
        _close(got, want, _tol(dtype))


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_reference(dtype, prefix, j_params,
                                                  t_params):
    """Prefill (positions over prefix + tokens, the cache sized to count the
    prefix) and 3 decode steps of (B, 1, K) tokens."""
    j_cfg, t_cfg = _cfgs(dtype)
    toks = _tokens(2, 16, seed=3)
    pre = _prefix(2, seed=4) if prefix else None
    P = 8 if prefix else 0
    max_len = P + 16 + 3
    logits, cache = tfm.prefill(
        t_cfg, t_params, torch.tensor(toks), max_len=max_len, impl="kernel",
        prefix_embeds=None if pre is None else torch.tensor(pre))
    j_logits, j_cache = jax.jit(lambda p, t, e: j_tfm.prefill(
        j_cfg, p, t, e, max_len=max_len))(
        j_params, jnp.asarray(toks), None if pre is None else jnp.asarray(pre))
    assert logits.shape == (2, 1, K, V) and cache["pos"] == P + 16
    assert int(j_cache["pos"]) == P + 16
    assert cache["layers"]["k"].shape == j_cache["layers"]["k"].shape
    _close(logits, j_logits, _tol(dtype))
    decode = jax.jit(lambda p, c, t: j_tfm.decode_step(j_cfg, p, c, t))
    for step in range(3):
        tok = _tokens(2, 1, seed=10 + step)
        logits, cache = tfm.decode_step(t_cfg, t_params, cache,
                                        torch.tensor(tok))
        j_logits, j_cache = decode(j_params, j_cache, jnp.asarray(tok))
        assert logits.shape == (2, 1, K, V) and cache["pos"] == P + 17 + step
        _close(logits, j_logits, F32_DECODE_TOL if dtype == "float32"
               else BF16_TOL)


def test_float32_greedy_generate_equals_reference(j_params, t_params):
    """serve.generate's float32 greedy tokens (each codebook's argmax) equal
    the reference's prefill / decode_step loop on the same prompts."""
    j_cfg, t_cfg = _cfgs("float32")
    toks, gen = _tokens(3, 12, seed=5), 5
    prefill = jax.jit(lambda p, t: j_tfm.prefill(j_cfg, p, t,
                                                 max_len=12 + gen))
    decode = jax.jit(lambda p, c, t: j_tfm.decode_step(j_cfg, p, c, t))
    logits, cache = prefill(j_params, jnp.asarray(toks))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32).reshape(3, 1, K)
    want = [np.asarray(tok)]
    for _ in range(gen - 1):
        logits, cache = decode(j_params, cache, tok)
        tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32).reshape(
            3, 1, K)
        want.append(np.asarray(tok))
    res = serve.generate(t_cfg, t_params, torch.tensor(toks, dtype=torch.int64),
                         gen, device="cpu")
    assert res.tokens.shape == (3, gen, K)
    assert res.prefill_logits.shape == (3, 1, K, V)
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.concatenate(want, axis=1))
    _close(res.last_logits, logits, F32_DECODE_TOL)


def test_generate_with_a_prefix_counts_it_in_the_cache(t_params):
    cfg = registry.get_config(ARCH, smoke=True).replace(dtype="float32")
    toks = torch.tensor(_tokens(2, 10, seed=6), dtype=torch.int64)
    res = serve.generate(cfg, t_params, toks, 3, device="cpu",
                         prefix_embeds=torch.tensor(_prefix(2, seed=7)))
    assert res.tokens.shape == (2, 3, K)
    # The prefix conditions the continuation.
    plain = serve.generate(cfg, t_params, toks, 3, device="cpu")
    assert not torch.equal(res.prefill_logits, plain.prefill_logits)


def test_serve_main_audio_on_cpu():
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "1", "--prompt-len", "8", "--gen", "3"])
    assert toks.shape == (1, 3, K) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < V


# ---------------------------------------------------------------------------
# The reference's tests/test_models_smoke.py, for every arch the port serves
# ---------------------------------------------------------------------------

B, S = 2, 32


def _smoke_batch(cfg, gen):
    m = cfg.modality
    shape = (B, S, m.n_codebooks) if m and m.kind == "audio" else (B, S)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen)}
    if m:
        batch["prefix_embeds"] = torch.randn((B, m.prefix_len, m.embed_dim),
                                             generator=gen)
    return batch


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_smoke_forward_train_step_and_decode_shapes(arch):
    cfg = registry.get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(cfg, gen, device="cpu")
    batch = _smoke_batch(cfg, gen)
    logits, aux, P = tfm.forward(cfg, params, batch["tokens"],
                                 prefix_embeds=batch.get("prefix_embeds"))
    S_total = S + (cfg.modality.prefix_len if cfg.modality else 0)
    m = cfg.modality
    want = ((B, S_total, m.n_codebooks, cfg.vocab_size)
            if m and m.kind == "audio" else (B, S_total, cfg.vocab_size))
    assert tuple(logits.shape) == want and P == S_total - S
    assert not bool(torch.isnan(logits).any()) and not bool(torch.isnan(aux))

    p = tree_map(lambda t: t.requires_grad_(True), params)
    loss, _ = tfm.loss_fn(cfg, p, batch)
    grads = torch.autograd.grad(loss, leaves(p), allow_unused=True)
    assert np.isfinite(float(loss.detach()))
    # Loss at init near ln(vocab) (uniform predictions).
    assert abs(float(loss.detach()) - np.log(cfg.vocab_size)) < 2.0
    used = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in used)
    assert any(float(g.abs().max()) > 0 for g in used)

    cache = tfm.init_cache(cfg, B, max_len=S, device="cpu")
    tok_shape = (B, 1, m.n_codebooks) if m and m.kind == "audio" else (B, 1)
    tok = torch.randint(0, cfg.vocab_size, tok_shape, generator=gen)
    logits, cache2 = tfm.decode_step(cfg, params, cache, tok)
    assert not bool(torch.isnan(logits).any()) and cache2["pos"] == 1
    assert tree_map(lambda t: tuple(t.shape), cache2["layers"]) == tree_map(
        lambda t: tuple(t.shape), cache["layers"])
