"""The five archs of the mixture-of-experts family and its neighbours
against the JAX reference: qwen3-moe-30b-a3b, moonshot-v1-16b-a3b and
llama4-scout-17b-a16e (MoE; moonshot and llama4 with a shared expert),
qwen3-32b (dense, qk_norm) and llava-next-34b (a vision prefix).

Each smoke config's reference init_params is carried over by
convert.to_torch, and the same numpy tokens (and, for llava, patch
embeddings) feed both packages, in float32. Tolerances, of max(1, max
|reference logit|): 1e-5 for the forward and prefill logits, the loss and
the aux loss, and of each gradient leaf's largest |value| (the GEMMs sum
in another order); 1e-3 for decode logits (the KV cache is bf16 even in a
float32 config, so a key or value a few float32 ulps apart can round to
neighbouring bf16 values, as tests/test_torch_musicgen.py explains).
Greedy tokens must be equal.
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

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
         "qwen3-32b", "llava-next-34b"]
F32_TOL, F32_DECODE_TOL = 1e-5, 1e-3
# The reference's param_count() of each full config.
FULL_PARAMS = {"qwen3-moe-30b-a3b": 30_532_122_624,
               "moonshot-v1-16b-a3b": 28_888_467_456,
               "llama4-scout-17b-a16e": 107_769_861_120,
               "qwen3-32b": 32_762_123_264,
               "llava-next-34b": 34_396_264_448}

_PARAMS = {}


def _cfgs(arch):
    return (j_registry.get_config(arch, smoke=True).replace(dtype="float32"),
            registry.get_config(arch, smoke=True).replace(dtype="float32"))


def _params(arch):
    """(reference params, the port's copy of them), drawn once an arch."""
    if arch not in _PARAMS:
        jp = j_tfm.init_params(j_registry.get_config(arch, smoke=True),
                               jax.random.PRNGKey(0))
        _PARAMS[arch] = jp, to_torch(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return _PARAMS[arch]


def _close(actual, desired, tol):
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pre = None
    if cfg.modality:
        m = cfg.modality
        pre = rng.normal(0, 1, (B, m.prefix_len, m.embed_dim)).astype(
            np.float32)
    return toks, pre


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.tensor(x)


# ---------------------------------------------------------------------------
# Configs, registry, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch, smoke):
    j_cfg = j_registry.get_config(arch, smoke=smoke)
    t_cfg = registry.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    if not smoke:
        assert t_cfg.param_count()[0] == FULL_PARAMS[arch]


def test_registry_serves_all_ten_archs():
    assert registry.NOT_YET_PORTED == ()
    assert registry.ARCH_IDS == [
        "qwen2-0.5b", "falcon-mamba-7b", "gemma-7b", "zamba2-2.7b",
        "musicgen-large", *ARCHS]
    assert sorted(registry.ARCH_IDS) == sorted(j_registry.ARCH_IDS)
    for arch in registry.ARCH_IDS:
        for smoke in (False, True):
            cfg = registry.get_config(arch, smoke=smoke)
            tfm.check_supported(cfg)  # raises nothing
            assert cfg.name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("qwen3-moe-30b")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_equals_reference(arch):
    """The port's own init draws the reference's tree (keys, shapes,
    dtypes), and to_torch carries the reference's leaves unchanged."""
    jp, tp = _params(arch)
    cfg = registry.get_config(arch, smoke=True)
    own = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    spec = tree_map(lambda t: (tuple(t.shape), t.dtype), own)
    assert spec == tree_map(lambda t: (tuple(t.shape), t.dtype), tp)
    assert sum(t.numel() for t in leaves(own)) == cfg.param_count()[0]
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cfg.mlp == "moe":
        m = cfg.moe
        want = {"router": (cfg.d_model, m.n_experts),
                "wg": (m.n_experts, cfg.d_model, m.d_ff_expert),
                "wi": (m.n_experts, cfg.d_model, m.d_ff_expert),
                "wo": (m.n_experts, m.d_ff_expert, cfg.d_model)}
        layers = own["layers"]["moe"]
        assert {k: tuple(layers[k].shape[2:]) for k in want} == want
        assert ("shared" in layers) == bool(m.shared_expert_d_ff)


# ---------------------------------------------------------------------------
# Forward, prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch):
    j_cfg, t_cfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks, pre = _inputs(t_cfg, 2, 20, seed=1)
    want, j_aux, j_plen = jax.jit(
        lambda p, t, e: j_tfm.forward(j_cfg, p, t, e))(jp, _j(toks), _j(pre))
    for impl in ("plain", "kernel"):
        got, aux, plen = tfm.forward(t_cfg, tp, torch.tensor(toks), impl,
                                     prefix_embeds=_t(pre))
        assert plen == j_plen == (t_cfg.modality.prefix_len if pre is not None
                                  else 0)
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want, F32_TOL)
        _close(aux, j_aux, F32_TOL)
        assert (float(aux) > 0) == (t_cfg.mlp == "moe")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_greedy_tokens_match_reference(arch):
    """Prefill and 4 greedy decode steps: logits at every step within the
    tolerances, and the port's greedy token the reference's at every
    step; then serve.generate's tokens equal that loop's."""
    j_cfg, t_cfg = _cfgs(arch)
    jp, tp = _params(arch)
    B, S, gen = 3, 12, 5
    toks, pre = _inputs(t_cfg, B, S, seed=2)
    P = 0 if pre is None else t_cfg.modality.prefix_len
    max_len = P + S + gen
    j_logits, j_cache = jax.jit(lambda p, t, e: j_tfm.prefill(
        j_cfg, p, t, e, max_len=max_len))(jp, _j(toks), _j(pre))
    logits, cache = tfm.prefill(t_cfg, tp, torch.tensor(toks),
                                max_len=max_len, impl="kernel",
                                prefix_embeds=_t(pre))
    assert cache["pos"] == int(j_cache["pos"]) == P + S
    _close(logits, j_logits, F32_TOL)
    decode = jax.jit(lambda p, c, t: j_tfm.decode_step(j_cfg, p, c, t))
    want = [np.asarray(jnp.argmax(j_logits[:, -1], axis=-1))]
    assert torch.equal(logits[:, -1].argmax(-1),
                       torch.tensor(want[0], dtype=torch.int64))
    for _ in range(gen - 1):
        tok = want[-1].astype(np.int32).reshape(B, 1)
        j_logits, j_cache = decode(jp, j_cache, jnp.asarray(tok))
        logits, cache = tfm.decode_step(t_cfg, tp, cache, torch.tensor(tok))
        _close(logits, j_logits, F32_DECODE_TOL)
        want.append(np.asarray(jnp.argmax(j_logits[:, 0], axis=-1)))
        assert torch.equal(logits[:, 0].argmax(-1),
                           torch.tensor(want[-1], dtype=torch.int64))
    res = serve.generate(t_cfg, tp, torch.tensor(toks, dtype=torch.int64), gen,
                         device="cpu", prefix_embeds=_t(pre))
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))


# ---------------------------------------------------------------------------
# Training: the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_loss_fn_and_every_gradient_leaf_match_reference(arch):
    """loss_fn = cross-entropy + the summed aux loss, and its gradient in
    every leaf (the router's and the experts' too)."""
    j_cfg, t_cfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks, _ = _inputs(t_cfg, 2, 17, seed=3)
    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(
        lambda p, t: j_tfm.loss_fn(j_cfg, p, {"tokens": t}), has_aux=True))(
        jp, jnp.asarray(toks))
    p = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, m = tfm.loss_fn(t_cfg, p, {"tokens": torch.tensor(toks)}, "kernel")
    _close(loss, j_loss, F32_TOL)
    _close(m["ce_loss"], j_m["ce_loss"], F32_TOL)
    _close(m["aux_loss"], j_m["aux_loss"], F32_TOL)
    loss_v, ce, aux = (float(t.detach()) for t in (loss, m["ce_loss"],
                                                   m["aux_loss"]))
    assert aux > 0 and loss_v == pytest.approx(ce + aux, rel=1e-7)
    grads = torch.autograd.grad(loss, leaves(p))
    j_leaves = jax.tree.leaves(j_grads)
    assert len(grads) == len(j_leaves)
    for g, want in zip(grads, j_leaves):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=F32_TOL * max(float(np.abs(want).max()),
                                                      1e-30))
    router = p["layers"]["moe"]["router"]
    assert float(grads[[id(t) for t in leaves(p)].index(id(router))]
                 .abs().max()) > 0


def test_serve_main_moe_on_cpu():
    toks = serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen", "3"])
    assert toks.shape == (2, 3) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
