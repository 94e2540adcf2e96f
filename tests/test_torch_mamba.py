"""The port's falcon-mamba-7b serving path (models/mamba.py and the mamba1
branches of models/transformer.py) against the JAX reference.

JAX-initialised parameters of the falcon-mamba-7b smoke config (2 layers,
d_model 128, d_inner 256, d_state 8, chunk 32) carried over by
convert.to_torch, the same numpy tokens and activations given to both:

- configs equal field for field, full and smoke, param_count included;
- causal_conv1d, mamba1_forward (every port impl against the reference's
  "xla" and "pallas", with h0 and return_state) and mamba1_decode_step;
- transformer forward and prefill logits and the prefill's caches;
- a 4-token greedy generate against the reference's prefill plus
  decode_step loop, in float32 and bf16;
- init_params draws the values of the former list-then-stack draw.

Tolerances: float32 runs sum their GEMMs in another order (XLA's Eigen
against oneDNN) and the port's chunked scan combines its pairs in another
tree order than lax.associative_scan, a few ulps of the largest terms, so
1e-5 of the compared tensor's scale (`_close`, scale = max(1, max |want|)),
and greedy tokens identical. The decode state is float32 throughout (the
conv cache holds float32 copies of the activations), so decode is held to
the same 1e-5. bf16 runs round every activation to 8 bits of mantissa;
where one side's sum lands on the other side of a rounding boundary the
two differ by a bf16 ulp, and the difference travels on: 3e-2 of scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import mamba as j_mamba
from repro.models import transformer as j_tfm
from repro_torch.configs import registry
from repro_torch.convert import to_numpy, to_torch
from repro_torch.launch import serve
from repro_torch.models import mamba
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves, tree_map

ARCH = "falcon-mamba-7b"
F32_TOL = 1e-5
BF16_TOL = 3e-2
# port impl -> the reference impls it is held against
IMPLS = {"plain": ("xla", "pallas"), "blocked": ("xla",),
         "kernel": ("xla", "pallas")}


def _close(actual, desired, tol):
    """|actual - desired| <= tol * max(1, max |desired|), elementwise."""
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _cfgs(dtype):
    j_cfg = j_registry.get_config(ARCH, smoke=True).replace(dtype=dtype)
    t_cfg = registry.get_config(ARCH, smoke=True).replace(dtype=dtype)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def j_params():
    return j_tfm.init_params(j_registry.get_config(ARCH, smoke=True),
                             jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def t_params(j_params):
    return to_torch(jax.tree.map(np.asarray, j_params), device="cpu")


def _layer0(j_params, t_params):
    pj = jax.tree.map(lambda t: t[0, 0], j_params["layers"]["mamba"])
    pt = tree_map(lambda t: t[0, 0], t_params["layers"]["mamba"])
    return pj, pt


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
    assert t_cfg.param_count() == j_cfg.param_count()
    if not smoke:
        assert t_cfg.param_count() == (7_006_588_928, 7_006_588_928)
    assert ARCH in registry.ARCH_IDS and ARCH not in registry.NOT_YET_PORTED


def test_to_torch_carries_init_params_unchanged(j_params, t_params):
    assert [tuple(x.shape) for x in leaves(t_params)] == [
        x.shape for x in jax.tree.leaves(j_params)]
    for a, b in zip(leaves(to_numpy(t_params)), jax.tree.leaves(j_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    own = tfm.init_params(registry.get_config(ARCH, smoke=True),
                          torch.Generator().manual_seed(0), device="cpu")
    spec = tree_map(lambda t: (tuple(t.shape), t.dtype), own)
    assert spec == tree_map(lambda t: (tuple(t.shape), t.dtype), t_params)
    # The port's own A_log, D, dt_b and conv_b equal the reference's init.
    for name in ("A_log", "D", "dt_b", "conv_b"):
        np.testing.assert_allclose(
            own["layers"]["mamba"][name].numpy(),
            np.asarray(j_params["layers"]["mamba"][name]), rtol=1e-6)


def _list_then_stack(cfg, gen):
    """The port's former draw: every layer, then one stack per leaf."""
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen) * 0.02
    G, sg = cfg.n_scan_groups, cfg.scan_group
    layers = [tfm._init_layer(cfg, gen) for _ in range(G * sg)]
    return {"embed": embed,
            "layers": tree_map(lambda *xs: torch.stack(xs).unflatten(
                0, (G, sg)), *layers),
            "ln_f": torch.zeros(cfg.d_model)}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", ARCH])
def test_init_params_draws_the_list_then_stack_values(arch):
    cfg = registry.get_config(arch, smoke=True)
    for c in (cfg, cfg.replace(n_layers=4, scan_group=2)):
        want = _list_then_stack(c, torch.Generator().manual_seed(5))
        got = tfm.init_params(c, torch.Generator().manual_seed(5),
                              device="cpu")
        assert tree_map(lambda t: tuple(t.shape), got) == tree_map(
            lambda t: tuple(t.shape), want)
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)


def test_check_supported_still_refuses_unported_parts():
    cfg = registry.get_config(ARCH, smoke=True)
    modality = j_registry.get_config("llava-next-34b", smoke=True).modality
    # What no reference config has is refused: another mixer, channel
    # mixer or dtype.
    for bad in ({"mixer": "rwkv"}, {"mlp": "kan"}, {"dtype": "float16"}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tfm.init_params(cfg.replace(**bad), torch.Generator(),
                            device="cpu")
    # The MoE channel mixer is ported (qwen3-moe-30b-a3b) and no longer
    # refused.
    moe = j_registry.get_config("qwen3-moe-30b-a3b", smoke=True).moe
    p = tfm.init_params(cfg.replace(mlp="moe", moe=moe), torch.Generator(),
                        device="cpu")
    assert p["layers"]["moe"]["wg"].shape[2:] == (
        moe.n_experts, cfg.d_model, moe.d_ff_expert)
    # The modality prefix and the untied LM head are ported (musicgen-large)
    # and no longer refused.
    p = tfm.init_params(cfg.replace(modality=modality), torch.Generator(),
                        device="cpu")
    assert p["projector"]["w"].shape == (modality.embed_dim, cfg.d_model)
    p = tfm.init_params(cfg.replace(tie_embeddings=False), torch.Generator(),
                        device="cpu")
    assert p["lm_head"].shape == (cfg.d_model, cfg.vocab_size)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-100, 100, 2001),
                        [-1e30, 1e30, 0.0, -0.0, np.inf, -np.inf]])
    x = x.astype(np.float32)
    got = mamba.softplus(torch.tensor(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    # XLA on the CPU flushes denormal results to zero; torch keeps them.
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(dtype, j_params, t_params):
    pj, pt = _layer0(j_params, t_params)
    x_t, x_j = _x((2, 30, 256), dtype)
    _close(mamba.causal_conv1d(x_t, pt["conv_w"], pt["conv_b"] + 0.1),
           j_mamba.causal_conv1d(x_j, pj["conv_w"], pj["conv_b"] + 0.1),
           _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_mamba1_forward_matches_reference(dtype, impl, j_params, t_params):
    """S=70: two full chunks of 32 and a ragged one; return_state gives the
    pre-activation conv tail and the final state."""
    _, t_cfg = _cfgs(dtype)
    pj, pt = _layer0(j_params, t_params)
    x_t, x_j = _x((2, 70, 128), dtype)
    got, (tail, h) = mamba.mamba1_forward(pt, x_t, t_cfg.ssm, impl,
                                          return_state=True)
    assert got.dtype == x_t.dtype and tail.dtype == x_t.dtype
    assert h.dtype == torch.float32 and h.shape == (2, 256, 8)
    for j_impl in IMPLS[impl]:
        want, (w_tail, w_h) = j_mamba.mamba1_forward(
            pj, x_j, t_cfg.ssm, j_impl, return_state=True)
        _close(got, want, _tol(dtype))
        _close(tail, w_tail, _tol(dtype))
        _close(h, w_h, _tol(dtype))
    assert torch.equal(mamba.mamba1_forward(pt, x_t, t_cfg.ssm, impl), got)


def test_mamba1_forward_carries_h0(j_params, t_params):
    _, t_cfg = _cfgs("float32")
    pj, pt = _layer0(j_params, t_params)
    x_t, x_j = _x((2, 40, 128), "float32", seed=2)
    h0 = np.random.default_rng(3).normal(0, 0.5, (2, 256, 8)).astype(
        np.float32)
    for impl in ("plain", "kernel"):
        got, (_, h) = mamba.mamba1_forward(pt, x_t, t_cfg.ssm, impl,
                                           h0=torch.tensor(h0),
                                           return_state=True)
        want, (_, w_h) = j_mamba.mamba1_forward(pj, x_j, t_cfg.ssm, "xla",
                                                h0=jnp.asarray(h0),
                                                return_state=True)
        _close(got, want, F32_TOL)
        _close(h, w_h, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_decode_steps_match_reference(dtype, j_params, t_params):
    """A 20-token forward's state, then three decode steps; outputs and
    caches against the reference's, the port's cache written in place."""
    _, t_cfg = _cfgs(dtype)
    pj, pt = _layer0(j_params, t_params)
    x_t, x_j = _x((2, 20, 128), dtype)
    _, (tail, h) = mamba.mamba1_forward(pt, x_t, t_cfg.ssm, "kernel",
                                        return_state=True)
    _, (w_tail, w_h) = j_mamba.mamba1_forward(pj, x_j, t_cfg.ssm, "xla",
                                              return_state=True)
    c_t = mamba.init_mamba1_cache(2, 128, t_cfg.ssm)
    c_j = j_mamba.init_mamba1_cache(2, 128, t_cfg.ssm)
    assert {k: tuple(v.shape) for k, v in c_t.items()} == {
        k: v.shape for k, v in c_j.items()}
    c_t["conv"].copy_(tail)
    c_t["h"].copy_(h)
    c_j = {"conv": w_tail.astype(jnp.float32), "h": w_h}
    conv, state = c_t["conv"], c_t["h"]
    for step in range(3):
        d_t, d_j = _x((2, 1, 128), dtype, seed=10 + step)
        out_t, c_t = mamba.mamba1_decode_step(pt, d_t, t_cfg.ssm, c_t)
        out_j, c_j = j_mamba.mamba1_decode_step(pj, d_j, t_cfg.ssm, c_j)
        assert c_t["conv"] is conv and c_t["h"] is state
        _close(out_t, out_j, _tol(dtype))
        _close(c_t["conv"], c_j["conv"], _tol(dtype))
        _close(c_t["h"], c_j["h"], _tol(dtype))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_reference(dtype, j_params, t_params):
    j_cfg, t_cfg = _cfgs(dtype)
    toks = _tokens(2, 40)
    tt = torch.tensor(toks, dtype=torch.int64)
    tol = _tol(dtype)
    for j_impl in ("xla", "pallas"):
        want, aux, plen = jax.jit(lambda p, t, i=j_impl: j_tfm.forward(
            j_cfg, p, t, impl=i))(j_params, jnp.asarray(toks))
        want_pre, want_cache = jax.jit(lambda p, t, i=j_impl: j_tfm.prefill(
            j_cfg, p, t, max_len=48, impl=i))(j_params, jnp.asarray(toks))
        for t_impl in ("plain", "blocked", "kernel"):
            got, t_aux, t_plen = tfm.forward(t_cfg, t_params, tt, t_impl)
            assert got.dtype == torch.float32 and t_plen == plen == 0
            assert float(t_aux) == float(aux) == 0.0
            _close(got, want, tol)
            pre, cache = tfm.prefill(t_cfg, t_params, tt, max_len=48,
                                     impl=t_impl)
            assert pre.shape == (2, 1, 512) and cache["pos"] == 40
            _close(pre, want_pre, tol)
            for name in ("conv", "h"):
                got_c = cache["layers"][name]
                want_c = want_cache["layers"][name]
                assert got_c.dtype == torch.float32
                assert tuple(got_c.shape) == want_c.shape
                _close(got_c, want_c, tol)


def test_prefill_refuses_a_prompt_shorter_than_the_conv_tail(t_params):
    _, t_cfg = _cfgs("float32")
    with pytest.raises(ValueError, match="d_conv - 1"):
        tfm.prefill(t_cfg, t_params, torch.zeros(1, 2, dtype=torch.int64))
    logits, cache = tfm.prefill(t_cfg, t_params,
                                torch.zeros(1, 3, dtype=torch.int64))
    assert cache["layers"]["conv"].shape == (2, 1, 1, 3, 256)


def _j_generate(j_cfg, j_params, toks, gen):
    """The reference serve loop: prefill, greedy argmax, decode steps."""
    B, S = toks.shape
    prefill = jax.jit(lambda p, t: j_tfm.prefill(j_cfg, p, t, max_len=S + gen,
                                                 impl="pallas"))
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
        _close(res.last_logits, want_last, F32_TOL)
    else:
        # A bf16 near-tie may flip a greedy token, after which the two
        # runs decode different sequences: compare the last logits only
        # where every earlier token agreed.
        same = (res.tokens.numpy() == want_toks).all(axis=1)
        assert same.any()
        _close(res.last_logits[torch.tensor(same)],
               np.asarray(want_last)[same], _tol(dtype))


def test_serve_main_serves_falcon_on_cpu():
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert toks.shape == (2, 3) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
