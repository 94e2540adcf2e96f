"""The port's mixture-of-experts layer (models/moe.py) against the JAX
reference (repro/models/moe.py): the six cases of tests/test_moe.py, each
held against the reference function, plus the router's tie order.

The same numpy inputs feed both packages, and the reference's init_moe
weights are carried over by convert.to_torch. The routing (each token's
k experts), every assignment's buffer position, `keep` and `drop_frac`
must be exact (`drop_frac` is 1 - mean(keep): exact wherever `keep` is;
the reference under jit may leave an ulp of 1.0 on it). The reference's
routing internals are recomputed here from its own lines
(repro/models/moe.py:77-95), since its function returns only the output
and the metrics. Outputs and the aux loss are
held within 1e-5 of max(1, max |reference|) in float32 (the GEMMs sum in
another order); in bf16 within 2e-2 of it (each product of the expert
GLU rounds to 8 bits of mantissa, and the two packages round in other
places: a value on the other side of a rounding boundary moves an output
by a few bf16 ulps).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import mlp as j_mlp
from repro.models import moe as j_moe
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import to_torch
from repro_torch.models import mlp, moe

F32_TOL, BF16_TOL = 1e-5, 2e-2


def _cfgs(**kw):
    base = dict(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=8.0)
    base.update(kw)
    return JMoEConfig(**base), MoEConfig(**base)


def _params(j_cfg, d, seed=0):
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), d, j_cfg)
    return jp, to_torch(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(actual, desired, tol):
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


@jax.jit
def _j_softmax_matmul(x, w):
    return jax.nn.softmax(x @ w, axis=-1)


# The reference under jit (its ops one by one would each compile).
_j_forward = jax.jit(j_moe.moe_forward, static_argnums=(2, 3, 4))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _j_routing(jp, xt, cfg, capacity_factor=None):
    """The reference's routing and dispatch positions, from its lines."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.astype(jnp.float32) @ jp["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    C = j_moe.moe_capacity(T, cfg, capacity_factor or cfg.capacity_factor)
    flat_expert = expert_idx.reshape(T * k)
    onehot = jax.nn.one_hot(flat_expert, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    pos_own = jnp.take_along_axis(pos, flat_expert[:, None], axis=1)[:, 0]
    return gate_vals, expert_idx, pos_own, pos_own < C


def _same_routing(tp, jp, xt, j_cfg, t_cfg, capacity_factor=None):
    """The port's route() against the reference's: experts, positions,
    keep and C exact; gates within 1e-6."""
    gates, experts, pos, keep = _j_routing(jp, jnp.asarray(xt), j_cfg,
                                           capacity_factor)
    C = j_moe.moe_capacity(xt.shape[0], j_cfg,
                           capacity_factor or j_cfg.capacity_factor)
    r = moe.route(tp, torch.tensor(xt), t_cfg, capacity_factor)
    assert r.capacity == C
    np.testing.assert_array_equal(r.experts.numpy(), np.asarray(experts))
    np.testing.assert_array_equal(r.pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    assert r.pos.dtype == torch.int32
    np.testing.assert_allclose(r.gates.numpy(), np.asarray(gates), rtol=0,
                               atol=1e-6)
    return r


def _forward(jp, tp, x, j_cfg, t_cfg, **kw):
    want, j_metrics = _j_forward(jp, jnp.asarray(x), j_cfg, *kw.values())
    got, metrics = moe.moe_forward(tp, torch.tensor(x), t_cfg, **kw)
    assert set(metrics) == set(j_metrics) == {"aux_loss", "drop_frac"}
    # Under jit XLA divides the mean by multiplying with 1/n, which can
    # leave an ulp of 1.0 (2**-23) on 1 - mean(keep); `keep` itself is
    # held exact by _same_routing.
    assert abs(float(metrics["drop_frac"])
               - float(j_metrics["drop_frac"])) <= 2.0 ** -23
    _close(metrics["aux_loss"], j_metrics["aux_loss"], F32_TOL)
    return got, metrics, want


def test_moe_config_equals_reference_field_for_field():
    fields = [(f.name, f.default) for f in dataclasses.fields(MoEConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JMoEConfig)]


def test_init_moe_tree_shapes_and_scales():
    j_cfg, t_cfg = _cfgs(shared_expert_d_ff=24, n_experts=8, d_ff_expert=64)
    jp, tp = _params(j_cfg, 32)
    own = moe.init_moe(torch.Generator().manual_seed(0), 32, t_cfg)
    assert {k: tuple(v.shape) for k, v in own.items() if k != "shared"} == {
        k: tuple(v.shape) for k, v in tp.items() if k != "shared"}
    assert {k: tuple(v.shape) for k, v in own["shared"].items()} == {
        k: tuple(v.shape) for k, v in tp["shared"].items()}
    # The reference's scales: 1/sqrt(d) for the router, wg and wi,
    # 1/sqrt(f) for wo.
    for name, want in (("router", 32 ** -0.5), ("wg", 32 ** -0.5),
                       ("wi", 32 ** -0.5), ("wo", 64 ** -0.5)):
        assert float(own[name].std()) == pytest.approx(want, rel=0.1)
        assert own[name].dtype == torch.float32
    # convert.to_torch carries every leaf across unchanged.
    for name in ("router", "wg", "wi", "wo"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    for name in ("wg", "wi", "wo"):
        np.testing.assert_array_equal(tp["shared"][name].numpy(),
                                      np.asarray(jp["shared"][name]))


def test_ample_capacity_matches_dense_computation():
    """No drops: the port equals the reference, and both equal the explicit
    per-token mixture of the k experts."""
    j_cfg, t_cfg = _cfgs()
    d = 8
    jp, tp = _params(j_cfg, d)
    x = _x((2, 6, d))
    got, metrics, want = _forward(jp, tp, x, j_cfg, t_cfg)
    assert float(metrics["drop_frac"]) == 0.0
    _close(got, want, F32_TOL)
    r = _same_routing(tp, jp, x.reshape(-1, d), j_cfg, t_cfg)
    assert bool(r.keep.all())
    xt = torch.tensor(x.reshape(-1, d))
    ref = torch.zeros_like(xt)
    for e in range(t_cfg.n_experts):
        g = torch.nn.functional.silu(xt @ tp["wg"][e]) * (xt @ tp["wi"][e])
        w = torch.where(r.experts == e, r.gates, 0.0).sum(-1)
        ref = ref + w[:, None] * (g @ tp["wo"][e])
    _close(got.reshape(-1, d), ref.numpy(), 1e-5)


def test_shared_expert_added():
    j_cfg, t_cfg = _cfgs(shared_expert_d_ff=16)
    d = 8
    jp, tp = _params(j_cfg, d)
    x = _x((1, 4, d), seed=2)
    got, _, want = _forward(jp, tp, x, j_cfg, t_cfg)
    _close(got, want, F32_TOL)
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    out_no, _ = moe.moe_forward(no_shared, torch.tensor(x), t_cfg)
    shared = j_mlp.mlp_forward(jp["shared"], jnp.asarray(x.reshape(-1, d)),
                               "silu")
    _close((got - out_no).reshape(-1, d), shared, 1e-5)
    np.testing.assert_allclose(
        mlp.mlp_forward(tp["shared"], torch.tensor(x.reshape(-1, d))).numpy(),
        np.asarray(shared), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dispatch", ["global", "batched"])
def test_capacity_drops_tokens(dispatch):
    """A capacity factor of 0.25: drops, the same ones as the reference's
    (positions and keep exact), and the same outputs."""
    j_cfg, t_cfg = _cfgs(capacity_factor=0.25, dispatch=dispatch)
    d = 8
    jp, tp = _params(j_cfg, d)
    x = _x((4, 16, d), seed=3)
    got, metrics, want = _forward(jp, tp, x, j_cfg, t_cfg)
    assert float(metrics["drop_frac"]) > 0.0
    assert bool(torch.isfinite(got).all())
    _close(got, want, F32_TOL)
    rows = [x.reshape(-1, d)] if dispatch == "global" else list(x)
    for xt in rows:
        r = _same_routing(tp, jp, xt, j_cfg, t_cfg)
        assert not bool(r.keep.all())
        # A dropped assignment adds nothing: its token's output is the
        # gate-weighted sum of its kept experts alone.
        assert int(r.keep.sum()) <= r.capacity * t_cfg.n_experts


def test_capacity_formula():
    """moe_capacity equals the reference's over a grid, with its floor of 8
    and its multiples of 8."""
    for E, k in ((4, 2), (16, 1), (64, 6), (128, 8)):
        j_cfg, t_cfg = _cfgs(n_experts=E, top_k=k)
        for n in (1, 4, 7, 100, 1024, 8192, 65_536):
            for cf in (0.25, 1.0, 1.25, 2.0, 8.0):
                c = moe.moe_capacity(n, t_cfg, cf)
                assert c == j_moe.moe_capacity(n, j_cfg, cf), (E, k, n, cf)
                assert c % 8 == 0 and c >= 8
                assert c >= n * k * cf / E - 8
    _, qwen3 = _cfgs(n_experts=128, top_k=8)
    assert moe.moe_capacity(4 * 2048, qwen3, 1.25) == 640  # prefill B=4


def test_aux_loss_prefers_balance():
    j_cfg, t_cfg = _cfgs(n_experts=2, top_k=1)
    d = 4
    jp, tp = _params(j_cfg, d)
    x = _x((8, 8, d), seed=4)
    jp_col = dict(jp, router=jnp.zeros_like(jp["router"]).at[:, 0].set(10.0))
    tp_col = dict(tp, router=torch.tensor(np.asarray(jp_col["router"])))
    _, m_bal, _ = _forward(jp, tp, x, j_cfg, t_cfg)
    _, m_col, _ = _forward(jp_col, tp_col, x, j_cfg, t_cfg)
    assert float(m_col["aux_loss"]) > float(m_bal["aux_loss"])


def test_batched_dispatch_matches_global():
    """dispatch='batched' (per-row capacity buffers) equals global dispatch
    at ample capacity, and the reference's batched dispatch."""
    j_cfg, t_cfg = _cfgs()
    jb_cfg = dataclasses.replace(j_cfg, dispatch="batched")
    tb_cfg = dataclasses.replace(t_cfg, dispatch="batched")
    d = 8
    jp, tp = _params(j_cfg, d)
    x = _x((3, 10, d), seed=5)
    og, _, _ = _forward(jp, tp, x, j_cfg, t_cfg)
    ob, mb, want = _forward(jp, tp, x, jb_cfg, tb_cfg)
    np.testing.assert_allclose(og.numpy(), ob.numpy(), rtol=0, atol=1e-5)
    _close(ob, want, F32_TOL)
    assert float(mb["drop_frac"]) == 0.0


def test_tied_router_probabilities_take_the_lower_expert_first():
    """Equal probabilities: the port's top-k order is jax.lax.top_k's (the
    lower index first). A zero router ties all experts; zero columns tie
    some of them (their logits are exact zeros whatever the sum order)."""
    j_cfg, t_cfg = _cfgs()
    d = 8
    jp, tp = _params(j_cfg, d)
    x = _x((2, 6, d), seed=6)
    router = np.asarray(jp["router"]).copy()
    router[:, [1, 2]] = 0.0
    for r_np in (np.zeros_like(router), router):
        jpr = dict(jp, router=jnp.asarray(r_np))
        tpr = dict(tp, router=torch.tensor(r_np))
        r = _same_routing(tpr, jpr, x.reshape(-1, d), j_cfg, t_cfg)
        got, _, want = _forward(jpr, tpr, x, j_cfg, t_cfg)
        _close(got, want, F32_TOL)
        probs = np.asarray(_j_softmax_matmul(
            jnp.asarray(x.reshape(-1, d)), jnp.asarray(r_np)))
        # Ties did occur among the chosen experts.
        top = np.take_along_axis(probs, r.experts.numpy(), axis=1)
        assert (np.diff(top, axis=1) == 0).any()
    vals, idx = moe.top_k(torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0]]), 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert vals.tolist() == [[0.5, 0.5, 0.25, 0.25]]


def test_bfloat16_matches_reference():
    """bf16 tokens (the serve path's dtype): routing in float32 from the
    same bf16 values, the experts' weights cast per use."""
    j_cfg, t_cfg = _cfgs(shared_expert_d_ff=16, capacity_factor=0.5)
    d = 16
    jp, tp = _params(j_cfg, d)
    x = _x((2, 24, d), seed=7)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, j_metrics = _j_forward(jp, xb, j_cfg)
    got, metrics = moe.moe_forward(tp, torch.tensor(x).to(torch.bfloat16),
                                   t_cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 24, d)
    assert abs(float(metrics["drop_frac"])
               - float(j_metrics["drop_frac"])) <= 2.0 ** -23
    assert float(metrics["drop_frac"]) > 0
    _close(metrics["aux_loss"], j_metrics["aux_loss"], F32_TOL)
    _close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)
    _same_routing(tp, jp, np.asarray(xb.astype(jnp.float32)).reshape(-1, d),
                  j_cfg, t_cfg)


def test_moe_gradients_match_reference():
    """d(sum(out * up) + aux) / d every leaf and x, at a capacity that
    drops, within 1e-5 of each gradient's largest |value|."""
    j_cfg, t_cfg = _cfgs(shared_expert_d_ff=16, capacity_factor=0.5)
    d = 8
    jp, tp = _params(j_cfg, d)
    x, up = _x((2, 12, d), seed=8), _x((2, 12, d), seed=9)

    def j_loss(p, x):
        out, m = j_moe.moe_forward(p, x, j_cfg)
        return jnp.sum(out * up) + m["aux_loss"]

    j_gp, j_gx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp,
                      is_leaf=lambda t: isinstance(t, torch.Tensor))
    xt = torch.tensor(x, requires_grad=True)
    out, m = moe.moe_forward(tp, xt, t_cfg)
    loss = torch.sum(out * torch.tensor(up)) + m["aux_loss"]
    names = ["router", "wg", "wi", "wo"]
    grads = torch.autograd.grad(
        loss, [tp[k] for k in names] + [tp["shared"][k] for k in
                                         ("wg", "wi", "wo")] + [xt])
    wants = [j_gp[k] for k in names] + [j_gp["shared"][k] for k in
                                        ("wg", "wi", "wo")] + [j_gx]
    for got, want in zip(grads, wants):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
