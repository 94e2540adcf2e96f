"""The port's Mamba-2 block (models/mamba2.py) against the JAX reference
(repro/models/mamba2.py).

JAX-initialised parameters of one mamba2 layer of the zamba2-2.7b smoke
config (d_model 128, d_inner 256, 8 heads of 32, d_state 16, chunk 32)
carried over by convert.to_torch, the same numpy activations given to
both:

- mamba2_dims and the port's own init (its fixed leaves equal the
  reference's, its drawn leaves have the reference's shapes and scales);
- ssd_chunked on a ragged S (padded to a multiple of the chunk), a prompt
  shorter than one chunk, and a nonzero h0, against the reference's;
- ssd_chunked against a float64 step-by-step recurrence, also where the
  reference's chunk overflows exp (inf * 0 in its upper triangle) and
  gives NaN;
- mamba2_forward (return_state, h0) and mamba2_decode_step against the
  reference's, the decode cache written in place.

Tolerances: float32 runs sum their einsums in another order (XLA's Eigen
against oneDNN), a few ulps of the largest terms: 1e-5 of the compared
tensor's scale (`_close`, scale = max(1, max |want|)). bf16 runs round
every activation to 8 bits of mantissa, and a sum that lands on the other
side of a rounding boundary moves by a bf16 ulp: 3e-2 of scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as j_m2
from repro_torch.configs import registry
from repro_torch.convert import to_torch
from repro_torch.models import mamba2

ARCH = "zamba2-2.7b"
F32_TOL = 1e-5
BF16_TOL = 3e-2


def _close(actual, desired, tol):
    """|actual - desired| <= tol * max(1, max |desired|), elementwise."""
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy()
    scale = max(1.0, float(np.max(np.abs(desired))))
    np.testing.assert_allclose(actual, desired, rtol=0, atol=tol * scale)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.fixture(scope="module")
def ssm():
    return registry.get_config(ARCH, smoke=True).ssm


@pytest.fixture(scope="module")
def layer(ssm):
    """(reference params, port params) of one mamba2 layer, with nonzero
    conv bias and norm scale so every leaf takes part."""
    pj = j_m2.init_mamba2(jax.random.PRNGKey(7), 128, ssm)
    rng = np.random.default_rng(8)
    pj = dict(pj)
    pj["conv_b"] = jnp.asarray(rng.normal(0, 0.1, pj["conv_b"].shape),
                               jnp.float32)
    pj["norm"] = jnp.asarray(rng.normal(0, 0.1, pj["norm"].shape),
                             jnp.float32)
    return pj, to_torch(jax.tree.map(np.asarray, pj), device="cpu")


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return (torch.tensor(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


def _ssd_inputs(B, S, H, P, N, seed, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(-2, 1, (B, S, H)))) * dt_scale
          ).astype(np.float32)
    A = -np.exp(rng.normal(0, 0.5, (H,))).astype(np.float32)
    Bm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    Cm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def test_dims_and_own_init_follow_the_reference(ssm):
    assert mamba2.mamba2_dims(128, ssm) == j_m2.mamba2_dims(128, ssm)
    full = registry.get_config(ARCH).ssm
    assert mamba2.mamba2_dims(2560, full) == j_m2.mamba2_dims(2560, full) \
        == (5120, 80, 5248)
    own = mamba2.init_mamba2(torch.Generator().manual_seed(0), 128, ssm)
    ref = j_m2.init_mamba2(jax.random.PRNGKey(0), 128, ssm)
    assert sorted(own) == sorted(ref)
    for name, t in own.items():
        assert tuple(t.shape) == ref[name].shape and t.dtype == torch.float32
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm"):
        np.testing.assert_allclose(own[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-6)
    # The drawn leaves keep the reference's scales: 1/sqrt(fan_in), 0.1.
    for name, want in (("in_x", 128 ** -0.5), ("out_proj", 256 ** -0.5),
                       ("conv_w", 0.1)):
        assert abs(float(own[name].std()) / want - 1) < 0.1


@pytest.mark.parametrize("S, chunk, with_h0", [
    (70, 32, False),   # two full chunks and a ragged one (padded)
    (70, 32, True),
    (20, 32, True),    # shorter than one chunk: one chunk of 20
    (64, 16, False),   # whole chunks only
])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    B, H, P, N = 2, 4, 8, 16
    arrs = _ssd_inputs(B, S, H, P, N, seed=S + chunk)
    h0 = (np.random.default_rng(3).normal(0, 0.5, (B, H, P, N))
          .astype(np.float32) if with_h0 else None)
    y, h = mamba2.ssd_chunked(*map(torch.tensor, arrs), chunk=chunk,
                              h0=None if h0 is None else torch.tensor(h0))
    w_y, w_h = j_m2.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                                h0=None if h0 is None else jnp.asarray(h0))
    assert tuple(y.shape) == w_y.shape and tuple(h.shape) == w_h.shape
    _close(y, w_y, F32_TOL)
    _close(h, w_h, F32_TOL)


def _recurrence(x, dt, A, Bm, Cm, h0):
    """float64 step-by-step SSM: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
    y_t = h_t C_t."""
    x, dt, Bm, Cm = (np.asarray(t, np.float64) for t in (x, dt, Bm, Cm))
    h = np.asarray(h0, np.float64).copy()
    ys = []
    for t in range(x.shape[1]):
        a = np.exp(dt[:, t] * np.asarray(A, np.float64))  # (B, H)
        h = (a[:, :, None, None] * h + np.einsum(
            "bn,bhp,bh->bhpn", Bm[:, t], x[:, t], dt[:, t]))
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("dt_scale", [1.0, 40.0])
def test_ssd_chunked_matches_the_recurrence(dt_scale):
    """At dt_scale 40 a chunk's log-decay spans past float32's exp range:
    the reference's exp(La_l - La_m) overflows above the diagonal and
    inf * 0 makes its output NaN; the port masks the exponent and stays
    on the recurrence."""
    B, S, H, P, N = 2, 48, 3, 4, 8
    arrs = _ssd_inputs(B, S, H, P, N, seed=11, dt_scale=dt_scale)
    h0 = np.random.default_rng(4).normal(0, 0.5, (B, H, P, N))
    y, h = mamba2.ssd_chunked(*map(torch.tensor, arrs), chunk=16,
                              h0=torch.tensor(h0, dtype=torch.float32))
    want_y, want_h = _recurrence(*arrs, h0)
    _close(y, want_y, F32_TOL)
    _close(h, want_h, F32_TOL)
    w_y, _ = j_m2.ssd_chunked(*map(jnp.asarray, arrs), chunk=16,
                              h0=jnp.asarray(h0, jnp.float32))
    assert np.isnan(np.asarray(w_y)).any() == (dt_scale > 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_matches_reference(dtype, ssm, layer):
    """S=70: two chunks of 32 and a ragged one; return_state gives the
    pre-activation conv tail and the final state; h0 carried."""
    pj, pt = layer
    x_t, x_j = _x((2, 70, 128), dtype)
    h0 = np.random.default_rng(5).normal(0, 0.5, (2, 8, 32, 16)).astype(
        np.float32)
    for h0_t, h0_j in ((None, None), (torch.tensor(h0), jnp.asarray(h0))):
        got, (tail, h) = mamba2.mamba2_forward(pt, x_t, ssm, h0=h0_t,
                                               return_state=True)
        want, (w_tail, w_h) = j_m2.mamba2_forward(pj, x_j, ssm, h0=h0_j,
                                                  return_state=True)
        assert got.dtype == x_t.dtype and tail.dtype == x_t.dtype
        assert h.dtype == torch.float32 and h.shape == (2, 8, 32, 16)
        assert tail.shape == (2, 3, 256 + 2 * 16)
        _close(got, want, _tol(dtype))
        _close(tail, w_tail, _tol(dtype))
        _close(h, w_h, _tol(dtype))
    assert torch.equal(mamba2.mamba2_forward(pt, x_t, ssm,
                                             h0=torch.tensor(h0)), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_steps_match_reference(dtype, ssm, layer):
    """A 20-token forward's state, then three decode steps; outputs and
    caches against the reference's, the port's cache written in place."""
    pj, pt = layer
    x_t, x_j = _x((2, 20, 128), dtype)
    _, (tail, h) = mamba2.mamba2_forward(pt, x_t, ssm, return_state=True)
    _, (w_tail, w_h) = j_m2.mamba2_forward(pj, x_j, ssm, return_state=True)
    c_t = mamba2.init_mamba2_cache(2, 128, ssm)
    c_j = j_m2.init_mamba2_cache(2, 128, ssm)
    assert {k: (tuple(v.shape), v.dtype) for k, v in c_t.items()} == {
        k: (v.shape, torch.float32) for k, v in c_j.items()}
    c_t["conv"].copy_(tail)
    c_t["h"].copy_(h)
    c_j = {"conv": w_tail.astype(jnp.float32), "h": w_h}
    conv, state = c_t["conv"], c_t["h"]
    for step in range(3):
        d_t, d_j = _x((2, 1, 128), dtype, seed=10 + step)
        out_t, c_t = mamba2.mamba2_decode_step(pt, d_t, ssm, c_t)
        out_j, c_j = j_m2.mamba2_decode_step(pj, d_j, ssm, c_j)
        assert c_t["conv"] is conv and c_t["h"] is state
        _close(out_t, out_j, _tol(dtype))
        _close(c_t["conv"], c_j["conv"], _tol(dtype))
        _close(c_t["h"], c_j["h"], _tol(dtype))


def test_decode_continues_the_forward(ssm, layer):
    """Prefill S tokens, then decode token S+1: equal (float32) to the
    forward over S+1 tokens at its last position."""
    _, pt = layer
    x, _ = _x((2, 41, 128), "float32", seed=6)
    full = mamba2.mamba2_forward(pt, x, ssm)
    _, (tail, h) = mamba2.mamba2_forward(pt, x[:, :40], ssm,
                                         return_state=True)
    cache = mamba2.init_mamba2_cache(2, 128, ssm)
    cache["conv"].copy_(tail)
    cache["h"].copy_(h)
    out, _ = mamba2.mamba2_decode_step(pt, x[:, 40:], ssm, cache)
    _close(out, full[:, 40:].numpy(), F32_TOL)
