"""The port's selective scan (plain version and wrapper) against the JAX
reference, on the CPU.

The same numpy inputs, made from a seed, go to the reference's
`selective_scan_sequential` and `selective_scan_ref` and to its Pallas
kernel through `repro.kernels.selective_scan.ops.selective_scan` (interpret
mode on the CPU, as the reference's own tests run it), and to the port's
`selective_scan_sequential`, `selective_scan_ref` and wrapper. Cases: the
reference's sweep (tests/test_kernels_scan.py) with chunk 32, so S=100 has
a ragged last chunk; a nonzero h0; chunks longer than S.

Tolerance: 3e-5 absolute, the reference's own for its scans. The port's
chunked form replaces `lax.associative_scan` by a doubling scan, which
combines the same pairs in another tree order, so it agrees to float32
rounding, not to the bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import ops as j_ops
from repro.kernels.selective_scan import ref as j_ref
from repro_torch.kernels.selective_scan import ops, ref

ATOL = 3e-5
SWEEP = [(1, 64, 128, 8), (2, 128, 256, 16), (1, 96, 512, 16),
         (2, 100, 128, 8)]


def _inputs(B, S, D, N, seed=0, h0=False):
    """x, dt, A, B, C, D[, h0] as float32 numpy, distributed as the
    reference's test inputs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, D))
    dt = np.logaddexp(rng.normal(0, 1, (B, S, D)), 0) * 0.2
    A = -np.exp(rng.normal(0, 1, (D, N)) * 0.3)
    Bm = rng.normal(0, 1, (B, S, N))
    Cm = rng.normal(0, 1, (B, S, N))
    Dskip = np.linspace(0.5, 1.5, D)
    out = [x, dt, A, Bm, Cm, Dskip]
    if h0:
        out.append(rng.normal(0, 0.5, (B, D, N)))
    return [a.astype(np.float32) for a in out]


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(actual, desired):
    np.testing.assert_allclose(actual.numpy(), np.asarray(desired), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("B,S,D,N", SWEEP)
def test_sequential_matches_reference_oracle(B, S, D, N):
    args = _inputs(B, S, D, N)
    y, h = ref.selective_scan_sequential(*_t(args))
    y_j, h_j = j_ref.selective_scan_sequential(*_j(args))
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    _close(y, y_j)
    _close(h, h_j)


@pytest.mark.parametrize("B,S,D,N", SWEEP)
def test_chunked_ref_matches_reference_and_pallas_kernel(B, S, D, N):
    args = _inputs(B, S, D, N)
    y, h = ref.selective_scan_ref(*_t(args), chunk=32)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    for want in (j_ref.selective_scan_ref(*_j(args), chunk=32),
                 j_ref.selective_scan_sequential(*_j(args)),
                 j_ops.selective_scan(*_j(args), chunk=32)):
        _close(y, want[0])
        _close(h, want[1])


@pytest.mark.parametrize("chunk", [16, 32, 100, 256])
def test_nonzero_h0_and_chunk_lengths_match_reference(chunk):
    """h0 carried in by both forms; chunk 100 leaves a ragged tail of 50
    steps and 256 is longer than S (one chunk of S steps)."""
    *args, h0 = _inputs(2, 150, 128, 16, seed=1, h0=True)
    want_y, want_h = j_ref.selective_scan_sequential(*_j(args),
                                                     h0=jnp.asarray(h0))
    y, h = ref.selective_scan_ref(*_t(args), chunk=chunk,
                                  h0=torch.tensor(h0))
    _close(y, want_y)
    _close(h, want_h)
    y_j, h_j = j_ref.selective_scan_ref(*_j(args), chunk=chunk,
                                        h0=jnp.asarray(h0))
    _close(y, y_j)
    _close(h, h_j)
    y_s, h_s = ref.selective_scan_sequential(*_t(args), h0=torch.tensor(h0))
    _close(y_s, want_y)
    _close(h_s, want_h)


@pytest.mark.parametrize("L", [1, 2, 5, 8, 13])
def test_doubling_scan_is_the_inclusive_scan_of_assoc_op(L):
    rng = np.random.default_rng(L)
    a = torch.tensor(rng.uniform(0.5, 1.0, (3, L, 4)).astype(np.float32))
    b = torch.tensor(rng.normal(0, 1, (3, L, 4)).astype(np.float32))
    got_a, got_b = ref._doubling_scan(a, b, dim=1)
    acc = (a[:, 0], b[:, 0])
    for i in range(L):
        if i:
            acc = ref._assoc_op(acc, (a[:, i], b[:, i]))
        torch.testing.assert_close(got_a[:, i], acc[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got_b[:, i], acc[1], rtol=1e-6, atol=1e-6)


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    *args, h0 = _inputs(2, 100, 128, 8, seed=2, h0=True)
    before = ops.launches
    y, h = ops.selective_scan(*_t(args), chunk=32)
    y0, h0_out = ops.selective_scan(*_t(args), chunk=32, h0=torch.tensor(h0))
    assert ops.launches == before
    want = ref.selective_scan_ref(*_t(args), chunk=32)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    want0 = ref.selective_scan_ref(*_t(args), chunk=32, h0=torch.tensor(h0))
    assert torch.equal(y0, want0[0]) and torch.equal(h0_out, want0[1])
    y_j, h_j = j_ops.selective_scan(*_j(args), chunk=32)
    _close(y, y_j)
    _close(h, h_j)


def test_wrapper_takes_strided_b_and_c_views():
    """B and C as the model makes them: split views of one projection."""
    x, dt, A, Bm, Cm, D = _t(_inputs(1, 64, 128, 8, seed=3))
    proj = torch.cat([torch.zeros(1, 64, 5), Bm, Cm], dim=-1)
    _, B_v, C_v = proj.split([5, 8, 8], dim=-1)
    assert B_v.stride(1) == 21 and not B_v.is_contiguous()
    y, h = ops.selective_scan(x, dt, A, B_v, C_v, D, chunk=32)
    y_c, h_c = ops.selective_scan(x, dt, A, Bm, Cm, D, chunk=32)
    assert torch.equal(y, y_c) and torch.equal(h, h_c)


def test_wrapper_refuses_bad_dtype_device_and_shape():
    x, dt, A, Bm, Cm, D = _t(_inputs(1, 16, 32, 8, seed=4))
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm, D)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.selective_scan(*meta)
    with pytest.raises(ValueError, match="lie on"):
        ops.selective_scan(x, dt, A, Bm, Cm, D.to("meta"))
    with pytest.raises(TypeError, match="float32"):
        ops.selective_scan(x.double(), dt, A, Bm, Cm, D)
    with pytest.raises(TypeError, match="float32"):
        ops.selective_scan(x, dt, A, Bm.to(torch.bfloat16), Cm, D)
    with pytest.raises(ValueError, match="dt has shape"):
        ops.selective_scan(x, dt[:, :8], A, Bm, Cm, D)
    with pytest.raises(ValueError, match="C has shape"):
        ops.selective_scan(x, dt, A, Bm, Cm[..., :4], D)
    with pytest.raises(ValueError, match="h0 has shape"):
        ops.selective_scan(x, dt, A, Bm, Cm, D, h0=torch.zeros(1, 32, 4))
    with pytest.raises(ValueError, match=r"x \(B, S, D\)"):
        ops.selective_scan(x[0], dt, A, Bm, Cm, D)
