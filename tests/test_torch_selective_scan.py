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


# -- the Hopper kernel's algorithm, emulated on the CPU ------------------------

# csrc/selective_scan.cu's kT (steps a tile), kChannels (channels a block) and
# kLanes (lanes a channel).
KT, BLOCK_CHANNELS, LANES = 32, 64, 4
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)

# name: (B, S, D, N, h0): the reference's sweep, a ragged D (and S=77, a
# ragged last tile), nonzero h0 cases (one with a ragged D at N=8) and S=1.
EMULATION_CASES = {
    "sweep_1x64x128_n8": (1, 64, 128, 8, False),
    "sweep_2x128x256_n16": (2, 128, 256, 16, False),
    "sweep_1x96x512_n16": (1, 96, 512, 16, False),
    "sweep_2x100x128_n8": (2, 100, 128, 8, False),
    "ragged_d200_n16": (2, 77, 200, 16, False),
    "h0_n16": (2, 150, 384, 16, True),
    "h0_ragged_n8": (1, 45, 130, 8, True),
    "s1_n8": (3, 1, 256, 8, False),
}


def _hopper_scan_emulation(x, dt, A, Bm, Cm, Dskip, h0=None, carry=True):
    """selective_scan_fwd (csrc/selective_scan.cu) step by step, over all
    (batch, channel) pairs at once: channels padded to whole blocks of 64
    and rows to whole groups of 4 steps with zeros (the kernel zero-fills
    both, and a zero row leaves h as it is), each channel's N states split
    over 4 lanes of N/4 contiguous states, the sequence walked in tiles of
    kT steps (the last one ragged) with h carried from tile to tile,
    exp(dt * A) as exp2(dt * (A * log2 e)) in float32, each lane's partial
    sum of h * C taken state by state, a group's 4 x 4 partials combined by
    the reduce-scatter (lanes xor 1, then xor 2: lane s ends with step s's
    sum, (p0 + p1) + (p2 + p3) over the lanes in the butterfly's order), D * x
    added last. `carry=False` drops the carry across tiles: h restarts from
    h0 at each tile. Returns (y (B, S, D), h (B, D, N)), float32."""
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    per_lane = N // LANES
    pad_d = (-Dm) % BLOCK_CHANNELS
    pad_s = (-S) % LANES
    Dp, Sp = Dm + pad_d, S + pad_s

    def padded(t, dim, pad):
        shape = list(t.shape)
        shape[dim] = pad
        return torch.cat([t, torch.zeros(shape)], dim=dim)

    x, dt = (padded(padded(t, 2, pad_d), 1, pad_s) for t in (x, dt))
    Bm, Cm = padded(Bm, 1, pad_s), padded(Cm, 1, pad_s)
    a2 = (padded(A, 0, pad_d) * LOG2E).reshape(Dp, LANES, per_lane)
    skip = padded(Dskip, 0, pad_d)
    start = (torch.zeros(Bsz, Dp, N) if h0 is None else padded(h0, 1, pad_d))
    start = start.reshape(Bsz, Dp, LANES, per_lane)
    h = start.clone()
    y = torch.empty(Bsz, Sp, Dp)
    for t0 in range(0, Sp, KT):
        if not carry:
            h = start.clone()
        for g0 in range(t0, min(t0 + KT, Sp), LANES):
            part = torch.zeros(Bsz, Dp, LANES, LANES)  # (lane, step)
            for s in range(LANES):
                t = g0 + s
                xv = x[:, t, :, None, None]
                dtv = dt[:, t, :, None, None]
                bv = Bm[:, t].reshape(Bsz, 1, LANES, per_lane)
                cv = Cm[:, t].reshape(Bsz, 1, LANES, per_lane)
                h = torch.exp2(dtv * a2) * h + (dtv * xv) * bv
                p = torch.zeros(Bsz, Dp, LANES)
                for j in range(per_lane):
                    p = h[..., j] * cv[..., j] + p
                part[..., s] = p
            sums = ((part[:, :, 0] + part[:, :, 1])
                    + (part[:, :, 2] + part[:, :, 3]))  # (B, Dp, step)
            y[:, g0:g0 + LANES] = (skip * x[:, g0:g0 + LANES]
                                   + sums.transpose(1, 2))
    return y[:, :S, :Dm], h[:, :Dm].reshape(Bsz, Dm, N)


@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_hopper_kernel_emulation_matches_reference(name):
    B, S, D, N, with_h0 = EMULATION_CASES[name]
    *args, h0 = _inputs(B, S, D, N, seed=len(name), h0=True)
    h0 = h0 if with_h0 else None
    y, h = _hopper_scan_emulation(
        *_t(args), h0=None if h0 is None else torch.tensor(h0))
    y_j, h_j = j_ref.selective_scan_sequential(
        *_j(args), h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    _close(y, y_j)
    _close(h, h_j)


def test_hopper_kernel_emulation_without_tile_carry_fails():
    """The emulation is sharp enough to see a lost carry: with h restarting
    at each tile of 32 steps, it leaves the tolerance."""
    args = _inputs(2, 128, 256, 16, seed=5)
    y, h = _hopper_scan_emulation(*_t(args), carry=False)
    y_j, h_j = j_ref.selective_scan_sequential(*_j(args))
    with pytest.raises(AssertionError):
        _close(y, y_j)
    with pytest.raises(AssertionError):
        _close(h, h_j)
    y, h = _hopper_scan_emulation(*_t(args))
    _close(y, y_j)
    _close(h, h_j)
