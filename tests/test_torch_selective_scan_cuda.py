"""The CUDA selective-scan kernel against its plain version, on the card.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_selective_scan_cuda.py

Without a card the tests skip (the kernel has no CPU form; the plain
version's parity with the reference is held in
tests/test_torch_selective_scan.py). Tolerance: y and h within
3e-5 * max(1, max |plain|), the reference's own 3e-5 for its scans, scaled
for the larger values of long sequences.
"""
import pytest
import torch

from repro_torch.kernels.selective_scan import ops, ref

pytestmark = pytest.mark.cuda

ATOL = 3e-5

# name: (B, S, D, N, chunk, h0)
CASES = {
    "sweep_1x64x128_n8": (1, 64, 128, 8, 32, False),
    "sweep_2x128x256_n16": (2, 128, 256, 16, 32, False),
    "sweep_1x96x512_n16": (1, 96, 512, 16, 32, False),
    "sweep_2x100x128_n8": (2, 100, 128, 8, 32, False),
    "ragged_d200_n16": (2, 77, 200, 16, 32, False),
    "s1_n8": (3, 1, 256, 8, 128, False),
    "h0_n16": (2, 150, 384, 16, 64, True),
    "h0_ragged_n8": (1, 45, 130, 8, 32, True),
    "falcon_prefill_4x2048x8192_n16": (4, 2048, 8192, 16, 128, False),
    "falcon_prompt_1x2048x8192_n16": (1, 2048, 8192, 16, 128, False),
}


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU form")
    return torch.device("cuda")


def scan_inputs(B, S, D, N, h0, seed, device):
    """x, dt, A, B, C, D and h0 (or None), distributed as the reference's
    test inputs, drawn on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = randn(B, S, D)
    dt = torch.nn.functional.softplus(randn(B, S, D)) * 0.2
    A = -torch.exp(randn(D, N) * 0.3)
    Bm, Cm = randn(B, S, N), randn(B, S, N)
    Dskip = torch.linspace(0.5, 1.5, D, device=device)
    return x, dt, A, Bm, Cm, Dskip, (randn(B, D, N) * 0.5 if h0 else None)


def _err(got, want):
    return float((got - want).abs().max()), max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_version(cuda_device, name):
    B, S, D, N, chunk, with_h0 = CASES[name]
    *args, h0 = scan_inputs(B, S, D, N, with_h0, len(name), cuda_device)
    before = ops.launches
    y, h = ops.selective_scan(*args, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    assert y.dtype == h.dtype == torch.float32
    y_r, h_r = ref.selective_scan_ref(*args, chunk=chunk, h0=h0)
    for got, want in ((y, y_r), (h, h_r)):
        err, scale = _err(got, want)
        assert err <= ATOL * scale, (err, scale)


def test_cuda_kernel_takes_strided_b_and_c(cuda_device):
    """B and C as split views of one projection, rows 5 + 2N apart."""
    x, dt, A, Bm, Cm, D, _ = scan_inputs(2, 100, 256, 16, False, 7,
                                         cuda_device)
    proj = torch.cat([torch.zeros(2, 100, 5, device=cuda_device), Bm, Cm],
                     dim=-1)
    _, B_v, C_v = proj.split([5, 16, 16], dim=-1)
    y, h = ops.selective_scan(x, dt, A, B_v, C_v, D)
    y_c, h_c = ops.selective_scan(x, dt, A, Bm, Cm, D)
    torch.cuda.synchronize()
    assert torch.equal(y, y_c) and torch.equal(h, h_c)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, dt, A, Bm, Cm, D, _ = scan_inputs(1, 16, 64, 4, False, 8, cuda_device)
    with pytest.raises(ValueError, match="d_state"):
        ops.selective_scan(x, dt, A, Bm, Cm, D)
    x, dt, A, Bm, Cm, D, _ = scan_inputs(1, 16, 64, 8, False, 8, cuda_device)
    x_t = x.transpose(1, 2).contiguous().transpose(1, 2)  # same values
    assert not x_t.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(x_t, dt, A, Bm, Cm, D)
