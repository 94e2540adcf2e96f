"""The CUDA quantize kernel against its plain version, on the card.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_quantize_cuda.py

Without a card the test skips (it needs the kernel, which has no CPU
form; the plain version's parity with the reference is held in
tests/test_torch_quantize.py).
"""
import pytest
import torch

from repro_torch.kernels.quantize import ops, ref

pytestmark = pytest.mark.cuda

SHAPES = {
    "rows_not_multiple_of_256": (300, 1024),
    "narrow_rows": (64, 128),
    "slice_shape": (16280, 1024),
}


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_kernel_matches_plain_version(cuda_device, name):
    g = torch.Generator().manual_seed(len(name))
    x = (torch.randn(SHAPES[name], generator=g) * 0.05).to(cuda_device)
    x[0] = 0.0  # an all-zero row
    x[1, :2] = torch.tensor([float("nan"), 1.0])
    x[2, 5] = float("inf")
    u = ref.stochastic_noise(
        torch.Generator(device=cuda_device).manual_seed(1), x.shape)
    before = ops.launches
    q, s = ops.quantize(x, u)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    q_r, s_r = ref.quantize_ref(x, u)
    assert torch.equal(q, q_r)
    assert torch.equal(s, s_r)
    assert s[1, 0] == 1.0 and q[1, 0] == 0 and torch.isinf(s[2, 0])
