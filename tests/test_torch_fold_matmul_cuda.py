"""The CUDA fold matmul against its plain version, and what it exists for:
a client's numbers that do not depend on the rows or the padding beside
them. On the card.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_fold_matmul_cuda.py

Without a card the tests skip (the kernel has no CPU form; the stacked
gradient's parity with the reference is held in
tests/test_torch_stacked_grad.py).
"""
import pytest
import torch

from repro_torch.kernels.fold_matmul import ops, ref
from repro_torch.models import cnn
from repro_torch.utils.tree import leaves, tree_map

pytestmark = pytest.mark.cuda

# (batch, M, K, N): ragged, a conv's weight gradient (K over samples x
# pixels), a dense forward.
SHAPES = {"ragged": (3, 70, 33, 65), "wgrad": (4, 200, 4000, 64),
          "dense": (5, 32, 3136, 512)}


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("layout", ["nn", "tn", "nt"])
def test_cuda_kernel_matches_plain_version(cuda_device, name, layout):
    batch, M, K, N = SHAPES[name]
    g = torch.Generator(device=cuda_device).manual_seed(len(name))
    a = torch.randn(batch, M, K, generator=g, device=cuda_device)
    b = torch.randn(batch, K, N, generator=g, device=cuda_device)
    if layout == "tn":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "nt":
        b = b.transpose(1, 2).contiguous().transpose(1, 2)
    before = ops.launches
    c = ops.fold_matmul(a, b)
    assert ops.launches == before + 1
    plain = ref.fold_matmul_ref(a, b)
    assert float((c - plain).abs().max()) <= 1e-4 * max(
        1.0, float(plain.abs().max()))
    # More rows, and K padded with zeros: the rows do not move.
    assert torch.equal(ops.fold_matmul(a[:, : M // 2 + 1], b),
                       c[:, : M // 2 + 1])
    a_pad = torch.cat([a, a.new_zeros(batch, M, 19)], dim=2)
    b_pad = torch.cat([b, b.new_zeros(batch, 19, N)], dim=1)
    assert torch.equal(ops.fold_matmul(a_pad, b_pad), c)
    # Both routes, the same bits, signs of zero included.
    for route in ("tiles", "rows"):
        out = ops.fold_matmul(a, b, route=route)
        assert torch.equal(out.view(torch.int32), c.view(torch.int32))


def test_stacked_grad_is_the_same_beside_other_clients_and_padded(
        cuda_device):
    """Five clients' gradients and losses at N=5, B=6 equal, bit for bit,
    rows 5..9 of a call at N=12 with their batches padded to B=16."""
    cfg = cnn.mnist_cnn_small()
    g = torch.Generator().manual_seed(0)

    def stacked(n):
        p = cnn.init_cnn(cfg, 0, "cpu")
        return tree_map(lambda x: (x[None] * (1 + 0.1 * torch.randn(
            (n,) + x.shape, generator=g))).to(cuda_device), p)

    small = stacked(5)
    x = torch.rand(5, 6, 28, 28, 1, generator=g).to(cuda_device)
    y = torch.randint(0, 10, (5, 6), generator=g).to(cuda_device)
    g_small, l_small = cnn.cnn_stacked_value_and_grad(
        cfg, small, {"x": x, "y": y})
    big = tree_map(lambda b, s: torch.cat([b[:5], s, b[10:]]), stacked(12),
                   small)
    xb = torch.rand(12, 16, 28, 28, 1, generator=g).to(cuda_device)
    yb = torch.randint(0, 10, (12, 16), generator=g).to(cuda_device)
    xb[5:10, :6], yb[5:10, :6] = x, y
    xb[5:10, 6:] = float("nan")  # padded samples never reach a product
    mask = torch.ones(12, 16, device=cuda_device)
    mask[5:10, 6:] = 0.0
    n = torch.full((12,), 16.0, device=cuda_device)
    n[5:10] = 6.0
    g_big, l_big = cnn.cnn_stacked_value_and_grad(
        cfg, big, {"x": xb, "y": yb}, mask, n)
    assert torch.equal(l_big[5:10], l_small)
    for u, v in zip(leaves(g_big), leaves(g_small)):
        assert torch.equal(u[5:10], v)
