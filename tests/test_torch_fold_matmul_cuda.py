"""The CUDA fold matmul against its plain version, every route and kernel
instance against the row route bit for bit, and what it exists for: a
client's numbers that do not depend on the rows or the padding beside
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
# K around the tail rule's multiple of 16, and the main path's long K.
KS = (1, 15, 16, 17, 40, 48, 4000, 12544)
# Every route, and every instance by name.
ROUTES = ops.ROUTES + tuple(ops.INSTANCES)


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
    # Every route and instance, the same bits, signs of zero included.
    for route in ROUTES:
        assert same_bits(ops.fold_matmul(a, b, route=route), c)


def same_bits(x, y):
    return torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))


def _rows(a, b):
    return ops.fold_matmul(a, b, route="rows")


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("instance", sorted(ops.INSTANCES))
def test_every_instance_equals_the_row_route(cuda_device, instance, K):
    """Each tile and panel instance against the row route (the oracle), bit
    for bit, at K around the tail rule's multiple of 16 and at the main
    path's long K; ragged M and N."""
    g = torch.Generator(device=cuda_device).manual_seed(K)
    a = torch.randn(2, 37, K, generator=g, device=cuda_device)
    b = torch.randn(2, K, 45, generator=g, device=cuda_device)
    before = ops.launches
    out = ops.fold_matmul(a, b, route=instance)
    assert ops.launches == before + 1
    assert same_bits(out, _rows(a, b))


def _layout(name, dev, g):
    """(a, b) at K = 100 (not a multiple of 16) in one of the layouts the
    FL path hands the kernel."""
    K = 100
    if name == "ones":  # a bias gradient: A all strides 0, M = 1
        return (torch.ones((), device=dev).expand(3, 1, K),
                torch.randn(3, K, 64, generator=g, device=dev))
    if name == "wbc":  # FedAvg's weights: A broadcast over the batch
        return (torch.rand(1, 5, K, generator=g, device=dev).expand(4, 5, K),
                torch.randn(4, K, 70, generator=g, device=dev))
    if name == "tn_odd":  # conv1's patches^T: A's k stride 25
        return (torch.randn(3, K, 25, generator=g, device=dev).transpose(1, 2),
                torch.randn(3, K, 32, generator=g, device=dev))
    if name == "nt_odd":  # a transposed weight: B's n stride K = 101
        return (torch.randn(3, 20, 101, generator=g, device=dev),
                torch.randn(3, 10, 101, generator=g,
                            device=dev).transpose(1, 2))
    if name == "offset":  # bases one float off 16-byte alignment
        return (torch.randn(3, 40, K + 1, generator=g, device=dev)[:, :, 1:],
                torch.randn(3, K + 1, 68, generator=g, device=dev)[:, 1:])
    raise KeyError(name)


@pytest.mark.parametrize("layout", ["ones", "wbc", "tn_odd", "nt_odd",
                                    "offset"])
@pytest.mark.parametrize("instance", sorted(ops.INSTANCES))
def test_every_instance_takes_every_layout(cuda_device, instance, layout):
    a, b = _layout(layout, cuda_device,
                   torch.Generator(device=cuda_device).manual_seed(7))
    assert same_bits(ops.fold_matmul(a, b, route=instance), _rows(a, b))


@pytest.mark.parametrize("K,sign", [(48, -1), (40, 1)])
@pytest.mark.parametrize("route", ROUTES)
def test_signed_zero_follows_the_tail_rule(cuda_device, route, K, sign):
    """-1e-30 x 1e-30 underflows to -0, and a chain of them stays -0; at K
    = 40 the tail rule's one fmaf(0, 0, acc) makes it +0."""
    a = torch.full((2, 3, K), -1e-30, device=cuda_device)
    b = torch.full((2, K, 5), 1e-30, device=cuda_device)
    out = ops.fold_matmul(a, b, route=route)
    bits = torch.tensor(-2**31 if sign < 0 else 0, dtype=torch.int32)
    assert bool((out.view(torch.int32).cpu() == bits).all())


def test_64_bit_offsets_at_the_study_conv1_forward(cuda_device):
    """The Fig. 2 MNIST group's conv1 forward, (60, 25088, 25) @ (60, 25,
    32): 48M outputs, the FL path's largest product."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn(60, 25088, 25, generator=g, device=cuda_device)
    b = torch.randn(60, 25, 32, generator=g, device=cuda_device)
    assert ops.route_for(60, 25088, 32, 25) == "tiles"
    assert same_bits(ops.fold_matmul(a, b), _rows(a, b))


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
