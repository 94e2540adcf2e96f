"""Training through the CUDA kernels, on the card: the flash kernel and the
selective scan under autograd against the plain path.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_train_cuda.py

Without a card the tests skip (the kernels have no CPU form). Tolerances:
one attention layer's gradients through the kernel against autograd
through the plain path (impl="plain") within 1e-5 of the largest
|gradient| in float32 (the kernel's forward and the plain path's sum in
other orders; the backward is the plain version's VJP on both), 2e-2 in
bf16 (a bf16 output a rounding step apart feeds the backward).
"""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.launch import train
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves, tree_map

pytestmark = pytest.mark.cuda

GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def _layer_grads(cfg, p, x, impl):
    p = tree_map(lambda t: t.detach().requires_grad_(True), p)
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[0], -1)
    out = attention.attention_forward(p, x, cfg.attention, pos, impl)
    up = torch.randn(out.shape, generator=torch.Generator(
        device=x.device).manual_seed(1), device=x.device).to(out.dtype)
    names = sorted(p)
    grads = torch.autograd.grad(out, [p[k] for k in names], up)
    return out, dict(zip(names, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "musicgen-large"])
def test_attention_layer_grads_through_kernel(cuda_device, arch, dtype):
    cfg = registry.get_config(arch, smoke=True).replace(dtype=dtype)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda_device)
    p = tree_map(lambda t: t[0, 0], params["layers"]["attn"])
    x = torch.randn((2, 77, cfg.d_model), generator=torch.Generator(
        device=cuda_device).manual_seed(2), device=cuda_device).to(
        getattr(torch, dtype))
    before = fa_ops.launches
    out, got = _layer_grads(cfg, p, x, "kernel")
    assert fa_ops.launches == before + 1  # one launch, none in the backward
    assert out.grad_fn is not None
    _, want = _layer_grads(cfg, p, x, "plain")
    for name in ("wq", "wk", "wv"):
        assert float(got[name].abs().max()) > 0, name
    for name in want:
        scale = float(want[name].abs().max())
        err = float((got[name].float() - want[name].float()).abs().max())
        assert err <= GRAD_TOL[dtype] * scale, (name, err, scale)


def test_loss_fn_grads_through_kernel_match_plain(cuda_device):
    """The whole model's loss with impl="kernel" on the card: every
    attention weight gets a gradient within 1e-5 of the plain path's."""
    cfg = registry.get_config("qwen2-0.5b", smoke=True).replace(
        dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                             device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda_device)
    vg = {impl: train.value_and_grad_fn(cfg, impl) for impl in
          ("kernel", "plain")}
    one = tree_map(lambda t: t[None], params)
    before = fa_ops.launches
    g_k, l_k = vg["kernel"](one, {"tokens": tokens[None]})
    assert fa_ops.launches == before + cfg.n_layers
    g_p, l_p = vg["plain"](one, {"tokens": tokens[None]})
    assert abs(float(l_k) - float(l_p)) <= 1e-5 * abs(float(l_p))
    for name in ("wq", "wk", "wv", "wo"):
        a = g_k["layers"]["attn"][name]
        b = g_p["layers"]["attn"][name]
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert all(bool(torch.isfinite(t).all()) for t in leaves(g_k))


def test_selective_scan_refuses_grad_on_the_card(cuda_device):
    """The scan under grad on the card (it refused before it had a
    backward): one launch, and float32 gradients of every input (h0
    included) within 1e-5 of the largest |gradient| of autograd through
    the plain version on the same inputs, all nonzero. Without grad it
    still launches once and builds no graph."""
    Bsz, S, D, N = 2, 40, 32, 16
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    dt = torch.nn.functional.softplus(rand(Bsz, S, D)) * 0.2
    bc = rand(Bsz, S, 2 * N)  # B and C as strided views of one projection
    inputs = [rand(Bsz, S, D), dt, -torch.exp(rand(D, N) * 0.3),
              bc[..., :N], bc[..., N:], rand(D), rand(Bsz, D, N) * 0.5]
    up_y, up_h = rand(Bsz, S, D), rand(Bsz, D, N)
    grads = {}
    for name, fn in (("kernel", ss_ops.selective_scan),
                     ("plain", ss_ops.selective_scan_ref)):
        leaves_ = [t.detach().clone().requires_grad_(True) for t in inputs]
        before = ss_ops.launches
        y, h = fn(*leaves_[:6], chunk=16, h0=leaves_[6])
        assert ss_ops.launches == before + (name == "kernel")
        grads[name] = torch.autograd.grad(
            (y * up_y).sum() + (h * up_h).sum(), leaves_)
        assert ss_ops.launches == before + (name == "kernel")
    for got, want in zip(grads["kernel"], grads["plain"]):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-5 * scale
    before = ss_ops.launches
    with torch.no_grad():
        y, h = ss_ops.selective_scan(*inputs[:6], h0=inputs[6])
    assert ss_ops.launches == before + 1 and y.grad_fn is None


def test_falcon_mamba_smoke_trains_through_the_scan_kernel(cuda_device):
    """falcon-mamba-7b's smoke config: the loss's gradients through the
    scan kernel (one launch a layer) equal the plain path's within 1e-5
    of each leaf's largest |gradient|, and the mixer's weights get nonzero
    gradients."""
    cfg = registry.get_config("falcon-mamba-7b", smoke=True).replace(
        dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2, 33), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(1))
    one = tree_map(lambda t: t[None], params)
    before = ss_ops.launches
    g_k, l_k = train.value_and_grad_fn(cfg, "kernel")(one, {"tokens": tokens})
    assert ss_ops.launches == before + cfg.n_layers
    g_p, l_p = train.value_and_grad_fn(cfg, "plain")(one, {"tokens": tokens})
    assert abs(float(l_k) - float(l_p)) <= 1e-5 * abs(float(l_p))
    for a, b in zip(leaves(g_k), leaves(g_p)):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-30)
    for name, t in g_k["layers"]["mamba"].items():
        assert float(t.abs().max()) > 0, name
