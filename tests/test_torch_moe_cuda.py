"""The mixture-of-experts layer and an MoE arch on the card against the CPU.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_moe_cuda.py

Without a card the tests skip. The same weights and tokens go to both
devices in float32: routing, positions and keep exact (the router's
float32 logits differ by a few ulps between cuBLAS and the CPU, far
below these inputs' smallest top-k margin), outputs and the aux loss
within 1e-5 of max(1, max |CPU value|). A routing or dispatch step that
read a value back to the host would fail under
torch.cuda.set_sync_debug_mode("error").
"""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves, tree_map

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _gap(a, b):
    return float((a.cpu().float() - b.float()).abs().max()) / max(
        1.0, float(b.float().abs().max()))


@pytest.mark.parametrize("dispatch", ["global", "batched"])
def test_moe_forward_card_equals_cpu_without_a_host_sync(cuda_device,
                                                         dispatch):
    cfg = MoEConfig(n_experts=16, top_k=4, d_ff_expert=32,
                    capacity_factor=0.75, shared_expert_d_ff=32,
                    dispatch=dispatch)
    p = moe.init_moe(torch.Generator().manual_seed(0), 64, cfg)
    x = torch.randn((3, 50, 64), generator=torch.Generator().manual_seed(1))
    want, m_want = moe.moe_forward(p, x, cfg)
    p_c, x_c = tree_map(lambda t: t.to(cuda_device), p), x.to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, m_got = moe.moe_forward(p_c, x_c, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.device.type == "cuda"
    assert _gap(got, want) <= TOL
    assert _gap(m_got["aux_loss"], m_want["aux_loss"]) <= TOL
    # keep is exact (below); the batched mean over rows of 1 - mean(keep)
    # may round an ulp apart on the two devices.
    assert abs(float(m_got["drop_frac"])
               - float(m_want["drop_frac"])) <= 2.0 ** -23
    assert float(m_want["drop_frac"]) > 0
    rows = [x.reshape(-1, 64)] if dispatch == "global" else list(x)
    for xt in rows:
        r_c = moe.route(p_c, xt.to(cuda_device), cfg)
        r = moe.route(p, xt, cfg)
        for name in ("experts", "pos", "keep"):
            assert torch.equal(getattr(r_c, name).cpu(),
                               getattr(r, name)), name


def test_qwen3_moe_smoke_loss_grads_card_equal_cpu(cuda_device):
    """qwen3-moe-30b-a3b's smoke config: the loss (with the aux loss) and
    every gradient leaf, the attention through the flash kernel on the
    card (one launch a layer), within 1e-5 of the CPU's."""
    cfg = registry.get_config("qwen3-moe-30b-a3b", smoke=True).replace(
        dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2, 33),
                           generator=torch.Generator().manual_seed(3))
    vg = train.value_and_grad_fn(cfg)
    g_cpu, l_cpu = vg(tree_map(lambda t: t[None], params),
                      {"tokens": tokens})
    before = fa_ops.launches
    g_card, l_card = vg(tree_map(lambda t: t[None].to(cuda_device), params),
                        {"tokens": tokens.to(cuda_device)})
    assert fa_ops.launches == before + cfg.n_layers
    assert abs(float(l_card) - float(l_cpu)) <= TOL * abs(float(l_cpu))
    for a, b in zip(leaves(g_card), leaves(g_cpu)):
        assert float((a.cpu() - b).abs().max()) <= TOL * max(
            float(b.abs().max()), 1e-30)
    assert float(g_card["layers"]["moe"]["router"].abs().max()) > 0
