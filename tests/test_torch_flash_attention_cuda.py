"""The CUDA flash-attention kernel against its plain version, on the card.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_flash_attention_cuda.py

Without a card the tests skip (the kernel has no CPU form; the plain
version's parity with the reference is held in
tests/test_torch_flash_attention.py). Tolerances as there: atol 2e-6 in
float32, 2e-2 in bf16.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}

# name: (B, Sq, Sk, H, KV, hd, dtype, causal, window, q_offset)
CASES = {
    "s64_f32": (2, 64, 64, 4, 2, 64, torch.float32, True, None, 0),
    "s200_bf16": (2, 200, 200, 4, 2, 64, torch.bfloat16, True, None, 0),
    "s384_f32": (1, 384, 384, 4, 2, 64, torch.float32, True, None, 0),
    "s2048_bf16": (1, 2048, 2048, 4, 2, 64, torch.bfloat16, True, None, 0),
    "window32_f32": (1, 256, 256, 2, 1, 64, torch.float32, True, 32, 0),
    "window128_bf16": (1, 384, 384, 2, 1, 64, torch.bfloat16, True, 128, 0),
    "hd32_f32": (2, 200, 200, 4, 2, 32, torch.float32, True, None, 0),
    "hd128_bf16": (2, 200, 200, 4, 2, 128, torch.bfloat16, True, None, 0),
    "q_offset_f32": (2, 64, 200, 4, 2, 64, torch.float32, True, None, 136),
    "rows_without_keys_f32": (1, 64, 40, 2, 1, 64, torch.float32, True, 32,
                              20),
    "gqa7_qwen2_heads_bf16": (2, 256, 256, 14, 2, 64, torch.bfloat16, True,
                              None, 0),
    "not_causal_f32": (1, 100, 130, 2, 1, 32, torch.float32, False, 16, 0),
}


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_version(cuda_device, name):
    B, Sq, Sk, H, KV, hd, dtype, causal, window, q_offset = CASES[name]
    g = torch.Generator().manual_seed(len(name))
    q, k, v = (torch.randn(shape, generator=g).to(cuda_device, dtype)
               for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal, window, q_offset)
    assert out.dtype == dtype and out.shape == q.shape
    err = float((out.float() - want.float()).abs().max())
    assert err <= ATOL[dtype], err
