"""The CUDA flash-attention kernel against its plain version, on the card.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_flash_attention_cuda.py

Without a card the tests skip (the kernel has no CPU form; the plain
version's parity with the reference is held in
tests/test_torch_flash_attention.py). Tolerances as there: atol 2e-6 in
float32, 2e-2 in bf16. float32 inputs go to the CUDA-core kernel, bf16
inputs to the wgmma + TMA kernel (which rounds P to bf16 before the PV
product, as the reference's plain path does).
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
    # bf16 cases of the wgmma + TMA kernel: ragged S (TMA zero-fills the
    # rows past S, the kernel masks them), Sq != Sk with q_offset, the
    # window and the other head dims at S=2048, the qwen2 heads at B=4.
    "s77_bf16": (2, 77, 77, 4, 2, 64, torch.bfloat16, True, None, 0),
    "s1_bf16": (2, 1, 1, 4, 2, 64, torch.bfloat16, True, None, 0),
    "q_offset_bf16": (2, 64, 200, 4, 2, 64, torch.bfloat16, True, None, 136),
    "q_offset_window_bf16": (1, 100, 300, 4, 2, 64, torch.bfloat16, True, 64,
                             200),
    "rows_without_keys_bf16": (1, 64, 40, 2, 1, 64, torch.bfloat16, True, 32,
                               20),
    "not_causal_bf16": (1, 100, 130, 2, 1, 32, torch.bfloat16, False, 16, 0),
    "window128_s2048_bf16": (1, 2048, 2048, 4, 2, 64, torch.bfloat16, True,
                             128, 0),
    "hd32_s2048_bf16": (1, 2048, 2048, 4, 2, 32, torch.bfloat16, True, None,
                        0),
    "hd128_s2048_bf16": (1, 2048, 2048, 4, 2, 128, torch.bfloat16, True,
                         None, 0),
    "qwen2_heads_b4_bf16": (4, 2048, 2048, 14, 2, 64, torch.bfloat16, True,
                            None, 0),
    # hd 80 (zamba2-2.7b's shared block: five 16-column panels under
    # SWIZZLE_32B in bf16, a third column chunk on half the lanes in
    # float32) and hd 256 (gemma-7b: four 64-column panels, 64-key tiles,
    # two PV products in bf16; 2 rows a thread in float32), each causal,
    # ragged and not causal, windowed with q_offset, and at S = 2048.
    "hd80_f32": (2, 200, 200, 4, 4, 80, torch.float32, True, None, 0),
    "hd80_bf16": (2, 200, 200, 4, 4, 80, torch.bfloat16, True, None, 0),
    "hd80_not_causal_f32": (1, 100, 130, 2, 1, 80, torch.float32, False, 16,
                            0),
    "hd80_not_causal_bf16": (1, 100, 130, 2, 1, 80, torch.bfloat16, False,
                             16, 0),
    "hd80_q_offset_window_f32": (1, 100, 300, 4, 2, 80, torch.float32, True,
                                 64, 200),
    "hd80_q_offset_window_bf16": (1, 100, 300, 4, 2, 80, torch.bfloat16,
                                  True, 64, 200),
    "hd80_s2048_bf16": (1, 2048, 2048, 4, 4, 80, torch.bfloat16, True, None,
                        0),
    "hd256_f32": (2, 200, 200, 4, 4, 256, torch.float32, True, None, 0),
    "hd256_bf16": (2, 200, 200, 4, 4, 256, torch.bfloat16, True, None, 0),
    "hd256_not_causal_f32": (1, 100, 130, 2, 1, 256, torch.float32, False,
                             16, 0),
    "hd256_not_causal_bf16": (1, 100, 130, 2, 1, 256, torch.bfloat16, False,
                              16, 0),
    "hd256_q_offset_window_f32": (1, 100, 300, 4, 2, 256, torch.float32,
                                  True, 64, 200),
    "hd256_q_offset_window_bf16": (1, 100, 300, 4, 2, 256, torch.bfloat16,
                                   True, 64, 200),
    "hd256_s2048_bf16": (1, 2048, 2048, 4, 4, 256, torch.bfloat16, True,
                         None, 0),
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


@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_bf16_kernel_agrees_with_float32_kernel(cuda_device, hd):
    """The two kernels on the same bf16-representable inputs: the bf16
    kernel (tensor cores, P rounded to bf16, bf16 output) within the bf16
    tolerance of the float32 kernel (CUDA cores, float32 throughout)."""
    g = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16)
               .to(cuda_device)
               for shape in ((2, 300, 4, hd), (2, 300, 2, hd), (2, 300, 2, hd)))
    before = ops.launches
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert ops.launches == before + 2
    err = float((got.float() - want).abs().max())
    assert err <= ATOL[torch.bfloat16], err
