"""The port's flash attention (plain version and wrapper) against the JAX
reference's contract.

The reference's Pallas kernel does not run on the installed jax (its
kernel.py calls `pl.load`, which jax 0.9 no longer has), so the port is
held against the reference's oracle, `attention_ref`, and against the GQA
contract of the reference's wrapper (ops.flash_attention: (B, S, H, hd)
queries, (B, S, KV, hd) keys and values, each kv head repeated to its
group with `jnp.repeat`), composed here from `attention_ref` exactly as
ops.py composes it around the kernel.

The same numpy inputs go to both packages (bf16 cases round the same
float32 values to bf16 in both, to nearest even). Tolerances are those of
the reference's tests/test_kernels_flash.py: atol 2e-6 in float32 (both
sum in float32, in another order) and 2e-2 in bf16 (the float32 result
rounded once to bf16 can land one bf16 ulp apart).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import ops, ref

ATOL = {"float32": 2e-6, "bfloat16": 2e-2}

# name: (B, Sq, Sk, H, KV, hd, dtype, causal, window, q_offset)
CASES = {
    "s64_f32": (2, 64, 64, 4, 2, 64, "float32", True, None, 0),
    "s128_f32": (2, 128, 128, 4, 2, 64, "float32", True, None, 0),
    "s200_f32": (2, 200, 200, 4, 2, 64, "float32", True, None, 0),
    "s384_f32": (1, 384, 384, 4, 2, 64, "float32", True, None, 0),
    "s64_bf16": (2, 64, 64, 4, 2, 64, "bfloat16", True, None, 0),
    "s128_bf16": (2, 128, 128, 4, 2, 64, "bfloat16", True, None, 0),
    "s200_bf16": (2, 200, 200, 4, 2, 64, "bfloat16", True, None, 0),
    "s384_bf16": (1, 384, 384, 4, 2, 64, "bfloat16", True, None, 0),
    "window32": (1, 256, 256, 2, 1, 64, "float32", True, 32, 0),
    "window128": (1, 384, 384, 2, 1, 64, "float32", True, 128, 0),
    "window32_bf16": (1, 200, 200, 2, 1, 64, "bfloat16", True, 32, 0),
    "hd32": (2, 128, 128, 4, 2, 32, "float32", True, None, 0),
    "hd128": (2, 128, 128, 4, 2, 128, "float32", True, None, 0),
    "gqa7_qwen2_heads": (1, 128, 128, 14, 2, 64, "bfloat16", True, None, 0),
    "q_offset": (2, 64, 200, 4, 2, 64, "float32", True, None, 136),
    "q_offset_window": (1, 64, 256, 2, 2, 64, "float32", True, 32, 100),
    # Rows whose window holds no key (positions >= 40 - 1 + 32) give zeros.
    "rows_without_keys": (1, 64, 40, 2, 1, 64, "float32", True, 32, 20),
    "not_causal": (1, 100, 100, 2, 1, 32, "float32", False, None, 0),
    # The zoo's other head dims: zamba2-2.7b's shared block (80) and
    # gemma-7b (256, MHA).
    "hd80": (2, 128, 128, 4, 4, 80, "float32", True, None, 0),
    "hd80_window_bf16": (1, 200, 200, 2, 2, 80, "bfloat16", True, 32, 0),
    "hd256": (2, 128, 128, 4, 4, 256, "float32", True, None, 0),
    "hd256_q_offset_bf16": (2, 64, 200, 4, 2, 256, "bfloat16", True, None,
                            136),
}


def _inputs(name):
    B, Sq, Sk, H, KV, hd, dtype, *_ = CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.normal(0, 1, (B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


def _j_gqa(q, k, v, causal, window, q_offset, rows=8):
    """ops.py's GQA contract around the reference's oracle, which runs on
    `rows` (batch, head) pairs at a time so that its (rows, Sq, Sk) scores
    stay small at S = 2048."""
    B, Sq, H, hd = q.shape
    rep = H // k.shape[2]
    qt = q.transpose(0, 2, 1, 3).reshape(B * H, Sq, hd)
    kt = jnp.repeat(k.transpose(0, 2, 1, 3), rep, axis=1).reshape(B * H, -1, hd)
    vt = jnp.repeat(v.transpose(0, 2, 1, 3), rep, axis=1).reshape(B * H, -1, hd)
    out = jnp.concatenate([
        j_attention_ref(qt[i:i + rows], kt[i:i + rows], vt[i:i + rows],
                        causal, window, q_offset)
        for i in range(0, B * H, rows)])
    return out.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)


def _both(name):
    """(port tensors, reference arrays) of the case's inputs."""
    dtype = CASES[name][6]
    arrs = _inputs(name)
    t = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    return t, j


def _close(actual, desired, dtype):
    np.testing.assert_allclose(actual.float().numpy(),
                               np.asarray(desired, np.float32),
                               rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("name", sorted(CASES))
def test_gqa_ref_matches_reference_contract(name):
    *_, dtype, causal, window, q_offset = CASES[name]
    (q, k, v), (jq, jk, jv) = _both(name)
    out = ref.flash_attention_ref(q, k, v, causal, window, q_offset)
    want = _j_gqa(jq, jk, jv, causal, window, q_offset)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, want, dtype)
    if name == "rows_without_keys":
        assert out[:, 51:].abs().max() == 0
        assert (out[:, :51].abs().amax(dim=-1) > 0).all()


@pytest.mark.parametrize("name", ["s200_f32", "s200_bf16", "q_offset_window",
                                  "rows_without_keys"])
def test_attention_ref_matches_reference_oracle(name):
    """The (BH, S, hd) oracle itself: head 0 of each batch row."""
    *_, dtype, causal, window, q_offset = CASES[name]
    arrs = [a[:, :, 0] for a in _inputs(name)]
    t = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    out = ref.attention_ref(*t, causal, window, q_offset)
    _close(out, j_attention_ref(*j, causal, window, q_offset), dtype)


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    (q, k, v), (jq, jk, jv) = _both("s200_bf16")
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=True, window=None)
    assert ops.launches == before
    assert torch.equal(out, ref.flash_attention_ref(q, k, v))
    _close(out, _j_gqa(jq, jk, jv, True, None, 0), "bfloat16")


def test_wrapper_refuses_other_devices_and_bad_arguments():
    x = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(x, x, x)
    q = torch.zeros(1, 8, 3, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q, kv, kv)
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, kv, kv, window=0)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, kv.to(torch.bfloat16), kv)


# -- the bf16 Hopper kernel's algorithm, emulated on the CPU -------------------

# name: (B, Sq, Sk, H, KV, hd, causal, window, q_offset), all bf16: the bf16
# cases of tests/test_torch_flash_attention_cuda.py.
HOPPER_CASES = {
    "s77": (2, 77, 77, 4, 2, 64, True, None, 0),
    "s1": (2, 1, 1, 4, 2, 64, True, None, 0),
    "s200": (2, 200, 200, 4, 2, 64, True, None, 0),
    "q_offset": (2, 64, 200, 4, 2, 64, True, None, 136),
    "q_offset_window": (1, 100, 300, 4, 2, 64, True, 64, 200),
    "rows_without_keys": (1, 64, 40, 2, 1, 64, True, 32, 20),
    "not_causal": (1, 100, 130, 2, 1, 32, False, 16, 0),
    "window128_s2048": (1, 2048, 2048, 4, 2, 64, True, 128, 0),
    "hd32_s2048": (1, 2048, 2048, 4, 2, 32, True, None, 0),
    "hd128_s2048": (1, 2048, 2048, 4, 2, 128, True, None, 0),
    "qwen2_heads_b4": (4, 2048, 2048, 14, 2, 64, True, None, 0),
    # hd 80: five 16-column panels, 128-key tiles, one PV product of N = 80;
    # hd 256: four 64-column panels, 64-key tiles, two PV products of 128.
    "hd80_s200": (2, 200, 200, 4, 4, 80, True, None, 0),
    "hd80_q_offset_window": (1, 100, 300, 4, 2, 80, True, 64, 200),
    "hd80_not_causal": (1, 100, 130, 2, 1, 80, False, 16, 0),
    "hd80_s2048": (1, 2048, 2048, 4, 4, 80, True, None, 0),
    "hd256_s200": (2, 200, 200, 4, 4, 256, True, None, 0),
    "hd256_q_offset_window": (1, 100, 300, 4, 2, 256, True, 64, 200),
    "hd256_not_causal": (1, 100, 130, 2, 1, 256, False, 16, 0),
    "hd256_s2048": (1, 2048, 2048, 4, 4, 256, True, None, 0),
}
WG_ROWS, BLOCK_ROWS = 64, 128  # a consumer warpgroup's and a block's rows


def _hopper_emulation(q, k, v, causal, window, q_offset):
    """flash_fwd_sm90 (csrc/flash_attention.cu) step by step, over all
    (batch, head) pairs at once: blocks of 128 query rows in two warpgroups
    of 64, key tiles of 128 (64 from hd = 128 up) between the kernel's loop
    bounds, rows past S zero-filled as TMA fills them, element masks only
    on the tiles the kernel masks, a warpgroup's tile skipped when it sees
    no key of it, the float32 online softmax in exp2 of scores scaled by
    scale * log2(e), P rounded to bf16 before P V, the row sum divided out
    at the end (zeros where it is 0). Returns (B, Sq, H, hd) in bf16."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    bk = 64 if hd >= 128 else 128  # Tile<HD>::kBK
    sl2 = torch.tensor(hd ** -0.5 * math.log2(math.e), dtype=torch.float32)
    n_qt = -(-Sq // BLOCK_ROWS)
    rep = H // KV
    # (B, H, rows, hd) float32 of the bf16 operands, zero rows past S.
    qf = torch.zeros(B, H, n_qt * BLOCK_ROWS, hd)
    qf[:, :, :Sq] = q.float().transpose(1, 2)
    kf = torch.zeros(B, H, -(-Sk // bk) * bk, hd)
    vf = torch.zeros_like(kf)
    kf[:, :, :Sk] = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf[:, :, :Sk] = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    out = torch.zeros(B, H, n_qt * BLOCK_ROWS, hd)
    for q0 in range(0, Sq, BLOCK_ROWS):
        p_lo = q_offset + q0
        p_hi = q_offset + min(q0 + BLOCK_ROWS, Sq) - 1
        k_end = min(Sk, p_hi + 1) if causal else Sk
        k_begin = max(0, p_lo - window + 1) if window else 0
        k_begin = k_begin // bk * bk
        for r0 in range(q0, q0 + BLOCK_ROWS, WG_ROWS):
            wp_lo = q_offset + r0
            wp_hi = wp_lo + WG_ROWS - 1
            qpos = (wp_lo + torch.arange(WG_ROWS))[:, None]
            m = torch.full((B, H, WG_ROWS, 1), -math.inf)
            l = torch.zeros(B, H, WG_ROWS, 1)
            acc = torch.zeros(B, H, WG_ROWS, hd)
            for k0 in range(k_begin, k_end, bk):
                if (causal and k0 > wp_hi) or (
                        window and k0 + bk - 1 <= wp_lo - window):
                    continue  # this warpgroup sees no key of the tile
                s = qf[:, :, r0:r0 + WG_ROWS] @ kf[:, :, k0:k0 + bk].mT
                straddles = (k0 + bk > Sk or (causal and k0 + bk - 1 > wp_lo)
                             or (window and k0 <= wp_hi - window))
                if straddles:
                    kpos = (k0 + torch.arange(bk))[None, :]
                    ok = kpos < Sk
                    if causal:
                        ok = ok & (kpos <= qpos)
                    if window:
                        ok = ok & (kpos > qpos - window)
                    s = torch.where(ok, s, -math.inf)
                mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                mu = torch.where(mx == -math.inf, 0.0, mx)
                alpha = torch.exp2((m - mu) * sl2)
                p = torch.exp2(s * sl2 - mu * sl2)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                m = mx
                pv = p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
                acc = acc * alpha + pv
            out[:, :, r0:r0 + WG_ROWS] = torch.where(
                l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out[:, :, :Sq].transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("name", sorted(HOPPER_CASES))
def test_hopper_kernel_emulation_matches_reference(name):
    B, Sq, Sk, H, KV, hd, causal, window, q_offset = HOPPER_CASES[name]
    rng = np.random.default_rng(len(name))
    arrs = [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in arrs)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    out = _hopper_emulation(q, k, v, causal, window, q_offset)
    want = _j_gqa(jq, jk, jv, causal, window, q_offset)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close(out, want, "bfloat16")
    if name == "rows_without_keys":
        assert out[:, 51:].abs().max() == 0
        assert (out[:, :51].abs().amax(dim=-1) > 0).all()
