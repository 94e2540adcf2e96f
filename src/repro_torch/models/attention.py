"""GQA attention: train forward, prefill (cache write) and decode step.
Port of repro/models/attention.py.

Supports qk-norm, QKV bias, sliding-window attention, and three ways to
compute the full-sequence attention, chosen by `impl` (the reference's
names in brackets):

  "plain"   ("xla")     masked dense attention, `_sdpa`;
  "blocked" ("blocked") per-query-block attention against only its valid
                        context, `_blocked_causal_sdpa`;
  "kernel"  ("pallas")  the hand-written CUDA flash-attention kernel
                        (kernels/flash_attention), which runs its plain
                        version on CPU tensors.

Decode stays plain torch, as in the reference.

The KV cache is written in place (the reference returns an updated copy):
`attention_prefill` and `attention_decode_step` fill the tensors of the
cache they are given and return the same dict.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.norms import init_rms_norm, rms_norm
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
IMPLS = ("plain", "blocked", "kernel")


def init_attention(gen: torch.Generator, d_model: int, cfg: AttentionConfig,
                   ) -> Dict:
    """Head-major 3D weights: (d, H, hd) / (H, hd, d), drawn from `gen` on
    its device."""
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    scale_in = 1.0 / (d_model ** 0.5)
    scale_out = 1.0 / ((h * hd) ** 0.5)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device) * scale

    p = {
        "wq": normal((d_model, h, hd), scale_in),
        "wk": normal((d_model, kvh, hd), scale_in),
        "wv": normal((d_model, kvh, hd), scale_in),
        "wo": normal((h, hd, d_model), scale_out),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=gen.device)
        p["bk"] = torch.zeros((kvh, hd), device=gen.device)
        p["bv"] = torch.zeros((kvh, hd), device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, device=gen.device)
        p["k_norm"] = init_rms_norm(hd, device=gen.device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bshd,hdo->bso')."""
    return o.flatten(-2) @ w.to(o.dtype).flatten(0, 1)


def _project_qkv(p: Dict, x: torch.Tensor, cfg: AttentionConfig, positions):
    """x: (B, S, d) -> q (B,S,H,hd), k,v (B,S,KV,hd), roped."""
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """Reference scaled-dot-product GQA attention, with the reference's
    rounding points: the score product in the operands' common dtype, then
    float32; the probabilities cast back to q's dtype before the PV
    product.

    q: (B,S,H,hd), k/v: (B,T,KV,hd), mask: (S,T) or (B,S,T) bool
    (True=keep). KV heads are repeated to H (repeat-interleave order).
    Mixed dtypes (float32 queries against the bf16 cache) promote, as
    jnp.einsum does.
    """
    hd = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bshd,bthd->bhst", q.to(dt), k.to(dt))
    logits = logits.to(torch.float32) / math.sqrt(hd)
    mask_b = mask[None, None] if mask.dim() == 2 else mask[:, None]
    logits = torch.where(mask_b, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs.to(dt), v.to(dt))


def _causal_mask(S: int, window: Optional[int], device=None) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m


def _blocked_causal_sdpa(q, k, v, window: Optional[int], block: int = 2048):
    """Causal attention computed per query block against only its valid
    context — skips the strictly-upper triangle, ~2x fewer score/PV FLOPs
    than the dense-masked _sdpa at long S."""
    S = q.shape[1]
    outs = []
    for i in range(0, S, block):
        bq = min(block, S - i)
        end = i + bq
        start = 0 if window is None else max(0, end - window - bq)
        q_pos = i + torch.arange(bq, device=q.device)
        k_pos = start + torch.arange(end - start, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        outs.append(_sdpa(q[:, i:end], k[:, start:end], v[:, start:end],
                          mask))
    return torch.cat(outs, dim=1)


def _attend(q, k, v, cfg: AttentionConfig, impl: str) -> torch.Tensor:
    """Causal self-attention of projected q, k, v by `impl`."""
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window)
    if impl == "blocked":
        return _blocked_causal_sdpa(q, k, v, cfg.sliding_window)
    if impl == "plain":
        mask = _causal_mask(q.shape[1], cfg.sliding_window, device=q.device)
        return _sdpa(q, k, v, mask)
    raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                     f"{IMPLS}")


def attention_forward(
    p: Dict,
    x: torch.Tensor,
    cfg: AttentionConfig,
    positions: torch.Tensor,
    impl: str = "plain",
) -> torch.Tensor:
    """Causal self-attention over the full sequence. x: (B, S, d)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    return _out(_attend(q, k, v, cfg, impl), p["wo"])


# ---------------------------------------------------------------------------
# KV cache (full-length or sliding-window ring buffer)
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig,
                  dtype=torch.bfloat16, device=None) -> Dict:
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(
    p: Dict, x: torch.Tensor, cfg: AttentionConfig, positions, cache: Dict,
    impl: str = "plain",
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also fills the KV cache (in place)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    S = x.shape[1]
    L = cache["k"].shape[1]
    if cfg.sliding_window and S > L:
        # Ring buffer keeps the last L positions at slot p % L (the decode
        # step writes pos % L, so the layout must match).
        slots = torch.arange(S - L, S, device=x.device) % L
        cache["k"][:, slots] = k[:, S - L:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, S - L:].to(cache["v"].dtype)
    else:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    return _out(_attend(q, k, v, cfg, impl), p["wo"]), cache


def attention_decode_step(
    p: Dict, x: torch.Tensor, cfg: AttentionConfig, pos: int, cache: Dict,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the KV cache (written in place).

    x: (B, 1, d); pos: the current absolute position, a host int (the
    reference's 0-d int32 array), so no step waits on the card to read it.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    L = cache["k"].shape[1]
    slot = pos % L if cfg.sliding_window else pos
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    # Valid positions: for full cache, j <= pos; for ring buffer every slot
    # written so far is in-window by construction.
    j = torch.arange(L, device=x.device)
    if cfg.sliding_window:
        valid = (j <= min(pos, L - 1)) | (pos >= L)
    else:
        valid = j <= pos
    out = _sdpa(q, cache["k"], cache["v"], valid[None, :])
    return _out(out, p["wo"]), cache
