"""Mamba-2 block (zamba2): the SSD chunked matmul form. Port of
repro/models/mamba2.py.

Plain PyTorch throughout: the reference's SSD is plain JAX (einsums over
sequence chunks), not a Pallas kernel, so no kernel takes part. The
reference's `lax.scan` over chunks computes each chunk's intra-chunk
output and state contribution, which depend on no other chunk; the port
computes those for all chunks at once, batched over a chunk axis, and
loops over the chunks only for the (B, H, P, N) state they carry, two ops
a chunk (at zamba2-2.7b's width, 16 chunks a layer at S = 2048). Group
count G = 1 (zamba2), as in the reference.

Two stated changes, neither of which moves a finite result:

- the intra-chunk decay exp(La_l - La_m) is taken only where l >= m (0
  above the diagonal). The reference takes it everywhere and multiplies
  the upper triangle by 0, so a chunk whose log-decay spans more than
  float32's exp range (~88) gives inf * 0 = NaN there; where it does not,
  the two are equal;
- the three-operand einsums are written as a two-operand einsum and a
  product, so no order of contraction can materialise a (B, L, N, H, P)
  intermediate (671 MB a chunk at zamba2-2.7b's width).

At zamba2-2.7b's width (B = 4, S = 2048, 80 heads, chunk 128) the
batched (B, nc, L, L, H) float32 decay and W take 335 MB each.

bf16 rounding points follow the reference: the projections run in the
activations' dtype, dt is cast to float32 before `+ dt_bias` and the
softplus, x, B and C are cast to float32 for the SSD, and y is rounded to
the activations' dtype before the gate. The decode step updates the
layer's cache in place (the reference returns a new one), as the mamba1
and attention decode steps do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.mamba import causal_conv1d, softplus
from repro_torch.models.norms import init_rms_norm, rms_norm


def mamba2_dims(d_model: int, cfg: SSMConfig):
    d_in = cfg.expand * d_model
    n_heads = d_in // cfg.head_dim
    conv_dim = d_in + 2 * cfg.n_groups * cfg.d_state
    return d_in, n_heads, conv_dim


def init_mamba2(gen: torch.Generator, d_model: int, cfg: SSMConfig) -> Dict:
    """The reference's initialisation, drawn from `gen` on its device (the
    values differ from the reference's: torch's generator is not JAX's
    threefry). The normal draws go in the reference's key order."""
    d_in, H, conv_dim = mamba2_dims(d_model, cfg)
    GN = cfg.n_groups * cfg.d_state
    dev = gen.device
    si = 1.0 / (d_model ** 0.5)
    so = 1.0 / (d_in ** 0.5)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    in_z = normal((d_model, d_in), si)
    in_x = normal((d_model, d_in), si)
    in_B = normal((d_model, GN), si)
    in_C = normal((d_model, GN), si)
    in_dt = normal((d_model, H), si)
    conv_w = normal((cfg.d_conv, conv_dim), 0.1)
    out_proj = normal((d_in, d_model), so)
    return {
        "in_z": in_z,
        "in_x": in_x,
        "in_B": in_B,
        "in_C": in_C,
        "in_dt": in_dt,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), device=dev),
        "dt_bias": torch.log(torch.expm1(
            torch.full((H,), 0.01, device=dev))),
        "norm": init_rms_norm(d_in, device=dev),
        "out_proj": out_proj,
    }


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) float32
    dt: torch.Tensor,  # (B, S, H) float32 (softplus'd)
    A: torch.Tensor,  # (H,) float32, negative
    Bm: torch.Tensor,  # (B, S, N) float32 (G = 1)
    Cm: torch.Tensor,  # (B, S, N) float32
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. Returns y (B, S, H, P) and the final state (B, H, P, N)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # dt = 0 => decay 1 and zero input: the state is carried unchanged
        # through the padding.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
        y, h = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        return y[:, :S], h
    nc = S // L

    def to_chunks(t):
        return t.reshape(Bsz, nc, L, *t.shape[2:])

    xc, dtc, Bc, Cc = map(to_chunks, (x, dt, Bm, Cm))
    La = torch.cumsum(dtc * A, dim=2)  # (B, nc, L, H) inclusive log-decay
    # Intra-chunk (attention form), all chunks at once: W[l, m] =
    # C_l . B_m exp(La_l - La_m) for l >= m, else 0.
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)  # (B, nc, L, L)
    diff = La[:, :, :, None, :] - La[:, :, None, :, :]  # (B, nc, L, L, H)
    lower = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(lower[:, :, None], diff, -torch.inf))
    W = scores[..., None] * decay
    xdt = xc * dtc[..., None]  # (B, nc, L, H, P)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", W, xdt)
    # Each chunk's own contribution to the state at its end.
    seg = torch.exp(La[:, :, -1:, :] - La)  # decay from step m to the end
    S_c = torch.einsum("bcmn,bcmhp->bchpn", Bc, xdt * seg[..., None])
    # The carried state, chunk by chunk (the reference's scan carry): h_in
    # holds the state entering each chunk.
    end = torch.exp(La[:, :, -1, :])[..., None, None]  # (B, nc, H, 1, 1)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = end[:, c] * h + S_c[:, c]
    # Inter-chunk: the carried state's contribution.
    y_inter = (torch.einsum("bcln,bchpn->bclhp", Cc, torch.stack(h_in, 1))
               * torch.exp(La)[..., None])
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def _in_proj(p: Dict, x: torch.Tensor):
    """z and the conv's input xBC = [x, B, C] projections of x."""
    z = x @ p["in_z"].to(x.dtype)
    xBC = torch.cat([x @ p["in_x"].to(x.dtype),
                     x @ p["in_B"].to(x.dtype),
                     x @ p["in_C"].to(x.dtype)], dim=-1)
    return z, xBC


def _split_xbc(conv_out: torch.Tensor, d_in: int, N: int):
    """The reference's jnp.split at [d_in, d_in + N]."""
    return (conv_out[..., :d_in], conv_out[..., d_in:d_in + N],
            conv_out[..., d_in + N:])


def _dt(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return softplus((x @ p["in_dt"].to(x.dtype)).to(torch.float32)
                    + p["dt_bias"])


def mamba2_forward(
    p: Dict, x: torch.Tensor, cfg: SSMConfig,
    h0: Optional[torch.Tensor] = None, return_state: bool = False,
):
    """x: (B, S, d_model) -> (B, S, d_model) [+ final (conv_tail, h)]."""
    B_, S, d_model = x.shape
    d_in, H, _ = mamba2_dims(d_model, cfg)
    P, N = cfg.head_dim, cfg.d_state
    z, xBC = _in_proj(p, x)
    conv_out = F.silu(causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    x_c, Bm, Cm = _split_xbc(conv_out, d_in, N)
    dt = _dt(p, x)
    A = -torch.exp(p["A_log"])
    xh = x_c.to(torch.float32).reshape(B_, S, H, P)
    y, h = ssd_chunked(xh, dt, A, Bm.to(torch.float32),
                       Cm.to(torch.float32), chunk=cfg.chunk, h0=h0)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        K = p["conv_w"].shape[0]
        conv_tail = xBC[:, -(K - 1):, :]
        return out, (conv_tail, h)
    return out


def init_mamba2_cache(batch: int, d_model: int, cfg: SSMConfig,
                      dtype=torch.float32, device=None) -> Dict:
    d_in, H, conv_dim = mamba2_dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, H, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
    }


def mamba2_decode_step(
    p: Dict, x: torch.Tensor, cfg: SSMConfig, cache: Dict
) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step. x: (B, 1, d_model). The cache's tensors
    are updated in place and the same dict returned."""
    B_, _, d_model = x.shape
    d_in, H, _ = mamba2_dims(d_model, cfg)
    P, N = cfg.head_dim, cfg.d_state
    z, xBC = _in_proj(p, x)
    window = torch.cat([cache["conv"].to(x.dtype), xBC], dim=1)
    conv_out = F.silu(
        torch.einsum("bkd,kd->bd", window, p["conv_w"].to(x.dtype))
        + p["conv_b"].to(x.dtype))
    x_c, Bm, Cm = _split_xbc(conv_out, d_in, N)
    dt = _dt(p, x)[:, 0]  # (B, H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None])  # (B, H)
    xh = x_c.to(torch.float32).reshape(B_, H, P)
    dBx = (Bm.to(torch.float32)[:, None, None, :]
           * (xh * dt[:, :, None])[..., None])  # (B, H, P, N)
    h = a[:, :, None, None] * cache["h"] + dBx
    y = torch.einsum("bhpn,bn->bhp", h, Cm.to(torch.float32))
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return out, cache
